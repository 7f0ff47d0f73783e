"""recon_surface_ms: the port's span recon_metric.surface (the host
distances to the scene's surface in engine/eval.py
IncrementalReconMetric.update), its mean milliseconds after the traced
stretch."""
from harness.spans import mean_span_ms


def read(run):
    return mean_span_ms(run, "recon_metric.surface")
