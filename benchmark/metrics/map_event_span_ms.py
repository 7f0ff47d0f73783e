"""map_event_span_ms: the port's own span map.event
(models/slam.py GaussianSLAM._mapping_event), its mean host milliseconds
over the window's events after the traced stretch."""
from harness.spans import mean_span_ms


def read(run):
    return mean_span_ms(run, "map.event")
