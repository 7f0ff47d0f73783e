"""recon_update_ms: the port's StepTimer phase `recon_metric`, its mean
over the updates inside the window."""
from harness.readers import mean_span


def read(run):
    return mean_span(run, "recon_update_ms")
