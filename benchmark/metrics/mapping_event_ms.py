"""mapping_event_ms: the mean of the harness's spans around
GaussianSLAM.track_rgbd on the window's mapping steps, synchronized at both
ends (traced run)."""
from harness.readers import mean_span


def read(run):
    return mean_span(run, "mapping_event_ms")
