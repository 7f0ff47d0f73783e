"""track_step_ms: the port's own span track.step (models/slam.py
_tracking_phase: one Adam iteration on the pose, its render, backward
and update), its mean host milliseconds over the window's iterations
after the traced stretch."""
from harness.spans import mean_span_ms


def read(run):
    return mean_span_ms(run, "track.step")
