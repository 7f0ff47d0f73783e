"""track_frame_ms: the port's own span track.frame
(models/slam.py GaussianSLAM._track_pose: one frame's tracking, its
phases and the pose read back), its mean host milliseconds over the
window's tracked frames after the traced stretch."""
from harness.spans import mean_span_ms


def read(run):
    return mean_span_ms(run, "track.frame")
