"""track_iters_per_frame: the port's counter track.iters (the Adam
iterations of one tracked frame, written once a frame by
models/slam.py GaussianSLAM._track_pose) summed over the window's frames
after the traced stretch, over the number of those frames."""
from harness.spans import window_counts


def read(run):
    iters = window_counts(run, "track.iters")
    return sum(iters) / len(iters) if iters else None
