"""launches_per_track_step: CUDA kernels of the traced stretch that
start inside a host range phase:track.step (the port's span of one Adam
iteration on the pose), over the number of those ranges."""
from harness.spans import kernels_per_range


def read(run):
    return kernels_per_range(run, "track.step")
