"""launches_per_adam_step.map: CUDA kernels of the traced stretch that
start inside a host range phase:map.step (the port's span of one Adam
iteration), over the number of those ranges."""
from harness.spans import kernels_per_range


def read(run):
    return kernels_per_range(run, "map.step")
