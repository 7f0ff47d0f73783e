"""k1_roofline.track: K1 (blend_kernel) in the traced tracked frames: the
bound of the live pairs counted on each frame's map at each iteration's
pose over the profiler's device time of the same launches."""
from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k1.track", "blend_kernel")
