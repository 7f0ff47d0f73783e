"""k1_roofline.eval: K1 (blend_kernel) in the traced evaluation chunks: the
bound of the live pairs counted at each pose over the profiler's device
time of the same launches."""
from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k1.eval", "blend_kernel")
