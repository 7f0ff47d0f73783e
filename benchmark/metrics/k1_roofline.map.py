"""k1_roofline.map: K1 (blend_kernel) in the traced mapping events: the
bound of the live pairs counted on each event's starting map over the
profiler's device time of the same launches."""
from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k1.map", "blend_kernel")
