"""k2_roofline.map: K2 (blend_bwd_kernel) in the traced mapping events, as
k1_roofline.map."""
from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k2.map", "blend_bwd_kernel")
