"""k2_roofline.track: K2 (blend_bwd_kernel) in the traced tracked frames,
as k1_roofline.track counts K1: the bound of the live pairs at each
iteration's pose over the device time of the same launches."""
from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k2.track", "blend_bwd_kernel")
