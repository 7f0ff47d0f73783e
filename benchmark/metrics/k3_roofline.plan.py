"""k3_roofline.plan: K3 (fisher_kernel, 11- and 20-wide) in the first traced
planning events: the bound of the live pairs counted at every pose the
kernel scored over the profiler's device time of the same launches."""
from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k3.plan", "fisher_kernel")
