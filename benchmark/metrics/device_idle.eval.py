"""device_idle.eval: the share of the traced evaluation chunks in which
nothing ran on the card."""
from harness.readers import idle_pct


def read(run):
    return idle_pct(run)
