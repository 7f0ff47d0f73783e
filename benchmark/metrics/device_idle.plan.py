"""device_idle.plan: the share of the traced planning events in which
nothing ran on the card."""
from harness.readers import idle_pct


def read(run):
    return idle_pct(run)
