"""device_idle.episode: the share of the traced stretch of an episode in
which nothing ran on the card."""
from harness.readers import idle_pct


def read(run):
    return idle_pct(run)
