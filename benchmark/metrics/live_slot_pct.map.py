"""live_slot_pct.map: 100 x the live slots over the capacity, summed over
the window's mapping events after the traced stretch (the port's
counters map.n_active and map.capacity at each event's start): the share
of the slots that preprocess runs over that hold a Gaussian."""
from harness.spans import window_counts


def read(run):
    live = window_counts(run, "map.n_active")
    cap = window_counts(run, "map.capacity")
    if not live or not cap or len(live) != len(cap) or sum(cap) <= 0:
        return None
    return 100.0 * sum(live) / sum(cap)
