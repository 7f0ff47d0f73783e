"""plan_candidates_ms: the port's StepTimer phases plan.global +
plan.sweep + plan.global.wait (the candidates, their K3 11-wide scoring
and the sweep field; the sum ends in the pull of the scores) over the
window, per event."""
from harness.readers import mean_span


def read(run):
    return mean_span(run, "plan_candidates_ms")
