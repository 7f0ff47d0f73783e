"""plan_p90_ms: the 90th percentile of the harness's synchronized span
around each planning event of the window (statistics.quantiles, n=10)."""
from harness.readers import mean_span


def read(run):
    return mean_span(run, "plan_p90_ms")
