"""What the metric readers under metrics/ share: each reader is a file of
its own with `read(run) -> float | None`, and None leaves the metric out
of the line (nothing to read in this run)."""
from __future__ import annotations

import statistics


def mean_span(run, name: str):
    vals = run.spans.get(name)
    return statistics.fmean(vals) if vals else None


def idle_pct(run):
    """The share of the traced stretch in which no kernel or copy ran on
    the card."""
    s = run.trace_summary
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def roofline_pct(run, work_key: str, kernel_key: str):
    """100 x the bound of the counted calls over the device time of the
    same calls: the kernels named `kernel_key` that start inside the
    marked ranges that the work names."""
    s, work = run.trace_summary, run.work.get(work_key)
    if not s or not work:
        return None
    ranges = {name: (a, b) for a, b, name in s["marks"]}
    bound = device = 0.0
    for mark, bound_s in work:
        if mark not in ranges:
            continue
        a, b = ranges[mark]
        t = sum(e - st for st, e, n in s["kernels"]
                if kernel_key in n and a <= st <= b) * 1e-6
        if t > 0:
            bound += bound_s
            device += t
    return 100.0 * bound / device if device > 0 else None
