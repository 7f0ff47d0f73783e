"""The port's own spans and counters, read after a run from the store of
fisher_nerf_customized_tpu_torch/utils/logging_utils.py (STORE): the
records that start after the traced stretch (its end laid on the host's
perf_counter through the store's clock anchor; the window's start
without a trace) and before the window's end, as the harness's own
spans after the traced stretch are.  A program without the store, or
without records of the name there, gives None."""
from __future__ import annotations

import bisect
import statistics


def store():
    from fisher_nerf_customized_tpu_torch.utils import logging_utils
    return getattr(logging_utils, "STORE", None)


def _bounds_ns(run, st):
    """(lo, hi) of the records read, in perf_counter nanoseconds."""
    if run.t_window is None or run.t_window[1] is None:
        return None
    lo = run.t_window[0] * 1e9
    s = run.trace_summary
    if s:
        lo = max(lo, st.perf_ns(int(s["hi"] * 1e3)))
    return lo, run.t_window[1] * 1e9


def window_spans(run, name: str) -> list:
    """The store's span records of `name` inside the read stretch."""
    st = store()
    bounds = _bounds_ns(run, st) if st is not None else None
    if bounds is None:
        return []
    lo, hi = bounds
    return [r for r in st.records(name) if lo <= r.t0_ns <= hi]


def mean_span_ms(run, name: str):
    recs = window_spans(run, name)
    return statistics.fmean(r.dt_ns * 1e-6 for r in recs) if recs else None


def window_counts(run, name: str) -> list[float]:
    """The values of the store's counter `name` inside the read stretch."""
    st = store()
    bounds = _bounds_ns(run, st) if st is not None else None
    if bounds is None:
        return []
    lo, hi = bounds
    return [v for t, v in st.counts(name) if lo <= t <= hi]


def kernels_per_range(run, phase: str):
    """CUDA kernels of the traced stretch that start inside a host range
    `phase:<phase>`, over the number of those ranges."""
    s = run.trace_summary
    if not s or not s["kernels"]:
        return None
    ranges = sorted((a, b) for a, b, n in s["phases"] if n == phase)
    if not ranges:
        return None
    starts = [a for a, _b in ranges]
    n = 0
    for k in s["kernels"]:
        i = bisect.bisect_right(starts, k[0]) - 1
        if i >= 0 and k[0] <= ranges[i][1]:
            n += 1
    return n / len(ranges)
