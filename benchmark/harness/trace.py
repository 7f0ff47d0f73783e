"""The traced stretch of a window: torch.profiler over the card and the
host, reduced once the window has closed to the device's busy time, its
kernels by name, the host phases that the idle gaps fall in, and the
ranges that the cells mark with `mark`."""
from __future__ import annotations

import bisect
from contextlib import contextmanager

PHASE = "phase:"      # the port's StepTimer phases, mirrored while traced
MARK = "bench:"       # ranges the harness marks (events, chunks, the stretch)
STRETCH = MARK + "traced"


class Tracer:
    """Profiles from start() to stop(); `mark(name)` records a named host
    range that the readers find again in the summary.  While on, the
    port's StepTimer phases are mirrored as ranges, so that an idle gap
    can be named by what the host was doing."""

    def __init__(self):
        self.prof = None
        self.on = False
        self.summary = None
        self._stretch = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._stretch = torch.profiler.record_function(STRETCH)
        self._stretch.__enter__()
        self.on = True

    def stop(self):
        """End the traced stretch; reduce() reads it later, outside the
        window."""
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._stretch.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.on = False

    def reduce(self) -> dict | None:
        if self.prof is not None and self.summary is None:
            if self.on:
                self.stop()
            # the profiler's raw events: building its FunctionEvent tree
            # takes minutes for a mapping event's ~10^5 launches
            self.summary = summarize(self.prof.profiler.kineto_results
                                     .events())
            self.prof = None
        return self.summary

    @contextmanager
    def mark(self, name: str):
        if not self.on:
            yield
            return
        import torch
        with torch.profiler.record_function(MARK + name):
            yield

    def mirror_phases(self, timer):
        """Wrap a StepTimer's phase() to open a range of the same name
        while the tracer is on."""
        inner = timer.phase
        tracer = self

        @contextmanager
        def phase(name):
            if not tracer.on:
                with inner(name):
                    yield
                return
            import torch
            with inner(name), torch.profiler.record_function(PHASE + name):
                yield
        timer.phase = phase


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events) -> dict:
    """Device intervals (kernels and copies), host phase and mark ranges,
    on the profiler's clock in microseconds, from its raw events."""
    from torch.autograd import DeviceType
    kernels, copies, phases, marks = [], [], [], []
    for e in events:
        name, dev = e.name(), e.device_type()
        s = e.start_ns() * 1e-3
        t = s + e.duration_ns() * 1e-3
        if name.startswith((PHASE, MARK)):
            # a range is shown on the device's timeline too: only the
            # host's copy counts, and as a range, not as device work
            if dev != DeviceType.CUDA:
                (phases if name.startswith(PHASE) else marks).append(
                    (s, t, name.split(":", 1)[1]))
        elif dev == DeviceType.CUDA:
            (copies if name.startswith(("Memcpy", "Memset"))
             else kernels).append((s, t, name))
    stretch = [m for m in marks if m[2] == "traced"]
    lo, hi = (stretch[0][0], stretch[0][1]) if stretch else (
        min(k[0] for k in kernels), max(k[1] for k in kernels))
    busy = _union([(max(s, lo), min(t, hi)) for s, t, _n in kernels + copies
                   if t > lo and s < hi])
    busy_us = sum(e - s for s, e in busy)
    gaps = [(a[1], b[0]) for a, b in zip([[lo, lo]] + busy, busy + [[hi, hi]])
            if b[0] > a[1]]
    return dict(lo=lo, hi=hi, window_s=(hi - lo) * 1e-6,
                busy_s=busy_us * 1e-6, kernels=kernels, copies=copies,
                phases=phases, marks=marks, gaps=gaps)


def _innermost(ranges, starts, t, look_back: int = 256):
    """The shortest of the ranges (sorted by start) that hold t, looking
    at the `look_back` latest to start before it."""
    best = None
    i = bisect.bisect_right(starts, t)
    for s, e, name in ranges[max(i - look_back, 0):i]:
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "untracked"


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    the innermost host phase open at each gap's middle, each summed by
    name, in seconds."""
    ops: dict[str, float] = {}
    for s, e, name in summary["kernels"] + summary["copies"]:
        key = name if len(name) <= 96 else name[:93] + "..."
        ops[key] = ops.get(key, 0.0) + (e - s) * 1e-6
    idle: dict[str, float] = {}
    ranges = sorted(summary["phases"] + [m for m in summary["marks"]
                                         if m[2] != "traced"])
    starts = [r[0] for r in ranges]
    for s, e in summary["gaps"]:
        name = _innermost(ranges, starts, 0.5 * (s + e))
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    by = lambda d: [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
    return dict(device_ops=by(ops), idle_gaps=by(idle))


def kernel_time_in(summary: dict, key: str, mark_prefix: str):
    """(device seconds, launches) of the kernels whose name holds `key`
    and that start inside a mark range named `mark_prefix`..., and the
    names of those ranges."""
    ranges = [m for m in summary["marks"] if m[2].startswith(mark_prefix)]
    total, n = 0.0, 0
    for s, e, name in summary["kernels"]:
        if key in name and any(r[0] <= s <= r[1] for r in ranges):
            total += (e - s) * 1e-6
            n += 1
    return total, n, [r[2] for r in ranges]
