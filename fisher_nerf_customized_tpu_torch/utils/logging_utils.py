"""Metrics channels of an episode, the JAX package's
utils/logging_utils.py: MetricsLogger, a JSONL stream of per-step
metrics (tensorboardX and wandb too when they are installed), StepTimer,
the per-phase wall-clock accounting, and profile_trace, a torch.profiler
trace around a block.  StepTimer reads the host clock: a phase that only
launches device work is charged its launch time, and the next phase that
waits on the device is charged the wait; on a CUDA device it also times
each phase on the device, between two CUDA events on the current stream.

Below the episode loop, the layers record into one process-wide SpanStore,
STORE, through `span(name)` and `count(name, value)`: a span is a host
stretch with its name, start and duration on time.perf_counter_ns, and
the span open on the same thread when it began; a counter is a value at
a time.  Every StepTimer phase is a span too.  While a torch.profiler
runs (and only then) each span also opens a `phase:<name>` range, so a
trace names the host's stretches; `STORE.profiler_ns` lays a span's time
on the profiler's clock.  The spans of the port:

  map.event          GaussianSLAM._mapping_event (with device time)
    map.densify      the previous densify's guard and _densify
    map.window       the keyframe window: depth pull, selection, stacking
    map.bin          the frozen tile binning of the window's frames
    map.step         one Adam iteration; run as written, with children
      map.step.loss  the frames' renders and the L1 + SSIM loss
      map.step.grad  torch.autograd.grad (K2, SSIM and preprocess backward)
      map.step.adam  densify statistics, adam_step, the soft prune
                     (a step replayed from the CUDA graph has none)
    map.capture      the CUDA graph capture of one step (on a CUDA device)
    map.compact      prune_compact
    map.gs_densify   the gradient clone / split
  track.frame        GaussianSLAM._track_pose (with device time)
    track.phase      one _tracking_phase (a second with the doubled steps)
      track.step     one Adam iteration on the pose, with children
        track.step.loss   the render and the masked SUM loss
        track.step.grad   torch.autograd.grad to (q, t) (K2, projection)
        track.step.adam   the Adam update and the best-pose keep
  render.preprocess, render.bin, render.blend   ops/rasterize.py
  render.pose        one pose's render (models/slam.py::_render_pose)
  eval.poses, eval.render, eval.gt, eval.metrics
                     one chunk of engine/eval.py::eval_navigation
  plan.global.prune, plan.global.candidates, plan.global.launch
                     inside ActiveMapper's plan.global phase

and the counters map.capacity, map.steps and map.n_active (the live
slots at the event's start, kept as the device's 0-d tensor and read
only when the record is read), and map.graph_steps (the event's steps
replayed from a CUDA graph, at its end), and once a tracked frame
track.iters (the Adam iterations it ran) and track.doubled (1 when its
second phase ran, else 0)."""
from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger(__name__)

RANGE_PREFIX = "phase:"


def _cuda_events(device):
    """A started (begin, end) pair of timing events on the current stream
    of a CUDA device; None for any other device."""
    if device is None or torch.device(device).type != "cuda":
        return None
    begin = torch.cuda.Event(enable_timing=True)
    begin.record()
    return begin, torch.cuda.Event(enable_timing=True)


class SpanRecord:
    """One closed span: name, start t0_ns and duration dt_ns on
    time.perf_counter_ns, its id, and the id and name of the span open on
    the same thread when it began (0 and None at the top).  A span given
    a CUDA device carries a pair of timing events; `device_ms()` reads
    their interval, waiting for the end event."""

    __slots__ = ("id", "name", "t0_ns", "dt_ns", "parent_id", "parent",
                 "_events", "_device_ms")

    def __init__(self, id_, name, t0_ns, dt_ns, parent_id, parent, events):
        self.id, self.name = id_, name
        self.t0_ns, self.dt_ns = t0_ns, dt_ns
        self.parent_id, self.parent = parent_id, parent
        self._events, self._device_ms = events, None

    def device_ms(self):
        if self._device_ms is None and self._events is not None:
            begin, end = self._events
            end.synchronize()
            self._device_ms = begin.elapsed_time(end)
            self._events = None
        return self._device_ms


class _Span:
    """The context manager of one span (a class: a generator-based one
    costs a few microseconds more on the mapping step's path)."""

    __slots__ = ("store", "name", "device", "id", "t0", "parent", "rf",
                 "events")

    def __init__(self, store, name, device):
        self.store, self.name, self.device = store, name, device

    def __enter__(self):
        st = self.store
        stack = st._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(st._ids)
        stack.append((self.id, self.name))
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            st._profiler_seen()
            self.rf = torch.profiler.record_function(RANGE_PREFIX
                                                     + self.name)
            self.rf.__enter__()
        self.events = (None if self.device is None
                       else _cuda_events(self.device))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        st = self.store
        st._stack().pop()
        pid, pname = self.parent or (0, None)
        st._ring(st.spans, self.name).append(SpanRecord(
            self.id, self.name, self.t0, dt, pid, pname, self.events))
        return False


class SpanStore:
    """Span and counter records in memory, the newest RING of each name
    (one busy name never pushes out another's), and the clock anchors:
    (time.perf_counter_ns, time.time_ns) pairs taken back to back at the
    first span opened while a profiler runs and at each profiler start
    seen since, which lay a record on the profiler's clock (Unix-epoch
    nanoseconds) and back."""

    RING = 16384

    def __init__(self):
        self.spans: dict[str, deque] = {}
        self.counters: dict[str, deque] = {}
        self.anchors: list[tuple[int, int]] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._profiling = False

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _ring(self, table: dict, name: str) -> deque:
        ring = table.get(name)
        if ring is None:
            ring = table[name] = deque(maxlen=self.RING)
        return ring

    def _profiler_seen(self):
        if not self._profiling:
            self.anchor()
        self._profiling = True

    def span(self, name: str, device=None) -> _Span:
        """A context manager recording the block as a span `name`; with a
        CUDA `device`, also its device time between two events."""
        if self._profiling and not _autograd_profiler._is_profiler_enabled:
            self._profiling = False      # the next profiler start anchors
        return _Span(self, name, device)

    def count(self, name: str, value):
        """A counter record (t_ns, value, the open span's id).  The value
        may be a 0-d tensor: it is read to a number only by `counts`."""
        stack = self._stack()
        self._ring(self.counters, name).append(
            (time.perf_counter_ns(), value, stack[-1][0] if stack else 0))

    def records(self, name: str) -> list[SpanRecord]:
        return list(self.spans.get(name, ()))

    def counts(self, name: str) -> list[tuple[int, float]]:
        """(t_ns, value) of each counter record, tensors read to numbers."""
        return [(t, float(v.item() if isinstance(v, torch.Tensor) else v))
                for t, v, _p in self.counters.get(name, ())]

    def anchor(self) -> tuple[int, int]:
        pair = (time.perf_counter_ns(), time.time_ns())
        self.anchors.append(pair)
        return pair

    def profiler_ns(self, perf_ns: int) -> int:
        """A time on perf_counter_ns laid on the profiler's clock, by the
        latest anchor (one is taken if there is none yet)."""
        p, w = self.anchors[-1] if self.anchors else self.anchor()
        return perf_ns + (w - p)

    def perf_ns(self, profiler_ns: int) -> int:
        """The inverse of profiler_ns."""
        p, w = self.anchors[-1] if self.anchors else self.anchor()
        return profiler_ns - (w - p)


STORE = SpanStore()


def span(name: str, device=None) -> _Span:
    """STORE.span: `with span("map.step"): ...`."""
    return STORE.span(name, device)


def count(name: str, value):
    """STORE.count: a counter record of `value` under `name`."""
    STORE.count(name, value)


class MetricsLogger:
    """Appends one JSON record per log call to
    <log_dir>/<run_name>_metrics.jsonl: {"step", "t" (unix seconds), the
    metrics as floats}; mirrors them to tensorboardX when it imports, and
    with use_wandb to a wandb run (project "active_mapping", named
    run_name).  A wandb that fails to import or to start logs a warning
    and the logger carries on without it, as the JAX package's does.
    With enabled=False (a rank other than 0 of a process group) it writes
    nothing and starts no wandb run."""

    def __init__(self, log_dir: str, run_name: str = "run",
                 use_wandb: bool = False, enabled: bool = True):
        self._f = self._tb = self._wandb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}_metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter   # optional
            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project="active_mapping",
                                         name=run_name)
            except Exception:
                logger.warning("wandb requested but unavailable")

    def log(self, step: int, **metrics):
        if self._f is None:
            return
        rec = dict(step=int(step), t=time.time(), **{
            k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Total, count and mean wall time per named phase, plus a bounded
    timeline [(name, t_start, dt)] that separates steady-state cost from
    one-time outliers.  Each phase is also a span of STORE.  With a CUDA
    `device`, each phase is timed on the device too, between two events
    on the current stream, read when they have completed (no wait on the
    phase's path) and at the latest by `summary()`, which then gives
    `device_ms`, the mean device milliseconds, beside the other keys."""

    MAX_EVENTS = 20000

    def __init__(self, device=None):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.events: list[tuple[str, float, float]] = []
        self.device = device
        self.device_totals = defaultdict(float)
        self.device_counts = defaultdict(int)
        self._pending: deque = deque()

    @contextmanager
    def phase(self, name: str):
        with STORE.span(name):
            events = _cuda_events(self.device)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.totals[name] += dt
                self.counts[name] += 1
                if len(self.events) < self.MAX_EVENTS:
                    self.events.append((name, t0, dt))
                if events is not None:
                    events[1].record()
                    self._pending.append((name, *events))
                    self._resolve(wait=False)

    def _resolve(self, wait: bool):
        """Add the device time of the finished phases, oldest first; with
        `wait`, of all of them."""
        while self._pending:
            name, begin, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._pending.popleft()
            self.device_totals[name] += begin.elapsed_time(end)
            self.device_counts[name] += 1

    def summary(self) -> dict:
        self._resolve(wait=True)
        out = {k: dict(total_s=round(self.totals[k], 3),
                       count=self.counts[k],
                       mean_ms=round(self.totals[k] / max(self.counts[k], 1)
                                     * 1000, 2))
               for k in self.totals}
        for k, n in self.device_counts.items():
            out[k]["device_ms"] = round(self.device_totals[k] / n, 2)
        return out


@contextmanager
def profile_trace(log_dir: str | None):
    """A torch.profiler trace of the block (the host's activity, and the
    card's where CUDA is available), written as a Chrome trace
    <log_dir>/trace_<pid>_<time>.json when the block ends, also when it
    raises; a no-op for a falsy log_dir.  View it in chrome://tracing or
    Perfetto."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
