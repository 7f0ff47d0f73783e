"""Metrics channels of an episode, the JAX package's
utils/logging_utils.py: MetricsLogger, a JSONL stream of per-step
metrics (tensorboardX and wandb too when they are installed), StepTimer,
the per-phase wall-clock accounting, and profile_trace, a torch.profiler
trace around a block.  StepTimer reads the host clock: a phase that only
launches device work is charged its launch time, and the next phase that
waits on the device is charged the wait."""
from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict
from contextlib import contextmanager

logger = logging.getLogger(__name__)


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
    one-time outliers."""

    MAX_EVENTS = 20000

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.events: list[tuple[str, float, float]] = []

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            if len(self.events) < self.MAX_EVENTS:
                self.events.append((name, t0, dt))

    def summary(self) -> dict:
        return {k: dict(total_s=round(self.totals[k], 3),
                        count=self.counts[k],
                        mean_ms=round(self.totals[k] / max(self.counts[k], 1)
                                      * 1000, 2))
                for k in self.totals}


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
