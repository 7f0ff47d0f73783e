"""What every cell shares: the run's context, its clocks and spans, the
result line, and the look into sys.modules for JAX."""
from __future__ import annotations

import json
import math
import os
import sys
import time
from contextlib import contextmanager

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
# Top-level module names the process may not hold once the window has
# closed: JAX, its libraries, and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fisher_nerf_customized_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules, each
    compared whole (the port's name begins with the JAX package's)."""
    names = {m.split(".", 1)[0] for m in (modules or list(sys.modules))}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


class Run:
    """One run of one cell: its arguments, its configuration, the clocks
    of set-up and window, the spans and counters it records, and the
    numbers its correctness check compares."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str, workload: dict, config: dict,
                 t_process: float, control: bool = False):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.workload = workload
        self.params = workload.get("params", {})
        self.config = config
        self.t_process = t_process
        self.t_setup_end = None
        self.t_window = None          # (start, end) on the host clock
        self.setup_parts: dict[str, float] = {}
        self.spans: dict[str, list[float]] = {}
        self.values: dict[str, float] = {}   # window quantities
        self.work: dict[str, list] = {}      # roofline work, by metric
        self.trace_summary = None
        self.checks: list[tuple[str, float, float]] = []
        self.control = bool(control)       # also read the control's numbers
        self.control_checks: dict[str, float] = {}
        self.workdir = None
        self.after_parts: dict[str, float] = {}   # seconds after the window
        self.notes: dict[str, object] = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0

    # -- clocks -----------------------------------------------------------
    def sync(self):
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    @contextmanager
    def setup_part(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.setup_parts[name] = self.setup_parts.get(name, 0.0) \
                + time.perf_counter() - t0

    def start_window(self):
        self.sync()
        now = time.perf_counter()
        self.t_setup_end = now
        self.t_window = (now, None)

    def window_elapsed(self) -> float:
        return time.perf_counter() - self.t_window[0]

    def end_window(self):
        self.sync()
        self.t_window = (self.t_window[0], time.perf_counter())

    @property
    def window_s(self) -> float:
        return self.t_window[1] - self.t_window[0]

    @property
    def setup_s(self) -> float:
        return self.t_setup_end - self.t_process

    @contextmanager
    def span(self, name: str, sync: bool = True):
        """A host-clock span, synchronized at both ends, kept under name."""
        if sync:
            self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                self.sync()
            self.spans.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)

    @contextmanager
    def timed(self, name: str):
        """Seconds of a step after the window (the check, the trace)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.after_parts[name] = time.perf_counter() - t0

    def note(self, name: str, value):
        """A diagnostic printed on standard error beside the check."""
        self.notes[name] = value

    def limit(self, name: str) -> float:
        return float(self.workload["limits"][name])

    def check(self, name: str, value: float, limit: float):
        """One number of the correctness comparison, beside its limit."""
        self.checks.append((name, float(value), float(limit)))

    def control_check(self, name: str, value: float):
        """The same number for the control (the reference one precision
        below), read only by benchmark/control.py."""
        self.control_checks[name] = float(value)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for _n, v, lim in self.checks)


def result_line(run: Run, metrics: dict, device_info: dict,
                breakdown: dict | None) -> str:
    out = dict(correct=run.correct, attempted=int(run.attempted),
               failed=int(run.failed), metrics=metrics, device=device_info)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {n: {"value": v, "limit": lim}
                       for n, v, lim in run.checks}
    return json.dumps(out)
