"""Per-phase wall-clock accounting of an episode (the JAX package's
utils/logging_utils.py StepTimer).  Host clock: a phase that only
launches device work is charged its launch time, and the next phase
that waits on the device is charged the wait."""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


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
