"""Wall-clock timing of a callable on a torch device, synchronized around
the repetitions (the stage profilers' clock)."""
from __future__ import annotations

import time

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device, reps: int = 20):
    """(ms per call over reps calls after one warm call, the last
    output)."""
    out = fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(device)
    return (time.perf_counter() - t0) / reps * 1000.0, out
