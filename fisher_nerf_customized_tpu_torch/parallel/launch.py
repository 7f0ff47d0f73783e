"""Run a function on several local ranks, each a spawned process in a
fresh process group, under a wall limit: the launcher of the multi-rank
tests and of chip_smoke.py's sharded phase.  (torchrun starts ranks for
the entry points; this is for a program that starts its own.)"""
from __future__ import annotations

import queue
import socket
import time
import traceback

import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, port, init, backend, device,
               collective_timeout_s, threads, args, results):
    try:
        if threads:
            import torch
            torch.set_num_threads(threads)
        if init:
            from .distributed import init_distributed
            init_distributed(f"tcp://127.0.0.1:{port}", world_size, rank,
                             local_rank=rank, local_world_size=world_size,
                             backend=backend, device=device,
                             timeout_s=collective_timeout_s)
        out = fn(rank, world_size, port, *args)
        results.put((rank, "ok", out))
    except Exception:
        # reported to run_ranks, which raises it with this traceback
        results.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, args=(), timeout_s: float = 120.0,
              init: bool = True, backend: str | None = None, device="cpu",
              collective_timeout_s: float = 60.0,
              threads: int | None = None) -> list:
    """fn(rank, world_size, port, *args) on `world_size` spawned
    processes; returns their return values in rank order.

    With `init`, each process first joins a group over
    tcp://127.0.0.1:<port> (parallel/distributed.init_distributed with
    `backend`, `device` and a collective timeout); without, fn joins one
    itself.  `threads` sets torch's CPU threads.  fn and its results must
    pickle.  Raises RuntimeError with the rank's traceback if a rank
    fails, and kills every rank if they have not all returned within
    timeout_s."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world_size, port, init, backend, device,
        collective_timeout_s, threads, tuple(args), results))
        for r in range(world_size)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"ranks {sorted(set(range(world_size)) - set(out))} "
                    f"did not finish within {timeout_s:.0f} s")
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(out) == world_size else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
