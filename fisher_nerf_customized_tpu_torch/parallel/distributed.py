"""The process group: one process per rank, as torchrun or SLURM start
them, or as a caller names them.

`init_distributed` resolves the group from, in order: its arguments;
torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK, LOCAL_WORLD_SIZE); SLURM's (SLURM_PROCID, SLURM_NTASKS,
SLURM_LOCALID, SLURM_NTASKS_PER_NODE, with MASTER_ADDR and MASTER_PORT
from the environment).  One process is a no-op returning False, so the
entry points call it unconditionally.  The backend follows one rule,
stated up front and printed: NCCL when every local rank has a card of
its own; gloo on the CPU, and gloo when several ranks share one card
(NCCL refuses two ranks on one device).  It is never switched after a
failure.  Every collective runs under the group's timeout, so that ranks
that part fail rather than hang.

Ranks are numbered host by host (rank = host * local ranks + local
rank), so `make_multihost_mesh` keeps each `model` group inside a host
and puts the host boundary on the outer `data` axis.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

_LOCAL_WORLD = [1]


def _slurm_per_node(value: str | None) -> int | None:
    """The first count of SLURM_NTASKS_PER_NODE / SLURM_TASKS_PER_NODE
    ('4' or '4(x2),2')."""
    if not value:
        return None
    head = value.split(",")[0].split("(")[0]
    return int(head) if head.isdigit() else None


def choose_backend(device=None, local_world_size: int = 1) -> tuple[str, str]:
    """(backend, the reason): the rule of the module docstring."""
    on_cpu = (device is not None and torch.device(device).type == "cpu")
    if on_cpu or not torch.cuda.is_available():
        return "gloo", "gloo: the ranks run on the CPU"
    n = torch.cuda.device_count()
    if local_world_size <= n:
        return "nccl", f"nccl: {local_world_size} local ranks on {n} cards"
    return "gloo", (f"gloo: {local_world_size} local ranks share {n} "
                    f"card(s); NCCL refuses two ranks on one device")


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     local_rank: int | None = None,
                     local_world_size: int | None = None,
                     backend: str | None = None, device=None,
                     timeout_s: float = 600.0) -> bool:
    """Join the process group; False (and nothing done) for one process.

    init_method: 'tcp://host:port' (or 'host:port'); by default
    tcp://MASTER_ADDR:MASTER_PORT.  device: the ranks' device type
    ("cpu" selects gloo).  The rank's card is cuda:local_rank when there
    are enough cards, else the one card."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if world_size is None:
        if "WORLD_SIZE" in env and "RANK" in env:
            world_size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
            local_rank = int(env.get("LOCAL_RANK", rank))
            local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
        elif "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
            world_size = int(env["SLURM_NTASKS"])
            rank = int(env["SLURM_PROCID"])
            local_rank = int(env.get("SLURM_LOCALID", rank))
            local_world_size = _slurm_per_node(
                env.get("SLURM_NTASKS_PER_NODE")
                or env.get("SLURM_TASKS_PER_NODE")) or world_size
    if world_size is None or int(world_size) <= 1:
        return False
    world_size, rank = int(world_size), int(rank or 0)
    local_rank = rank if local_rank is None else int(local_rank)
    local_world_size = int(local_world_size or world_size)
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise RuntimeError("init_distributed: a group of "
                               f"{world_size} ranks needs init_method or "
                               "MASTER_ADDR and MASTER_PORT")
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    elif "://" not in init_method:
        init_method = "tcp://" + init_method
    reason = f"{backend}: as asked"
    if backend is None:
        backend, reason = choose_backend(device, local_world_size)
    if backend == "nccl" or (torch.cuda.is_available() and not (
            device is not None and torch.device(device).type == "cpu")):
        n = torch.cuda.device_count()
        torch.cuda.set_device(local_rank if local_rank < n else 0)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _LOCAL_WORLD[0] = local_world_size
    if rank == 0:
        print(f"init_distributed: {world_size} ranks, {reason}", flush=True)
    return True


def world_size() -> int:
    """Ranks in the default group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_writer() -> bool:
    """Only rank 0 writes files (the SPMD counterpart of JAX's single
    controller); True without a group."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def any_rank(flag: bool) -> bool:
    """True on every rank if `flag` is true on any rank: one all-reduce
    (MAX) of one int over the default group, on the rank's card under
    NCCL and on the CPU under gloo.  Without a group, `flag` itself and
    no collective."""
    if world_size() == 1:
        return bool(flag)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    x = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return bool(x.item())


def barrier():
    """dist.barrier over the default group; nothing without one."""
    if world_size() > 1:
        dist.barrier()


def make_multihost_mesh(model: int = 1, group=None) -> Mesh:
    """The (world / model, model) mesh with each `model` group inside one
    host: the host boundary rides the outer `data` axis (independent
    work, small score gathers), the `model` collectives stay on the
    host's links."""
    n = world_size()
    n_local = _LOCAL_WORLD[0]
    if model > 1:
        assert n_local % model == 0 or n % model == 0, \
            f"model={model} must divide the per-host rank count"
    assert n % model == 0, f"model={model} must divide {n} ranks"
    return make_mesh(data=n // model, model=model, group=group)


def process_info() -> dict:
    """The JAX package's four keys: this rank, the ranks, and the devices
    of this rank (one) and of the group (one a rank)."""
    n = world_size()
    return dict(process_index=dist.get_rank() if n > 1 else 0,
                process_count=n, local_devices=1, global_devices=n)
