"""The port's process group (parallel/distributed.py), the counterpart of
tests/test_multihost.py: four spawned ranks on the CPU (gloo), laid out
as two simulated hosts of two ranks each, join a group three times in a
row: from explicit arguments, from torchrun's environment variables and
from SLURM's.  Each time they report process_info and
make_multihost_mesh(model=2)'s layout and run one all-reduce across the
host boundary.  One spawned group (a 120 s wall limit, a 60 s collective
timeout).  In this process: the no-op of one process.

This module imports no JAX: the spawned ranks import it to find their
function.
"""
import os

import pytest
import torch

WORLD = 4
PER_HOST = 2
SOURCES = ("arguments", "torchrun", "slurm")
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS",
            "SLURM_LOCALID", "SLURM_NTASKS_PER_NODE", "SLURM_TASKS_PER_NODE")


def _join(source, rank, port):
    from fisher_nerf_customized_tpu_torch.parallel.distributed import (
        init_distributed)
    for k in ENV_KEYS:
        os.environ.pop(k, None)
    if source == "arguments":
        return init_distributed(f"127.0.0.1:{port}", WORLD, rank,
                                local_rank=rank % PER_HOST,
                                local_world_size=PER_HOST, device="cpu",
                                timeout_s=60)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if source == "torchrun":
        os.environ.update(WORLD_SIZE=str(WORLD), RANK=str(rank),
                          LOCAL_RANK=str(rank % PER_HOST),
                          LOCAL_WORLD_SIZE=str(PER_HOST))
    else:
        os.environ.update(SLURM_NTASKS=str(WORLD), SLURM_PROCID=str(rank),
                          SLURM_LOCALID=str(rank % PER_HOST),
                          SLURM_NTASKS_PER_NODE=f"{PER_HOST}(x2)")
    return init_distributed(device="cpu", timeout_s=60)


def _rank(rank, world, port, ports):
    import torch.distributed as dist
    from fisher_nerf_customized_tpu_torch.parallel.distributed import (
        is_writer, make_multihost_mesh, process_info)
    out = {}
    for source, p in zip(SOURCES, (port,) + tuple(ports)):
        joined = _join(source, rank, p)
        mesh = make_multihost_mesh(model=PER_HOST)
        row = mesh.devices[mesh.coords["data"]].tolist()
        # one psum across the data axis: it crosses the host boundary
        x = torch.full((3,), float(rank + 1))
        out[source] = dict(
            joined=joined, info=process_info(), writer=is_writer(),
            backend=dist.get_backend(), shape=mesh.shape,
            coords=mesh.coords, model_group=row,
            psum=mesh.axis("data").psum(x).tolist(),
            gathered=mesh.axis("model").all_gather(x[:1]).tolist())
        dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def ranks():
    from fisher_nerf_customized_tpu_torch.parallel.launch import (free_port,
                                                                  run_ranks)
    return run_ranks(_rank, WORLD, args=((free_port(), free_port()),),
                     init=False, timeout_s=120, threads=1)


@pytest.mark.parametrize("source", SOURCES)
def test_init_distributed_joins_the_group(ranks, source):
    for rank, out in enumerate(ranks):
        got = out[source]
        assert got["joined"] is True
        assert got["backend"] == "gloo"
        assert got["writer"] == (rank == 0)
        assert got["info"] == dict(process_index=rank, process_count=WORLD,
                                   local_devices=1, global_devices=WORLD)


@pytest.mark.parametrize("source", SOURCES)
def test_multihost_mesh_keeps_model_groups_in_a_host(ranks, source):
    for rank, out in enumerate(ranks):
        got = out[source]
        assert got["shape"] == {"data": WORLD // PER_HOST, "model": PER_HOST}
        assert got["coords"] == {"data": rank // PER_HOST,
                                 "model": rank % PER_HOST}
        # the model group is this rank's host
        assert {r // PER_HOST for r in got["model_group"]} == \
            {rank // PER_HOST}
        # psum over the data axis: this rank's column, one rank per host
        col = [r for r in range(WORLD) if r % PER_HOST == rank % PER_HOST]
        assert got["psum"] == [float(sum(r + 1 for r in col))] * 3
        assert got["gathered"] == [float(r + 1) for r in got["model_group"]]


def test_init_distributed_is_a_noop_in_one_process(monkeypatch):
    from fisher_nerf_customized_tpu_torch.parallel.distributed import (
        choose_backend, init_distributed, is_writer, make_multihost_mesh,
        process_info)
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert init_distributed() is False
    assert process_info() == dict(process_index=0, process_count=1,
                                  local_devices=1, global_devices=1)
    assert is_writer()
    mesh = make_multihost_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert choose_backend("cpu", 2)[0] == "gloo"
    if not torch.cuda.is_available():
        assert choose_backend(None, 1)[0] == "gloo"
