"""Process-group mesh: the (data, model) grid of ranks.

The JAX package runs `shard_map` from one controller over a device
mesh.  Here every rank is a process that runs the same program (SPMD):
replicated state stays replicated because every rank takes the same
steps from the same data, and only the sharded dispatches split their
work, each rank computing its shard and a collective restoring the
replicated value.  `make_mesh` lays the ranks of a process group out as
JAX reshapes its devices (row-major, `model` the inner axis) and gives
each axis a process group of its own; an `Axis` is one axis as this rank
sees it, with the collectives of `jax.lax`:

    psum / pmean        dist.all_reduce (SUM; the mean divides by the
                        axis size)
    all_gather          dist.all_gather_into_tensor
    psum_scatter        dist.reduce_scatter_tensor (tiled, along dim 0)

With no process group (one process) the mesh is 1 x 1 and every
collective is the identity.  Under gloo a CUDA tensor is staged through a
host copy (gloo's CUDA support varies by collective); under NCCL it
never is.  The collectives are bitwise identical on every rank, so the
ranks' replicated state stays equal to the bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")


def _world(group=None) -> tuple[list[int], int]:
    """(global ranks of `group`, this process's global rank); one rank 0
    without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return [0], 0
    g = group if group is not None else dist.group.WORLD
    return dist.get_process_group_ranks(g), dist.get_rank()


class Pending:
    """An all-gather issued with async_op=True: `wait()` returns its
    result (and copies a gloo-staged result back to the card)."""

    def __init__(self, work, out, device):
        self._work, self._out, self._device = work, out, device

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._out.to(self._device)


class Axis:
    """One mesh axis seen from this rank: its `size`, this rank's `index`
    along it and the process `group` of the ranks it shares the other
    coordinate with.  Without a group (make_mesh gives none to an axis of
    size 1) every collective is the identity."""

    def __init__(self, name: str, size: int, index: int, group=None):
        self.name, self.size, self.index, self.group = name, size, index, group
        self.staged = (group is not None
                       and dist.get_backend(group) == "gloo")

    def shard(self, n: int) -> tuple[int, int]:
        """This rank's contiguous block [lo, hi) of n rows (n a multiple
        of the axis size): the layout of PartitionSpec(axis)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.name} axis "
                             f"of size {self.size}")
        per = n // self.size
        return self.index * per, (self.index + 1) * per

    def _stage(self, x):
        return x.cpu() if self.staged and x.is_cuda else x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return x
        y = self._stage(x).clone().contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y.to(x.device)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.group is None else self.psum(x) / self.size

    def pmean_all(self, tensors) -> list:
        """pmean of several tensors through one collective (flattened
        into one buffer and split again)."""
        if self.group is None:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        flat = self.pmean(flat)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return out

    def all_gather(self, x: torch.Tensor, tiled: bool = True,
                   async_op: bool = False):
        """Every rank's x (at least 1-D) in axis order: concatenated
        along dim 0 (tiled) or stacked on a new leading axis.  With
        async_op a `Pending`."""
        if self.group is None:
            out = x if tiled else x[None]
            return Pending(None, out, x.device) if async_op else out
        src = self._stage(x).contiguous()
        out = src.new_empty((self.size * src.shape[0],) + src.shape[1:])
        work = dist.all_gather_into_tensor(out, src, group=self.group,
                                           async_op=async_op)
        if not tiled:
            out = out.reshape((self.size,) + x.shape)
        pending = Pending(work, out, x.device)
        return pending if async_op else pending.wait()

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """psum over the axis, each rank keeping its block of dim 0
        (psum_scatter with tiled=True)."""
        if self.group is None:
            return x
        src = self._stage(x).contiguous()
        out = src.new_empty((src.shape[0] // self.size,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=self.group)
        return out.to(x.device)


class Mesh:
    """The (data, model) grid of global ranks (`devices`, as JAX's
    Mesh.devices), `shape` {"data": d, "model": m}, this rank's
    `coords` (None for a rank outside the grid) and one `Axis` per axis
    name (`axis(name)`)."""

    def __init__(self, devices: np.ndarray, rank: int, groups: dict):
        self.devices = devices
        self.shape = dict(zip(AXES, (int(s) for s in devices.shape)))
        hit = np.argwhere(devices == rank)
        self.coords = (dict(zip(AXES, (int(c) for c in hit[0])))
                       if len(hit) else None)
        self._axes = {}
        for name in AXES:
            if self.coords is None:
                self._axes[name] = Axis(name, 1, 0)
            else:
                self._axes[name] = Axis(name, self.shape[name],
                                        self.coords[name], groups[name])

    def axis(self, name: str) -> Axis:
        return self._axes[name]


def make_mesh(data: int | None = None, model: int = 1, group=None) -> Mesh:
    """The (data, model) mesh over the ranks of `group` (the default
    process group; with none, the 1 x 1 mesh of this process).  The
    first data * model ranks are reshaped row-major, `model` inner, as
    the JAX package reshapes its devices.  Every rank of the default
    group must call this, in the same order: each axis's sub-groups are
    made with dist.new_group, which is collective."""
    ranks, me = _world(group)
    n = len(ranks)
    if data is None:
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} > {n} ranks")
    grid = np.asarray(ranks[:data * model]).reshape(data, model)
    groups = {"data": None, "model": None}
    if n > 1:
        for name, lines in (("data", grid.T), ("model", grid)):
            for line in lines:
                members = [int(r) for r in line]
                if len(members) == 1:
                    continue
                if members == ranks:
                    g = group if group is not None else dist.group.WORLD
                else:
                    g = dist.new_group(members)
                if me in members:
                    groups[name] = g
    return Mesh(grid, me, groups)
