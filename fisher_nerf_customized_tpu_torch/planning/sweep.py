"""Multi-goal shortest-path field on the device, and its host backtrace.

Counterpart of the JAX package's planning/sweep.py: one whole-grid
Bellman-Ford relaxation over the A* edge set (planning/astar.py: 16
jumps, each checked against its 9-cell corridor, weighted by the jump's
length plus the corridor's collision tiers) answers every goal of a
planning event; per goal, only a host backtrace over the parent field
remains.

The JAX package runs the rounds in a `lax.while_loop` that tests
`changed` after each one.  Here each test would be a host sync, so
rounds run in blocks of `check_every` between syncs; a round after the
one at which the JAX loop stops is computed but not applied (a device
flag freezes the field), so the field is the one JAX stops at, and the
`max_iters` cap holds to the round.  Within a round the 16 directions
are relaxed at once: a direction d sets a cell's parent iff its
candidate is below the running minimum over the cell's cost and the
candidates of directions 0..d-1, less 1e-4, which is the JAX loop's
sequential rule, so parents tie-break alike.  Plain torch (this is XLA
code in the JAX package, not a Pallas kernel).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.raster import distance_l1
from .astar import _CORRIDORS, _NEIGHBORS, _collision_cost, \
    check_collision_free

_INF = np.float32(3e38)
_PAD = 3          # the longest jump


def _edge_weights(free, tier_cost):
    """(16, H, W) f32 edge weight by SOURCE cell: the jump's length plus
    the corridor's tier costs, _INF where a corridor cell is not free.
    Corridor cells are read with wrap-around (jnp.roll), as in JAX."""
    freef = free.to(torch.float32)
    weights = []
    for d, (dy, dx) in enumerate(_NEIGHBORS):
        ok = torch.ones_like(freef)
        wc = torch.zeros_like(freef)
        for cy, cx in _CORRIDORS[d]:
            ok = ok * torch.roll(freef, (-int(cy), -int(cx)), (0, 1))
            wc = wc + torch.roll(tier_cost, (-int(cy), -int(cx)), (0, 1))
        step = torch.tensor(float(np.hypot(dy, dx)), dtype=torch.float32)
        weights.append(torch.where(ok > 0.5, step + wc,
                                   torch.full_like(wc, _INF)))
    return torch.stack(weights)


def _source_index(h: int, w: int, device):
    """(16, H*W) index into each direction's flattened (H+6, W+6) padded
    field of every target's source cell t - (dy, dx)."""
    wp = w + 2 * _PAD
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return torch.stack([((ys - int(dy) + _PAD) * wp + (xs - int(dx) + _PAD))
                        .reshape(-1) for dy, dx in _NEIGHBORS])


def sweep_field(free, tier_cost, start_yx, max_iters: int = 600,
                check_every: int = 16):
    """Converged shortest-path cost and parent-direction fields.

    free (H, W) bool, tier_cost (H, W) f32 (the collision tier of each
    cell's L1 obstacle distance), start_yx (y, x) ints, on one device.
    Returns cost (H, W) f32 (_INF where unreachable) and parent (H, W)
    int8 (index into _NEIGHBORS of the edge that set the cell's cost, -1
    at the start and at unreached cells), as tensors on that device, and
    the number of rounds the JAX loop runs (the last one changes nothing
    by more than 1e-4)."""
    h, w = free.shape
    dev = free.device
    weights = _edge_weights(free, tier_cost)
    src = _source_index(h, w, dev)
    dirs = torch.arange(16, device=dev, dtype=torch.int8)[:, None, None]
    cost = torch.full((h, w), _INF, device=dev)
    cost[int(start_yx[0]), int(start_yx[1])] = 0.0
    parent = torch.full((h, w), -1, dtype=torch.int8, device=dev)
    changed = torch.ones((), dtype=torch.bool, device=dev)
    padded = torch.full((16, h + 2 * _PAD, w + 2 * _PAD), _INF, device=dev)
    applied = torch.zeros((), dtype=torch.int32, device=dev)
    rounds = 0
    while rounds < max_iters:
        n = min(check_every, max_iters - rounds)
        for _ in range(n):
            padded[:, _PAD:_PAD + h, _PAD:_PAD + w] = cost + weights
            cand = torch.gather(padded.reshape(16, -1), 1, src).reshape(
                16, h, w)
            # running minimum before direction d: the cell's cost and the
            # candidates of directions 0..d-1
            run = torch.cummin(cand, dim=0).values
            before = torch.cat([cost[None], torch.minimum(cost[None],
                                                         run[:-1])])
            better = cand < before - 1e-4
            last = torch.where(better, dirs, torch.full_like(dirs, -1)).amax(0)
            new_parent = torch.where(last >= 0, last, parent)
            new_cost = torch.minimum(cost, run[-1])
            step_changed = torch.any(new_cost < cost - 1e-4)
            # a round runs iff the previous one changed the field
            cost = torch.where(changed, new_cost, cost)
            parent = torch.where(changed, new_parent, parent)
            applied += changed.to(torch.int32)
            changed = changed & step_changed
        rounds += n
        if not bool(changed):
            break
    return cost, parent, int(applied)


def _sweep_window(free: np.ndarray, start):
    """((y0, y1), (x0, x1)): the rows and columns the sweep needs, the
    bounding box of the free cells and the start grown by _PAD + 1 cells,
    or the whole grid when that box comes within _PAD + 1 of its edge.
    Only free cells (and the start) are ever reached, since a jump's
    target lies in its corridor; cells of the margin are never free, so a
    corridor read that wraps around the window reads non-free cells,
    where on the whole grid it reads the non-free cells beside it.  The
    field on the window is the whole grid's, cut to it."""
    h, w = free.shape
    ys, xs = np.nonzero(free)
    m = _PAD + 1
    y0 = min(int(ys.min()) if len(ys) else start[0], start[0]) - m
    y1 = max(int(ys.max()) if len(ys) else start[0], start[0]) + m + 1
    x0 = min(int(xs.min()) if len(xs) else start[1], start[1]) - m
    x1 = max(int(xs.max()) if len(xs) else start[1], start[1]) + m + 1
    if y0 < 0 or x0 < 0 or y1 > h or x1 > w:
        return (0, h), (0, w)
    return (y0, y1), (x0, x1)


class SweepSearch:
    """One device sweep at construction, over the window of the grid that
    holds the free space (_sweep_window), then `plan(goal)` is a host
    backtrace over the parent-direction field (pulled at the first plan
    call)."""

    def __init__(self, occ_map_np: np.ndarray, free_space_np: np.ndarray,
                 start, device="cuda"):
        self.occ = occ_map_np
        self.start = (int(start[0]), int(start[1]))
        dist_obs = distance_l1(free_space_np.astype(np.uint8))
        tier = _collision_cost(dist_obs)
        self.window = _sweep_window(free_space_np, self.start)
        (y0, y1), (x0, x1) = self.window
        self._cost_dev, self._parent_dev, self.rounds = sweep_field(
            torch.as_tensor(free_space_np[y0:y1, x0:x1].astype(bool),
                            device=device),
            torch.as_tensor(tier[y0:y1, x0:x1], dtype=torch.float32,
                            device=device),
            (self.start[0] - y0, self.start[1] - x0))
        self.cost = None
        self.parent = None

    def _materialize(self):
        if self.cost is None:
            (y0, y1), (x0, x1) = self.window
            self.cost = np.full(self.occ.shape, _INF, np.float32)
            self.parent = np.full(self.occ.shape, -1, np.int8)
            self.cost[y0:y1, x0:x1] = self._cost_dev.cpu().numpy()
            self.parent[y0:y1, x0:x1] = self._parent_dev.cpu().numpy()

    def plan(self, goal, shortcut: bool = True) -> np.ndarray:
        """Shortest path to `goal` [y, x] (goal tolerance <2 cells in
        Chebyshev distance).  Returns (K, 2) [x, z] cells, an empty array
        if unreachable."""
        self._materialize()
        gy, gx = int(goal[0]), int(goal[1])
        h, w = self.cost.shape
        if self.occ[gy, gx]:
            return np.array([])
        # min-cost reachable cell within the 3x3 tolerance window
        y0, y1 = max(gy - 1, 0), min(gy + 2, h)
        x0, x1 = max(gx - 1, 0), min(gx + 2, w)
        win = self.cost[y0:y1, x0:x1]
        if not np.isfinite(win.min()) or win.min() >= 3e38:
            return np.array([])
        dy, dx = np.unravel_index(int(np.argmin(win)), win.shape)
        cy, cx = y0 + int(dy), x0 + int(dx)

        path = [(cy, cx)]
        while (cy, cx) != self.start:
            d = int(self.parent[cy, cx])
            if d < 0:
                return np.array([])     # inconsistent field (unreached)
            oy, ox = _NEIGHBORS[d]
            cy, cx = cy - int(oy), cx - int(ox)
            path.append((cy, cx))
            if len(path) > h + w:       # cycle guard
                return np.array([])
        if len(path) == 1:
            return np.array([])
        paths = np.array(path[::-1])[:, [1, 0]]       # to [x, z]
        if shortcut:
            paths = self._shortcut(paths)
        return paths

    def _shortcut(self, paths: np.ndarray) -> np.ndarray:
        """Line-of-sight smoothing over the 7-px collision check."""
        if len(paths) < 3:
            return paths
        out = [paths[0], paths[1]]
        idx = 1
        for i in range(2, paths.shape[0] - 1):
            if check_collision_free(out[idx - 1], paths[i], self.occ):
                out[idx] = paths[i]
            else:
                out.append(paths[i])
                idx += 1
        out.append(paths[-1])
        return np.stack(out, axis=0)
