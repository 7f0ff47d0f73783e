"""The host A* search: its edge set, collision tiers and line-of-sight
check.

Counterpart of the JAX package's planning/astar.py: a heap search over
16 "jump" neighbours three cells away, each validated against a 9-cell
swept corridor (3 path cells + 1-cell width on each side), where the
obstacle distance (L1 distance transform) adds tiered collision costs
(0/4/8/12 for L1 distances >20 / >10 / >5 / <=5 cells) to the travel
cost, and line-of-sight shortcutting of the found path.  It runs on the
host in numpy and heapq (`explore.planner_backend: astar`); the sweep
field (planning/sweep.py), the default backend, relaxes over the same
edge set on the device.  cv2's distance transform, erosion and thick
line come from utils/raster.py.
"""
from __future__ import annotations

import heapq

import numpy as np

from ..utils.raster import distance_l1, erode3, thick_line_box

# 16 jump targets relative to the current cell (dy, dx), and the 3-cell
# corridors swept to reach them
_NEIGHBORS = np.array([
    [-3, 0], [-3, 1], [-3, 3], [-1, 3], [0, 3],
    [3, 0], [3, 1], [3, 3], [1, 3],
    [-3, -1], [-3, -3], [-1, -3], [0, -3],
    [3, -1], [3, -3], [1, -3]])

_PATHS = np.array([
    [[-1, 0], [-2, 0], [-3, 0]],
    [[-1, 0], [-2, 1], [-3, 1]],
    [[-1, 1], [-2, 2], [-3, 3]],
    [[0, 1], [-1, 2], [-1, 3]],
    [[0, 1], [0, 2], [0, 3]],
    [[1, 0], [2, 0], [3, 0]],
    [[1, 0], [2, 1], [3, 1]],
    [[1, 1], [2, 2], [3, 3]],
    [[0, 1], [1, 2], [1, 3]],
    [[-1, 0], [-2, -1], [-3, -1]],
    [[-1, -1], [-2, -2], [-3, -3]],
    [[0, -1], [-1, -2], [-1, -3]],
    [[0, -1], [0, -2], [0, -3]],
    [[1, 0], [2, -1], [3, -1]],
    [[1, -1], [2, -2], [3, -3]],
    [[0, -1], [1, -2], [1, -3]],
])
# widen each corridor by one cell on both sides
_W_A = np.concatenate([_PATHS[:9] + np.array([[[0, 1]]]),
                       _PATHS[9:] + np.array([[[1, 0]]])], axis=0)
_W_B = np.concatenate([_PATHS[:9] + np.array([[[0, -1]]]),
                       _PATHS[9:] + np.array([[[-1, 0]]])], axis=0)
_CORRIDORS = np.concatenate([_PATHS, _W_A, _W_B], axis=1)   # (16, 9, 2)


def _collision_cost(dist_obs: np.ndarray) -> np.ndarray:
    cost = np.full_like(dist_obs, 12.0)
    cost[dist_obs > 5] = 8.0
    cost[dist_obs > 10] = 4.0
    cost[dist_obs > 20] = 0.0
    return cost


class AstarSearch:
    """One search seeded at a start cell; repeated `plan(goal)` calls grow
    and reuse one search tree."""

    def __init__(self, occ_map_np: np.ndarray, free_space_np: np.ndarray,
                 start):
        self.occ = occ_map_np            # 1 = obstacle (dilated binary)
        self.free = free_space_np        # 1 = connected free space
        h, w = occ_map_np.shape
        self.shape = (h, w)
        self.start = (int(start[0]), int(start[1]))
        # per cell: (cost, parent_y, parent_x, collision cost), -1 unseen
        self.tree = np.full((h, w, 4), -1.0)
        self.tree[self.start[0], self.start[1]] = [0, start[0], start[1], 0]
        self.dist_obs = distance_l1(free_space_np.astype(np.uint8))

    def plan(self, goal, max_iter: int = 10000,
             shortcut: bool = True) -> np.ndarray:
        """A* to `goal` [y, x].  Returns the path as (K, 2) [x, z] cells,
        or an empty array if it is unreachable."""
        goal = np.asarray(goal, np.int64)
        h, w = self.shape
        if self.occ[goal[0], goal[1]]:
            return np.array([])

        # the frontier: the boundary of the searched region, in free space
        searched = (self.tree[..., 1] >= 0).astype(np.uint8)
        boundary = searched - erode3(searched)
        boundary = boundary * self.free
        fy, fx = np.where(boundary > 0)
        heap = [(float(np.hypot(y - goal[0], x - goal[1])), int(y), int(x))
                for y, x in zip(fy, fx)]
        if not heap and searched[goal[0], goal[1]] == 0:
            sy, sx = self.start
            heap = [(float(np.hypot(sy - goal[0], sx - goal[1])), sy, sx)]
        heapq.heapify(heap)

        it = 0
        while heap and it < max_iter:
            _, cy, cx = heapq.heappop(heap)
            if max(abs(cy - goal[0]), abs(cx - goal[1])) < 2:
                goal = np.array([cy, cx])
                break

            nbr = _NEIGHBORS + np.array([cy, cx])
            cor = _CORRIDORS + np.array([[[cy, cx]]])
            inside = ((cor[..., 0] >= 0) & (cor[..., 0] < h)
                      & (cor[..., 1] >= 0) & (cor[..., 1] < w)).all(axis=1)
            nbr, cor = nbr[inside], cor[inside]
            if len(nbr) == 0:
                it += 1
                continue
            corr_flat = cor.reshape(-1, 2)
            free_ok = self.free[corr_flat[:, 0], corr_flat[:, 1]]
            free_ok = free_ok.reshape(-1, cor.shape[1]).all(axis=1)
            nbr, cor = nbr[free_ok], cor[free_ok]

            base_cost = self.tree[cy, cx, 0]
            base_coll = self.tree[cy, cx, 3]
            for (ny, nx), corridor in zip(nbr, cor):
                d_obs = self.dist_obs[corridor[:, 0], corridor[:, 1]]
                coll = base_coll + _collision_cost(d_obs).sum()
                cost = base_cost + np.hypot(ny - cy, nx - cx)
                old = self.tree[ny, nx]
                if old[0] < 0 or old[0] + old[3] > cost + coll:
                    self.tree[ny, nx] = [cost, cy, cx, coll]
                    h_goal = np.hypot(ny - goal[0], nx - goal[1])
                    heapq.heappush(heap, (float(h_goal + coll), int(ny),
                                          int(nx)))
            it += 1

        if self.tree[goal[0], goal[1], 0] < 0:
            return np.array([])

        path = [np.asarray(goal)]
        while True:
            parent = self.tree[path[-1][0], path[-1][1], 1:3].astype(np.int64)
            if parent[0] == path[-1][0] and parent[1] == path[-1][1]:
                break
            path.append(parent)
        if len(path) == 1:
            return np.array([])
        paths = np.array(path)[::-1][:, [1, 0]]     # reversed, as [x, z]

        if shortcut:
            paths = self._shortcut(paths)
        return paths

    def _shortcut(self, paths: np.ndarray) -> np.ndarray:
        """Line-of-sight smoothing: a cell is dropped while the line from
        the last kept one passes it free."""
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


def check_collision_free(pt1, pt2, occ_map: np.ndarray) -> bool:
    """True if a 7-px-wide line between the two [x, z] cells (cv2.line's
    cells, utils/raster.py) stays free of occ_map's nonzero cells."""
    mask, y0, x0 = thick_line_box(pt1, pt2, 7, occ_map.shape)
    win = occ_map[y0:y0 + mask.shape[0], x0:x0 + mask.shape[1]]
    return not bool(np.any(win[mask > 0]))
