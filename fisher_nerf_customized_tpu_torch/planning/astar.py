"""The A* edge set, collision tiers and line-of-sight check.

Counterparts of the JAX package's planning/astar.py constants and
helpers: 16 "jump" neighbours three cells away, each validated against a
9-cell swept corridor (3 path cells + 1-cell width on each side), and
tiered obstacle-distance collision costs (0/4/8/12 for L1 distances
>20 / >10 / >5 / <=5 cells).  The sweep field (planning/sweep.py) relaxes
over this edge set.  The host A* search itself (AstarSearch, the
`explore.planner_backend: astar` fallback) is not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import numpy as np

from ..utils.raster import thick_line_box

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


def check_collision_free(pt1, pt2, occ_map: np.ndarray) -> bool:
    """True if a 7-px-wide line between the two [x, z] cells (cv2.line's
    cells, utils/raster.py) stays free of occ_map's nonzero cells."""
    mask, y0, x0 = thick_line_box(pt1, pt2, 7, occ_map.shape)
    win = occ_map[y0:y0 + mask.shape[0], x0:x0 + mask.shape[1]]
    return not bool(np.any(win[mask > 0]))
