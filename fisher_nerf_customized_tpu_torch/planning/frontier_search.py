"""Yamauchi wavefront-frontier detection, for UPEN's FBE goals.

Counterpart of the JAX package's planning/frontier_search.py (the
reference's frontier_exploration FrontierSearch and Map): the free cells
reachable from the agent that 8-neighbour a VOID cell, grouped into
8-connected frontiers; the goal is the closest frontier at least
min_thresh cells away, else a step backward.  numpy only: cv2's
connected components and 3x3 dilation are utils/raster.py's label8 and
dilate3, whose label numbers follow cv2's block scan (searchFrom sorts
the frontiers by distance with a stable sort, so the label order breaks
ties as it does in the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils import raster

VOID, OCCUPIED, FREE = 0, 1, 2


@dataclass
class Frontier:
    size: int = 1
    min_distance: float = float("inf")
    travel_point: tuple | None = None     # (x, y)
    points: list = field(default_factory=list)


def labels_from_probs(grid_probs: np.ndarray, void_thresh: float = 0.4):
    """(3, H, W) class probabilities -> label map; cells whose largest
    probability is under void_thresh are VOID."""
    unknown = grid_probs.max(axis=0) < void_thresh
    return np.argmax(grid_probs, axis=0) * np.logical_not(unknown)


class FrontierSearch:
    def __init__(self, step: int, grid_probs: np.ndarray,
                 min_frontier_size: int = 2,
                 travel_point: str = "closest"):
        self.step = step
        self.labels = labels_from_probs(np.asarray(grid_probs))
        self.min_frontier_size = int(min_frontier_size)
        self.travel_point = travel_point
        self.random_magnitude = 15

    def _reachable_free(self, start_xy) -> np.ndarray:
        """The free component of the start cell (or of the free cell
        nearest to it), as uint8 0/1."""
        free = (self.labels == FREE).astype(np.uint8)
        h, w = free.shape
        sx, sy = int(start_xy[0]), int(start_xy[1])
        sx, sy = np.clip(sx, 0, w - 1), np.clip(sy, 0, h - 1)
        if free[sy, sx] == 0:
            ys, xs = np.nonzero(free)
            if len(ys) == 0:
                return np.zeros_like(free)
            i = np.argmin((ys - sy) ** 2 + (xs - sx) ** 2)
            sy, sx = ys[i], xs[i]
        _n, comps, _areas = raster.label8(free)
        return (comps == comps[sy, sx]).astype(np.uint8)

    def searchFrom(self, pose_coords) -> list[Frontier]:
        """Frontiers sorted by their distance from the agent: the reachable
        free cells that 8-neighbour a VOID cell, grouped by 8-connectivity
        in label order, those under min_frontier_size cells dropped."""
        start = np.asarray(pose_coords).reshape(-1)[:2]
        reach = self._reachable_free(start)
        void_dil = raster.dilate3(self.labels == VOID)
        frontier_cells = (reach > 0) & (void_dil > 0)
        if not frontier_cells.any():
            return []
        n, comps, _areas = raster.label8(frontier_cells)
        out = []
        for lab in range(1, n):
            ys, xs = np.nonzero(comps == lab)
            if len(ys) < self.min_frontier_size:
                continue
            d = np.hypot(xs - start[0], ys - start[1])
            i_min = int(np.argmin(d))
            f = Frontier(size=len(ys), min_distance=float(d.min()))
            if self.travel_point == "closest":
                f.travel_point = (int(xs[i_min]), int(ys[i_min]))
            elif self.travel_point == "middle":
                mid = len(ys) // 2
                order = np.argsort(xs * 10000 + ys)
                f.travel_point = (int(xs[order[mid]]), int(ys[order[mid]]))
            else:  # centroid
                f.travel_point = (float(xs.mean()), float(ys.mean()))
            f.points = list(zip(xs.tolist(), ys.tolist()))
            out.append(f)
        out.sort(key=lambda f: f.min_distance)
        return out

    def nextGoal(self, pose_coords, rel_pose, min_thresh: int = 4):
        """The travel point of the closest frontier at least min_thresh
        cells away (the farthest frontier if none is), as (1, 1, 2); with
        no frontier, a point behind the agent."""
        frontiers = self.searchFrom(pose_coords)
        pose_coords = np.asarray(pose_coords, np.float64)
        if not frontiers:
            x = np.cos(np.pi * 5 / 4)
            y = np.sin(np.pi * 5 / 4)
            return pose_coords + np.array(
                [[[-x * self.random_magnitude, -y * self.random_magnitude]]])
        chosen = None
        for f in frontiers:
            if f.min_distance >= min_thresh:
                chosen = f
                break
        if chosen is None:
            chosen = frontiers[-1]
        return np.array([[[chosen.travel_point[0], chosen.travel_point[1]]]])


def select_maximin_points(point_arrays: list[np.ndarray]) -> list[int]:
    """One point per group, chosen to maximize the minimum distance to
    the other groups' choices (iterated conditional improvement, at most
    4 sweeps)."""
    n = len(point_arrays)
    if n == 0:
        return []
    if n == 1:
        return [0]
    idx = [0] * n
    for _sweep in range(4):
        changed = False
        for g in range(n):
            others = np.stack([point_arrays[j][idx[j]]
                               for j in range(n) if j != g])
            d = np.linalg.norm(point_arrays[g][:, None] - others[None],
                               axis=-1).min(axis=1)
            best = int(np.argmax(d))
            if best != idx[g]:
                idx[g] = best
                changed = True
        if not changed:
            break
    return idx


def approx_min_dist_center(points: np.ndarray) -> np.ndarray:
    """The point of the set with the smallest largest distance to the
    others."""
    d = np.linalg.norm(points[:, None] - points[None], axis=-1)
    return points[int(np.argmin(d.max(axis=1)))]
