"""The reconstruction metric's nearest-neighbour distances, worked out
again: for each ground-truth point its distance to the nearest point of
the estimated cloud, by scipy's exact k-d tree in float64."""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def nearest(queries, refs):
    """(distances float64, nearest index) of each query."""
    return cKDTree(np.asarray(refs, np.float64)).query(
        np.asarray(queries, np.float64), k=1, workers=-1)


def distances_float32(queries, refs, idx) -> np.ndarray:
    """The same distances to the same nearest points, computed in
    float32: the control one precision below the reference."""
    d = np.asarray(queries, np.float32) - np.asarray(refs, np.float32)[idx]
    return np.sqrt((d * d).sum(axis=1, dtype=np.float32)).astype(np.float64)
