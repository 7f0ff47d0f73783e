"""Host-side DBSCAN for the legacy in-SLAM uncertainty targeting
(models/slam.py::GaussianSLAM.global_planning).

A copy of the JAX package's utils/clustering.py: the core-point
depth-first scan over a cKDTree neighbour graph, noise labelled -1.
Cluster ids follow the scan order (points in input order, each cluster's
members from a stack), and global_planning picks its cluster in the
order of those ids, so the scan is kept as it is rather than
vectorised.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def dbscan(points: np.ndarray, eps: float = 0.1,
           min_samples: int = 5) -> np.ndarray:
    """Cluster labels (N,), noise = -1."""
    n = len(points)
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    tree = cKDTree(np.asarray(points, np.float64))
    neighbors = tree.query_ball_point(points, eps)      # includes self
    core = np.fromiter((len(nb) >= min_samples for nb in neighbors),
                       bool, n)
    cluster = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        labels[i] = cluster
        stack = [i]
        while stack:
            j = stack.pop()
            for q in neighbors[j]:
                if labels[q] == -1:
                    labels[q] = cluster
                    if core[q]:
                        stack.append(q)
        cluster += 1
    return labels
