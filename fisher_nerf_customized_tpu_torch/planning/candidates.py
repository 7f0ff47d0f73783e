"""Candidate camera-pose sampling for EIG evaluation (host-side numpy).

A ring of K poses around xz center points, each looking back at its
center (the reference's generate_candidate: theta+pi yaw, then the x/y
column flips of the CV camera frame).
"""
from __future__ import annotations

import numpy as np


def _yaw_rotmat(theta):
    """y-axis rotation (world y-up) for an array of angles: (K, 3, 3)."""
    c, s = np.cos(theta), np.sin(theta)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, zeros, s], -1),
        np.stack([zeros, ones, zeros], -1),
        np.stack([-s, zeros, c], -1),
    ], axis=-2)


def generate_candidates(center_points: np.ndarray, k: int, radius: float,
                        min_range: float, cam_height: float,
                        rng: np.random.Generator,
                        expansion: float = 1.0) -> np.ndarray:
    """K c2w poses (K, 4, 4) on rings around the given (M, 2) xz centers."""
    radius = radius * expansion
    theta = rng.uniform(0.0, 2 * np.pi, k)
    rr = min_range + rng.uniform(0.0, 1.0, k) * max(radius - min_range, 1e-6)
    centers = center_points[rng.integers(0, len(center_points), k)]

    pos = np.zeros((k, 3), np.float32)
    pos[:, 0] = centers[:, 0] + rr * np.sin(theta)
    pos[:, 1] = cam_height
    pos[:, 2] = centers[:, 1] + rr * np.cos(theta)

    R = _yaw_rotmat(theta + np.pi)
    R[:, :, 0] *= -1.0      # CV camera: x right (flip), y down (flip)
    R[:, :, 1] *= -1.0

    c2ws = np.zeros((k, 4, 4), np.float32)
    c2ws[:, :3, :3] = R
    c2ws[:, :3, 3] = pos
    c2ws[:, 3, 3] = 1.0
    return c2ws
