"""The held-out poses of an evaluation chunk, drawn again from its seed as
the evaluation draws them: navigable (x, z) by rejection from the room's
bounds (clear of the walls and obstacles by the agent's radius), a
uniform yaw, the camera at cam_height looking along +z of its yaw, x
right and y down."""
from __future__ import annotations

import numpy as np


def navigable(scene, x: float, z: float) -> bool:
    r = scene.agent_radius
    lo, hi = scene.room_lo, scene.room_hi
    if not (lo[0] + r <= x <= hi[0] - r and lo[2] + r <= z <= hi[2] - r):
        return False
    return not any(blo[0] - r <= x <= bhi[0] + r
                   and blo[2] - r <= z <= bhi[2] + r
                   for blo, bhi in scene.obstacles)


def eval_poses(scene, n: int, cam_height: float, seed: int) -> np.ndarray:
    """(n, 4, 4) float32 camera-to-world poses."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.room_lo, scene.room_hi
    xz = []
    while len(xz) < n:
        x = rng.uniform(lo[0], hi[0])
        z = rng.uniform(lo[2], hi[2])
        # the test reads the position in float32, as it is stored
        if navigable(scene, float(np.float32(x)), float(np.float32(z))):
            xz.append((x, z))
    xz = np.asarray(xz, np.float32)
    yaw = rng.uniform(0, 2 * np.pi, n)
    c, s = np.cos(yaw), np.sin(yaw)
    poses = np.zeros((n, 4, 4), np.float32)
    poses[:, 0, 0], poses[:, 0, 2] = -c, s
    poses[:, 1, 1] = -1.0
    poses[:, 2, 0], poses[:, 2, 2] = s, c
    poses[:, 0, 3], poses[:, 1, 3], poses[:, 2, 3] = xz[:, 0], cam_height, \
        xz[:, 1]
    poses[:, 3, 3] = 1.0
    return poses
