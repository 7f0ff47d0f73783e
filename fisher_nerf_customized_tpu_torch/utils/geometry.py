"""SE(3) utilities.

Conventions: camera-to-world / world-to-camera are 4x4 row-major
matrices; the camera frame is +z forward, +x right, +y down.
"""
from __future__ import annotations

import numpy as np
import torch


def invert_se3(M: torch.Tensor) -> torch.Tensor:
    """Invert a rigid (..., 4, 4) transform without a general solve."""
    R = M[..., :3, :3]
    t = M[..., :3, 3]
    Rt = R.transpose(-1, -2)
    out = torch.zeros_like(M)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ t.unsqueeze(-1)).squeeze(-1)
    out[..., 3, 3] = 1.0
    return out


# Discrete agent kinematics (host-side numpy).  Action ids: 1 = forward
# (+z in the camera frame), 2 = turn left, 3 = turn right.
def compute_next_campos(cam_H: np.ndarray, action_id: int,
                        forward_step_size: float = 0.065,
                        turn_angle: float = 10.0) -> np.ndarray:
    next_H = np.array(cam_H, dtype=np.float64, copy=True)
    if action_id == 1:
        next_H[:3, 3] = cam_H[:3, 3] + cam_H[:3, :3] @ np.array(
            [0.0, 0.0, forward_step_size])
    elif action_id in (2, 3):
        a = np.deg2rad(turn_angle)
        s = -np.sin(a) if action_id == 2 else np.sin(a)
        R = np.array([[np.cos(a), 0.0, s], [0.0, 1.0, 0.0],
                      [-s, 0.0, np.cos(a)]])
        next_H[:3, :3] = cam_H[:3, :3] @ R
    return next_H
