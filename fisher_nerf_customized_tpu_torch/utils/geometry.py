"""SE(3) and quaternion utilities.

Conventions: quaternions are (w, x, y, z); camera-to-world /
world-to-camera are 4x4 row-major matrices; the camera frame is +z
forward, +x right, +y down.
"""
from __future__ import annotations

import numpy as np
import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    return v / (torch.linalg.vector_norm(v, dim=dim, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion, normalized first -> (..., 3, 3)."""
    q = normalize(q)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 4) unit wxyz quaternion.

    Branchless: the four candidate quaternions are formed and the one
    with the largest |component| taken (argmax over the candidates'
    magnitudes, the first on a tie), each divided by
    max(2 |q_i|, 0.1 tiny + 1e-8), as the JAX package does, so that
    rotations near 180 degrees take the same candidate there and here."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = torch.sqrt(torch.clamp(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22], dim=-1), min=0.0))
    cand = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2)                                              # (..., 4, 4)
    floor = 0.1 * torch.finfo(m.dtype).tiny + 1e-8
    cand = cand / torch.clamp(2.0 * q_abs[..., None], min=floor)
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return normalize(torch.gather(cand, -2, idx)[..., 0, :])


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


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
