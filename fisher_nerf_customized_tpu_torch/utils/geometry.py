"""SE(3) and quaternion utilities.

Conventions: quaternions are (w, x, y, z); camera-to-world /
world-to-camera are 4x4 row-major matrices; the camera frame is +z
forward, +x right, +y down.
"""
from __future__ import annotations

import numpy as np
import torch


def normalize(v: torch.Tensor, axis: int = -1, eps: float = 1e-12):
    return v / (torch.linalg.vector_norm(v, dim=axis, keepdim=True) + eps)


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


def pose_matrix(rot_q: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion and (..., 3) translation -> (..., 4, 4)
    homogeneous matrix."""
    R = quat_to_rotmat(rot_q)
    M = R.new_zeros(R.shape[:-2] + (4, 4))
    M[..., :3, :3] = R
    M[..., :3, 3] = trans
    M[..., 3, 3] = 1.0
    return M


def transform_points(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply the (..., 4, 4) rigid transform M to (..., N, 3) points.  Each
    entry is written out as ((M_i0 x + M_i1 y) + M_i2 z) + M_i3: no
    matmul, so no TF32 and the same order of summation on every
    device."""
    x, y, z = pts.unbind(-1)
    return torch.stack([((M[..., i, 0, None] * x + M[..., i, 1, None] * y)
                         + M[..., i, 2, None] * z) + M[..., i, 3, None]
                        for i in range(3)], dim=-1)


def _mat3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for 3x3 matrices, written out (see transform_points)."""
    return (A[:, 0:1] * B[0:1, :] + A[:, 1:2] * B[1:2, :]) \
        + A[:, 2:3] * B[2:3, :]


def compute_next_campos_torch(cam_H: torch.Tensor, action_id,
                              forward_step_size: float = 0.065,
                              turn_angle: float = 10.0) -> torch.Tensor:
    """compute_next_campos on a (4, 4) tensor, on its device: the JAX
    package's compute_next_campos_jax.  action_id is an int or an int
    tensor; an id other than 1, 2 or 3 leaves the pose unchanged.  No
    host round trip, so a rollout can stay on the card."""
    dev, dt = cam_H.device, cam_H.dtype
    a = torch.as_tensor(action_id, device=dev)
    ang = torch.deg2rad(torch.tensor(float(turn_angle), dtype=dt,
                                     device=dev))
    c, s = torch.cos(ang), torch.sin(ang)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R, t = cam_H[:3, :3], cam_H[:3, 3]
    fwd = t + R[:, 2] * forward_step_size
    r_left = torch.stack([torch.stack([c, zero, -s]),
                          torch.stack([zero, one, zero]),
                          torch.stack([s, zero, c])])
    r_right = torch.stack([torch.stack([c, zero, s]),
                           torch.stack([zero, one, zero]),
                           torch.stack([-s, zero, c])])
    rot = torch.where(a == 2, _mat3(R, r_left),
                      torch.where(a == 3, _mat3(R, r_right), R))
    out = cam_H.clone()
    out[:3, 3] = torch.where(a == 1, fwd, t)
    out[:3, :3] = rot
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
