"""Spherical harmonics -> RGB for view-dependent Gaussian colours.

Counterpart of the JAX package's ops/sh.py (the reference's
computeColorFromSH, degree 0 to 3): real SH evaluated along the
camera -> Gaussian direction, plus 0.5, clamped at 0.  The clamp is a
relu, so autograd masks the gradient of a clamped channel as the
reference's `clamped` bookkeeping does.  Plain torch on the tensors'
device; ops/rasterize.py::render_sh feeds the colours to the renderer.
"""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def num_sh_coeffs(deg: int) -> int:
    return (deg + 1) ** 2


def sh_to_rgb(sh, means_world, campos, deg: int = 3):
    """sh (N, M, 3) coefficients with M >= (deg + 1)^2, means_world
    (N, 3), campos (3,) the camera centre -> (N, 3) colours >= 0."""
    if deg < 0 or deg > 3:
        raise ValueError(f"sh_to_rgb supports deg 0..3, got {deg}")
    if sh.shape[1] < num_sh_coeffs(deg):
        raise ValueError(f"deg {deg} needs {num_sh_coeffs(deg)} coeffs, "
                         f"sh has {sh.shape[1]}")
    d = means_world - campos[None, :]
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]

    res = SH_C0 * sh[:, 0]
    if deg > 0:
        res = res - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        res = (res + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
               + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg > 2:
        res = (res
               + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
               + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15])
    return torch.relu(res + 0.5)
