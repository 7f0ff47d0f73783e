"""Per-Gaussian preprocessing: EWA projection, culling, screen-space extent.

Plain torch over a fixed-capacity Gaussian array; every function takes
camera-frame means with any leading batch dimensions (..., N, 3), so a
batch of poses is one call.  Everything is masked rather than dropped:
invalid Gaussians get radius 0 and never enter a tile list.  Rotations
stay world-frame while means are camera-frame (the reference SLAM
layer's transform_to_frame quirk, kept for parity).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import Camera


class Preprocessed(NamedTuple):
    mean2d: torch.Tensor     # (..., N, 2) pixel coords of the projected center
    conic: torch.Tensor      # (..., N, 3) inverse 2D covariance (a, b, c)
    cov2d: torch.Tensor      # (..., N, 3) 2D covariance
    depth: torch.Tensor      # (..., N)   camera-frame z
    radius: torch.Tensor     # (..., N)   screen-space extent in pixels (0 = culled)
    valid: torch.Tensor      # (..., N)   bool


def _cov3d_cols(scales, quats):
    """Σ = R diag(s²) Rᵀ as six (N,) columns [xx, xy, xz, yy, yz, zz];
    quaternions are wxyz and normalized first."""
    w, x, y, z = quats.unbind(-1)
    inv = 1.0 / torch.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w * inv, x * inv, y * inv, z * inv
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0 = scales[..., 0] * scales[..., 0]
    s1 = scales[..., 1] * scales[..., 1]
    s2 = scales[..., 2] * scales[..., 2]
    c_xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    c_xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    c_xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    c_yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    c_yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    c_zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return c_xx, c_xy, c_xz, c_yy, c_yz, c_zz


def build_cov3d(scales, quats):
    """Σ = R diag(s²) Rᵀ, packed (N, 6) as [xx, xy, xz, yy, yz, zz]."""
    return torch.stack(_cov3d_cols(scales, quats), dim=-1)


def _fov_limits(camera: Camera):
    tan_fovx = camera.width / (2.0 * camera.fx)
    tan_fovy = camera.height / (2.0 * camera.fy)
    return 1.3 * tan_fovx, 1.3 * tan_fovy


def _floor_z(z):
    """max(z, 1e-6).  The floors and clips on the differentiated path are
    maximum/minimum rather than clamp: at a tie their gradient is split
    0.5/0.5 as jnp.maximum's and jnp.clip's is; clamp passes all of it."""
    return torch.maximum(z, z.new_tensor(1e-6))


def _clip(x, lim: float):
    """clip(x, -lim, lim) with jnp.clip's tie gradient (see _floor_z)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(-lim)),
                         x.new_tensor(lim))


def project_cov2d(means_cam, cov3d, camera: Camera):
    """EWA: cov2d = J Σ Jᵀ + dilation·I, J the perspective Jacobian at
    the fov-clamped camera-frame mean.  Returns ((a, b, c), (tx, ty, z))."""
    x, y, z = means_cam.unbind(-1)
    z = _floor_z(z)
    limx, limy = _fov_limits(camera)
    tx = _clip(x / z, limx) * z
    ty = _clip(y / z, limy) * z

    fx, fy = camera.fx, camera.fy
    j00 = fx / z
    j02 = -fx * tx / (z * z)
    j11 = fy / z
    j12 = -fy * ty / (z * z)

    if isinstance(cov3d, tuple):
        c0, c1, c2, c3, c4, c5 = cov3d
    else:
        c0, c1, c2, c3, c4, c5 = cov3d.unbind(-1)
    s00 = c0 * j00 + c2 * j02
    s01 = c1 * j00 + c4 * j02
    s02 = c2 * j00 + c5 * j02
    a = j00 * s00 + j02 * s02 + camera.dilation
    b = j11 * s01 + j12 * s02
    s11 = c3 * j11 + c4 * j12
    s12 = c4 * j11 + c5 * j12
    c_ = j11 * s11 + j12 * s12 + camera.dilation
    return (a, b, c_), (tx, ty, z)


def project_cov2d_packed(means_cam, cov3d, camera: Camera):
    """project_cov2d with (..., N, 3)-packed outputs: ((a, b, c) stacked,
    (tx, ty, z) stacked)."""
    (a, b, c_), (tx, ty, z) = project_cov2d(means_cam, cov3d, camera)
    return torch.stack([a, b, c_], dim=-1), torch.stack([tx, ty, z], dim=-1)


def mark_visible(means_world, w2c):
    """The reference rasterizer's markVisible, with no render: (N,) bool,
    True where the camera-frame depth z_view > 0.001 (its in_frustum test,
    whose NDC bounds check is commented out upstream).  means_world
    (N, 3), w2c (4, 4) on one device.  z_view is written out as
    x r0 + y r1 + z r2 + t, in that order: a matvec would leave its
    summation order to the BLAS, and a point within rounding of 0.001
    could then fall on either side on the card and on the CPU."""
    w2c = torch.as_tensor(w2c, dtype=torch.float32, device=means_world.device)
    x, y, z = means_world.to(torch.float32).unbind(-1)
    z_view = ((x * w2c[2, 0] + y * w2c[2, 1]) + z * w2c[2, 2]) + w2c[2, 3]
    return z_view > 0.001


def conic_mean_jac(means_cam, cov3d, camera: Camera, valid=None):
    """Per-Gaussian Jacobian d(conic)/d(mean_cam): (..., N, 3, 3), rows the
    conic entries (a, b, c) = (c'/det, -b'/det, a'/det), columns the
    camera-frame mean components.  Written out analytically (the JAX
    package takes it by forward-mode autodiff).  The fov-clamp quirk is
    kept: where |x/z| exceeds 1.3 tan_fov the whole tx path carries no
    derivative (no d/dx and no tx-through-z term), likewise for y.  Rows
    for invalid Gaussians are zero."""
    if isinstance(cov3d, tuple):
        c0, c1, c2, c3, c4, c5 = cov3d
    else:
        c0, c1, c2, c3, c4, c5 = cov3d.unbind(-1)
    fx, fy = camera.fx, camera.fy
    limx, limy = _fov_limits(camera)
    x, y, zr = means_cam.unbind(-1)
    z = torch.clamp(zr, min=1e-6)
    dz = (zr > 1e-6).to(z.dtype)                 # d max(z, 1e-6) / dz
    clamp_x = torch.abs(x / z) > limx
    clamp_y = torch.abs(y / z) > limy
    tx = torch.where(clamp_x, torch.clamp(x / z, -limx, limx) * z, x)
    ty = torch.where(clamp_y, torch.clamp(y / z, -limy, limy) * z, y)
    ux = (~clamp_x).to(z.dtype)                  # d tx / dx
    uy = (~clamp_y).to(z.dtype)                  # d ty / dy

    j00 = fx / z
    j02 = -fx * tx / (z * z)
    j11 = fy / z
    j12 = -fy * ty / (z * z)
    zero = torch.zeros_like(z)
    # d j / d(x, y, z), each a 3-tuple
    dj00 = (zero, zero, -fx / (z * z) * dz)
    dj02 = (-fx / (z * z) * ux, zero, 2.0 * fx * tx / (z * z * z) * dz)
    dj11 = (zero, zero, -fy / (z * z) * dz)
    dj12 = (zero, -fy / (z * z) * uy, 2.0 * fy * ty / (z * z * z) * dz)

    a = j00 * (c0 * j00 + c2 * j02) + j02 * (c2 * j00 + c5 * j02) \
        + camera.dilation
    b = j11 * (c1 * j00 + c4 * j02) + j12 * (c2 * j00 + c5 * j02)
    c_ = j11 * (c3 * j11 + c4 * j12) + j12 * (c4 * j11 + c5 * j12) \
        + camera.dilation
    det_pos = (a * c_ - b * b) > 0
    det = torch.where(det_pos, a * c_ - b * b, torch.ones_like(z))

    da_d00 = 2 * (j00 * c0 + j02 * c2)
    da_d02 = 2 * (j00 * c2 + j02 * c5)
    db_d00 = j11 * c1 + j12 * c2
    db_d02 = j11 * c4 + j12 * c5
    db_d11 = j00 * c1 + j02 * c4
    db_d12 = j00 * c2 + j02 * c5
    dc_d11 = 2 * (j11 * c3 + j12 * c4)
    dc_d12 = 2 * (j11 * c4 + j12 * c5)

    cols = []
    for m in range(3):
        da = da_d00 * dj00[m] + da_d02 * dj02[m]
        db = (db_d00 * dj00[m] + db_d02 * dj02[m] + db_d11 * dj11[m]
              + db_d12 * dj12[m])
        dc = dc_d11 * dj11[m] + dc_d12 * dj12[m]
        ddet = torch.where(det_pos, c_ * da + a * dc - 2 * b * db, zero)
        inv = 1.0 / det
        cols.append(torch.stack([
            dc * inv - c_ * ddet * inv * inv,
            -db * inv + b * ddet * inv * inv,
            da * inv - a * ddet * inv * inv,
        ], dim=-1))
    jac = torch.stack(cols, dim=-1)              # (..., N, 3 rows, 3 cols)
    if valid is not None:
        jac = torch.where(valid[..., None, None], jac, torch.zeros_like(jac))
    return jac


def preprocess(means_cam, scales, quats, camera: Camera,
               active=None) -> Preprocessed:
    """Full per-Gaussian forward preprocess.

    means_cam: (..., N, 3) camera-frame centers; scales (N, 3) stddevs
    (already exp'd); quats (N, 4) wxyz; active (N,) bool slot mask."""
    z = means_cam[..., 2]
    in_front = z > camera.near

    cov3d = _cov3d_cols(scales, quats)
    (a, b, c), _t = project_cov2d(means_cam, cov3d, camera)
    cov2d = torch.stack([a, b, c], dim=-1)
    det = a * c - b * b
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    # screen-space radius = ceil(3 sqrt(λmax))
    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam_max))

    zs = _floor_z(z)
    u = camera.fx * means_cam[..., 0] / zs + camera.cx - 0.5
    v = camera.fy * means_cam[..., 1] / zs + camera.cy - 0.5
    mean2d = torch.stack([u, v], dim=-1)

    on_screen = ((u + radius >= 0) & (u - radius < camera.width)
                 & (v + radius >= 0) & (v - radius < camera.height))
    valid = in_front & det_ok & on_screen
    if active is not None:
        valid = valid & active
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Preprocessed(mean2d=mean2d, conic=conic, cov2d=cov2d, depth=z,
                        radius=radius, valid=valid)
