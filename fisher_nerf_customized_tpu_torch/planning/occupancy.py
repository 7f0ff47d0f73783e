"""Occupancy-map vote update, on the map's device.

Counterpart of the JAX package's planning/occupancy.py.  Each depth
frame samples points along its rays (free votes), bins the ray ends
(occupied votes x100, free votes x0.01), carves free space along
camera -> hit segments and adds the channel-normalized vote grid to the
persistent (3, Gz, Gx) map (ch0 unknown / ch1 occupied / ch2 free).
The vote histograms are `index_add_` over the flattened grid and the
carve canvas a `scatter_reduce` with amax; the counts are whole numbers
in f32, so they are exact in any order of summation.

The arithmetic follows the JAX package's compiled form on the CPU term
by term (the f32 reciprocal of the focal length and of n_carve, the
rotation as a left-to-right sum of fused multiply-adds, a fused
multiply-add where XLA's CPU code has one and not elsewhere), because a
point within one ulp of a cell edge would otherwise fall into the other
cell and move a whole vote.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.camera import Camera


def _fma(a, b, c):
    """a * b + c rounded once to f32 (XLA's fused multiply-add), through
    f64: exact but for a rare double rounding."""
    return (a.double() * b.double() + c.double()).float()


def _fractions(n: int) -> np.ndarray:
    """linspace(1e-3, 0.95, n) in f32 with the last set to 1.0, as the JAX
    package's compiled occ_update holds it: a lerp with the step
    i * (1 / (n - 1)) (these are its constants at n = 11)."""
    f32 = np.float32
    step = np.arange(n, dtype=f32) * (f32(1.0) / f32(n - 1))
    out = f32(1e-3) * (f32(1.0) - step) + f32(0.95) * step
    out[-1] = 1.0
    return out


def discretize_coords(x, z, grid_dim, cell_size, map_center):
    """World xz -> integer grid coords: floor((p - center) / cell) +
    (dim - 1) // 2, clamped to the grid.  grid_dim is (gx, gz)."""
    xb = torch.floor((x - map_center[0]) / cell_size) + (grid_dim[0] - 1) // 2
    zb = torch.floor((z - map_center[1]) / cell_size) + (grid_dim[1] - 1) // 2
    xb = torch.clamp(xb, 0, grid_dim[0] - 1).to(torch.int64)
    zb = torch.clamp(zb, 0, grid_dim[1] - 1).to(torch.int64)
    return xb, zb


def occ_update(occ_map, depth, c2w, camera: Camera, cell_size: float,
               map_center, height_lower: float, height_upper: float,
               pcd_far: float, n_free: int = 11, carve_stride: int = 4,
               n_carve: int = 192):
    """One depth observation -> updated persistent occupancy map.

    occ_map (3, Gz, Gx) f32, depth (H, W) f32, c2w (4, 4) f32 and
    map_center (2,) f32, all on one device.  Returns (occ_map,
    cam_pos (2,) int64 [z, x])."""
    dev = occ_map.device
    f32 = torch.float32
    gz, gx = occ_map.shape[1], occ_map.shape[2]
    grid_dim = (gx, gz)
    h, w = depth.shape
    cell = torch.tensor(cell_size, dtype=f32, device=dev)

    cam_px = (torch.floor((c2w[0, 3] - map_center[0]) / cell)
              + (gx - 1) // 2).to(torch.int64)
    cam_pz = (torch.floor((c2w[2, 3] - map_center[1]) / cell)
              + (gz - 1) // 2).to(torch.int64)

    # the agent's 3x3 cell block is strongly free
    occ_map = occ_map.clone()
    off = torch.arange(-1, 2, device=dev)
    zs3 = torch.clamp(cam_pz + off, 0, gz - 1)
    xs3 = torch.clamp(cam_px + off, 0, gx - 1)
    occ_map[2, zs3[:, None], xs3[None, :]] = 1e3

    ys = (torch.arange(h, dtype=f32, device=dev) - camera.cy) \
        * torch.tensor(1.0 / camera.fy, dtype=f32)
    xs = (torch.arange(w, dtype=f32, device=dev) - camera.cx) \
        * torch.tensor(1.0 / camera.fx, dtype=f32)
    gy, gxx = torch.meshgrid(ys, xs, indexing="ij")

    # z fractions: n_free - 1 interior free samples + the ray end
    fracs = torch.as_tensor(_fractions(n_free), device=dev)
    depth_z = fracs[:, None, None] * depth[None]                 # (K, H, W)
    valid = (depth_z > 0) & (depth_z < pcd_far)

    px_cam = gxx[None] * depth_z
    py_cam = gy[None] * depth_z
    rot, t = c2w[:3, :3], c2w[:3, 3]
    # world = R @ p + t, each row a left-to-right sum with fused steps
    pts_w = [_fma(rot[i, 2], depth_z, _fma(rot[i, 1], py_cam,
                                            rot[i, 0] * px_cam)) + t[i]
             for i in range(3)]
    height_ok = (pts_w[1] >= height_lower) & (pts_w[1] <= height_upper)
    ok = valid & height_ok

    px, pz = discretize_coords(pts_w[0].reshape(-1), pts_w[2].reshape(-1),
                               grid_dim, cell, map_center)
    flat = (pz * gx + px).reshape(n_free, -1)
    okf = ok.reshape(n_free, -1)
    kk = n_free - 1
    free_counts = torch.zeros(gz * gx, dtype=f32, device=dev).index_add_(
        0, flat[:kk].reshape(-1), okf[:kk].reshape(-1).to(f32))
    occ_counts = torch.zeros(gz * gx, dtype=f32, device=dev).index_add_(
        0, flat[kk], okf[kk].to(f32))
    delta_free = 0.01 * free_counts.reshape(gz, gx)
    delta_occ = 100.0 * occ_counts.reshape(gz, gx)

    # free-space carve: n_carve samples along camera -> hit segments of
    # every carve_stride-th ray in each direction
    hit_ok = ok[kk, ::carve_stride, ::carve_stride].reshape(-1)
    ts = (torch.arange(n_carve, dtype=f32, device=dev) + 0.5) \
        * torch.tensor(1.0 / n_carve, dtype=f32)
    # cam + ts (hit - cam): the JAX package's CPU code fuses the multiply
    # and add for x but not for z
    hit_x = pts_w[0][kk, ::carve_stride, ::carve_stride].reshape(-1, 1)
    hit_z = pts_w[2][kk, ::carve_stride, ::carve_stride].reshape(-1, 1)
    seg_x = _fma(ts[None, :], hit_x - t[0], t[0])
    seg_z = t[2] + ts[None, :] * (hit_z - t[2])
    sx, sz = discretize_coords(seg_x.reshape(-1), seg_z.reshape(-1),
                               grid_dim, cell, map_center)
    s_ok = hit_ok.repeat_interleave(n_carve).to(f32)
    canvas = torch.zeros(gz * gx, dtype=f32, device=dev).scatter_reduce_(
        0, sz * gx + sx, s_ok, reduce="amax")
    delta_free = torch.where(canvas.reshape(gz, gx) > 0,
                             torch.ones_like(delta_free), delta_free)

    denom = (delta_occ + delta_free) + 1e-5
    occ_map[1] = occ_map[1] + delta_occ / denom
    occ_map[2] = occ_map[2] + delta_free / denom
    return occ_map, torch.stack([cam_pz, cam_px])
