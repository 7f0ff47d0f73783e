"""Geocentric occupancy grid with pose-conditioned ego registration.

Counterpart of the JAX package's models/semantic_grid.py (the
reference's SemanticGrid): each step's ego grid is rotated and
translated into the geocentric frame and Bayes-fused into the running
map, which stays on the grid's device.  The warp is the JAX package's
jax.scipy.ndimage.map_coordinates (order 1, mode "constant", cval 0)
written out as a bilinear gather: floor, two weights per axis, each
out-of-range neighbour contributing 0, the four products summed in
map_coordinates' order; grid_sample is not used, since its coordinate
normalization rounds differently.  The fusion keeps the JAX package's
float32 operations in their order.
"""
from __future__ import annotations

import numpy as np
import torch


def warp_ego_to_geo(ego: torch.Tensor, rel_xy_cells, rel_yaw: float,
                    grid_dim) -> torch.Tensor:
    """Warp a (C, h, w) ego grid into the (C, Gh, Gw) geocentric frame:
    the ego centre goes to the grid centre moved by rel_xy_cells (x, z
    cells), rotated by rel_yaw.  float32, on ego's device."""
    c, h, w = ego.shape
    gh, gw = int(grid_dim[0]), int(grid_dim[1])
    dev, f32 = ego.device, torch.float32
    ys = torch.arange(gh, dtype=f32, device=dev) - gh / 2.0
    xs = torch.arange(gw, dtype=f32, device=dev) - gw / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    tx = torch.tensor(np.float32(rel_xy_cells[0]), device=dev)
    ty = torch.tensor(np.float32(rel_xy_cells[1]), device=dev)
    # the inverse rotation's cosine and sine, correctly rounded to float32
    yaw = np.float64(np.float32(rel_yaw))
    ca = torch.tensor(np.float32(np.cos(-yaw)), device=dev)
    sa = torch.tensor(np.float32(np.sin(-yaw)), device=dev)
    dx, dy = gx - tx, gy - ty
    # the JAX package's fused kernel rounds each coordinate's first
    # product and sum once (a fused multiply-add): here in float64, where
    # the product of two float32 numbers is exact
    f64 = torch.float64
    ex = (ca.to(f64) * dx.to(f64) - (sa * dy).to(f64)).to(f32) + w / 2.0
    ey = (sa.to(f64) * dx.to(f64) + (ca * dy).to(f64)).to(f32) + h / 2.0

    def nodes(coord, size):
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.to(torch.int64)
        return [(idx, 1 - upper_w), (idx + 1, upper_w)]

    flat = ego.reshape(c, -1)
    out = None
    for iy, wy in nodes(ey, h):
        for ix, wx in nodes(ex, w):
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            at = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(-1)
            vals = torch.where(valid, flat[:, at].reshape(c, gh, gw),
                               torch.zeros((), dtype=f32, device=dev))
            term = (wy * wx) * vals
            out = term if out is None else out + term
    return out


class SemanticGrid:
    def __init__(self, grid_dim=(192, 192), n_classes: int = 3,
                 cell_size: float = 0.1, device="cuda"):
        self.cell_size = float(cell_size)
        self.n_classes = n_classes
        self.grid_dim = tuple(grid_dim)
        self.device = torch.device(device)
        # uniform prior
        self.proj_grid = torch.full((n_classes,) + self.grid_dim,
                                    1.0 / n_classes, dtype=torch.float32,
                                    device=self.device)
        self.origin_pose = None     # (x, z, yaw) of the grid centre

    def set_origin(self, pose_xzyaw):
        self.origin_pose = np.asarray(pose_xzyaw, np.float64)

    def warp(self, ego_probs, pose_xzyaw) -> torch.Tensor:
        """The ego grid observed at pose (x, z, yaw) in the geocentric
        frame."""
        assert self.origin_pose is not None, "call set_origin first"
        rel = np.asarray(pose_xzyaw, np.float64) - self.origin_pose
        ego = torch.as_tensor(ego_probs, dtype=torch.float32,
                              device=self.device)
        return warp_ego_to_geo(ego, (rel[0] / self.cell_size,
                                     rel[1] / self.cell_size), rel[2],
                               self.grid_dim)

    def register_ego(self, ego_probs, pose_xzyaw) -> torch.Tensor:
        """Fuse an ego grid observed at pose (x, z, yaw) into the map:
        where the warped grid has mass, multiply the likelihoods and
        renormalize."""
        warped = self.warp(ego_probs, pose_xzyaw)
        observed = (warped[0] + warped[1] + warped[2]) > 1e-3
        fused = self.proj_grid * torch.where(
            observed, warped + 1e-4, torch.ones((), device=self.device))
        fused = fused / ((fused[0] + fused[1] + fused[2]) + 1e-12)
        self.proj_grid = fused
        return self.proj_grid

    def crop_at(self, pose_xzyaw, crop: int = 64) -> torch.Tensor:
        """The (C, crop, crop) window of the map centred on the pose's
        cell, uniform outside the map."""
        rel = np.asarray(pose_xzyaw, np.float64) - self.origin_pose
        cx = int(self.grid_dim[1] / 2 + rel[0] / self.cell_size)
        cz = int(self.grid_dim[0] / 2 + rel[1] / self.cell_size)
        out = torch.full((self.n_classes, crop, crop), 1.0 / self.n_classes,
                         dtype=torch.float32, device=self.device)
        z0, z1 = cz - crop // 2, cz + crop // 2
        x0, x1 = cx - crop // 2, cx + crop // 2
        sz0, sx0 = max(z0, 0), max(x0, 0)
        sz1 = min(z1, self.grid_dim[0])
        sx1 = min(x1, self.grid_dim[1])
        if sz1 > sz0 and sx1 > sx0:
            out[:, sz0 - z0:sz1 - z0, sx0 - x0:sx1 - x0] = \
                self.proj_grid[:, sz0:sz1, sx0:sx1]
        return out
