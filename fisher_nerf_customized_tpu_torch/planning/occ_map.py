"""A standalone occupancy map and grid utilities.

Counterpart of the JAX package's planning/occ_map.py (the reference's
lighter OccupancyMap with ego crops, and map_utils' est_occ_from_pcd and
crop_grid): the planner's vote update (planning/occupancy.py::occ_update)
on a (3, Gz, Gx) map held on `device` ("cuda" by default), without the
planner's state.  Channels: 0 unknown, 1 occupied, 2 free.
`est_occ_from_pcd` and `crop_grid` are numpy copies.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.camera import Camera
from .occupancy import occ_update


class OccupancyMap:
    def __init__(self, camera: Camera, grid_dim=(768, 768),
                 cell_size: float = 0.1, map_center=(0.0, 0.0),
                 height_lower: float = 0.1, height_upper: float = 1.3,
                 pcd_far: float = 7.0, device="cuda"):
        self.camera = camera
        self.device = torch.device(device)
        self.cell_size = float(cell_size)
        self.map_center = np.asarray(map_center, np.float32)
        self.height_lower = float(height_lower)
        self.height_upper = float(height_upper)
        self.pcd_far = float(pcd_far)
        occ = torch.zeros((3, grid_dim[1], grid_dim[0]), device=self.device)
        occ[0] = 1.0
        self.occ_map = occ

    def update(self, depth, c2w) -> torch.Tensor:
        """Add one depth frame (H, W), seen from c2w, to the map."""
        dev = self.device
        depth = torch.as_tensor(depth, device=dev).float()
        self.occ_map, _ = occ_update(
            self.occ_map, depth.reshape(depth.shape[-2:]),
            torch.as_tensor(np.asarray(c2w, np.float32), device=dev),
            self.camera, self.cell_size,
            torch.as_tensor(self.map_center, device=dev), self.height_lower,
            self.height_upper, self.pcd_far)
        return self.occ_map

    def labels(self) -> np.ndarray:
        """(Gz, Gx) labels: 0 unknown, 1 occupied, 2 free (the first
        channel on ties)."""
        return torch.argmax(self.occ_map, dim=0).cpu().numpy()

    def explored_ratio(self) -> float:
        """The share of cells no longer unknown."""
        return float((self.labels() != 0).mean())

    def ego_crop(self, c2w, crop: int = 64) -> np.ndarray:
        """(3, crop, crop) window of the map centred on the agent's cell;
        outside the map, unknown."""
        occ = self.occ_map.cpu().numpy()
        gz, gx = occ.shape[1], occ.shape[2]
        c2w = np.asarray(c2w)
        cx = int((c2w[0, 3] - self.map_center[0]) / self.cell_size + gx // 2)
        cz = int((c2w[2, 3] - self.map_center[1]) / self.cell_size + gz // 2)
        out = np.zeros((3, crop, crop), np.float32)
        out[0] = 1.0
        z0, x0 = cz - crop // 2, cx - crop // 2
        sz0, sx0 = max(z0, 0), max(x0, 0)
        sz1, sx1 = min(z0 + crop, gz), min(x0 + crop, gx)
        if sz1 > sz0 and sx1 > sx0:
            out[:, sz0 - z0:sz1 - z0, sx0 - x0:sx1 - x0] = \
                occ[:, sz0:sz1, sx0:sx1]
        return out

    def save(self, path: str):
        """The map, its centre and cell size as a compressed npz (the JAX
        package's keys)."""
        np.savez_compressed(path, occ_map=self.occ_map.cpu().numpy(),
                            map_center=self.map_center,
                            cell_size=self.cell_size)

    def load(self, path: str):
        with np.load(path) as d:
            self.occ_map = torch.as_tensor(
                np.asarray(d["occ_map"], np.float32), device=self.device)
            self.map_center = np.asarray(d["map_center"], np.float32)
            self.cell_size = float(d["cell_size"])


def est_occ_from_pcd(points: np.ndarray, grid_dim, cell_size: float,
                     map_center, height_band=(0.1, 1.3)) -> np.ndarray:
    """A (3, Gz, Gx) vote grid from a world point cloud: channel 0 all
    ones, channel 1 a vote per point in the height band."""
    gx, gz = int(grid_dim[0]), int(grid_dim[1])
    occ = np.zeros((3, gz, gx), np.float32)
    occ[0] = 1.0
    pts = np.asarray(points)
    band = (pts[:, 1] >= height_band[0]) & (pts[:, 1] <= height_band[1])
    pts = pts[band]
    if len(pts) == 0:
        return occ
    ix = np.clip(np.floor((pts[:, 0] - map_center[0]) / cell_size)
                 + (gx - 1) // 2, 0, gx - 1).astype(np.int64)
    iz = np.clip(np.floor((pts[:, 2] - map_center[1]) / cell_size)
                 + (gz - 1) // 2, 0, gz - 1).astype(np.int64)
    np.add.at(occ[1], (iz, ix), 1.0)
    return occ


def crop_grid(grid: np.ndarray, center_cell, crop: int) -> np.ndarray:
    """A (C, crop, crop) window of a (C, H, W) grid centred on
    center_cell (row, column), zero outside the grid."""
    c, h, w = grid.shape
    out = np.zeros((c, crop, crop), grid.dtype)
    z0 = int(center_cell[0]) - crop // 2
    x0 = int(center_cell[1]) - crop // 2
    sz0, sx0 = max(z0, 0), max(x0, 0)
    sz1, sx1 = min(z0 + crop, h), min(x0 + crop, w)
    if sz1 > sz0 and sx1 > sx0:
        out[:, sz0 - z0:sz1 - z0, sx0 - x0:sx1 - x0] = grid[:, sz0:sz1,
                                                            sx0:sx1]
    return out
