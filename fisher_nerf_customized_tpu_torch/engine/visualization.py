"""Top-down fog-of-war map: the 2D coverage of an episode.

Counterpart of the JAX package's engine/visualization.py MapVisualizer
(the reference's HabitatVisualizer): a ground-truth navigable grid
aligned with the planner's map and a fog-of-war mask that each step's
field-of-view wedge reveals; coverage_2d is the revealed share of the
navigable cells.  The wedge is drawn by utils/raster.fill_poly, cv2's
fillPoly without cv2.  state_dict/load_state_dict carry the mask and the
agent's cells through a checkpoint, and update_object records a dynamic
object's cells.  Drawing the map and the PNG export are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import numpy as np

from ..utils.raster import fill_poly


class MapVisualizer:
    def __init__(self, gt_free_map: np.ndarray, cell_size: float,
                 map_center: np.ndarray, fov_deg: float = 90.0,
                 vis_range: float = 4.0):
        """gt_free_map: (Gz, Gx) bool navigable mask (FakeSim:
        BoxScene.gt_free_map)."""
        self.gt_free = np.asarray(gt_free_map, bool)
        self.cell_size = float(cell_size)
        self.map_center = np.asarray(map_center, np.float64)
        self.fov = np.deg2rad(fov_deg)
        self.vis_range = float(vis_range)
        self.fow_mask = np.zeros_like(self.gt_free, bool)
        self.traj: list[tuple[int, int]] = []       # the agent's cells
        self.obj_traj: list[tuple[int, int]] = []   # a dynamic object's

    def _to_cell(self, x, z):
        gz, gx = self.gt_free.shape
        cx = int((x - self.map_center[0]) / self.cell_size + gx // 2)
        cz = int((z - self.map_center[1]) / self.cell_size + gz // 2)
        return np.clip(cx, 0, gx - 1), np.clip(cz, 0, gz - 1)

    def update_fow_sim(self, c2w: np.ndarray):
        """Reveal the field-of-view wedge ahead of the camera."""
        c2w = np.asarray(c2w, np.float64)
        cx, cz = self._to_cell(c2w[0, 3], c2w[2, 3])
        self.traj.append((cx, cz))
        fwd = c2w[:3, :3] @ np.array([0.0, 0.0, 1.0])
        yaw = np.arctan2(fwd[0], fwd[2])
        r_cells = int(self.vis_range / self.cell_size)
        pts = [(cx, cz)]
        for a in np.linspace(yaw - self.fov / 2, yaw + self.fov / 2, 24):
            pts.append((int(cx + r_cells * np.sin(a)),
                        int(cz + r_cells * np.cos(a))))
        wedge = fill_poly(self.gt_free.shape, np.asarray(pts, np.int32))
        self.fow_mask |= (wedge > 0) & self.gt_free

    def update_object(self, pos_xz):
        """Record the dynamic object's cell ((x, ..., z) world position)."""
        self.obj_traj.append(self._to_cell(pos_xz[0], pos_xz[-1]))

    def coverage_2d(self) -> float:
        """% of the navigable cells revealed."""
        total = self.gt_free.sum()
        return float(self.fow_mask.sum() / max(total, 1) * 100.0)

    # checkpoint hooks
    def state_dict(self):
        return dict(fow_mask=self.fow_mask, traj=np.asarray(self.traj),
                    obj_traj=np.asarray(self.obj_traj))

    def load_state_dict(self, d):
        self.fow_mask = np.asarray(d["fow_mask"], bool)
        self.traj = [tuple(p) for p in np.asarray(d["traj"]).reshape(-1, 2)]
        self.obj_traj = [tuple(p) for p in
                         np.asarray(d["obj_traj"]).reshape(-1, 2)]
