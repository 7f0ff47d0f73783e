"""Top-down episode images: the fog-of-war map and the occupancy PNG.

Counterpart of the JAX package's engine/visualization.py (the
reference's HabitatVisualizer and its planning images): MapVisualizer
keeps a ground-truth navigable grid aligned with the planner's map and a
fog-of-war mask that each step's field-of-view wedge reveals
(coverage_2d is the revealed share of the navigable cells), the agent's
and a dynamic object's cells, and draws them (render, save_vis_seen);
save_occ_map_png draws a planning event's occupancy map with its
candidate scores.  The drawing is cv2's without cv2 (utils/raster.py:
fill_poly, draw_lines, fill_circle, dilate3), and the PNGs are written
by raster.write_png as RGB, the pixels the JAX package's
cv2.imwrite(img[..., ::-1]) stores.  state_dict/load_state_dict carry
the mask and the cells through a checkpoint.  write_trajectory_video
writes an episode's frames as an mp4 without cv2: utils/video.py's H.264
I_PCM stream (every macroblock raw samples) in ISO BMFF, about 1.5 bytes
a pixel.
"""
from __future__ import annotations

import os
import warnings

import numpy as np

from ..utils.raster import (dilate3, draw_lines, fill_circle, fill_poly,
                            write_png)
from ..utils.video import write_mp4


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

    def render(self) -> np.ndarray:
        """The (Gz, Gx, 3) uint8 RGB map: navigable cells grey, revealed
        ones green, the agent's trajectory red, the object's blue, the
        agent a filled circle."""
        img = np.full(self.gt_free.shape + (3,), 30, np.uint8)
        img[self.gt_free] = (200, 200, 200)
        img[self.fow_mask] = (120, 180, 120)
        for cells, color in ((self.traj, (200, 60, 60)),
                             (self.obj_traj, (60, 60, 200))):
            if len(cells) > 1:
                pts = np.asarray(cells, np.int64)
                img[draw_lines(self.gt_free.shape, pts[:-1],
                               pts[1:]) > 0] = color
        if self.traj:
            img[fill_circle(self.gt_free.shape, self.traj[-1], 3) > 0] = \
                (255, 0, 0)
        return img

    def save_vis_seen(self, out_dir: str, t: int):
        os.makedirs(out_dir, exist_ok=True)
        write_png(os.path.join(out_dir, f"topdown_{t:05d}.png"),
                  self.render())

    # checkpoint hooks
    def state_dict(self):
        return dict(fow_mask=self.fow_mask, traj=np.asarray(self.traj),
                    obj_traj=np.asarray(self.obj_traj))

    def load_state_dict(self, d):
        self.fow_mask = np.asarray(d["fow_mask"], bool)
        self.traj = [tuple(p) for p in np.asarray(d["traj"]).reshape(-1, 2)]
        self.obj_traj = [tuple(p) for p in
                         np.asarray(d["obj_traj"]).reshape(-1, 2)]


def write_trajectory_video(frames: list, path: str, fps: int = 10):
    """Episode RGB frames (H, W, 3) -> an mp4 of `fps` frames a second, the
    frames the JAX package's cv2.VideoWriter(mp4v) file holds: a frame
    that is not uint8 becomes np.clip(img * 255, 0, 255).astype(uint8), a
    tensor comes to the host first, a frame whose shape is not the first
    frame's (H, W) with 3 channels is skipped with a warning, and odd
    sides are floored to even.  The stream is utils/video.py's H.264
    I_PCM: lossless up to the 4:2:0 limited-range colour conversion."""
    if not frames:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames[0].shape[:2]
    keep = []
    for i, f in enumerate(frames):
        img = (f.detach().cpu().numpy() if hasattr(f, "detach")
               else np.asarray(f))
        if img.dtype != np.uint8:
            img = np.clip(img * 255, 0, 255).astype(np.uint8)
        if img.shape != (h, w, 3):
            warnings.warn(f"write_trajectory_video: frame {i} of shape "
                          f"{img.shape} skipped (the video is {h}x{w}x3)")
            continue
        keep.append(img)
    write_mp4(path, keep, (h, w), fps)


def save_occ_map_png(occ_map, path: str, candidates=None, scores=None,
                     agent_cell=None, frontier=None):
    """A planning event's image: the (3, Gz, Gx) occupancy map's labels
    (occupied white, free grey), the target frontier dilated (green), the
    candidates' cells coloured by their normalized score (blue to red,
    drawn in order) and the agent's cell (red), as an RGB PNG."""
    index = np.asarray(occ_map).argmax(axis=0)
    shape = index.shape
    img = np.zeros(shape + (3,), np.uint8)
    img[index == 1] = (255, 255, 255)
    img[index == 2] = (80, 80, 80)
    if frontier is not None and np.asarray(frontier).sum() > 0:
        img[dilate3(np.asarray(frontier) > 0) > 0] = (0, 255, 0)
    if candidates is not None and scores is not None and len(scores) > 0:
        s = np.asarray(scores, np.float64)
        rng = s.max() - s.min()
        s = (s - s.min()) / (rng if rng > 0 else 1.0)
        for (x, z), v in zip(np.asarray(candidates), s):
            img[fill_circle(shape, (int(x), int(z)), 1) > 0] = (
                int(255 * v), 0, int(255 * (1 - v)))
    if agent_cell is not None:
        img[fill_circle(shape, (int(agent_cell[0]), int(agent_cell[1])),
                        2) > 0] = (255, 0, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, img)
