"""Point-cloud bookkeeping of an episode: back-projection, the subsampled
global cloud, PLY files.  The JAX package's utils/pointcloud.py.

GlobalPointCloud keeps 5 % of each frame's back-projected points, chosen
by `rng.random(n) < keep_ratio` from a numpy generator, one draw per
frame in frame order: the JAX package's numpy path.  (Its device path
draws from jax.random, which torch cannot reproduce.)  Frames that
arrive as tensors are not pulled one per step: each is kept on its
device for a window of frames, and at the window's end, or at
`get`/`get_new`/`save`, the window is pulled in one copy and each frame
goes through the numpy path, so the stream is the JAX numpy path's to
the bit.
"""
from __future__ import annotations

import os

import numpy as np
import torch

_PLY_COLOR = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
              ("r", "u1"), ("g", "u1"), ("b", "u1")]


def backproject_depth(depth: np.ndarray, intrinsics: np.ndarray,
                      c2w: np.ndarray, max_depth: float = 10.0,
                      color: np.ndarray | None = None):
    """World points (float64) of the pixels with 0 < depth < max_depth,
    in row-major pixel order; with `color`, also their colors."""
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = depth.reshape(-1)
    valid = (z > 0) & (z < max_depth)
    px = ((xs.reshape(-1) - cx) / fx * z)
    py = ((ys.reshape(-1) - cy) / fy * z)
    pts_cam = np.stack([px, py, z], -1)[valid]
    pts_w = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    if color is not None:
        return pts_w, color.reshape(-1, 3)[valid]
    return pts_w


def _pull(xs) -> list:
    """Tensors (or arrays) as numpy arrays, in one device-to-host copy
    when they are tensors of one shape on one device."""
    if all(isinstance(x, torch.Tensor) for x in xs) and \
            len({(x.shape, x.device) for x in xs}) == 1:
        return list(torch.stack(xs).cpu().numpy())
    return [x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in xs]


class GlobalPointCloud:
    """Running scene cloud with keep-ratio subsampling (keep_ratio 0.05)."""

    def __init__(self, keep_ratio: float = 0.05, seed: int = 0,
                 window: int = 64):
        self.keep_ratio = keep_ratio
        self.rng = np.random.default_rng(seed)
        self.points: list[np.ndarray] = []
        self.colors: list[np.ndarray] = []
        self.window = int(window)
        # frames not yet subsampled: (depth, color or None, c2w,
        # intrinsics, max_depth)
        self._raw: list = []

    def add_frame(self, depth, intrinsics, c2w, color=None,
                  max_depth: float = 10.0):
        self._raw.append((depth, color, np.asarray(c2w, np.float32),
                          np.asarray(intrinsics, np.float32),
                          float(max_depth)))
        if len(self._raw) >= self.window:
            self._flush()

    def _flush(self):
        """Subsample the held frames in frame order (one pull for all)."""
        if not self._raw:
            return
        raw, self._raw = self._raw, []
        depths = _pull([r[0] for r in raw])
        with_color = [r[1] is not None for r in raw]
        colors = iter(_pull([r[1] for r in raw if r[1] is not None]))
        for (_d, _c, c2w, intr, max_depth), depth, has_c in zip(
                raw, depths, with_color):
            depth = depth.reshape(depth.shape[-2], depth.shape[-1])
            if has_c:
                pts, cols = backproject_depth(depth, intr, c2w, max_depth,
                                              next(colors))
            else:
                pts = backproject_depth(depth, intr, c2w, max_depth)
                cols = None
            n = len(pts)
            if n == 0:
                continue
            keep = self.rng.random(n) < self.keep_ratio
            self.points.append(pts[keep].astype(np.float32))
            if cols is not None:
                self.colors.append(cols[keep].astype(np.float32))

    def n_points(self) -> int:
        """Points held, the frames not yet subsampled included."""
        self._flush()
        return sum(len(p) for p in self.points)

    def get(self) -> np.ndarray:
        self._flush()
        if not self.points:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(self.points)

    def get_new(self, cursor: int):
        """Points appended since `cursor` (a chunk index from a previous
        call) and the new cursor: the append-only feed of
        engine/eval.IncrementalReconMetric."""
        self._flush()
        chunks = self.points[cursor:]
        pts = (np.concatenate(chunks) if chunks
               else np.zeros((0, 3), np.float32))
        return pts, len(self.points)

    def save_ply(self, path: str):
        pts = self.get()
        cols = np.concatenate(self.colors) if self.colors else None
        write_ply(path, pts, cols)

    def save(self, path: str, **extra):
        """The cloud as an uncompressed npz (points, colors, and truncated
        = 0: the JAX device path's count of points past its per-frame
        capacity, which the numpy path never drops); `extra` arrays ride
        along (the driver's step stamp)."""
        from .io import atomic_savez
        pts = self.get()
        cols = np.concatenate(self.colors) if self.colors else None
        atomic_savez(path, points=pts,
                     colors=(cols if cols is not None
                             else np.zeros((0, 3), np.float32)),
                     truncated=0, **extra)

    def load(self, path: str):
        with np.load(path) as d:
            self._raw = []
            self.points = [np.asarray(d["points"], np.float32)] \
                if len(d["points"]) else []
            self.colors = [np.asarray(d["colors"], np.float32)] \
                if len(d["colors"]) else []


def write_ply(path: str, points: np.ndarray,
              colors: np.ndarray | None = None):
    """Binary little-endian PLY: float x, y, z (+ uchar r, g, b from
    colors in [0, 1])."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(points)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if colors is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode())
        pts = np.asarray(points, "<f4")
        if colors is not None:
            cols = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
            rec = np.zeros(n, dtype=_PLY_COLOR)
            rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
            rec["r"], rec["g"], rec["b"] = cols[:, 0], cols[:, 1], cols[:, 2]
            f.write(rec.tobytes())
        else:
            f.write(pts.tobytes())


def read_ply(path: str) -> np.ndarray:
    """(N, 3) float32 points of a file write_ply wrote (or an ASCII PLY)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(ln.split()[-1]) for ln in header
                 if ln.startswith("element vertex"))
        has_color = any("uchar" in ln for ln in header)
        if any("binary_little_endian" in ln for ln in header):
            if has_color:
                rec = np.frombuffer(f.read(n * 15), dtype=_PLY_COLOR)
                return np.stack([rec["x"], rec["y"], rec["z"]], -1).copy()
            data = np.frombuffer(f.read(n * 12), dtype="<f4")
            return data.reshape(n, 3).copy()
        rows = [f.readline().decode().split()[:3] for _ in range(n)]
        return np.asarray(rows, np.float32)
