"""Keyframe buffer and the overlap-based selection of a mapping window.

Poses and ids are kept on the host (numpy); each keyframe's color and
depth are kept as given, a device tensor from the simulator or a host
array from a checkpoint, and converted to the other side only when asked.
`select_keyframes_overlap` is a copy of the JAX package's host-side numpy
selection (the port imports nothing of that package).
"""
from __future__ import annotations

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32)
    return np.asarray(x, np.float32)


class KeyframeBuffer:
    def __init__(self, height: int, width: int):
        self.colors: list = []     # (H, W, 3) float32 in [0, 1]
        self.depths: list = []     # (H, W) float32
        self.w2cs: list[np.ndarray] = []
        self.ids: list[int] = []
        self.height, self.width = height, width

    def __len__(self):
        return len(self.ids)

    def append(self, color, depth, w2c, frame_id: int):
        self.colors.append(color)
        self.depths.append(depth)
        self.w2cs.append(np.asarray(w2c, np.float32))
        self.ids.append(int(frame_id))

    def color_dev(self, i: int, device) -> torch.Tensor:
        return torch.as_tensor(self.colors[i], dtype=torch.float32,
                               device=device)

    def depth_dev(self, i: int, device) -> torch.Tensor:
        return torch.as_tensor(self.depths[i], dtype=torch.float32,
                               device=device)

    def stacked_w2cs(self) -> np.ndarray:
        if not self.w2cs:
            return np.zeros((0, 4, 4), np.float32)
        return np.stack(self.w2cs)

    def state_dict(self):
        return dict(colors=[_to_numpy(c) for c in self.colors],
                    depths=[_to_numpy(d) for d in self.depths],
                    w2cs=self.w2cs, ids=self.ids)

    def load_state_dict(self, d):
        self.colors = [np.asarray(c, np.float32) for c in d["colors"]]
        self.depths = [np.asarray(c, np.float32) for c in d["depths"]]
        self.w2cs = [np.asarray(c, np.float32) for c in d["w2cs"]]
        self.ids = [int(i) for i in d["ids"]]


def select_keyframes_overlap(gt_depth: np.ndarray, w2c: np.ndarray,
                             intrinsics: np.ndarray, buffer: KeyframeBuffer,
                             k: int, pixels: int = 1600,
                             rng: np.random.Generator | None = None,
                             exclude_last: bool = True) -> list[int]:
    """Indices (into the buffer, excluding its last entry) of up to k
    keyframes ranked by reprojection overlap with the current view.

    Samples `pixels` valid-depth pixels with `rng`, back-projects them with
    the current w2c, projects them into every keyframe, scores each
    keyframe by the fraction landing more than 20 px inside the image with
    positive depth, and returns a random permutation (from `rng`) of the
    keyframes with overlap > 0, cut to k.  The draws are the JAX package's
    (same numpy calls in the same order), so one seed gives both packages
    the same window."""
    rng = rng or np.random.default_rng()
    kf_w2cs = buffer.stacked_w2cs()
    if exclude_last:
        kf_w2cs = kf_w2cs[:-1]
    if len(kf_w2cs) == 0:
        return []

    h, w = gt_depth.shape[-2], gt_depth.shape[-1]
    d = gt_depth.reshape(h, w)
    vy, vx = np.nonzero(d > 0)
    if len(vy) == 0:
        return []
    sel = rng.integers(0, len(vy), size=min(pixels, len(vy)))
    py, px = vy[sel], vx[sel]
    z = d[py, px]

    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    pts_cam = np.stack([(px - cx) / fx * z, (py - cy) / fy * z, z], axis=-1)
    c2w = np.linalg.inv(w2c)
    pts_w = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]

    pts_k = (np.einsum("kij,pj->kpi", kf_w2cs[:, :3, :3], pts_w)
             + kf_w2cs[:, None, :3, 3])                    # (K, P, 3)
    zk = pts_k[..., 2] + 1e-5
    u = fx * pts_k[..., 0] / zk + cx
    v = fy * pts_k[..., 1] / zk + cy
    edge = 20
    inside = ((u > edge) & (u < w - edge) & (v > edge) & (v < h - edge)
              & (zk > 0))
    percent = inside.mean(axis=1)

    ranked = np.argsort(-percent, kind="stable")
    candidates = [int(i) for i in ranked if percent[i] > 0.0]
    return [int(i) for i in rng.permutation(candidates)[:k]]
