"""Keyframe-distinctiveness gating for object mapping (the DINO gate).

The port's own copy of the JAX package's engine/dino_gate.py (numpy
only; the reference's tester_gaussians_navigation.py DINOv2 gate, whose
dino_extract.py is absent from its repository and is reconstructed from
the call sites): each object frame's patch descriptors of the
object-mask region are compared against a bank of accepted descriptor
sets (`DinoBank.similarity_metrics`: pooled max similarity, chamfer
similarity and the two >0.8 match fractions), and a frame too similar to
the bank is not used for object mapping.  Without DINOv2 weights the
default `PatchDescriptorExtractor` gives normalized colour and gradient
histograms of each patch, the same gating contract.
"""
from __future__ import annotations

import numpy as np


class PatchDescriptorExtractor:
    """(H, W, 3) rgb + (H, W) mask -> (N, D) L2-normalized descriptors of
    patch_size x patch_size patches intersecting the mask."""

    def __init__(self, patch_size: int = 14, bins: int = 8):
        self.patch = int(patch_size)
        self.bins = int(bins)

    def __call__(self, rgb: np.ndarray, mask: np.ndarray) -> np.ndarray:
        rgb = np.asarray(rgb, np.float32)
        mask = np.asarray(mask, bool)
        h, w = mask.shape
        p = self.patch
        gray = rgb.mean(-1)
        gx = np.zeros_like(gray)
        gy = np.zeros_like(gray)
        gx[:, 1:] = np.diff(gray, axis=1)
        gy[1:, :] = np.diff(gray, axis=0)
        descs = []
        for y0 in range(0, h - p + 1, p):
            for x0 in range(0, w - p + 1, p):
                m = mask[y0:y0 + p, x0:x0 + p]
                if m.mean() < 0.3:
                    continue
                patch = rgb[y0:y0 + p, x0:x0 + p]
                hist = [np.histogram(patch[..., c][m], bins=self.bins,
                                     range=(0, 1))[0] for c in range(3)]
                ang = np.arctan2(gy[y0:y0 + p, x0:x0 + p],
                                 gx[y0:y0 + p, x0:x0 + p])[m]
                ghist = np.histogram(ang, bins=self.bins,
                                     range=(-np.pi, np.pi))[0]
                d = np.concatenate(hist + [ghist]).astype(np.float32)
                n = np.linalg.norm(d)
                if n > 0:
                    descs.append(d / n)
        if not descs:
            return np.zeros((0, self.bins * 4), np.float32)
        return np.stack(descs)


class DinoBank:
    """Bank of accepted descriptor sets with similarity gating
    (reference call sites: similarity_metrics -> (sim_pool_max, sim_chamfer,
    frac_fwd, frac_bwd); add_if_distinct(D, force))."""

    def __init__(self, sim_thresh: float = 0.8, frac_thresh: float = 0.6,
                 max_size: int = 64):
        self.sim_thresh = float(sim_thresh)
        self.frac_thresh = float(frac_thresh)
        self.max_size = int(max_size)
        self.bank: list[np.ndarray] = []

    def __len__(self):
        return len(self.bank)

    def similarity_metrics(self, descs: np.ndarray):
        """Against the most similar bank entry: (pooled max sim, chamfer
        sim, fraction of new descs matching >thresh (fwd), fraction of bank
        descs matched (bwd))."""
        if not self.bank or len(descs) == 0:
            return 0.0, 0.0, 0.0, 0.0
        best = (0.0, 0.0, 0.0, 0.0)
        for entry in self.bank:
            sim = descs @ entry.T                        # (N, M) cosine
            fwd = sim.max(axis=1)
            bwd = sim.max(axis=0)
            pooled = float(fwd.max())
            chamfer = float((fwd.mean() + bwd.mean()) / 2.0)
            frac_fwd = float((fwd > self.sim_thresh).mean())
            frac_bwd = float((bwd > self.sim_thresh).mean())
            if chamfer > best[1]:
                best = (pooled, chamfer, frac_fwd, frac_bwd)
        return best

    def is_distinct(self, descs: np.ndarray) -> bool:
        _pool, _ch, frac_fwd, frac_bwd = self.similarity_metrics(descs)
        return min(frac_fwd, frac_bwd) < self.frac_thresh

    def add_if_distinct(self, descs: np.ndarray, force: bool = False) -> bool:
        if len(descs) == 0:
            return False
        if force or not self.bank or self.is_distinct(descs):
            self.bank.append(np.asarray(descs, np.float32))
            if len(self.bank) > self.max_size:
                self.bank.pop(0)
            return True
        return False


def object_center_error(mask: np.ndarray, width: int | None = None) -> float:
    """Horizontal offset of the mask centroid from the image center in
    [-1, 1] (reference tester:2912 object_center_error — drives the
    mask-centering init actions of init_object_policy)."""
    mask = np.asarray(mask, bool)
    if not mask.any():
        return 0.0
    w = width or mask.shape[1]
    cx = np.nonzero(mask)[1].mean()
    return float((cx - w / 2.0) / (w / 2.0))
