"""Nearest neighbours: exact brute-force k-NN and the known-environment
novelty mask.

Counterpart of the JAX package's ops/knn.py.  `knn` keeps its contract:
Euclidean float32 distances (Q, k) and int32 rows (Q, k), the inputs
centred on the references' mean (over the unmasked rows only, so a
non-finite value in a masked row does not reach it), masked references
infinitely far, (inf, 0) where no reference is in reach, and ties kept
at the lowest row, as lax.top_k keeps them.  Distances are the direct
differences' (dx*dx + dy*dy) + dz*dz, not the JAX package's
|q|^2 + |r|^2 - 2 q.r, which cancels: the same function, without that
rounding.

With k = 1 on CUDA tensors, `knn` runs the 1-NN kernel
(ops/cuda_knn.py, csrc/nn1.cu); on CPU tensors, the plain twin
`knn_plain`.  k > 1 runs on CPU tensors only: nothing on the card's path
asks for it.
"""
from __future__ import annotations

import math

import torch

from .cuda_knn import cuda_nn1, nn1_plain


def center_inputs(queries, refs, ref_mask=None):
    """Queries and refs minus the refs' (masked) mean, float32; masked ref
    rows are zero."""
    queries = torch.as_tensor(queries, dtype=torch.float32)
    refs = torch.as_tensor(refs, dtype=torch.float32, device=queries.device)
    if ref_mask is None:
        center = refs.mean(dim=0, keepdim=True)
        return (queries - center).contiguous(), (refs - center).contiguous()
    keep = ref_mask[:, None]
    cnt = torch.clamp(ref_mask.sum(), min=1)
    center = torch.where(keep, refs, 0.0).sum(dim=0, keepdim=True) / cnt
    return ((queries - center).contiguous(),
            torch.where(keep, refs - center, 0.0).contiguous())


def knn_plain(queries, refs, k: int = 1, ref_mask=None, chunk: int = 65536):
    """The k nearest refs of each query on centred inputs, in plain
    PyTorch: (dists (Q, k) f32, idx (Q, k) int32).  A running merge over
    ref chunks by a stable sort of the candidates (the kept ones first,
    then the chunk's in row order), so equal distances keep the lowest
    rows; torch.topk promises no order among ties."""
    if k == 1:
        d, i = nn1_plain(queries, refs, ref_mask, chunk)
        return d[:, None], i[:, None]
    n_q, n_r = queries.shape[0], refs.shape[0]
    dev = queries.device
    best_d = torch.full((n_q, k), math.inf, device=dev)
    best_i = torch.zeros((n_q, k), dtype=torch.int64, device=dev)
    for r0 in range(0, n_r, chunk):
        r = refs[r0:r0 + chunk]
        dx = queries[:, None, 0] - r[None, :, 0]
        dy = queries[:, None, 1] - r[None, :, 1]
        dz = queries[:, None, 2] - r[None, :, 2]
        d2 = (dx * dx + dy * dy) + dz * dz
        keep = d2 == d2
        if ref_mask is not None:
            keep &= ref_mask[None, r0:r0 + chunk]
        d2 = torch.where(keep, d2, math.inf)
        rows = torch.arange(r0, r0 + r.shape[0], device=dev)
        cand_d = torch.cat([best_d, d2], dim=1)
        cand_i = torch.cat([best_i, rows[None, :].expand(n_q, -1)], dim=1)
        order = torch.sort(cand_d, dim=1, stable=True).indices[:, :k]
        best_d = torch.gather(cand_d, 1, order)
        best_i = torch.gather(cand_i, 1, order)
    return torch.sqrt(best_d), best_i.to(torch.int32)


def knn(queries, refs, k: int = 1, ref_mask=None, chunk: int = 65536):
    """For each query (Q, 3), the k nearest of refs (R, 3) whose ref_mask
    (R,) is True (all without one): (dists (Q, k) f32 Euclidean, idx
    (Q, k) int32).  CUDA tensors take the 1-NN kernel (k = 1 only), CPU
    tensors the plain twin."""
    qc, rc = center_inputs(queries, refs, ref_mask)
    if ref_mask is not None:
        ref_mask = ref_mask.to(device=qc.device, dtype=torch.bool)
    if qc.device.type == "cpu":
        return knn_plain(qc, rc, k, ref_mask, chunk)
    if k != 1:
        raise ValueError(f"knn: k = {k} on {qc.device}; the card's kernel "
                         f"is the 1-NN (k > 1 runs on CPU tensors)")
    d, i = cuda_nn1(qc, rc, ref_mask)
    return d[:, None], i[:, None]


def knn_self(points, k: int = 4, mask=None, chunk: int = 65536):
    """k-NN within one cloud without the self match: the k + 1 nearest,
    the first (distance 0, itself) dropped."""
    d, i = knn(points, points, k=k + 1, ref_mask=mask, chunk=chunk)
    return d[:, 1:], i[:, 1:]


def mean_sq_neighbor_dist(points, k: int = 3, mask=None):
    """Mean squared distance to the k nearest neighbours (the 3DGS scale
    initializer)."""
    d, _ = knn_self(points, k=k, mask=mask)
    return torch.mean(d * d, dim=-1)


def backproject_world(depth, inv_k, c2w):
    """World points (H*W, 3) f32 of every pixel of depth (H, W) through
    inv_k (3, 3) and c2w (4, 4), each 3x3 product written out
    elementwise: a matmul on the card may run in TF32, whose millimetres
    at 5 m would move pixels across the novelty mask's 5 cm cut."""
    h, w = depth.shape
    dev = depth.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = (gx, gy, torch.ones_like(gx))
    inv_k = inv_k.to(device=dev, dtype=torch.float32)
    c2w = c2w.to(device=dev, dtype=torch.float32)

    def mat3(m, v):
        return [(m[i, 0] * v[0] + m[i, 1] * v[1]) + m[i, 2] * v[2]
                for i in range(3)]

    cam = [r * depth for r in mat3(inv_k, pix)]
    world = [p + c2w[i, 3] for i, p in enumerate(mat3(c2w[:3, :3], cam))]
    return torch.stack(world, dim=-1).reshape(-1, 3)


def novelty_mask_from_pcd_nn(gt_points, depth, inv_k, c2w,
                             dist_thresh: float = 0.05,
                             min_pixels: int = 20):
    """The pixels whose back-projected point lies more than dist_thresh
    from the known ground-truth cloud, and with depth > 0: object
    discovery in a known environment.  gt_points (N, 3), depth (H, W),
    inv_k (3, 3) inverse intrinsics, c2w (4, 4), all on one device.
    Returns (mask (H, W) bool, n_novel ()): the mask is all False when
    fewer than min_pixels are novel."""
    h, w = depth.shape
    depth = depth.to(torch.float32)
    pts = backproject_world(depth, inv_k, c2w)
    d, _ = knn(pts, gt_points, k=1)
    novel = (d[:, 0] > dist_thresh) & (depth.reshape(-1) > 0)
    n_novel = novel.sum(dtype=torch.int32)
    mask = novel & (n_novel >= min_pixels)
    return mask.reshape(h, w), n_novel
