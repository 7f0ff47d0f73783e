"""The 1-NN kernel: CUDA kernel wrapper + plain twin.

Counterpart of the JAX package's ops/knn.py::knn at k = 1 (an XLA
program there).  The kernel (csrc/nn1.cu) finds, for each query, the
nearest unmasked reference: the Euclidean distance (float32) and the
lowest row at that distance (int32); a query with no finite distance
gets (inf, 0).  `nn1_plain` is the same function in plain PyTorch: the
same d2 = (dx*dx + dy*dy) + dz*dz of direct differences, elementwise,
and an exact lowest-row minimum, so on the same tensors kernel and twin
agree to the bit.  `cuda_nn1` runs the kernel for CUDA tensors and the
twin for CPU tensors.  Callers center the inputs first (ops/knn.py).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build

THREADS = 128
QUERIES_PER_BLOCK = THREADS * 8      # csrc/nn1.cu: 8 queries per thread
TILE = 1024                          # refs staged in shared memory at once
# blocks the first pass should launch before the refs are split over
# gridDim.y: 8 per SM of an H100's 132
TARGET_BLOCKS = 8 * 132

# Launches of the CUDA kernel (not of the plain twin).
launches = 0


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"cuda_nn1: {msg}")


def nn1_plain(queries, refs, mask=None, chunk: int = 65536):
    """(dist (Q,) f32, idx (Q,) int32): each query's nearest ref among
    those with mask True (all without a mask), the lowest row on ties;
    (inf, 0) where no distance is finite.  Refs are taken `chunk` at a
    time and queries in blocks that keep a block's distance matrix under
    2^25 entries."""
    n_q, n_r = queries.shape[0], refs.shape[0]
    dev = queries.device
    best = torch.full((n_q,), math.inf, device=dev)
    best_idx = torch.zeros(n_q, dtype=torch.int64, device=dev)
    q_block = max(1, (1 << 25) // max(min(chunk, n_r), 1))
    for q0 in range(0, n_q, q_block):
        q = queries[q0:q0 + q_block]
        b_d, b_i = best[q0:q0 + q_block], best_idx[q0:q0 + q_block]
        for r0 in range(0, n_r, chunk):
            r = refs[r0:r0 + chunk]
            dx = q[:, None, 0] - r[None, :, 0]
            dy = q[:, None, 1] - r[None, :, 1]
            dz = q[:, None, 2] - r[None, :, 2]
            d2 = (dx * dx + dy * dy) + dz * dz
            keep = d2 == d2                     # NaN never wins
            if mask is not None:
                keep &= mask[None, r0:r0 + chunk]
            d2 = torch.where(keep, d2, math.inf)
            m = d2.amin(dim=1)
            rows = torch.arange(r0, r0 + r.shape[0], device=dev)
            first = torch.where(d2 == m[:, None], rows[None, :],
                                n_r).amin(dim=1)
            better = m < b_d                    # strictly: earlier rows win
            b_i.copy_(torch.where(better, first, b_i))
            b_d.copy_(torch.where(better, m, b_d))
    return torch.sqrt(best), best_idx.to(torch.int32)


def _splits(n_q: int, n_r: int) -> tuple[int, int]:
    """(splits, refs per split) of the first pass: the refs in ranges of
    whole tiles over gridDim.y, enough to fill TARGET_BLOCKS blocks when
    the queries alone do not."""
    q_blocks = -(-n_q // QUERIES_PER_BLOCK)
    tiles = max(-(-n_r // TILE), 1)
    splits = max(1, min(-(-TARGET_BLOCKS // q_blocks), tiles, 65535))
    per = -(-tiles // splits) * TILE
    return -(-max(n_r, 1) // per), per


def cuda_nn1(queries, refs, mask=None):
    """The 1-NN on the tensors' device: the CUDA kernel for CUDA tensors,
    `nn1_plain` for CPU tensors.  queries (Q, 3), refs (R, 3) float32,
    mask (R,) bool or None.  Returns (dist (Q,) f32, idx (Q,) int32)."""
    global launches
    if queries.device.type == "cpu":
        return nn1_plain(queries, refs, mask)
    _check(queries.device.type == "cuda",
           f"unsupported device {queries.device}")
    _check(refs.device == queries.device
           and (mask is None or mask.device == queries.device),
           "all inputs must be on one device")
    _check(queries.dtype == torch.float32 and refs.dtype == torch.float32,
           "queries and refs must be float32")
    _check(queries.dim() == 2 and queries.shape[1] == 3 and refs.dim() == 2
           and refs.shape[1] == 3, "expected queries (Q, 3), refs (R, 3)")
    _check(mask is None or (mask.dtype == torch.bool
                            and mask.shape == (refs.shape[0],)),
           "mask must be bool (R,)")
    _check(queries.is_contiguous() and refs.is_contiguous()
           and (mask is None or mask.is_contiguous()),
           "inputs must be contiguous")
    n_q, n_r = queries.shape[0], refs.shape[0]
    _check(n_q < 2 ** 31 // 3 and n_r < 2 ** 31 // 3, "too many points")
    dist = torch.empty(n_q, device=queries.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=queries.device)
    if n_q == 0:
        return dist, idx
    splits, per = _splits(n_q, n_r)
    scratch_d2 = torch.empty(splits, n_q, device=queries.device)
    scratch_idx = torch.empty(splits, n_q, dtype=torch.int32,
                              device=queries.device)
    lib = cuda_build.load("nn1")
    fn = lib.fnc_nn1
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = fn(queries.data_ptr(), refs.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 dist.data_ptr(), idx.data_ptr(), scratch_d2.data_ptr(),
                 scratch_idx.data_ptr(), n_q, n_r, splits, per, stream)
    if err != 0:
        raise RuntimeError(f"nn1 kernel launch failed: CUDA error {err}")
    launches += 1
    return dist, idx
