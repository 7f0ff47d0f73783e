"""K1, the per-tile forward alpha blend: CUDA kernel wrapper + plain twin.

Counterpart of the JAX package's ops/pallas_blend.py.  The kernel
(csrc/blend.cu) walks each tile's packed slot rows front to back in
depth chunks and stops a tile once every pixel's transmittance is below
1e-4, checked after each chunk, or at ceil(nvalid/chunk)*chunk rows.
`blend_plain` is the same function in plain PyTorch with the same
chunk-granular early stop and `nvalid` bound.  `cuda_blend` runs the
kernel for CUDA tensors and the plain twin's walk (`_blend_walk`) for
CPU tensors; it also returns the rows walked per tile (the stop), which
the backward (ops/cuda_blend_bwd.py) reads.

Both CUDA blend kernels skip, per warp, the rows whose blend region
cannot reach the warp's pixels: `row_boxes` is the plain form of the
kernels' conservative pixel box (csrc/blend_common.cuh::row_box) and
`warp_hits` of their per-warp test.  A pair outside its row's box has
alpha = 0, so the skip changes no result.

Packed row layout: [mu_x, mu_y, con_a, con_b, con_c, opacity, depth,
valid, color_0..C-1].
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

BASE_F = 8
SATURATED_T = 1e-4
ALPHA_MIN = 1.0 / 255.0
WARP = 32

# Launches of the CUDA kernel (not of the plain twin).
launches = 0


def _pair_alpha(blk, px, py):
    """blk (T, CH, F) packed rows; px, py (T, 1, P) -> alpha, G, dx, dy
    (T, CH, P), alpha and G zero where the pair does not blend (outside
    the ellipse, an invalid row, or alpha below 1/255)."""
    dx = blk[..., 0:1] - px
    dy = blk[..., 1:2] - py
    a, b, c = blk[..., 2:3], blk[..., 3:4], blk[..., 4:5]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    inside = power <= 0.0
    g = torch.exp(torch.where(inside, power, torch.zeros_like(power)))
    alpha = torch.clamp(blk[..., 5:6] * g, max=0.99)
    live = inside & (blk[..., 7:8] > 0.5) & (alpha >= ALPHA_MIN)
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    g = torch.where(live, g, torch.zeros_like(g))
    return alpha, g, dx, dy


def row_boxes(packed, valid_column: bool = True):
    """Conservative pixel box [x0, x1, y0, y1] (T, K, 4) of each row's
    blend region, the kernels' `row_box` in float32: every pixel at which
    `_pair_alpha` gives alpha > 0 lies inside.  From alpha >= 1/255 <=>
    d^T Q d <= r2 = 2 ln(255 opacity), Q = [[a, b], [b, c]]: half-widths
    r sqrt(c/det), r sqrt(a/det), widened by 1 % in r2, 0.5 % in each
    half-width, 0.01 pixel and 1e-6 |mu| against float rounding.  Infinite
    where the region is unbounded (det <= 0, a <= 0) or too elongated
    (a c > 1000 det); empty for an invalid row or opacity below 1/255.
    With `valid_column` False the rows have no valid column (K3's layout,
    where an invalid row has opacity 0)."""
    mx, my = packed[..., 0], packed[..., 1]
    a, b, c = packed[..., 2], packed[..., 3], packed[..., 4]
    op = packed[..., 5]
    valid = packed[..., 7] if valid_column else torch.ones_like(op)
    det = a * c - b * b
    r2 = torch.clamp(2.0 * torch.log(255.0 * op), min=0.0) * 1.01 + 1e-5
    hx = torch.sqrt(r2 * c / det) * 1.005 + 1e-2 + 1e-6 * mx.abs()
    hy = torch.sqrt(r2 * a / det) * 1.005 + 1e-2 + 1e-6 * my.abs()
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], dim=-1)
    inf = float("inf")
    bounded = (det > 0) & (a > 0) & (a * c <= 1000.0 * det)
    box = torch.where(bounded[..., None], box,
                      box.new_tensor([-inf, inf, -inf, inf]))
    live = (valid > 0.5) & (op * 1.0001 >= ALPHA_MIN)
    return torch.where(live[..., None], box,
                       box.new_tensor([inf, -inf, inf, -inf]))


def warp_hits(boxes, pix_xy, warp_pixels: int = WARP):
    """(T, K, P // warp_pixels) bool: does row k's box reach the pixel
    range (min and max of the coordinates) of the w-th group of
    `warp_pixels` consecutive pixels, the pixels one warp walks?"""
    n_tiles, _two, p = pix_xy.shape
    grp = pix_xy.reshape(n_tiles, 2, p // warp_pixels, warp_pixels)
    lo, hi = grp.amin(dim=-1), grp.amax(dim=-1)        # (T, 2, W)
    bx = boxes[:, :, None, :]                          # (T, K, 1, 4)
    return ((bx[..., 1] >= lo[:, None, 0]) & (bx[..., 0] <= hi[:, None, 0])
            & (bx[..., 3] >= lo[:, None, 1]) & (bx[..., 2] <= hi[:, None, 1]))


def _blend_walk(packed, pix_xy, nvalid, chunk: int, max_depth: float):
    """blend_plain's body; also returns the rows walked per tile."""
    n_tiles, k, f = packed.shape
    p = pix_xy.shape[-1]
    cch = f - BASE_F
    dev = packed.device
    px = pix_xy[:, 0, None, :]                               # (T, 1, P)
    py = pix_xy[:, 1, None, :]
    k_lim = torch.clamp((nvalid + chunk - 1) // chunk * chunk, max=k)
    t = torch.ones(n_tiles, p, device=dev)
    acc = torch.zeros(n_tiles, p, cch, device=dev)
    med = torch.zeros(n_tiles, p, device=dev)
    has_med = torch.zeros(n_tiles, p, dtype=torch.bool, device=dev)
    walked = torch.zeros(n_tiles, dtype=torch.long, device=dev)
    for k0 in range(0, k, chunk):
        live = (k0 < k_lim) & (t.amax(dim=-1) >= SATURATED_T)  # (T,)
        if not bool(live.any()):
            break
        walked += live.long() * chunk
        blk = packed[:, k0:k0 + chunk]                       # (T, CH, F)
        alpha, _g, _dx, _dy = _pair_alpha(blk, px, py)       # (T, CH, P)
        alpha = torch.where(live[:, None, None], alpha, torch.zeros_like(alpha))

        one_minus = 1.0 - alpha
        cum = torch.cumprod(one_minus, dim=1)
        cum_excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        t_before = t[:, None, :] * cum_excl
        w = alpha * t_before
        acc = acc + torch.einsum("tkp,tkc->tpc", w, blk[..., BASE_F:])

        t_after = t_before * one_minus
        crossing = (t_before > 0.5) & (t_after < 0.5) & (alpha > 0.0)
        dep = blk[..., 6:7].expand_as(crossing)
        dep_cross = torch.where(crossing, dep,
                                torch.full_like(dep, -1e30)).amax(dim=1)
        any_cross = crossing.any(dim=1)
        med = torch.where(~has_med & any_cross, dep_cross, med)
        has_med = has_med | any_cross
        t = t * cum[:, -1]
    med = torch.where(has_med, med, torch.full_like(med, max_depth))
    return (acc, t, med), walked


def blend_plain(packed, pix_xy, nvalid, chunk: int, max_depth: float = 15.0):
    """Plain PyTorch twin of the K1 kernel.

    packed (T, K, 8+C) f32; pix_xy (T, 2, P) f32; nvalid (T,) int.
    Returns (color (T, P, C), final_t (T, P), med_depth (T, P))."""
    out, _walked = _blend_walk(packed, pix_xy, nvalid, chunk, max_depth)
    return out


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"cuda_blend: {msg}")


def cuda_blend(packed, pix_xy, nvalid, chunk: int, max_depth: float = 15.0):
    """K1 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors.  Same arguments as `blend_plain`; returns
    its outputs and the rows walked per tile (T,), chunks entered times
    chunk: ((color, final_t, med_depth), walked), walked int32 from the
    kernel and int64 from the twin (`_blend_walk`)."""
    global launches
    if packed.device.type == "cpu":
        return _blend_walk(packed, pix_xy, nvalid, chunk, max_depth)
    _check(packed.device.type == "cuda", f"unsupported device {packed.device}")
    _check(pix_xy.device == packed.device and nvalid.device == packed.device,
           "all inputs must be on one device")
    _check(packed.dtype == torch.float32 and pix_xy.dtype == torch.float32,
           "packed and pix_xy must be float32")
    _check(nvalid.dtype == torch.int32, "nvalid must be int32")
    _check(packed.dim() == 3 and pix_xy.dim() == 3 and nvalid.dim() == 1,
           "expected packed (T, K, F), pix_xy (T, 2, P), nvalid (T,)")
    n_tiles, k, f = packed.shape
    p = pix_xy.shape[-1]
    cch = f - BASE_F
    _check(pix_xy.shape == (n_tiles, 2, p) and nvalid.shape == (n_tiles,),
           "tile counts disagree")
    _check(1 <= cch <= 8, f"{cch} channels; the kernel takes 1 to 8")
    _check(1 <= p <= 1024 and p % 32 == 0, f"{p} pixels per tile")
    _check(0 < chunk and k % chunk == 0, f"chunk {chunk} must divide K {k}")
    sub = 64 if chunk % 64 == 0 else chunk             # rows staged at once
    smem = 4 * (2 * sub * ((f + 3) // 4 * 4) + 4 * sub)
    _check(smem <= 227 * 1024, f"{smem} bytes of shared memory")
    _check(packed.is_contiguous() and pix_xy.is_contiguous()
           and nvalid.is_contiguous(), "inputs must be contiguous")
    color = torch.empty(n_tiles, p, cch, device=packed.device)
    final_t = torch.empty(n_tiles, p, device=packed.device)
    med = torch.empty(n_tiles, p, device=packed.device)
    walked = torch.empty(n_tiles, dtype=torch.int32, device=packed.device)
    if n_tiles == 0:
        return (color, final_t, med), walked
    lib = cuda_build.load("blend")
    fn = lib.fnc_blend
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(packed.data_ptr(), pix_xy.data_ptr(), nvalid.data_ptr(),
                 color.data_ptr(), final_t.data_ptr(), med.data_ptr(),
                 walked.data_ptr(), n_tiles, k, cch, p, chunk,
                 float(max_depth), stream)
    if err != 0:
        raise RuntimeError(f"blend kernel launch failed: CUDA error {err}")
    launches += 1
    return (color, final_t, med), walked
