"""K2, the blend backward: CUDA kernel wrapper + plain twin.

Counterpart of the JAX package's ops/pallas_blend_bwd.py: the analytic
power-1 VJP of the K1 tile blend, per slot.  Given the cotangents of the
blended color `gcol (T, P, C)` and of the final transmittance
`g_t (T, P)`, the kernel (csrc/blend_bwd.cu) returns per-slot gradients
(T, K, 6+C) = [d mu_x, d mu_y, d con_a, d con_b, d con_c, d opacity,
d color_0..C-1], each summed over the tile's P pixels:

  cg_i        = sum_c color_i,c gcol_c           (per pixel)
  dL/dalpha_i = T_i cg_i - (S_behind,i + g_t T_final) / max(1 - alpha_i, 1e-2)
  S_behind,i  = sum_{j > i} alpha_j T_j cg_j
  dL/dopac_i  = G_i dL/dalpha_i,  dL/dG_i = opac_i dL/dalpha_i,
  dL/dcolor_i = alpha_i T_i gcol,

with the JAX package's conventions: the 0.99 alpha clamp does not gate
the gradient, dL/dalpha is 0 where alpha is 0, and slots past the
forward's stop (every pixel's T below 1e-4 after a chunk, K1's rule) or
past `nvalid` give 0.  The packed rows are K1's (layout in
ops/cuda_blend.py), so the forward and the backward share one gather.
`blend_bwd_plain` is the same function in plain PyTorch;
`cuda_blend_bwd` runs the kernel for CUDA tensors and the plain twin for
CPU tensors.

The probe-batched variant `cuda_blend_bwd_probes` (twin
`blend_bwd_probes_plain`) takes B cotangents of one forward, gcol
(B, T, P, C) and g_t (B, T, P), and returns (B, T, K, 6+C) in one
launch: the Hutchinson estimators' probes through one VJP
(ops/fisher.py), which the JAX package runs as jax.vmap over its Pallas
VJP.  Each probe's rows equal a lone `cuda_blend_bwd` launch on that
probe, to the bit.

The kernel walks each tile once and takes what the twin's first pass and
suffix sums compute from K1's outputs: the stop from the rows walked,
g_t T_final from the final T, and S_behind,i = gcol . C_final - run_i
with run_i = sum_{j <= i} alpha_j T_j cg_j and C_final K1's color
without the background.  `blend_bwd_one_walk` is that algebra in plain
PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_blend import BASE_F, SATURATED_T, _pair_alpha

# Launches of the CUDA kernel (not of the plain twin), and of its
# probe-batched variant, counted apart.
launches = 0
launches_probes = 0
# The kernel gives each pixel two lanes, so a warp walks 16 pixels.
PIXELS_PER_WARP = 16


def _slot_grads(blk, alpha, g, dx, dy, dl_da, w, gcol):
    """Per-slot sums over the tile's pixels (..., T, CH, 6+C) from per-pair
    alpha, G, dx, dy, dL/dalpha and weight w = alpha T (T, CH, P); dl_da
    (..., T, CH, P) and gcol (..., T, P, C) may carry a leading batch."""
    dl_dg = blk[..., 5:6] * dl_da
    a, b, c = blk[..., 2:3], blk[..., 3:4], blk[..., 4:5]
    t1 = dl_dg * g
    return torch.cat([
        torch.stack([
            (-t1 * (a * dx + b * dy)).sum(-1),
            (-t1 * (c * dy + b * dx)).sum(-1),
            (-0.5 * t1 * dx * dx).sum(-1),
            (-t1 * dx * dy).sum(-1),
            (-0.5 * t1 * dy * dy).sum(-1),
            (g * dl_da).sum(-1)], dim=-1),
        torch.einsum("tkp,...tpc->...tkc", w, gcol)], dim=-1)


def blend_bwd_plain(packed, pix_xy, gcol, g_t, nvalid, chunk: int):
    """Plain PyTorch twin of the K2 kernel.

    packed (T, K, 8+C) f32; pix_xy (T, 2, P) f32; gcol (T, P, C) f32;
    g_t (T, P) f32; nvalid (T,) int.  Returns (T, K, 6+C)."""
    return blend_bwd_probes_plain(packed, pix_xy, gcol[None], g_t[None],
                                  nvalid, chunk)[0]


def blend_bwd_probes_plain(packed, pix_xy, gcol, g_t, nvalid, chunk: int):
    """Plain PyTorch twin of the probe-batched K2: `blend_bwd_plain` for
    each of B cotangents of one forward, gcol (B, T, P, C) and g_t
    (B, T, P).  Returns (B, T, K, 6+C)."""
    n_tiles, k, f = packed.shape
    p = pix_xy.shape[-1]
    nb = gcol.shape[0]
    cch = f - BASE_F
    dev = packed.device
    px = pix_xy[:, 0, None, :]                               # (T, 1, P)
    py = pix_xy[:, 1, None, :]
    n_chunks = torch.clamp((nvalid.long() + chunk - 1) // chunk,
                           max=k // chunk)

    # pass 1: forward walk, chunk-start T, tile-wide stop (K1's rule)
    t = torch.ones(n_tiles, p, device=dev)
    t_starts = []
    k_eff = torch.zeros(n_tiles, dtype=torch.long, device=dev)
    for ci in range(k // chunk):
        live = (ci < n_chunks) & (t.amax(dim=-1) >= SATURATED_T)
        if not bool(live.any()):
            break
        t_starts.append(t)
        k_eff += live.long()
        alpha, _g, _dx, _dy = _pair_alpha(
            packed[:, ci * chunk:(ci + 1) * chunk], px, py)
        alpha = torch.where(live[:, None, None], alpha, torch.zeros_like(alpha))
        t = t * torch.prod(1.0 - alpha, dim=1)
    gtf = g_t * t                                            # (B, T, P)

    # pass 2: reverse walk over the walked chunks, each on the tiles that
    # walked it (the others' rows stay 0 and their S_behind unchanged)
    out = torch.zeros(nb, n_tiles, k, 6 + cch, device=dev)
    s_behind = torch.zeros(nb, n_tiles, p, device=dev)
    for ci in reversed(range(len(t_starts))):
        sel = torch.nonzero(ci < k_eff).flatten()
        blk = packed[sel, ci * chunk:(ci + 1) * chunk]
        alpha, g, dx, dy = _pair_alpha(blk, px[sel], py[sel])
        one_minus = 1.0 - alpha
        cum = torch.cumprod(one_minus, dim=1)
        cum_excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        t_before = t_starts[ci][sel, None, :] * cum_excl     # (S, CH, P)
        w = alpha * t_before
        gc = gcol[:, sel]
        cg = torch.einsum("tkc,btpc->btkp", blk[..., BASE_F:], gc)
        contrib = w * cg                                     # (B, S, CH, P)
        suffix_inc = torch.flip(torch.cumsum(torch.flip(contrib, [2]), 2), [2])
        s_b = (suffix_inc - contrib) + s_behind[:, sel, None, :]

        inv_om = 1.0 / torch.clamp(one_minus, min=1e-2)
        dl_da = t_before * cg - (s_b + gtf[:, sel, None, :]) * inv_om
        dl_da = torch.where(alpha > 0.0, dl_da, torch.zeros_like(dl_da))
        out[:, sel, ci * chunk:(ci + 1) * chunk] = _slot_grads(
            blk, alpha, g, dx, dy, dl_da, w, gc)
        s_behind[:, sel] = s_behind[:, sel] + contrib.sum(dim=2)
    return out


def blend_bwd_one_walk(packed, pix_xy, gcol, g_t, nvalid, color, t_final,
                       walked):
    """The kernel's one-walk algebra in plain PyTorch: `blend_bwd_plain`'s
    function, computed from K1's outputs (color without background
    (T, P, C), final T (T, P), rows walked (T,)) in a single front-to-back
    pass over the rows below min(walked, nvalid)."""
    n_tiles, k, f = packed.shape
    px = pix_xy[:, 0, None, :]                               # (T, 1, P)
    py = pix_xy[:, 1, None, :]
    alpha, g, dx, dy = _pair_alpha(packed, px, py)           # (T, K, P)
    n_walk = torch.minimum(walked.long(), nvalid.long())
    rows = torch.arange(k, device=packed.device)[None, :] < n_walk[:, None]
    alpha = torch.where(rows[..., None], alpha, torch.zeros_like(alpha))
    g = torch.where(rows[..., None], g, torch.zeros_like(g))
    one_minus = 1.0 - alpha
    cum = torch.cumprod(one_minus, dim=1)
    t_before = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    w = alpha * t_before
    cg = torch.einsum("tkc,tpc->tkp", packed[..., BASE_F:], gcol)
    run = torch.cumsum(w * cg, dim=1)                        # inclusive
    s_b = (gcol * color).sum(-1)[:, None, :] - run
    gtf = (g_t * t_final)[:, None, :]
    inv_om = 1.0 / torch.clamp(one_minus, min=1e-2)
    dl_da = t_before * cg - (s_b + gtf) * inv_om
    dl_da = torch.where(alpha > 0.0, dl_da, torch.zeros_like(dl_da))
    return _slot_grads(packed, alpha, g, dx, dy, dl_da, w, gcol)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"cuda_blend_bwd: {msg}")


def cuda_blend_bwd(packed, pix_xy, gcol, g_t, nvalid, chunk: int, *,
                   color=None, t_final=None, walked=None):
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors.  Same arguments and output as
    `blend_bwd_plain`; the kernel also needs K1's outputs on these rows
    (`cuda_blend`): `color` (T, P, C) without background, `t_final`
    (T, P) and `walked` (T,) int32, which the twin does not read."""
    global launches
    if packed.device.type == "cpu":
        return blend_bwd_plain(packed, pix_xy, gcol, g_t, nvalid, chunk)
    out = _launch("fnc_blend_bwd", packed, pix_xy, gcol[None], g_t[None],
                  nvalid, chunk, color, t_final, walked)[0]
    launches += 1
    return out


def cuda_blend_bwd_probes(packed, pix_xy, gcol, g_t, nvalid, chunk: int, *,
                          color=None, t_final=None, walked=None):
    """The probe-batched K2 on the tensors' device: B cotangents of one
    forward, gcol (B, T, P, C) and g_t (B, T, P), through one launch of
    the CUDA kernel for CUDA tensors, or the plain twin
    `blend_bwd_probes_plain` for CPU tensors.  K1's outputs as for
    `cuda_blend_bwd`.  Returns (B, T, K, 6+C)."""
    global launches_probes
    if packed.device.type == "cpu":
        return blend_bwd_probes_plain(packed, pix_xy, gcol, g_t, nvalid,
                                      chunk)
    out = _launch("fnc_blend_bwd_probes", packed, pix_xy, gcol, g_t, nvalid,
                  chunk, color, t_final, walked)
    launches_probes += 1
    return out


def _launch(fn_name, packed, pix_xy, gcol, g_t, nvalid, chunk, color,
            t_final, walked):
    """Check the inputs (gcol (B, T, P, C), g_t (B, T, P)) and launch the
    kernel on B probes; returns (B, T, K, 6+C)."""
    _check(packed.device.type == "cuda", f"unsupported device {packed.device}")
    _check(color is not None and t_final is not None and walked is not None,
           "the kernel needs K1's color, t_final and walked")
    ins = (pix_xy, gcol, g_t, nvalid, color, t_final, walked)
    _check(all(x.device == packed.device for x in ins),
           "all inputs must be on one device")
    _check(all(x.dtype == torch.float32
               for x in (packed, pix_xy, gcol, g_t, color, t_final)),
           "packed, pix_xy, gcol, g_t, color and t_final must be float32")
    _check(nvalid.dtype == torch.int32 and walked.dtype == torch.int32,
           "nvalid and walked must be int32")
    _check(packed.dim() == 3 and pix_xy.dim() == 3,
           "expected packed (T, K, F) and pix_xy (T, 2, P)")
    n_tiles, k, f = packed.shape
    p = pix_xy.shape[-1]
    cch = f - BASE_F
    nb = gcol.shape[0]
    _check(pix_xy.shape == (n_tiles, 2, p)
           and gcol.shape == (nb, n_tiles, p, cch)
           and g_t.shape == (nb, n_tiles, p) and nvalid.shape == (n_tiles,)
           and color.shape == gcol.shape[1:] and t_final.shape == g_t.shape[1:]
           and walked.shape == nvalid.shape,
           "expected gcol (B, T, P, C), g_t (B, T, P), color (T, P, C), "
           "t_final (T, P), nvalid and walked (T,)")
    _check(1 <= nb <= 65535, f"{nb} probes; the kernel takes 1 to 65535")
    _check(1 <= cch <= 8, f"{cch} channels; the kernel takes 1 to 8")
    # a tile's 2 P lanes over the fewest blocks, at least 2, of at most
    # 256 threads, all in one thread-block cluster (at most 8 blocks)
    splits = max(2, 2 * p // 256)
    threads = 2 * p // splits
    _check(splits <= 8 and threads * splits == 2 * p and threads % 32 == 0
           and threads <= 256,
           f"{p} pixels per tile do not split into at most 8 blocks of "
           f"whole warps of at most 256 threads")
    _check(0 < chunk and k % chunk == 0, f"chunk {chunk} must divide K {k}")
    warps = threads // 32
    smem = 4 * (2 * 64 * ((f + 3) // 4 * 4) + 4 * 64
                + (k + warps * 64) * (6 + cch))
    _check(smem <= 227 * 1024, f"{smem} bytes of shared memory")
    _check(packed.is_contiguous() and all(x.is_contiguous() for x in ins),
           "inputs must be contiguous")
    out = torch.empty(nb, n_tiles, k, 6 + cch, device=packed.device)
    if n_tiles == 0:
        return out
    lib = cuda_build.load("blend_bwd")
    fn = getattr(lib, fn_name)
    batched = fn_name == "fnc_blend_bwd_probes"
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * (
        6 if batched else 5) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dims = ((nb,) if batched else ()) + (n_tiles, k, cch, p, splits)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(packed.data_ptr(), pix_xy.data_ptr(), gcol.data_ptr(),
                 g_t.data_ptr(), nvalid.data_ptr(), color.data_ptr(),
                 t_final.data_ptr(), walked.data_ptr(), out.data_ptr(),
                 *dims, stream)
    if err != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed: CUDA error {err}")
    return out
