"""K3, the Fisher squared backward: CUDA kernel wrapper + plain twin.

Counterpart of the JAX package's ops/pallas_fisher.py.  Per (pose, tile)
the result is each slot's sum over the tile's pixels of the squared
gradient w.r.t. [mean_cam x, y, z, opacity] under a uniform cotangent
`grad_value`, over the rows walked before the tile's stop: the first
chunk after which every pixel's transmittance is below 1e-4, or
ceil(nvalid/chunk) chunks.  `fisher_slots_plain` (the twin) computes it
as the Pallas kernel does: a forward walk that records each chunk's
starting transmittance, then a reverse walk over the same chunks that
forms the suffix S_behind.  The CUDA kernel (csrc/fisher.cu) walks front
to back twice instead: the first walk stops the tile and totals
C = sum alpha T csum per pixel, the second forms S_behind = C - run from
the inclusive prefix run; `fisher_one_walk` is that algebra in plain
PyTorch.  `cuda_fisher_slots` runs the kernel for CUDA tensors and the
twin for CPU tensors.

The kernel gives each warp a compact patch of the tile's pixels
(`fisher_warp_pixels`) and skips, per warp, the rows whose conservative
pixel box (`fisher_row_boxes`, the K3-layout form of
ops/cuda_blend.py::row_boxes) misses the patch; a skipped pair has
alpha = 0, so the skip changes no result.

Packed row layout (11 wide): [mu_x, mu_y, con_a, con_b, con_c, opacity,
depth, mc_x, mc_y, mc_z, color sum]; the 20-wide full-chain layout adds
the 9 entries of d(conic)/d(mean_cam), row-major.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_blend import row_boxes, warp_hits

NF = 11
NF_FULL = 20
SATURATED_T = 1e-4
# The kernel's thread -> pixel map: each lane a 2x1 pair, each warp an
# 8x8 patch (csrc/fisher.cu::warp_pixel).
PIXELS_PER_LANE = 2
PIXELS_PER_WARP = 32 * PIXELS_PER_LANE

# Launches of the CUDA kernel (not of the plain twin), and of those the
# launches of its 20-wide (full-chain) variant.
launches = 0
launches_full = 0


def pack_fisher_features(prep, bins, opacities, colors, means_cam,
                         conic_jac=None):
    """(B, T, K, 11|20) slot features from batched preprocess outputs
    (prep fields and means_cam carry a leading pose dimension B; opacities
    (N,) and colors (N, C) are shared).  Colors enter only as their
    channel sum: the cotangent is uniform across channels.  Invalid slots
    get opacity 0, so their alpha is 0 everywhere."""
    nb, n = prep.depth.shape
    parts = [prep.mean2d, prep.conic, opacities[None, :, None].expand(nb, n, 1),
             prep.depth[..., None], means_cam,
             colors.sum(dim=-1, keepdim=True).expand(nb, n, 1)]
    if conic_jac is not None:
        parts.append(conic_jac.reshape(nb, n, 9))
    feat = torch.cat(parts, dim=-1)                          # (B, N, NF)
    table = bins.table                                       # (B, T, K)
    idx = table.reshape(nb, -1, 1).expand(-1, -1, feat.shape[-1])
    packed = torch.gather(feat, 1, idx).reshape(table.shape + feat.shape[-1:])
    packed[..., 5] = packed[..., 5] * bins.slot_valid.to(packed.dtype)
    return packed.contiguous()


def _chunk_alpha(blk, px, py):
    """blk (R, CH, NF); px, py (R, 1, P) -> alpha, g, dx, dy (R, CH, P)."""
    dx = blk[..., 0:1] - px
    dy = blk[..., 1:2] - py
    a, b, c = blk[..., 2:3], blk[..., 3:4], blk[..., 4:5]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    inside = power <= 0.0
    g = torch.exp(torch.where(inside, power, torch.zeros_like(power)))
    alpha = torch.clamp(blk[..., 5:6] * g, max=0.99)
    live = inside & (alpha >= 1.0 / 255.0)
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    g = torch.where(live, g, torch.zeros_like(g))
    return alpha, g, dx, dy


def _slot_rows(blk, alpha, g, dx, dy, t_before, s_b, grad_value: float,
               fx: float, fy: float):
    """Per-slot rows (R, CH, 4): the squared per-pixel gradients w.r.t.
    [mean_cam x, y, z, opacity] summed over the pixels, from per-pair
    alpha, G, dx, dy, T before the pair and S_behind (R, CH, P) of the
    rows blk (R, CH, NF).  A pair that does not blend (alpha = 0) adds
    exactly 0, also where a field of its row is not finite (a NaN opacity
    times a zero dL/dalpha would be NaN), as in the kernel, where such a
    row blends nowhere and is skipped."""
    live = alpha > 0.0
    zero = torch.zeros_like(alpha)
    inv_om = 1.0 / torch.clamp(1.0 - alpha, min=1e-2)
    csum = blk[..., 10:11]
    dl_da = grad_value * (t_before * csum - s_b * inv_om)
    dl_da = torch.where(live, dl_da, zero)
    dl_do = g * dl_da
    dl_dg = blk[..., 5:6] * dl_da
    a, b, c = blk[..., 2:3], blk[..., 3:4], blk[..., 4:5]
    dl_dmx = dl_dg * (-g * (a * dx + b * dy))
    dl_dmy = dl_dg * (-g * (c * dy + b * dx))
    z = torch.clamp(blk[..., 9:10], min=1e-6)
    gx = dl_dmx * (fx / z)
    gy = dl_dmy * (fy / z)
    gz = -(dl_dmx * fx * blk[..., 7:8] + dl_dmy * fy * blk[..., 8:9]) / (z * z)
    if blk.shape[-1] >= NF_FULL:
        t1 = dl_dg * g
        ca = -0.5 * t1 * dx * dx
        cb = -t1 * dx * dy
        cc = -0.5 * t1 * dy * dy
        jc = blk[..., 11:20]
        gx = gx + ca * jc[..., 0:1] + cb * jc[..., 3:4] + cc * jc[..., 6:7]
        gy = gy + ca * jc[..., 1:2] + cb * jc[..., 4:5] + cc * jc[..., 7:8]
        gz = gz + ca * jc[..., 2:3] + cb * jc[..., 5:6] + cc * jc[..., 8:9]
    return torch.stack([torch.where(live, v * v, zero).sum(-1)
                        for v in (gx, gy, gz, dl_do)], dim=-1)


def _fisher_walk(packed, pix_xy, nvalid, chunk: int, grad_value: float,
                 fx: float, fy: float):
    """fisher_slots_plain's body on (R, K, NF) rows (R = B*T, row r uses
    tile r % T); also returns the chunks walked per row (k_eff)."""
    r_rows, k, _nf = packed.shape
    n_tiles = pix_xy.shape[0]
    p = pix_xy.shape[-1]
    dev = packed.device
    pix = pix_xy.repeat(r_rows // n_tiles, 1, 1)             # (R, 2, P)
    px, py = pix[:, 0, None, :], pix[:, 1, None, :]
    n_chunks = torch.clamp((nvalid.long() + chunk - 1) // chunk,
                           max=k // chunk)

    # pass 1: forward walk, chunk-start transmittance, tile-wide stop
    t = torch.ones(r_rows, p, device=dev)
    t_starts = []
    k_eff = torch.zeros(r_rows, dtype=torch.long, device=dev)
    for ci in range(k // chunk):
        live = (ci < n_chunks) & (t.amax(dim=-1) >= SATURATED_T)
        if not bool(live.any()):
            break
        t_starts.append(t)
        k_eff += live.long()
        blk = packed[:, ci * chunk:(ci + 1) * chunk]
        alpha, _g, _dx, _dy = _chunk_alpha(blk, px, py)
        alpha = torch.where(live[:, None, None], alpha, torch.zeros_like(alpha))
        t = t * torch.prod(1.0 - alpha, dim=1)

    # pass 2: reverse walk over the k_eff walked chunks
    h = torch.zeros(r_rows, k, 4, device=dev)
    s_behind = torch.zeros(r_rows, p, device=dev)
    for ci in reversed(range(len(t_starts))):
        act = (ci < k_eff)[:, None, None]
        blk = packed[:, ci * chunk:(ci + 1) * chunk]
        alpha, g, dx, dy = _chunk_alpha(blk, px, py)
        alpha = torch.where(act, alpha, torch.zeros_like(alpha))
        g = torch.where(act, g, torch.zeros_like(g))
        one_minus = 1.0 - alpha
        cum = torch.cumprod(one_minus, dim=1)
        cum_excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        t_before = t_starts[ci][:, None, :] * cum_excl
        csum = blk[..., 10:11]
        contrib = alpha * t_before * csum
        suffix_inc = torch.flip(torch.cumsum(torch.flip(contrib, [1]), 1), [1])
        s_b = (suffix_inc - contrib) + s_behind[:, None, :]

        h[:, ci * chunk:(ci + 1) * chunk] = _slot_rows(
            blk, alpha, g, dx, dy, t_before, s_b, grad_value, fx, fy)
        s_behind = s_behind + contrib.sum(dim=1)
    return h, k_eff


def fisher_slots_plain(packed, pix_xy, nvalid, chunk: int, grad_value: float,
                       fx: float, fy: float):
    """Plain PyTorch twin of the K3 kernel.

    packed (B, T, K, 11|20) f32; pix_xy (T, 2, P) f32; nvalid (B, T) int.
    Returns per-slot Hessian rows (B, T, K, 4) aligned with the table."""
    nb, n_tiles, k, nf = packed.shape
    h, _k_eff = _fisher_walk(packed.reshape(nb * n_tiles, k, nf), pix_xy,
                             nvalid.reshape(-1), chunk, grad_value, fx, fy)
    return h.reshape(nb, n_tiles, k, 4)


def fisher_one_walk(packed, pix_xy, nvalid, chunk: int, grad_value: float,
                    fx: float, fy: float):
    """The kernel's algebra in plain PyTorch: `fisher_slots_plain`'s
    function by two forward walks over the rows below nvalid.  Walk 1
    carries T, stops the tile after the first chunk that leaves every
    pixel's T below 1e-4 and totals C = sum alpha T csum per pixel; walk 2
    takes the same rows with run = the inclusive prefix of that sum and
    S_behind = C - run, where C is run's last value (the kernel's two
    walks add in the same order, so C - run cancels only the suffix's own
    rounding).  Same arguments and output as `fisher_slots_plain`."""
    nb, n_tiles, k, nf = packed.shape
    rows = packed.reshape(nb * n_tiles, k, nf)
    pix = pix_xy.repeat(nb, 1, 1)                            # (R, 2, P)
    alpha, g, dx, dy = _chunk_alpha(rows, pix[:, 0, None, :],
                                    pix[:, 1, None, :])      # (R, K, P)
    kk = torch.arange(k, device=packed.device)
    nv = torch.clamp(nvalid.reshape(-1).long(), max=k)
    zero = torch.zeros_like(alpha)
    alpha = torch.where((kk[None, :] < nv[:, None])[..., None], alpha, zero)

    # walk 1: T after each row; chunk m is walked iff m < ceil(nv / chunk)
    # and every chunk before it left some pixel at T >= 1e-4
    t_after = torch.cumprod(1.0 - alpha, dim=1)
    t_before = torch.cat([torch.ones_like(t_after[:, :1]), t_after[:, :-1]],
                         dim=1)
    still_open = t_after[:, chunk - 1::chunk].amax(dim=-1) >= SATURATED_T
    reached = torch.cat([torch.ones_like(still_open[:, :1]),
                         still_open[:, :-1]], dim=1).long().cumprod(dim=1)
    n_chunks = (nv + chunk - 1) // chunk
    m = torch.arange(k // chunk, device=packed.device)
    k_eff = ((reached > 0) & (m[None, :] < n_chunks[:, None])).sum(dim=1)
    walked = (kk[None, :] < (k_eff * chunk)[:, None])[..., None]
    alpha = torch.where(walked, alpha, zero)
    g = torch.where(walked, g, zero)

    # walk 2: S_behind = C - run
    run = torch.cumsum(alpha * t_before * rows[..., 10:11], dim=1)
    s_b = run[:, -1:, :] - run
    h = _slot_rows(rows, alpha, g, dx, dy, t_before, s_b, grad_value, fx, fy)
    return h.reshape(nb, n_tiles, k, 4)


def fisher_row_boxes(packed):
    """(..., K, 4) conservative pixel box [x0, x1, y0, y1] of each K3 row's
    blend region (csrc/fisher.cu calls blend_common.cuh::row_box with no
    valid column): every pixel at which `_chunk_alpha` gives alpha > 0
    lies inside; empty for opacity below 1/255, so for invalid rows."""
    return row_boxes(packed, valid_column=False)


def fisher_warp_pixels(p: int):
    """(P // 64, 64) long: the pixel indices (into a tile's P pixels,
    row-major at a tile width of 32 for P >= 512 and 16 for P = 256) that
    each warp of the kernel walks, lane-major, 2 per lane.  A lane holds a
    2x1 pair and a warp 4 x 8 pairs, an 8x8 patch; the patches tile the
    tile row-major (csrc/fisher.cu::warp_pixel)."""
    tw = 32 if p >= 512 else 16
    per_row = tw // 8
    warp = torch.arange(p // PIXELS_PER_WARP)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    i = torch.arange(PIXELS_PER_LANE)[None, None, :]
    x = (warp % per_row) * 8 + (lane % 4) * 2 + i
    y = (warp // per_row) * 8 + lane // 4 + 0 * i
    return (y * tw + x).reshape(-1, PIXELS_PER_WARP)


def fisher_warp_hits(boxes, pix_xy):
    """(R, K, P // 64) bool: does row k's box reach the pixel range of the
    patch that warp w walks?  boxes (R, K, 4), pix_xy (R, 2, P)."""
    perm = fisher_warp_pixels(pix_xy.shape[-1]).reshape(-1)
    return warp_hits(boxes, pix_xy[..., perm.to(pix_xy.device)],
                     PIXELS_PER_WARP)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"cuda_fisher_slots: {msg}")


def cuda_fisher_slots(packed, pix_xy, nvalid, chunk: int, grad_value: float,
                      fx: float, fy: float):
    """K3 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors.  Same arguments and outputs as
    `fisher_slots_plain`; an NF of 20 selects the full-chain variant."""
    global launches, launches_full
    if packed.device.type == "cpu":
        return fisher_slots_plain(packed, pix_xy, nvalid, chunk, grad_value,
                                  fx, fy)
    _check(packed.device.type == "cuda", f"unsupported device {packed.device}")
    _check(pix_xy.device == packed.device and nvalid.device == packed.device,
           "all inputs must be on one device")
    _check(packed.dtype == torch.float32 and pix_xy.dtype == torch.float32,
           "packed and pix_xy must be float32")
    _check(nvalid.dtype == torch.int32, "nvalid must be int32")
    _check(packed.dim() == 4 and pix_xy.dim() == 3 and nvalid.dim() == 2,
           "expected packed (B, T, K, NF), pix_xy (T, 2, P), nvalid (B, T)")
    nb, n_tiles, k, nf = packed.shape
    p = pix_xy.shape[-1]
    _check(nf in (NF, NF_FULL), f"NF {nf}; the kernel takes 11 or 20")
    _check(pix_xy.shape == (n_tiles, 2, p) and nvalid.shape == (nb, n_tiles),
           "tile counts disagree")
    _check(p in (256, 512, 1024), f"{p} pixels per tile; the kernel takes "
           "256, 512 or 1024")
    _check(0 < chunk and k % chunk == 0, f"chunk {chunk} must divide K {k}")
    # the tile's rows at a float4 stride, a chunk of boxes and the warps'
    # ballots of the rows that blend
    warps = p // PIXELS_PER_WARP
    smem = (16 * (k * ((nf + 3) // 4) + chunk)
            + 4 * warps * (k // chunk) * ((chunk + 31) // 32))
    _check(smem <= 227 * 1024, f"{smem} bytes of shared memory")
    _check(packed.is_contiguous() and pix_xy.is_contiguous()
           and nvalid.is_contiguous(), "inputs must be contiguous")
    h = torch.empty(nb, n_tiles, k, 4, device=packed.device)
    if nb * n_tiles == 0:
        return h
    # each warp's per-row sums over its patch, added in warp order at the end
    sums = torch.empty(nb * n_tiles, warps, k, 4, device=packed.device)
    lib = cuda_build.load("fisher")
    fn = lib.fnc_fisher
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(packed.data_ptr(), pix_xy.data_ptr(), nvalid.data_ptr(),
                 sums.data_ptr(), h.data_ptr(), nb * n_tiles, n_tiles, k, nf,
                 p, chunk, float(grad_value), float(fx), float(fy), stream)
    if err != 0:
        raise RuntimeError(f"fisher kernel launch failed: CUDA error {err}")
    launches += 1
    launches_full += nf == NF_FULL
    return h
