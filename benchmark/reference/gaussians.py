"""Plain PyTorch reference of the 3D Gaussian render, its mapping loss and
the live-pair count that the rooflines divide by.

A frozen copy of the plain path that the port's render follows
(projection, static-shape tile binning with the per-tile nearest-K cut,
the chunked front-to-back blend that stops a tile once every pixel's
transmittance is below 1e-4, the RGB-D loss with its 11x11 SSIM), written
out again here so that a later change to the port cannot move the
yardstick.  It imports nothing of the port.  Every function follows the
dtype of its inputs: the float32 call is the reference, the bfloat16 call
is the control that the comparison has to reject.

Gradients are taken by autograd through the blend, with the port's
custom-backward conventions written into the forward: the 0.99 alpha
clamp passes the gradient straight through, and the packed depth column
(the median-depth latch) carries none.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

ALPHA_MIN = 1.0 / 255.0
SATURATED_T = 1e-4
NEG_INF = float("-inf")


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    near: float = 0.2
    dilation: float = 0.3


# -- projection --------------------------------------------------------------
def _quat_rot(quats):
    w, x, y, z = quats.unbind(-1)
    inv = 1.0 / torch.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w * inv, x * inv, y * inv, z * inv
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))


def cov3d_cols(scales, quats):
    """Sigma = R diag(s^2) R^T as [xx, xy, xz, yy, yz, zz]."""
    r = _quat_rot(quats)
    s = [scales[..., i] * scales[..., i] for i in range(3)]

    def entry(i, j):
        return s[0] * r[i][0] * r[j][0] + s[1] * r[i][1] * r[j][1] \
            + s[2] * r[i][2] * r[j][2]
    return (entry(0, 0), entry(0, 1), entry(0, 2), entry(1, 1), entry(1, 2),
            entry(2, 2))


class Projected(NamedTuple):
    mean2d: torch.Tensor
    conic: torch.Tensor
    depth: torch.Tensor
    radius: torch.Tensor
    valid: torch.Tensor


def project(means_cam, scales, quats, cam: Camera, active=None) -> Projected:
    """EWA projection with the fov clamp, the 3-sigma screen radius and
    the in-front / positive-determinant / on-screen culling."""
    x, y, zr = means_cam.unbind(-1)
    z = torch.maximum(zr, zr.new_tensor(1e-6))
    limx = 1.3 * cam.width / (2.0 * cam.fx)
    limy = 1.3 * cam.height / (2.0 * cam.fy)
    tx = torch.minimum(torch.maximum(x / z, z.new_tensor(-limx)),
                       z.new_tensor(limx)) * z
    ty = torch.minimum(torch.maximum(y / z, z.new_tensor(-limy)),
                       z.new_tensor(limy)) * z
    j00, j02 = cam.fx / z, -cam.fx * tx / (z * z)
    j11, j12 = cam.fy / z, -cam.fy * ty / (z * z)
    c0, c1, c2, c3, c4, c5 = cov3d_cols(scales, quats)
    a = j00 * (c0 * j00 + c2 * j02) + j02 * (c2 * j00 + c5 * j02) \
        + cam.dilation
    b = j11 * (c1 * j00 + c4 * j02) + j12 * (c2 * j00 + c5 * j02)
    c = j11 * (c3 * j11 + c4 * j12) + j12 * (c4 * j11 + c5 * j12) \
        + cam.dilation
    det = a * c - b * b
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(
        mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))))
    u = cam.fx * x / z + cam.cx - 0.5
    v = cam.fy * y / z + cam.cy - 0.5
    on_screen = ((u + radius >= 0) & (u - radius < cam.width)
                 & (v + radius >= 0) & (v - radius < cam.height))
    valid = (zr > cam.near) & det_ok & on_screen
    if active is not None:
        valid = valid & active
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Projected(torch.stack([u, v], dim=-1), conic, zr, radius, valid)


# -- tile binning -------------------------------------------------------------
def _nearest_k(scores, k: int):
    """Per-row top-k of scores (higher = nearer): ties at the k-th value
    broken by the lowest index; rows come out score-descending, index
    ascending."""
    n = scores.shape[-1]
    if n < k:
        scores = torch.cat([scores, scores.new_full(
            scores.shape[:-1] + (k - n,), NEG_INF)], dim=-1)
    m = scores.shape[-1]
    vals, idx = torch.topk(scores, k, dim=-1, sorted=True)
    v = vals[..., -1:]
    n_above = (vals > v).sum(dim=-1, keepdim=True)
    rev = torch.arange(m, 0, -1, dtype=torch.int32, device=scores.device)
    tie_idx = torch.topk(torch.where(scores == v, rev, torch.zeros_like(rev)),
                         k, dim=-1, sorted=True).indices
    pos = torch.arange(k, device=scores.device)
    idx = torch.where(pos < n_above, idx, torch.gather(
        tie_idx, -1, torch.clamp(pos - n_above, min=0)))
    idx, _ = torch.sort(idx, dim=-1)
    vals, perm = torch.sort(torch.gather(scores, -1, idx), dim=-1,
                            descending=True, stable=True)
    idx = torch.gather(idx, -1, perm)
    return torch.clamp(idx, max=n - 1), vals > NEG_INF


def _tile_boxes(mean2d, radius, ntx, nty, ts):
    u, v = mean2d[..., 0], mean2d[..., 1]
    x0 = torch.clamp(torch.floor((u - radius) / ts), 0, ntx).to(torch.int32)
    y0 = torch.clamp(torch.floor((v - radius) / ts), 0, nty).to(torch.int32)
    x1 = torch.clamp(torch.floor((u + radius) / ts) + 1, 0, ntx).to(torch.int32)
    y1 = torch.clamp(torch.floor((v + radius) / ts) + 1, 0, nty).to(torch.int32)
    return x0, x1, y0, y1


def tile_bin(pr: Projected, cam: Camera, ts: int, k: int,
             coarse_factor: int = 4, coarse_mult: int = 8):
    """(table (T, K), slot_valid (T, K)): each tile's K nearest touching
    Gaussians, front to back, through the coarse supertile lists where
    the tile grid allows them (candidates cut there stay cut)."""
    mean2d, radius = pr.mean2d.detach().float(), pr.radius.detach().float()
    depth, valid = pr.depth.detach().float(), pr.valid
    n = depth.shape[0]
    dev = depth.device
    ntx, nty = -(-cam.width // ts), -(-cam.height // ts)
    n_tiles = ntx * nty
    x0, x1, y0, y1 = _tile_boxes(mean2d, radius, ntx, nty, ts)
    neg_depth = torch.where(valid, -depth, torch.full_like(depth, NEG_INF))
    cf = coarse_factor
    if not (ntx % cf == 0 and nty % cf == 0 and ntx >= 2 * cf
            and nty >= 2 * cf):
        tx = torch.arange(ntx, dtype=torch.int32, device=dev)
        ty = torch.arange(nty, dtype=torch.int32, device=dev)
        tch_x = (tx >= x0[:, None]) & (tx < x1[:, None]) & valid[:, None]
        tch_y = (ty >= y0[:, None]) & (ty < y1[:, None])
        touch = (tch_y[:, :, None] & tch_x[:, None, :]).reshape(n, n_tiles)
        return _nearest_k(torch.where(touch.T, neg_depth[None, :],
                                      torch.full_like(neg_depth, NEG_INF)), k)
    ncx, ncy = ntx // cf, nty // cf
    kc = min(coarse_mult * k, max(n, k))
    cx0 = torch.div(x0, cf, rounding_mode="floor")
    cx1 = torch.div(x1 + cf - 1, cf, rounding_mode="floor")
    cy0 = torch.div(y0, cf, rounding_mode="floor")
    cy1 = torch.div(y1 + cf - 1, cf, rounding_mode="floor")
    ctx = torch.arange(ncx, dtype=torch.int32, device=dev)
    cty = torch.arange(ncy, dtype=torch.int32, device=dev)
    tch_cx = (ctx >= cx0[:, None]) & (ctx < cx1[:, None]) & valid[:, None]
    tch_cy = (cty >= cy0[:, None]) & (cty < cy1[:, None])
    touch_c = (tch_cy[:, :, None] & tch_cx[:, None, :]).reshape(n, ncx * ncy)
    cidx, cvalid = _nearest_k(torch.where(
        touch_c.T, neg_depth[None, :], torch.full_like(neg_depth, NEG_INF)),
        kc)                                                # (C, Kc)
    bx0, bx1 = x0.float()[cidx], x1.float()[cidx]
    by0, by1 = y0.float()[cidx], y1.float()[cidx]
    cand_nd = torch.where(cvalid, neg_depth[cidx],
                          torch.full_like(bx0, NEG_INF))
    sub = torch.arange(cf * cf, device=dev)
    cell = torch.arange(ncx * ncy, device=dev)
    g_tx = ((cell % ncx)[:, None] * cf + (sub % cf)[None, :]).float()
    g_ty = ((cell // ncx)[:, None] * cf + (sub // cf)[None, :]).float()
    touch_f = ((g_tx[:, :, None] >= bx0[:, None, :])
               & (g_tx[:, :, None] < bx1[:, None, :])
               & (g_ty[:, :, None] >= by0[:, None, :])
               & (g_ty[:, :, None] < by1[:, None, :]))
    scores_f = torch.where(touch_f, cand_nd[:, None, :],
                           torch.full_like(cand_nd[:, None, :], NEG_INF))
    fpos, fvalid = _nearest_k(scores_f.reshape(n_tiles, kc), k)
    cell_of_row = torch.repeat_interleave(cell, cf * cf)
    table = torch.gather(cidx[cell_of_row], 1, fpos)
    row_tile = (g_ty.reshape(-1) * ntx + g_tx.reshape(-1)).long()
    inv = torch.empty(n_tiles, dtype=torch.long, device=dev)
    inv[row_tile] = torch.arange(n_tiles, device=dev)
    return table[inv], fvalid[inv]


# -- blend --------------------------------------------------------------------
def tile_pixels(cam: Camera, ts: int, device, dtype):
    ntx, nty = -(-cam.width // ts), -(-cam.height // ts)
    tiles = torch.arange(ntx * nty, device=device)
    lx = torch.arange(ts, device=device).repeat(ts)
    ly = torch.arange(ts, device=device).repeat_interleave(ts)
    px = ((tiles % ntx) * ts)[:, None] + lx[None, :]
    py = (torch.div(tiles, ntx, rounding_mode="floor") * ts)[:, None] \
        + ly[None, :]
    return px.to(dtype), py.to(dtype)


def pair_alpha(rows, px, py):
    """rows (..., CH, F) [mu_x, mu_y, a, b, c, opacity, ...]; px, py
    (..., 1, P) -> alpha (..., CH, P): min(opacity G, 0.99) with the clamp
    passing the gradient, 0 outside the ellipse or below 1/255."""
    dx = rows[..., 0:1] - px
    dy = rows[..., 1:2] - py
    a, b, c = rows[..., 2:3], rows[..., 3:4], rows[..., 4:5]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    inside = power <= 0.0
    raw = rows[..., 5:6] * torch.exp(torch.where(inside, power,
                                                 torch.zeros_like(power)))
    alpha = raw + (torch.clamp(raw, max=0.99) - raw).detach()
    live = inside & (alpha >= ALPHA_MIN)
    return torch.where(live, alpha, torch.zeros_like(alpha))


def _blend_tiles(rows, valid, px, py, n_chunks, max_depth: float = 15.0):
    """Front-to-back blend of (T, K, 7 + C) rows [mu, conic, opacity,
    depth, colors] over the pixels (T, 1, P), chunk by chunk, a tile
    stopping after the first chunk that leaves every pixel's T below 1e-4,
    or at ceil(nvalid / chunk) chunks.  Returns (color (T, P, C), T_final
    (T, P), the median depth (T, P): the depth of the first pair that takes
    T across 0.5, max_depth where none does)."""
    n_tiles, k, _f = rows.shape
    chunk = k // n_chunks
    nvalid = valid.sum(dim=-1)
    k_lim = torch.clamp((nvalid + chunk - 1) // chunk * chunk, max=k)
    t = torch.ones(n_tiles, px.shape[-1], dtype=rows.dtype,
                   device=rows.device)
    acc = rows.new_zeros(n_tiles, px.shape[-1], rows.shape[-1] - 7)
    med = torch.full_like(t, max_depth)
    has_med = torch.zeros_like(t, dtype=torch.bool)
    for k0 in range(0, k, chunk):
        live = (k0 < k_lim) & (t.detach().amax(dim=-1) >= SATURATED_T)
        if not bool(live.any()):
            break
        blk = rows[:, k0:k0 + chunk]
        alpha = pair_alpha(blk, px, py)
        alpha = torch.where((live[:, None] & valid[:, k0:k0 + chunk])[..., None],
                            alpha, torch.zeros_like(alpha))
        one_minus = 1.0 - alpha
        cum = torch.cumprod(one_minus, dim=1)
        t_before = t[:, None, :] * torch.cat(
            [torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        acc = acc + torch.einsum("tkp,tkc->tpc", alpha * t_before,
                                 blk[..., 7:])
        with torch.no_grad():
            cross = (t_before > 0.5) & (t_before * one_minus < 0.5) \
                & (alpha > 0.0)
            first = torch.argmax(cross.to(torch.int8), dim=1)   # (T, P)
            dep = torch.gather(blk[..., 6].detach(), 1, first)
            new = cross.any(dim=1) & ~has_med
            med = torch.where(new, dep, med)
            has_med = has_med | new
        t = t * cum[:, -1]
    return acc, t, med


TILE_BLOCK = 256      # tiles blended (and checkpointed) together


def render(params: dict, n_active: int, w2c, cam: Camera, k: int,
           with_depth_sq: bool = False, bins=None, ts: int = 16,
           chunk: int = 64):
    """[rgb, z (, z^2)] of the map at w2c: dict(im (H, W, 3), depth (H, W)
    (the blended z), med_depth (H, W), final_t (H, W)[, depth_sq]).
    params: means3D, log_scales, unnorm_rotations, logit_opacities,
    rgb_colors (capacity rows; the first n_active are live).  `bins` =
    tile_bin's (table, slot_valid), or None to bin here.  The blend runs
    in blocks of tiles under checkpointing, so that a backward holds one
    block at a time."""
    dt = params["means3D"].dtype
    w2c = w2c.to(dt)
    means_cam = params["means3D"] @ w2c[:3, :3].T + w2c[:3, 3]
    scales = torch.exp(params["log_scales"])
    opac = torch.sigmoid(params["logit_opacities"][:, 0])
    active = torch.arange(means_cam.shape[0], device=means_cam.device) \
        < n_active
    pr = project(means_cam, scales, params["unnorm_rotations"], cam, active)
    if bins is None:
        bins = tile_bin(pr, cam, ts, k)
    table, slot_valid = bins
    z = means_cam[:, 2:3]
    cols = [params["rgb_colors"], z] + ([z * z] if with_depth_sq else [])
    feats = torch.cat([pr.mean2d, pr.conic, opac[:, None],
                       pr.depth.detach()[:, None]] + cols, dim=-1)
    rows = feats[table]                                     # (T, K, 7 + C)
    px, py = tile_pixels(cam, ts, rows.device, dt)
    outs = []
    for t0 in range(0, rows.shape[0], TILE_BLOCK):
        sl = slice(t0, t0 + TILE_BLOCK)
        args = (rows[sl], slot_valid[sl], px[sl, None, :], py[sl, None, :],
                k // chunk)
        outs.append(checkpoint(_blend_tiles, *args, use_reentrant=False)
                    if rows.requires_grad else _blend_tiles(*args))
    ntx, nty = -(-cam.width // ts), -(-cam.height // ts)

    def image(i):
        buf = torch.cat([o[i] for o in outs])
        tr = buf.shape[2:]
        img = buf.reshape((nty, ntx, ts, ts) + tr).movedim(2, 1)
        return img.reshape((nty * ts, ntx * ts) + tr)[:cam.height, :cam.width]
    img = image(0)
    out = dict(im=img[..., :3], depth=img[..., 3], final_t=image(1),
               med_depth=image(2))
    if with_depth_sq:
        out["depth_sq"] = img[..., 4]
    return out


# -- the mapping loss ---------------------------------------------------------
def _gauss_window(size: int = 11, sigma: float = 1.5):
    xs = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).tolist()


def _filter(img, g):
    r = len(g) // 2
    h, w = img.shape[0], img.shape[1]
    x = torch.nn.functional.pad(img, (0, 0, 0, 0, r, r))
    out = sum(float(g[i]) * x[i:i + h] for i in range(len(g)))
    x = torch.nn.functional.pad(out, (0, 0, r, r))
    return sum(float(g[i]) * x[:, i:i + w] for i in range(len(g)))


def ssim(img1, img2):
    """Mean SSIM (11x11 Gaussian window, sigma 1.5, C1 0.01^2, C2 0.03^2)
    with the variances floored at 0 and the covariance bounded by
    Cauchy-Schwarz; images (H, W, C)."""
    c = img1.shape[-1]
    f = _filter(torch.cat([img1, img2, img1 * img1, img2 * img2,
                           img1 * img2], dim=-1), _gauss_window())
    mu1, mu2, m11, m22, m12 = [f[..., i * c:(i + 1) * c] for i in range(5)]
    zero = m11.new_zeros(())
    s1 = torch.maximum(m11 - mu1 * mu1, zero)
    s2 = torch.maximum(m22 - mu2 * mu2, zero)
    bound = torch.sqrt(s1 * s2).detach()
    s12 = torch.maximum(torch.minimum(m12 - mu1 * mu2, bound), -bound)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def rgbd_loss(im, depth, gt_color, gt_depth, depth_weight: float,
              im_weight: float):
    """depth_weight * mean |depth error| over gt_depth > 0 + im_weight *
    (0.8 L1 + 0.2 (1 - SSIM)) of the colour."""
    mask = ((gt_depth > 0) & torch.isfinite(depth)).detach()
    depth_l1 = torch.sum(torch.abs(gt_depth - depth) * mask) \
        / torch.clamp(mask.sum(), min=1)
    im_loss = 0.8 * torch.mean(torch.abs(im - gt_color)) \
        + 0.2 * (1.0 - ssim(im, gt_color))
    return depth_weight * depth_l1 + im_weight * im_loss


# -- work counted for the rooflines -------------------------------------------
@torch.no_grad()
def live_pairs(params: dict, n_active: int, w2cs, cam: Camera,
               ts: int = 16) -> list[tuple[int, int]]:
    """Per pose of w2cs (B, 4, 4): (live pairs, Gaussians in view).  The
    live pairs are the (pixel, Gaussian) pairs with alpha
    >= 1/255 that a pixel meets before its transmittance falls below 1e-4,
    over every Gaussian whose 3-sigma box touches the pixel's tile, front
    to back, with no per-tile cut.  This is the work of a blend or of its
    backward whatever lists or layout an implementation gives it."""
    out = []
    p = {k: v.detach().float() for k, v in params.items()}
    scales = torch.exp(p["log_scales"])
    opac = torch.sigmoid(p["logit_opacities"][:, 0])
    ntx, nty = -(-cam.width // ts), -(-cam.height // ts)
    px, py = tile_pixels(cam, ts, scales.device, torch.float32)
    for w2c in w2cs:
        w2c = w2c.float()
        mc = p["means3D"] @ w2c[:3, :3].T + w2c[:3, 3]
        active = torch.arange(mc.shape[0], device=mc.device) < n_active
        pr = project(mc, scales, p["unnorm_rotations"], cam, active)
        idx = torch.nonzero(pr.valid)[:, 0]
        if len(idx) == 0:
            out.append((0, 0))
            continue
        idx = idx[torch.argsort(pr.depth[idx], stable=True)]
        x0, x1, y0, y1 = _tile_boxes(pr.mean2d[idx], pr.radius[idx], ntx,
                                     nty, ts)
        tx = torch.arange(ntx, device=mc.device, dtype=torch.int32)
        ty = torch.arange(nty, device=mc.device, dtype=torch.int32)
        touch = (((ty[None, :, None] >= y0[:, None, None])
                  & (ty[None, :, None] < y1[:, None, None]))
                 & ((tx[None, None, :] >= x0[:, None, None])
                    & (tx[None, None, :] < x1[:, None, None])))
        tile, gpos = torch.nonzero(touch.reshape(len(idx), -1).T,
                                   as_tuple=True)            # tile-major
        counts = torch.bincount(tile, minlength=ntx * nty)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(len(tile), device=mc.device) - start[tile]
        lmax = int(counts.max()) if len(tile) else 0
        table = torch.full((ntx * nty, max(lmax, 1)), -1, dtype=torch.long,
                           device=mc.device)
        table[tile, rank] = idx[gpos]
        feats = torch.cat([pr.mean2d, pr.conic, opac[:, None]], dim=-1)
        t = torch.ones(ntx * nty, ts * ts, device=mc.device)
        n_live = torch.zeros((), dtype=torch.long, device=mc.device)
        for k0 in range(0, lmax, 64):
            blk_idx = table[:, k0:k0 + 64]
            ok = blk_idx >= 0
            open_t = (t.amax(dim=-1) >= SATURATED_T) & ok[:, 0]
            if not bool(open_t.any()):
                break
            sel = torch.nonzero(open_t)[:, 0]
            rows = feats[blk_idx[sel].clamp(min=0)]
            alpha = pair_alpha(rows, px[sel, None, :], py[sel, None, :])
            alpha = torch.where(ok[sel][..., None], alpha,
                                torch.zeros_like(alpha))
            cum = torch.cumprod(1.0 - alpha, dim=1)
            t_before = t[sel, None, :] * torch.cat(
                [torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
            n_live += ((alpha > 0) & (t_before >= SATURATED_T)).sum()
            t[sel] = t[sel] * cum[:, -1]
        out.append((int(n_live), int(pr.valid.sum())))
    return out
