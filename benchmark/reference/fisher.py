"""Plain PyTorch reference of the Fisher diagonal that the planning event
scores candidates and paths with (K3's function), of H_train, the
candidates' scores and the path EIG.

A frozen copy of the port's plain twin of K3 (the squared per-pixel
gradients of mean and opacity under a uniform cotangent, walked forward
for the chunk-start transmittance and back for the suffix sums, stopped
per tile as the blend is), of its slot packing and of the analytic
d(conic)/d(mean) of the full chain, with the projection and binning of
reference/gaussians.py; then the planning event's arithmetic over it.
It imports nothing of the port."""
from __future__ import annotations

import torch

from .gaussians import cov3d_cols, project, tile_bin, tile_pixels

NF_FULL = 20
SATURATED_T = 1e-4


def conic_mean_jac(means_cam, cov3d, camera, valid=None):
    """Per-Gaussian Jacobian d(conic)/d(mean_cam): (..., N, 3, 3), rows the
    conic entries (a, b, c) = (c'/det, -b'/det, a'/det), columns the
    camera-frame mean components.  Written out analytically (the JAX
    package takes it by forward-mode autodiff).  The fov-clamp quirk is
    kept: where |x/z| exceeds 1.3 tan_fov the whole tx path carries no
    derivative (no d/dx and no tx-through-z term), likewise for y.  Rows
    for invalid Gaussians are zero."""
    if isinstance(cov3d, tuple):
        c0, c1, c2, c3, c4, c5 = cov3d
    else:
        c0, c1, c2, c3, c4, c5 = cov3d.unbind(-1)
    fx, fy = camera.fx, camera.fy
    limx = 1.3 * camera.width / (2.0 * camera.fx)
    limy = 1.3 * camera.height / (2.0 * camera.fy)
    x, y, zr = means_cam.unbind(-1)
    z = torch.clamp(zr, min=1e-6)
    dz = (zr > 1e-6).to(z.dtype)                 # d max(z, 1e-6) / dz
    clamp_x = torch.abs(x / z) > limx
    clamp_y = torch.abs(y / z) > limy
    tx = torch.where(clamp_x, torch.clamp(x / z, -limx, limx) * z, x)
    ty = torch.where(clamp_y, torch.clamp(y / z, -limy, limy) * z, y)
    ux = (~clamp_x).to(z.dtype)                  # d tx / dx
    uy = (~clamp_y).to(z.dtype)                  # d ty / dy

    j00 = fx / z
    j02 = -fx * tx / (z * z)
    j11 = fy / z
    j12 = -fy * ty / (z * z)
    zero = torch.zeros_like(z)
    # d j / d(x, y, z), each a 3-tuple
    dj00 = (zero, zero, -fx / (z * z) * dz)
    dj02 = (-fx / (z * z) * ux, zero, 2.0 * fx * tx / (z * z * z) * dz)
    dj11 = (zero, zero, -fy / (z * z) * dz)
    dj12 = (zero, -fy / (z * z) * uy, 2.0 * fy * ty / (z * z * z) * dz)

    a = j00 * (c0 * j00 + c2 * j02) + j02 * (c2 * j00 + c5 * j02) \
        + camera.dilation
    b = j11 * (c1 * j00 + c4 * j02) + j12 * (c2 * j00 + c5 * j02)
    c_ = j11 * (c3 * j11 + c4 * j12) + j12 * (c4 * j11 + c5 * j12) \
        + camera.dilation
    det_pos = (a * c_ - b * b) > 0
    det = torch.where(det_pos, a * c_ - b * b, torch.ones_like(z))

    da_d00 = 2 * (j00 * c0 + j02 * c2)
    da_d02 = 2 * (j00 * c2 + j02 * c5)
    db_d00 = j11 * c1 + j12 * c2
    db_d02 = j11 * c4 + j12 * c5
    db_d11 = j00 * c1 + j02 * c4
    db_d12 = j00 * c2 + j02 * c5
    dc_d11 = 2 * (j11 * c3 + j12 * c4)
    dc_d12 = 2 * (j11 * c4 + j12 * c5)

    cols = []
    for m in range(3):
        da = da_d00 * dj00[m] + da_d02 * dj02[m]
        db = (db_d00 * dj00[m] + db_d02 * dj02[m] + db_d11 * dj11[m]
              + db_d12 * dj12[m])
        dc = dc_d11 * dj11[m] + dc_d12 * dj12[m]
        ddet = torch.where(det_pos, c_ * da + a * dc - 2 * b * db, zero)
        inv = 1.0 / det
        cols.append(torch.stack([
            dc * inv - c_ * ddet * inv * inv,
            -db * inv + b * ddet * inv * inv,
            da * inv - a * ddet * inv * inv,
        ], dim=-1))
    jac = torch.stack(cols, dim=-1)              # (..., N, 3 rows, 3 cols)
    if valid is not None:
        jac = torch.where(valid[..., None, None], jac, torch.zeros_like(jac))
    return jac


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
    t = torch.ones(r_rows, p, dtype=packed.dtype, device=dev)
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
    h = torch.zeros(r_rows, k, 4, dtype=packed.dtype, device=dev)
    s_behind = torch.zeros(r_rows, p, dtype=packed.dtype, device=dev)
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


def fisher_diag(params: dict, n_active: int, w2cs, cam, ts: int, k: int,
                chunk: int, grad_value: float, full_chain: bool,
                batch: int = 16):
    """(B, capacity, 4) Fisher diagonals [mean_cam x, y, z, opacity] of the
    map at w2cs (B, 4, 4), in pose batches of `batch`."""
    means_w = params["means3D"]
    scales = torch.exp(params["log_scales"])
    quats = params["unnorm_rotations"]
    opac = torch.sigmoid(params["logit_opacities"][:, 0])
    colors = params["rgb_colors"]
    n = means_w.shape[0]
    active = torch.arange(n, device=means_w.device) < n_active
    px, py = tile_pixels(cam, ts, means_w.device, means_w.dtype)
    pix_xy = torch.stack([px, py], dim=1)
    outs = []
    for b0 in range(0, w2cs.shape[0], batch):
        wb = w2cs[b0:b0 + batch].to(means_w.dtype)
        mc = means_w @ wb[:, :3, :3].transpose(1, 2) + wb[:, None, :3, 3]
        preps, tables, valids = [], [], []
        for i in range(wb.shape[0]):
            pr = project(mc[i], scales, quats, cam, active)
            table, valid = tile_bin(pr, cam, ts, k)
            preps.append(pr)
            tables.append(table)
            valids.append(valid)
        prep = _Prep(torch.stack([p.mean2d for p in preps]),
                     torch.stack([p.conic for p in preps]),
                     torch.stack([p.depth for p in preps]),
                     torch.stack([p.valid for p in preps]))
        bins = _Bins(torch.stack(tables), torch.stack(valids))
        cjac = None
        if full_chain:
            cjac = conic_mean_jac(mc, torch.stack(cov3d_cols(scales, quats),
                                                  -1), cam, valid=prep.valid)
        packed = pack_fisher_features(prep, bins, opac, colors, mc,
                                      conic_jac=cjac)
        nb, n_tiles, kk, nf = packed.shape
        nvalid = bins.slot_valid.sum(dim=-1)
        h, _k_eff = _fisher_walk(packed.reshape(nb * n_tiles, kk, nf),
                                 pix_xy, nvalid.reshape(-1), chunk,
                                 grad_value, cam.fx, cam.fy)
        h = torch.where(bins.slot_valid.reshape(-1, kk)[..., None], h,
                        torch.zeros_like(h))
        offs = torch.arange(nb, device=h.device)[:, None, None] * n
        out = torch.zeros(nb * n, 4, dtype=h.dtype, device=h.device)
        out.index_add_(0, (bins.table + offs).reshape(-1), h.reshape(-1, 4))
        outs.append(out.reshape(nb, n, 4))
    return torch.cat(outs)


class _Prep:
    def __init__(self, mean2d, conic, depth, valid):
        self.mean2d, self.conic, self.depth, self.valid = (mean2d, conic,
                                                           depth, valid)


class _Bins:
    def __init__(self, table, slot_valid):
        self.table, self.slot_valid = table, slot_valid


def h_train(fisher, keyframe_w2cs, window: int):
    """H_train: the Fisher diagonals summed over the keyframes; past
    `window` keyframes over ids strided evenly from the first to the
    latest, scaled by the count over the ids summed."""
    n_kf = keyframe_w2cs.shape[0]
    if window and n_kf > window:
        import numpy as np
        ids = sorted(set(np.round(np.linspace(0, n_kf - 1, window))
                         .astype(int).tolist()))
        return fisher(keyframe_w2cs[ids]).sum(0) * (n_kf / len(ids))
    return fisher(keyframe_w2cs).sum(0)


def pose_scores(fisher, w2cs, h_train_diag):
    """Each candidate's EIG: sum(H_pose / (H_train + 0.1))."""
    inv = 1.0 / (h_train_diag + 0.1)
    return torch.sum(fisher(w2cs) * inv[None], dim=(1, 2))


def path_scores(fisher_full, h_train_diag, acc_w2cs, acc_valid, lengths,
                final_eigs, h_reg_lambda: float, point_weight: float,
                end_weight: float, vol_weighted: bool, gs_pts_cnt: float):
    """Each path's score: over its acc steps, point EIG = log(sum H_s /
    (H_train_path + lambda)) weighted and summed, H_train_path += H_s;
    then sum / len + end_weight * final EIG (or (sum + final) / len when
    end_weight is 0)."""
    n_paths = acc_w2cs.shape[0]
    h_paths = h_train_diag[None].expand(n_paths, -1, -1)
    totals = torch.zeros(n_paths, dtype=h_train_diag.dtype,
                         device=h_train_diag.device)
    for s in range(acc_w2cs.shape[1]):
        ok = acc_valid[:, s]
        cur = fisher_full(acc_w2cs[:, s])
        raw = torch.sum(cur * (1.0 / (h_paths + h_reg_lambda)), dim=(1, 2))
        if vol_weighted:
            raw = raw / gs_pts_cnt
        eig = torch.log(torch.clamp(raw, min=1e-30))
        totals = totals + torch.where(ok, point_weight * eig,
                                      torch.zeros_like(eig))
        h_paths = h_paths + ok.to(cur.dtype)[:, None, None] * cur
    length = torch.clamp(lengths.to(totals.dtype), min=1.0)
    if end_weight > 0:
        return totals / length + end_weight * final_eigs.to(totals.dtype)
    return (totals + final_eigs.to(totals.dtype)) / length
