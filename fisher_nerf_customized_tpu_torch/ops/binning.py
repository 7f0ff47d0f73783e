"""Static-shape tile binning: per-tile nearest-K Gaussian lists.

Plain torch with the JAX package's semantics, so the kernels see the
same slot lists:

  1. a per-Gaussian screen bbox -> tile-touch predicate, factored into
     (N, ntx) x (N, nty) factors;
  2. per-tile nearest-K selection by top-k of the score -depth (invalid
     or non-touching pairs score -inf), so every row is front-to-back and
     its indices point into the original arrays;
  3. hierarchically where the tile grid allows it: coarse supertile
     candidate lists of Kc = min(coarse_mult·K, max(N, K)) first, then
     fine per-tile selection from them.  Candidates dropped at the coarse
     level are counted in `overflow` as the JAX package counts them.

K (`max_per_tile`) bounds per-tile blending work.  `counts` stays
uncapped and `overflow` reports truncation, because the SLAM object's
adaptive K bump reads them.  Every input may carry leading batch
dimensions (one per pose); outputs gain the same leading dimensions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_NEG_INF = float("-inf")


class TileBins(NamedTuple):
    table: torch.Tensor       # (..., T, K) int64 indices into the ORIGINAL arrays
    slot_valid: torch.Tensor  # (..., T, K) bool
    counts: torch.Tensor      # (..., T) touching Gaussians per tile (uncapped)
    overflow: torch.Tensor    # (...) total truncated entries across tiles
    n_tiles_x: int
    n_tiles_y: int


def _nearest_k(scores, k: int):
    """Per-row top-k of `scores` (higher = nearer), as lax.top_k selects
    and orders them: every score above the k-th value v is kept, and of
    the scores tied at v the lowest-index ones, up to k in all; the kept
    rows come out in (score descending, index ascending) order, i.e.
    front to back with ties in index order.  torch.topk keeps an
    arbitrary subset of the scores tied at v, so it gives v and the
    scores above it; a second top-k over the tie mask, keyed by the
    complement of the index, gives the lowest-index ties."""
    n = scores.shape[-1]
    if n < k:
        pad = scores.new_full(scores.shape[:-1] + (k - n,), _NEG_INF)
        scores = torch.cat([scores, pad], dim=-1)
    m = scores.shape[-1]
    vals, idx = torch.topk(scores, k, dim=-1, sorted=True)
    v = vals[..., -1:]
    n_above = (vals > v).sum(dim=-1, keepdim=True)
    rev = torch.arange(m, 0, -1, dtype=torch.int32, device=scores.device)
    tie_key = torch.where(scores == v, rev, torch.zeros_like(rev))
    tie_idx = torch.topk(tie_key, k, dim=-1, sorted=True).indices
    pos = torch.arange(k, device=scores.device)
    idx = torch.where(pos < n_above, idx, torch.gather(
        tie_idx, -1, torch.clamp(pos - n_above, min=0)))
    # (score desc, index asc): by index, then stably by score
    idx, _ = torch.sort(idx, dim=-1)
    vals, perm = torch.sort(torch.gather(scores, -1, idx), dim=-1,
                            descending=True, stable=True)
    idx = torch.gather(idx, -1, perm)
    return torch.clamp(idx, max=n - 1), vals > _NEG_INF


def _count(touch_y, touch_x):
    """(B, N, nty) x (B, N, ntx) bool -> exact (B, nty*ntx) int32 counts."""
    touch = touch_y[..., :, None] & touch_x[..., None, :]
    return touch.sum(dim=1, dtype=torch.int32).reshape(touch.shape[0], -1)


def tile_bin(mean2d, radius, depth, valid, width: int, height: int,
             tile_size: int, max_per_tile: int,
             coarse_factor: int = 4, coarse_mult: int = 8) -> TileBins:
    batch = depth.shape[:-1]
    n = depth.shape[-1]
    mean2d = mean2d.reshape(-1, n, 2)
    radius = radius.reshape(-1, n)
    depth = depth.reshape(-1, n)
    valid = valid.reshape(-1, n)
    nb = depth.shape[0]
    dev = depth.device
    ntx = -(-width // tile_size)
    nty = -(-height // tile_size)
    n_tiles = ntx * nty
    k = max_per_tile

    u, v = mean2d[..., 0], mean2d[..., 1]
    r = radius
    x0 = torch.clamp(torch.floor((u - r) / tile_size), 0, ntx).to(torch.int32)
    y0 = torch.clamp(torch.floor((v - r) / tile_size), 0, nty).to(torch.int32)
    x1 = torch.clamp(torch.floor((u + r) / tile_size) + 1, 0, ntx).to(torch.int32)
    y1 = torch.clamp(torch.floor((v + r) / tile_size) + 1, 0, nty).to(torch.int32)

    tx = torch.arange(ntx, dtype=torch.int32, device=dev)
    ty = torch.arange(nty, dtype=torch.int32, device=dev)
    touch_x = (tx >= x0[..., None]) & (tx < x1[..., None]) & valid[..., None]
    touch_y = (ty >= y0[..., None]) & (ty < y1[..., None])
    counts = _count(touch_y, touch_x)                       # (B, T)

    neg_inf = torch.tensor(_NEG_INF, device=dev)
    neg_depth = torch.where(valid, -depth, neg_inf)         # (B, N)

    use_hier = (ntx % coarse_factor == 0 and nty % coarse_factor == 0
                and ntx >= 2 * coarse_factor and nty >= 2 * coarse_factor)
    if use_hier:
        cf = coarse_factor
        ncx, ncy = ntx // cf, nty // cf
        n_coarse = ncx * ncy
        kc = min(coarse_mult * k, max(n, k))

        cx0 = torch.div(x0, cf, rounding_mode="floor")
        cx1 = torch.div(x1 + cf - 1, cf, rounding_mode="floor")
        cy0 = torch.div(y0, cf, rounding_mode="floor")
        cy1 = torch.div(y1 + cf - 1, cf, rounding_mode="floor")
        ctx = torch.arange(ncx, dtype=torch.int32, device=dev)
        cty = torch.arange(ncy, dtype=torch.int32, device=dev)
        touch_cx = ((ctx >= cx0[..., None]) & (ctx < cx1[..., None])
                    & valid[..., None])                     # (B, N, ncx)
        touch_cy = (cty >= cy0[..., None]) & (cty < cy1[..., None])
        touch_c = (touch_cy[..., :, None] & touch_cx[..., None, :]).reshape(
            nb, n, n_coarse)
        scores_c = torch.where(touch_c.transpose(1, 2), neg_depth[:, None, :],
                               neg_inf)                     # (B, C, N)
        cidx, cvalid = _nearest_k(scores_c, kc)             # (B, C, Kc)

        counts_c = _count(touch_cy, touch_cx)
        overflow_c = torch.clamp(counts_c - kc, min=0).sum(-1)

        bbox = torch.stack([x0.float(), x1.float(), y0.float(), y1.float(),
                            neg_depth], dim=-1)             # (B, N, 5)
        cand = torch.gather(bbox, 1, cidx.reshape(nb, -1, 1).expand(-1, -1, 5))
        cand = cand.reshape(nb, n_coarse, kc, 5)
        bx0, bx1 = cand[..., 0], cand[..., 1]
        by0, by1 = cand[..., 2], cand[..., 3]
        cand_nd = torch.where(cvalid, cand[..., 4], neg_inf)

        sub = torch.arange(cf * cf, device=dev)
        cell = torch.arange(n_coarse, device=dev)
        g_tx = ((cell % ncx)[:, None] * cf + (sub % cf)[None, :]).float()
        g_ty = ((cell // ncx)[:, None] * cf + (sub // cf)[None, :]).float()
        touch_f = ((g_tx[None, :, :, None] >= bx0[:, :, None, :])
                   & (g_tx[None, :, :, None] < bx1[:, :, None, :])
                   & (g_ty[None, :, :, None] >= by0[:, :, None, :])
                   & (g_ty[None, :, :, None] < by1[:, :, None, :]))
        scores_f = torch.where(touch_f, cand_nd[:, :, None, :], neg_inf)
        fpos, fvalid = _nearest_k(
            scores_f.reshape(nb, n_coarse * cf * cf, kc), k)
        # fpos indexes the coarse candidate list -> original index
        cell_of_row = torch.repeat_interleave(
            torch.arange(n_coarse, device=dev), cf * cf)
        table = torch.gather(cidx[:, cell_of_row, :], 2, fpos)
        # rows are (coarse cell, sub-tile) ordered; remap to tile-major
        row_tile = (g_ty.reshape(-1) * ntx + g_tx.reshape(-1)).long()
        inv = torch.empty(n_tiles, dtype=torch.long, device=dev)
        inv[row_tile] = torch.arange(n_tiles, device=dev)
        table = table[:, inv]
        slot_valid = fvalid[:, inv]
        overflow = torch.clamp(counts - k, min=0).sum(-1) + overflow_c
    else:
        touch = (touch_y[..., :, None] & touch_x[..., None, :]).reshape(
            nb, n, n_tiles)
        scores = torch.where(touch.transpose(1, 2), neg_depth[:, None, :],
                             neg_inf)
        table, slot_valid = _nearest_k(scores, k)
        overflow = torch.clamp(counts - k, min=0).sum(-1)

    return TileBins(table=table.reshape(batch + (n_tiles, k)),
                    slot_valid=slot_valid.reshape(batch + (n_tiles, k)),
                    counts=counts.reshape(batch + (n_tiles,)),
                    overflow=overflow.reshape(batch),
                    n_tiles_x=ntx, n_tiles_y=nty)
