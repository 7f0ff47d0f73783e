"""The 1-NN kernel: CUDA kernel wrapper, its plain twin, and the plain
emulation of the kernel's culled search.

Counterpart of the JAX package's ops/knn.py::knn at k = 1 (an XLA
program there).  The kernel (csrc/nn1.cu) finds, for each query, the
nearest unmasked reference: the Euclidean distance (float32) and the
lowest row at that distance (int32); a query with no finite distance
gets (inf, 0).  `nn1_plain` is the same function in plain PyTorch: the
same d2 = (dx*dx + dy*dy) + dz*dz of direct differences, elementwise,
and an exact lowest-row minimum, so on the same tensors kernel and twin
agree to the bit.  `cuda_nn1` runs the kernel for CUDA tensors and the
twin for CPU tensors.  Callers center the inputs first (ops/knn.py).

The kernel searches spatially sorted clouds and skips the ref tiles
that cannot hold a query's nearest ref.  `culled_layout` is its glue,
in PyTorch on the tensors' device:
  * refs that are masked or not finite are dropped (neither can win),
    and so are queries that are not finite (their answer is (inf, 0));
    each kept point keeps its original row;
  * both clouds get a Morton key (MORTON_BITS a axis, over a cube on
    the kept refs' bounding box) and are sorted stably by it;
  * the sorted refs are cut into tiles of TILE points (the last padded
    with +inf points of row -1, which never win), each with its box;
  * QUERIES_PER_WARP consecutive sorted queries form a warp,
    WARPS_PER_BLOCK warps a block; each block walks the tiles outward
    from the tile where its median query's key would sort
    (`visit_tile`), and when the blocks are fewer than TARGET_BLOCKS the
    walk's steps are dealt round-robin over `splits` copies of the block
    (gridDim.y), each with bests of its own, merged at the end; every
    copy but the first opens with the walk's first tile too
    (`split_steps`).
A warp evaluates a tile when, for some query of it, `box_lower_bound`
of the query (a point) against the tile's box is at most the query's
running best; a first test of the warp's box against the largest running
best among its queries passes every such tile and rules out the others
cheaply.  The update keeps the smallest (d2, original row), so the
answer is the twin's whatever the order.  `nn1_culled_plain` runs the
same search in plain PyTorch and returns the evaluated pairs too: the
tests hold it to the twin, and chip_smoke.py holds the kernel's pair
count to it.
`cuda_nn1_brute` keeps the all-pairs design the culled kernel replaced;
only chip_smoke.py calls it, as the yardstick of the culled kernel's
time.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from . import cuda_build

# csrc/nn1.cu's culled pass
WARPS_PER_BLOCK = 8                  # 256 threads
QUERIES_PER_WARP = 32 * 2            # 2 queries a lane
QUERIES_PER_BLOCK = WARPS_PER_BLOCK * QUERIES_PER_WARP
TILE = 64                            # refs staged in shared memory at once
MORTON_BITS = 10
# blocks the culled pass should launch before the walk's steps are split
# over gridDim.y: 4 per SM of an H100's 132 (4 resident at 256 threads)
TARGET_BLOCKS = 4 * 132
MIN_SPLIT_STEPS = 8
INF_KEY = 0x7F800000 << 32           # (d2 = +inf, row 0): no finite pair
# csrc/nn1.cu's all-pairs pass (the design the culled pass replaced, kept
# as a yardstick)
BRUTE_THREADS = 128
BRUTE_QUERIES_PER_BLOCK = BRUTE_THREADS * 8
BRUTE_TILE = 1024
BRUTE_TARGET_BLOCKS = 8 * 132

# Launches of the CUDA kernels (not of the plain twins).
launches = 0
launches_brute = 0


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


# ---------------------------------------------------------------------------
# the culled search's layout (the kernel's glue) and its plain emulation
# ---------------------------------------------------------------------------

_SPREAD: dict = {}       # device -> (2^MORTON_BITS,) int32: bit b at 3b


def morton_keys(points, lo, scale):
    """int32 Morton keys of points (N, 3): each axis' cell
    floor((p - lo) * scale), clamped to MORTON_BITS bits, its bits spread
    three apart by a table and interleaved x, y, z from the top down."""
    dev = points.device
    table = _SPREAD.get(dev)
    if table is None:
        v = torch.arange(1 << MORTON_BITS)
        table = torch.zeros_like(v)
        for bit in range(MORTON_BITS):
            table |= ((v >> bit) & 1) << (3 * bit)
        table = _SPREAD[dev] = table.to(device=dev, dtype=torch.int32)
    cell = ((points - lo) * scale).nan_to_num_(nan=0.0).floor_()
    spread = table[cell.clamp_(0, (1 << MORTON_BITS) - 1).long()]
    return (spread[:, 0] << 2) | (spread[:, 1] << 1) | spread[:, 2]


def visit_tile(start, n_tiles, step):
    """The tile at `step` of the walk outward from tile `start` over
    n_tiles tiles: start, start + 1, start - 1, start + 2, ..., then the
    longer side's rest in order (broadcasting tensors; csrc/nn1.cu's
    visit_tile)."""
    left, right = start, n_tiles - 1 - start
    m = torch.minimum(left, right)
    j = (step + 1) // 2
    alternating = torch.where(step % 2 == 1, start + j, start - j)
    rest = torch.where(right > left, start + (step - m), start - (step - m))
    return torch.where(step <= 2 * m, alternating, rest)


def box_lower_bound(q_lo, q_hi, r_lo, r_hi):
    """Lower bound of d2 between any point of box [q_lo, q_hi] and any of
    box [r_lo, r_hi] (..., 3): the per-axis gaps max(0, q_lo - r_hi,
    r_lo - q_hi) in the pair's own rounded operations and order, so
    every pair of points in the boxes has a computed d2 at least this
    one (round-to-nearest is monotone)."""
    g = torch.clamp_min(torch.maximum(q_lo - r_hi, r_lo - q_hi), 0.0)
    return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + \
        g[..., 2] * g[..., 2]


def split_steps(split, n_splits: int, i):
    """The walk's step that split `split` of `n_splits` takes at its
    i-th step (broadcasting tensors): split 0 takes 0, S, 2S, ...; the
    others take step 0 (the block's first tile) and then split,
    split + S, ... (csrc/nn1.cu's tile_of)."""
    return torch.where(split == 0, i * n_splits,
                       torch.where(i == 0, 0, split + (i - 1) * n_splits))


def n_split_steps(split, n_splits: int, n_tiles: int):
    """How many steps split `split` takes (n_splits <= n_tiles)."""
    own = -(-(n_tiles - split) // n_splits)
    return torch.where(split == 0, own, 1 + own)


def _splits(n_blocks: int, n_tiles: int) -> int:
    """gridDim.y of the culled pass: copies of each block that take every
    splits-th step of its walk, enough to fill TARGET_BLOCKS blocks when
    the queries alone do not, with MIN_SPLIT_STEPS steps of its own each
    (every copy's opening tile is work the others repeat)."""
    return max(1, min(-(-TARGET_BLOCKS // max(n_blocks, 1)),
                      n_tiles // MIN_SPLIT_STEPS, 65535))


@dataclass
class CulledLayout:
    """What csrc/nn1.cu's culled pass reads, built by `culled_layout`."""
    n_q: int                  # queries given
    queries: torch.Tensor     # (Qv, 3) f32: the finite queries, key order
    q_pos: torch.Tensor       # (Qv,) int32: their rows among the given
    n_refs: int               # kept refs (Rv)
    refs: torch.Tensor        # (T * tile, 4) f32: x, y, z, row's int bits
    boxes: torch.Tensor       # (T, 8) f32: min x, y, z, 0, max x, y, z, 0
    start: torch.Tensor       # (blocks,) int32: each block's first tile
    splits: int
    keys: torch.Tensor        # (Qv,) int64 (d2 bits, row), INF_KEY

    @property
    def n_tiles(self) -> int:
        return self.boxes.shape[0]


def culled_layout(queries, refs, mask=None) -> CulledLayout:
    """The culled search's inputs on the tensors' device (module
    docstring), at the kernel's sizes: compaction, Morton keys, the
    stable sorts, tiles and their boxes, each block's first tile, and
    the splits."""
    return _layout(queries, refs, mask)


def _layout(queries, refs, mask=None, *, tile: int = TILE,
            warp_queries: int = QUERIES_PER_WARP,
            block_warps: int = WARPS_PER_BLOCK,
            splits: int | None = None) -> CulledLayout:
    """culled_layout at any sizes (the emulation's): `tile` refs a tile,
    `warp_queries` queries a warp, `block_warps` warps a block; `splits`
    fixes the splits, else `_splits`."""
    dev = queries.device
    keep = torch.isfinite(refs).all(dim=1)
    if mask is not None:
        keep &= mask
    rows = torch.nonzero(keep).flatten()
    q_pos = torch.nonzero(torch.isfinite(queries).all(dim=1)).flatten()
    if q_pos.shape[0] == 0:                 # nothing to search for
        rows = rows[:0]
    r, q = refs[rows], queries[q_pos]
    n_r, n_qv = r.shape[0], q.shape[0]
    n_t = -(-n_r // tile)
    if n_t:
        lo = r.amin(dim=0)
        scale = (1 << MORTON_BITS) / torch.clamp((r.amax(dim=0) - lo).amax(),
                                                 min=1e-30)
        key = morton_keys(torch.cat([r, q]), lo, scale)
        r_key, order = torch.sort(key[:n_r], stable=True)
        r, rows = r[order], rows[order]
        q_key, order = torch.sort(key[n_r:], stable=True)
        q, q_pos = q[order], q_pos[order]
    staged = torch.empty((n_t * tile, 4), device=dev)
    staged[:, :3] = math.inf
    staged.view(torch.int32)[:, 3] = -1
    staged[:n_r, :3] = r
    staged.view(torch.int32)[:n_r, 3] = rows.to(torch.int32)
    pts = staged[:, :3].reshape(n_t, tile, 3)
    boxes = torch.zeros((n_t, 8), device=dev)
    boxes[:, :3] = pts.amin(dim=1)
    boxes[:, 4:7] = torch.where(torch.isinf(pts), -math.inf, pts).amax(dim=1)
    block_q = warp_queries * block_warps
    n_blocks = -(-n_qv // block_q) if n_t else 0
    first = torch.arange(n_blocks, device=dev) * block_q
    median = first + (torch.clamp(n_qv - first, max=block_q) - 1) // 2
    start = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
    if n_blocks:
        pos = torch.searchsorted(r_key, q_key[median])
        start = torch.clamp(pos // tile, max=n_t - 1).to(torch.int32)
    return CulledLayout(
        n_q=queries.shape[0], queries=q.contiguous(),
        q_pos=q_pos.to(torch.int32), n_refs=n_r, refs=staged, boxes=boxes,
        start=start, splits=splits or _splits(n_blocks, n_t),
        keys=torch.full((n_qv,), INF_KEY, dtype=torch.int64, device=dev))


def _decode(keys, lay: CulledLayout):
    """(dist (Q,), idx (Q,) int32) from the sorted queries' keys, at the
    queries' original rows; (inf, 0) for the others."""
    dev = lay.queries.device
    dist = torch.full((lay.n_q,), math.inf, device=dev)
    idx = torch.zeros(lay.n_q, dtype=torch.int32, device=dev)
    pos = lay.q_pos.long()
    d2 = (keys >> 32).to(torch.int32).view(torch.float32)
    dist[pos] = torch.sqrt(d2)
    idx[pos] = (keys & 0xFFFFFFFF).to(torch.int32)
    return dist, idx


def nn1_culled_plain(queries, refs, mask=None, *, tile: int = TILE,
                     warp_queries: int = QUERIES_PER_WARP,
                     block_warps: int = WARPS_PER_BLOCK,
                     splits: int | None = None):
    """csrc/nn1.cu's culled search in plain PyTorch on the tensors'
    device: (dist (Q,) f32, idx (Q,) int32, evaluated pairs).  The same
    layout (`culled_layout`'s, at the kernel's sizes by default), walk,
    tests and (d2, original row) minimum, each warp's tests in its walk's
    order with its bests so far; the pairs are each evaluated tile's refs
    times its warp's queries, as the kernel counts them.  Equal to
    `nn1_plain`; used by the tests and chip_smoke.py only."""
    lay = _layout(queries, refs, mask, tile=tile, warp_queries=warp_queries,
                  block_warps=block_warps, splits=splits)
    n_t, n_qv, s = lay.n_tiles, lay.queries.shape[0], lay.splits
    if n_t == 0:
        return (*_decode(lay.keys, lay), 0)
    dev = lay.queries.device
    n_w = -(-n_qv // warp_queries)
    q = torch.zeros((n_w * warp_queries, 3), device=dev)
    q[:n_qv] = lay.queries
    q = q.view(n_w, warp_queries, 3)
    valid = (torch.arange(n_w * warp_queries, device=dev) < n_qv).view(
        n_w, warp_queries)
    q_lo = torch.where(valid[..., None], q, math.inf).amin(dim=1)
    q_hi = torch.where(valid[..., None], q, -math.inf).amax(dim=1)
    n_valid = valid.sum(dim=1)
    start = lay.start.long()[torch.arange(n_w, device=dev) // block_warps]
    tile_refs = lay.refs.view(n_t, tile, 4)
    tile_rows = lay.refs.view(torch.int32).view(n_t, tile, 4)[..., 3]
    tile_n = torch.clamp(lay.n_refs - torch.arange(n_t, device=dev) * tile,
                         max=tile)
    best = torch.full((s, n_w, warp_queries), INF_KEY, dtype=torch.int64,
                      device=dev)
    split = torch.arange(s, device=dev)[:, None]
    n_steps = n_split_steps(split, s, n_t)                    # (S, 1)
    per_chunk = max(1, (1 << 22) // (warp_queries * tile))
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(int(n_steps.max())):
        ok = i < n_steps
        step = torch.where(ok, split_steps(split, s, torch.tensor(i)), 0)
        t = visit_tile(start[None, :], n_t, step)             # (S, W)
        lb = box_lower_bound(q_lo, q_hi, lay.boxes[t, :3], lay.boxes[t, 4:7])
        top = torch.where(valid, best >> 32, 0).amax(dim=-1)
        max_best = top.to(torch.int32).view(torch.float32)
        sw = torch.nonzero(ok & ~(lb > max_best))
        si, wi = sw.unbind(1)
        tt = t[si, wi]
        # the per-query test, on the units the box test leaves
        lb = box_lower_bound(q[wi], q[wi], lay.boxes[tt, None, :3],
                             lay.boxes[tt, None, 4:7])
        own = (best[si, wi] >> 32).to(torch.int32).view(torch.float32)
        sw = sw[(valid[wi] & ~(lb > own)).any(dim=-1)]
        for c0 in range(0, sw.shape[0], per_chunk):
            si, wi = sw[c0:c0 + per_chunk].unbind(1)
            tt = t[si, wi]
            qq, rr = q[wi], tile_refs[tt]
            dx = qq[:, :, None, 0] - rr[:, None, :, 0]
            dy = qq[:, :, None, 1] - rr[:, None, :, 1]
            dz = qq[:, :, None, 2] - rr[:, None, :, 2]
            d2 = (dx * dx + dy * dy) + dz * dz
            key = (d2.view(torch.int32).to(torch.int64) << 32) | (
                tile_rows[tt].to(torch.int64) & 0xFFFFFFFF)[:, None, :]
            best[si, wi] = torch.minimum(best[si, wi], key.amin(dim=-1))
            pairs += (n_valid[wi] * tile_n[tt]).sum()
    keys = best.amin(dim=0).flatten()[:n_qv]
    return (*_decode(keys, lay), int(pairs))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check_inputs(queries, refs, mask):
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
    _check(queries.shape[0] < 2 ** 31 // 3 and refs.shape[0] < 2 ** 31 // 3,
           "too many points")


def launch_culled(lay: CulledLayout, dist, idx, pair_count=None):
    """Run csrc/nn1.cu's culled pass and its finalize on a layout: dist
    (Q,) f32 and idx (Q,) int32 get each finite query's answer at its
    original row (the others are left as they are); lay.keys is reset to
    INF_KEY for the next launch.  pair_count: a (1,) int64 tensor on the
    device to which the kernel adds its evaluated pairs, or None."""
    global launches
    _check(dist.device.type == "cuda", f"unsupported device {dist.device}")
    _check(pair_count is None or (pair_count.dtype == torch.int64
                                  and pair_count.device == dist.device),
           "pair_count must be an int64 tensor on the device")
    n_qv = lay.queries.shape[0]
    if n_qv == 0 or lay.n_tiles == 0:
        return
    lib = cuda_build.load("nn1")
    fn = lib.fnc_nn1
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream(dist.device).cuda_stream
        err = fn(lay.queries.data_ptr(), lay.refs.data_ptr(),
                 lay.boxes.data_ptr(), lay.start.data_ptr(),
                 lay.q_pos.data_ptr(), lay.keys.data_ptr(), dist.data_ptr(),
                 idx.data_ptr(),
                 None if pair_count is None else pair_count.data_ptr(),
                 n_qv, lay.n_refs, lay.n_tiles, lay.splits, stream)
    if err != 0:
        raise RuntimeError(f"nn1 kernel launch failed: CUDA error {err}")
    launches += 1


def cuda_nn1(queries, refs, mask=None, pair_count=None):
    """The 1-NN on the tensors' device: the culled CUDA kernel for CUDA
    tensors, `nn1_plain` for CPU tensors.  queries (Q, 3), refs (R, 3)
    float32, mask (R,) bool or None.  Returns (dist (Q,) f32, idx (Q,)
    int32).  pair_count: see launch_culled (CUDA only)."""
    if queries.device.type == "cpu":
        return nn1_plain(queries, refs, mask)
    _check_inputs(queries, refs, mask)
    lay = culled_layout(queries, refs, mask)
    dist = torch.full((lay.n_q,), math.inf, device=queries.device)
    idx = torch.zeros(lay.n_q, dtype=torch.int32, device=queries.device)
    launch_culled(lay, dist, idx, pair_count)
    return dist, idx


def _brute_splits(n_q: int, n_r: int) -> tuple[int, int]:
    """(splits, refs per split) of the all-pairs pass: the refs in ranges
    of whole tiles over gridDim.y, enough to fill BRUTE_TARGET_BLOCKS
    blocks when the queries alone do not."""
    q_blocks = -(-n_q // BRUTE_QUERIES_PER_BLOCK)
    tiles = max(-(-n_r // BRUTE_TILE), 1)
    splits = max(1, min(-(-BRUTE_TARGET_BLOCKS // q_blocks), tiles, 65535))
    per = -(-tiles // splits) * BRUTE_TILE
    return -(-max(n_r, 1) // per), per


def cuda_nn1_brute(queries, refs, mask=None):
    """csrc/nn1.cu's all-pairs pass (the design the culled pass replaced)
    on CUDA tensors, the same function as cuda_nn1.  No path of the port
    calls it: chip_smoke.py times it beside the culled kernel."""
    global launches_brute
    _check_inputs(queries, refs, mask)
    n_q, n_r = queries.shape[0], refs.shape[0]
    dist = torch.empty(n_q, device=queries.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=queries.device)
    if n_q == 0:
        return dist, idx
    splits, per = _brute_splits(n_q, n_r)
    scratch_d2 = torch.empty(splits, n_q, device=queries.device)
    scratch_idx = torch.empty(splits, n_q, dtype=torch.int32,
                              device=queries.device)
    lib = cuda_build.load("nn1")
    fn = lib.fnc_nn1_brute
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
        raise RuntimeError(f"nn1 brute launch failed: CUDA error {err}")
    launches_brute += 1
    return dist, idx
