"""The culled 1-NN search (ops/cuda_knn.py: culled_layout,
nn1_culled_plain, the plain emulation of csrc/nn1.cu's culled pass)
against the plain twin nn1_plain, on the CPU.  The kernel runs only on
the card, where chip_smoke.py holds it against the same twin and its
count of evaluated pairs against the emulation's.

Tolerances: none.  The emulation must give the twin's distance and row
to the bit: it evaluates the same float32 expression on the same
points, and its skip test may drop only pairs whose computed d2 exceeds
a computed bound that no pair in the two boxes can undercut.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from scipy.spatial import cKDTree

from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene
from fisher_nerf_customized_tpu_torch.ops import cuda_knn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def assert_twin(q, r, mask=None, **sizes):
    """The emulation equals the twin to the bit; it evaluates at most every
    pair once, and each split's repeat of the opening tile."""
    d, i, pairs = cuda_knn.nn1_culled_plain(q, r, mask, **sizes)
    ref_d, ref_i = cuda_knn.nn1_plain(q, r, mask)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert torch.equal(d, ref_d), (d, ref_d)
    assert torch.equal(i, ref_i), (i, ref_i)
    lay = cuda_knn._layout(q, r, mask, **sizes)
    n_qv = lay.queries.shape[0]
    tile = sizes.get("tile", cuda_knn.TILE)
    assert 0 <= pairs <= n_qv * (lay.n_refs + (lay.splits - 1) * tile)
    return d, i, pairs


def points(rng, n, shape):
    """n points of a shape: on a 0.25 grid (exact duplicates, shared
    coordinates), uniform, on a line, on a plane, or one point."""
    if shape == "grid":
        return rng.integers(-4, 5, (n, 3)) * 0.25
    if shape == "uniform":
        return rng.uniform(-1.0, 1.0, (n, 3))
    p = np.zeros((n, 3))
    if shape == "collinear":
        p[:, 0] = rng.integers(-8, 9, n) * 0.125
        p[:, 1:] = 0.5
    elif shape == "coplanar":
        p[:, :2] = rng.integers(-8, 9, (n, 2)) * 0.125
        p[:, 2] = 0.25
    else:                                        # "point"
        p[:] = (0.3, -0.2, 0.1)
    return p


@st.composite
def cloud_cases(draw):
    n_r = draw(st.integers(0, 160))
    n_q = draw(st.integers(0, 90))
    shape = draw(st.sampled_from(["grid", "uniform", "collinear",
                                  "coplanar", "point"]))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
    r = points(rng, n_r, shape)
    q = points(rng, n_q, draw(st.sampled_from([shape, "uniform"])))
    if n_r:
        # queries on the refs (exact ties) and on the faces of boxes of
        # refs (each coordinate some ref's)
        k = n_q // 3
        q[:k] = r[rng.integers(0, n_r, k)]
        for axis in range(3):
            q[k:2 * k, axis] = r[rng.integers(0, n_r, k), axis]
    if n_r > 4:
        # exact duplicates far apart in row order (other tiles)
        src = rng.integers(0, n_r // 2, 4)
        r[n_r - 1 - np.arange(4)] = r[src]
    r, q = r.astype(np.float32), q.astype(np.float32)
    mask = None
    kind = draw(st.sampled_from(["none", "random", "all_masked"]))
    if kind == "random":
        mask = rng.uniform(size=n_r) < 0.6
    elif kind == "all_masked":
        mask = np.zeros(n_r, bool)
    # NaN and inf in masked and in unmasked rows, and in queries
    for arr, n in ((r, n_r), (q, n_q)):
        if n and draw(st.booleans()):
            bad = rng.integers(0, n, max(1, n // 8))
            arr[bad, rng.integers(0, 3, len(bad))] = rng.choice(
                [np.nan, np.inf, -np.inf], len(bad))
    sizes = draw(st.sampled_from([
        {},                                        # the kernel's sizes
        dict(tile=1, warp_queries=1, block_warps=1),
        dict(tile=4, warp_queries=3, block_warps=2),
        dict(tile=2, warp_queries=8, block_warps=1, splits=3),
        dict(tile=8, warp_queries=4, block_warps=2, splits=2),
        dict(tile=64, warp_queries=64, block_warps=8, splits=5),
    ]))
    return q, r, mask, sizes


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(cloud_cases())
def test_culled_equals_the_twin(case):
    q, r, mask, sizes = case
    assert_twin(t(q), t(r), None if mask is None else torch.from_numpy(mask),
                **sizes)


@pytest.mark.parametrize("n_q,n_r", [(0, 0), (0, 5), (5, 0), (1, 1), (1, 300),
                                     (300, 1), (17, 1000)])
def test_empty_single_and_sub_warp_clouds(n_q, n_r):
    rng = np.random.default_rng(n_q * 1000 + n_r)
    q = t(rng.uniform(-1, 1, (n_q, 3)))
    r = t(rng.uniform(-1, 1, (n_r, 3)))
    d, i, pairs = assert_twin(q, r)           # n_q < one warp's 64 queries
    if n_r == 0:
        assert torch.isinf(d).all() and not i.any() and pairs == 0


def test_all_masked_and_all_nonfinite_give_inf_row_0():
    rng = np.random.default_rng(3)
    q = t(rng.uniform(-1, 1, (70, 3)))
    r = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    d, i, pairs = assert_twin(q, t(r), torch.zeros(500, dtype=torch.bool))
    assert torch.isinf(d).all() and not i.any() and pairs == 0
    r[:, 1] = np.nan
    d, i, pairs = assert_twin(q, t(r))
    assert torch.isinf(d).all() and not i.any() and pairs == 0


def test_ties_across_tiles_and_splits_keep_the_lowest_row():
    """300 copies of one point (more than a tile, so neighbouring tiles,
    dealt to different splits) and three copies of 16 others at far rows:
    each query next to a copied point gets its lowest row."""
    rng = np.random.default_rng(4)
    r = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    many = np.arange(1000, 1000 + 300 * 9, 9)
    r[many] = r[5]
    src = np.arange(20, 20 + 16 * 11, 11)
    r[src + 1500] = r[src]
    r[src + 3500] = r[src]
    q = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    q[:16] = r[src] + np.float32(1e-4)
    q[16] = r[5] + np.float32(1e-4)
    for splits in (None, 1, 2, 7):
        _d, i, _pairs = assert_twin(t(q), t(r), splits=splits)
        np.testing.assert_array_equal(i.numpy()[:16], src)
        assert int(i[16]) == 5


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(*[st.floats(width=32, allow_nan=False,
                                      allow_infinity=False)] * 3),
                min_size=1, max_size=6),
       st.lists(st.tuples(*[st.floats(width=32, allow_nan=False,
                                      allow_infinity=False)] * 3),
                min_size=1, max_size=6),
       st.floats(0.0, 1.0), st.integers(0, 2))
def test_box_lower_bound_is_at_most_every_pair(qs, rs, mix, swap):
    """The computed bound between two point sets' boxes is at most every
    computed pair d2 between them, for any float32 coordinates; some
    queries take the refs' coordinates, so boxes touch and overlap."""
    q = np.asarray(qs, np.float32)
    r = np.asarray(rs, np.float32)
    if mix > 0.5:
        q[0, swap] = r[-1, swap]
        q[-1] = r[0]
    qt, rt = t(q), t(r)
    lb = cuda_knn.box_lower_bound(qt.amin(0), qt.amax(0), rt.amin(0),
                                  rt.amax(0))
    dx = qt[:, None, 0] - rt[None, :, 0]
    dy = qt[:, None, 1] - rt[None, :, 1]
    dz = qt[:, None, 2] - rt[None, :, 2]
    d2 = (dx * dx + dy * dy) + dz * dz
    assert not torch.isnan(lb)
    assert bool((d2 >= lb).all()), (lb, d2.min())


def test_pairs_well_below_all_pairs_on_a_surface_cloud():
    """A corner of a multi-room scene's surface cloud (the queries, as the
    recon metric's ground truth) against a noisy cloud of the whole scene
    at the recon update's 80 000 points: at the kernel's sizes the search
    evaluates about 2 % of the pairs, with cKDTree's distances."""
    scene = BoxScene.multi_room(seed=0)
    rng = np.random.default_rng(0)
    gt = scene.sample_surface_points(400_000, rng=rng).astype(np.float32)
    lo = gt.min(axis=0)
    q = gt[(gt[:, 0] < lo[0] + 3.0) & (gt[:, 2] < lo[2] + 3.0)]
    r = (scene.sample_surface_points(80_000, rng=rng)
         + rng.normal(0, 0.01, (80_000, 3))).astype(np.float32)
    d, _i, pairs = cuda_knn.nn1_culled_plain(t(q), t(r))
    share = pairs / (len(q) * len(r))
    print(f"{len(q)} queries: {pairs} pairs ({share:.4f} of Q x R)")
    assert share < 0.05
    ref, _ = cKDTree(r.astype(np.float64)).query(q.astype(np.float64))
    np.testing.assert_allclose(d.numpy(), ref, rtol=0, atol=1e-6)


def test_layout_tiles_boxes_and_walk():
    """Every finite unmasked ref is staged once, with its row, in key
    order; each tile's box holds its refs; queries keep their rows; each
    block's walk visits every tile once, and the splits deal its steps
    round-robin, each but the first opening with the walk's first
    tile."""
    rng = np.random.default_rng(6)
    r = rng.uniform(-2, 2, (1000, 3)).astype(np.float32)
    r[7, 0] = np.nan
    mask = torch.from_numpy(rng.uniform(size=1000) < 0.7)
    q = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
    q[11, 2] = np.inf
    lay = cuda_knn.culled_layout(t(q), t(r), mask)
    kept = np.flatnonzero(mask.numpy() & np.isfinite(r).all(1))
    rows = lay.refs.view(torch.int32)[:, 3].numpy()
    assert lay.n_refs == len(kept) and lay.refs.shape[0] == (
        lay.n_tiles * cuda_knn.TILE)
    np.testing.assert_array_equal(np.sort(rows[:lay.n_refs]), kept)
    assert (rows[lay.n_refs:] == -1).all()
    np.testing.assert_array_equal(lay.refs[:lay.n_refs, :3].numpy(),
                                  r[rows[:lay.n_refs]])
    pts = lay.refs[:, :3].reshape(lay.n_tiles, cuda_knn.TILE, 3)
    real = torch.arange(lay.n_tiles * cuda_knn.TILE).reshape(
        lay.n_tiles, cuda_knn.TILE) < lay.n_refs
    assert bool(((pts >= lay.boxes[:, None, :3])
                 & (pts <= lay.boxes[:, None, 4:7]))[real].all())
    np.testing.assert_array_equal(np.sort(lay.q_pos.numpy()),
                                  np.delete(np.arange(3000), 11))
    np.testing.assert_array_equal(lay.queries.numpy(),
                                  q[lay.q_pos.numpy()])
    assert lay.start.shape[0] == -(-2999 // cuda_knn.QUERIES_PER_BLOCK)
    assert int(lay.start.min()) >= 0 and int(lay.start.max()) < lay.n_tiles
    n_t, s = lay.n_tiles, 3
    for c in lay.start.tolist():
        walk = cuda_knn.visit_tile(torch.tensor(c), n_t, torch.arange(n_t))
        assert sorted(walk.tolist()) == list(range(n_t)) and int(walk[0]) == c
        dealt = sorted(int(x) for split in range(s) for x in walk[
            cuda_knn.split_steps(torch.tensor(split), s, torch.arange(int(
                cuda_knn.n_split_steps(torch.tensor(split), s, n_t))))])
        assert dealt == sorted([c] * (s - 1) + list(range(n_t)))


def test_the_card_wrappers_refuse_cpu_tensors():
    q, r = t(np.zeros((4, 3))), t(np.ones((5, 3)))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_knn.cuda_nn1_brute(q, r)
    lay = cuda_knn.culled_layout(q, r)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_knn.launch_culled(lay, torch.zeros(4),
                               torch.zeros(4, dtype=torch.int32))
    assert cuda_knn.launches == 0 and cuda_knn.launches_brute == 0
    assert math.isinf(float(cuda_knn.nn1_culled_plain(q, r[:0])[0][0]))
