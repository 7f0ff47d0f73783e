"""The port's ops/knn.py against scipy's cKDTree and the JAX package's
ops/knn.py, on the CPU (the plain twins; the 1-NN kernel runs only on
the card, where chip_smoke.py holds it against the same twin).

Tolerances:
- the twin against cKDTree at atol 1e-6: both take direct differences of
  the same points, the twin in float32 on centred inputs;
- the twin against the JAX package's knn at its own atol 1e-3
  (tests/test_knn_tracking.py): the JAX package expands
  |q|^2 + |r|^2 - 2 q.r in float32, which cancels; its rows are held
  equal wherever cKDTree's gap between the first and the second
  neighbour exceeds 2e-3, so that its rounding cannot reorder them;
- the novelty mask against the JAX package's: equal on every pixel
  except those whose float64 cKDTree distance lies within 1e-3 m of the
  5 cm cut (the two round the back-projection and the distance
  differently there), and the min_pixels gate decided the same way;
- exact ties (duplicated points) keep the lowest row, across chunk
  borders and across the kernel's split of the refs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from fisher_nerf_customized_tpu.envs import fake_sim as jsim
from fisher_nerf_customized_tpu.ops import knn as jknn
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch.ops import cuda_knn
from fisher_nerf_customized_tpu_torch.ops import knn as tknn

IMG = 48


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clouds(seed, n_q=400, n_r=3000, offset=0.0):
    rng = np.random.default_rng(seed)
    q = (rng.uniform(-0.5, 0.5, (n_q, 3)) + offset).astype(np.float32)
    r = (rng.uniform(-0.5, 0.5, (n_r, 3)) + offset).astype(np.float32)
    return q, r


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("chunk", [700, 65536])
def test_twin_matches_ckdtree(k, chunk):
    q, r = clouds(0)
    d, i = tknn.knn(t(q), t(r), k=k, chunk=chunk)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert d.shape == (len(q), k) and i.shape == (len(q), k)
    ref_d, ref_i = cKDTree(r.astype(np.float64)).query(q, k=k)
    ref_d, ref_i = ref_d.reshape(len(q), k), ref_i.reshape(len(q), k)
    np.testing.assert_allclose(d.numpy(), ref_d, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), ref_i)


@pytest.mark.parametrize("k", [1, 3])
def test_knn_matches_jax(k):
    q, r = clouds(1, offset=3.0)       # off-centre: the expansion's cancel
    d, i = tknn.knn(t(q), t(r), k=k, chunk=1024)
    ref_d, ref_i = jknn.knn(jnp.asarray(q), jnp.asarray(r), k=k, chunk=1024)
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), rtol=0,
                               atol=1e-3)
    kd, _ = cKDTree(r.astype(np.float64)).query(q, k=k + 1)
    clear = np.diff(kd, axis=1)[:, :k] > 2e-3
    np.testing.assert_array_equal(i.numpy()[clear], np.asarray(ref_i)[clear])
    assert clear.mean() > 0.5


def test_ref_mask_with_nan_in_masked_row():
    q, r = clouds(2, n_r=2000)
    mask = np.random.default_rng(3).uniform(size=len(r)) < 0.6
    r_bad = r.copy()
    r_bad[np.flatnonzero(~mask)[:5]] = np.nan
    r_bad[np.flatnonzero(~mask)[5]] = np.inf
    d, i = tknn.knn(t(q), t(r_bad), k=2, ref_mask=t(mask), chunk=512)
    keep = np.flatnonzero(mask)
    ref_d, ref_i = cKDTree(r[keep].astype(np.float64)).query(q, k=2)
    assert np.isfinite(d.numpy()).all()
    np.testing.assert_allclose(d.numpy(), ref_d, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), keep[ref_i])
    ref_j, ref_ji = jknn.knn(jnp.asarray(q), jnp.asarray(r_bad), k=2,
                             ref_mask=jnp.asarray(mask), chunk=512)
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_j), atol=1e-3)


def test_all_masked_cloud():
    q, r = clouds(4, n_q=50, n_r=300)
    mask = np.zeros(len(r), bool)
    for k in (1, 2):
        d, i = tknn.knn(t(q), t(r), k=k, ref_mask=t(mask), chunk=128)
        assert np.isinf(d.numpy()).all() and (i.numpy() == 0).all()
        ref_d, ref_i = jknn.knn(jnp.asarray(q), jnp.asarray(r), k=k,
                                ref_mask=jnp.asarray(mask), chunk=128)
        assert np.isinf(np.asarray(ref_d)).all()
        assert (np.asarray(ref_i) == 0).all()


def tied_clouds(n_r=3000, chunk=1000):
    """Refs holding exact duplicates on either side of chunk borders and
    inside a chunk, and queries placed at the duplicated points."""
    q, r = clouds(5, n_q=64, n_r=n_r)
    src = np.arange(0, n_r - chunk, 97)[:16]
    for s in src:
        r[s + chunk] = r[s]                    # across a chunk border
        r[s + 3] = r[s]                        # within the chunk
    q[:len(src)] = r[src] + np.float32(1e-3)
    return q, r, src


def test_exact_ties_keep_the_lowest_row():
    q, r, src = tied_clouds()
    for k in (1, 3):
        d, i = tknn.knn(t(q), t(r), k=k, chunk=1000)
        first = i.numpy()[:len(src), 0]
        np.testing.assert_array_equal(first, src)
        if k == 3:
            # the three copies, lowest first
            np.testing.assert_array_equal(
                i.numpy()[:len(src)], np.stack([src, src + 3, src + 1000], 1))
            assert (d.numpy()[:len(src), 0] == d.numpy()[:len(src), 2]).all()


def test_kernel_splits_cover_the_refs_with_whole_tiles():
    for n_q, n_r in [(3277, 1_200_000), (65536, 400_000), (1_200_000, 80_000),
                     (1, 1), (5000, 0), (17, 1025), (2048, 3_000_000)]:
        splits, per = cuda_knn._splits(n_q, n_r)
        assert per % cuda_knn.TILE == 0 and 1 <= splits <= 65535
        assert splits * per >= n_r and (splits - 1) * per < max(n_r, 1)
        q_blocks = -(-n_q // cuda_knn.QUERIES_PER_BLOCK)
        if q_blocks >= cuda_knn.TARGET_BLOCKS:
            assert splits == 1


def test_split_merge_keeps_the_lowest_row_across_splits():
    """The kernel's two passes on the twin: each split's partial 1-NN over
    its range of refs, merged in ascending split order by strictly
    smaller d2, equal the 1-NN over all refs, ties across a split border
    included."""
    q, r, src = tied_clouds(n_r=4096, chunk=1024)
    mask = np.ones(len(r), bool)
    mask[7] = False
    qc, rc = tknn.center_inputs(t(q), t(r), t(mask))
    per = 1024
    best, best_i = None, None
    for s0 in range(0, len(r), per):
        d, i = cuda_knn.nn1_plain(qc, rc[s0:s0 + per], t(mask[s0:s0 + per]))
        i = torch.where(torch.isinf(d), torch.zeros_like(i), i + s0)
        if best is None:
            best, best_i = d, i
        else:
            better = d < best
            best = torch.where(better, d, best)
            best_i = torch.where(better, i, best_i)
    d, i = cuda_knn.nn1_plain(qc, rc, t(mask), chunk=1000)
    assert torch.equal(best, d) and torch.equal(best_i, i)
    np.testing.assert_array_equal(i.numpy()[:len(src)], src)


def test_wrapper_runs_the_twin_on_the_cpu():
    q, r = clouds(6, n_q=100, n_r=500)
    n = cuda_knn.launches
    d, i = cuda_knn.cuda_nn1(t(q), t(r))
    ref_d, ref_i = cuda_knn.nn1_plain(t(q), t(r))
    assert torch.equal(d, ref_d) and torch.equal(i, ref_i)
    assert cuda_knn.launches == n


def test_knn_self_and_mean_sq_neighbor_dist_match_jax():
    _q, r = clouds(7, n_r=1500)
    mask = np.random.default_rng(8).uniform(size=len(r)) < 0.8
    for m in (None, mask):
        d, i = tknn.knn_self(t(r), k=4, mask=None if m is None else t(m),
                             chunk=512)
        ref_d, ref_i = jknn.knn_self(jnp.asarray(r), k=4,
                                     mask=None if m is None
                                     else jnp.asarray(m), chunk=512)
        np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), atol=1e-3)
        kd, _ = cKDTree(r[m] if m is not None else r).query(r, k=6)
        clear = np.diff(kd, axis=1)[:, :5] > 2e-3
        clear = clear[:, :4] & clear[:, 1:5]
        np.testing.assert_array_equal(i.numpy()[clear],
                                      np.asarray(ref_i)[clear])
    got = tknn.mean_sq_neighbor_dist(t(r), k=3)
    ref = jknn.mean_sq_neighbor_dist(jnp.asarray(r), k=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def novelty_inputs(yaw, seed=2):
    """A 48x48 frame of the JAX package's known-env test scene (a 6 m room,
    a 0.5 x 1.2 x 0.5 m object at (0, 1.8)), the empty room's cloud."""
    cam = JCamera(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                  width=IMG, height=IMG)
    scene = jsim.BoxScene(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                          obstacles=[])
    obj = jsim.SimObject(scene, semantic_id=100, size=(0.5, 1.2, 0.5),
                         start_xz=(0.0, 1.8), speed=0.03, seed=seed)
    sim = jsim.FakeSim(scene, cam, forward_step=0.15, turn_angle=30.0,
                       dynamic_object=obj, seed=seed, device_obs=False)
    obs = sim.reset(yaw=yaw)
    empty = jsim.BoxScene(room_lo=scene.room_lo, room_hi=scene.room_hi,
                          obstacles=[])
    gt = empty.sample_surface_points(40000)
    inv_k = np.linalg.inv(sim.intrinsics).astype(np.float32)
    return (gt, np.asarray(obs["depth"], np.float32), inv_k,
            np.asarray(obs["c2w"], np.float32))


@pytest.mark.parametrize("yaw", [0.0, 0.4, np.pi])
def test_novelty_mask_matches_jax(yaw):
    gt, depth, inv_k, c2w = novelty_inputs(yaw)
    ref, ref_n = jknn.novelty_mask_from_pcd_nn(
        jnp.asarray(gt), jnp.asarray(depth), jnp.asarray(inv_k),
        jnp.asarray(c2w))
    got, got_n = tknn.novelty_mask_from_pcd_nn(t(gt), t(depth), t(inv_k),
                                               t(c2w))
    ref, got = np.asarray(ref), got.numpy()
    # the cKDTree distance of each pixel's point, in float64
    ys, xs = np.mgrid[0:IMG, 0:IMG]
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    cam = (pix @ inv_k.astype(np.float64).T) * depth[..., None]
    pts = cam @ c2w[:3, :3].astype(np.float64).T + c2w[:3, 3]
    d, _ = cKDTree(gt.astype(np.float64)).query(pts.reshape(-1, 3))
    near = (np.abs(d - 0.05) < 1e-3).reshape(IMG, IMG)
    print(f"yaw {yaw}: {int(near.sum())} pixels within 1e-3 m of the cut, "
          f"novel {int(got_n)} (JAX {int(ref_n)})")
    assert (int(got_n) >= 20) == (int(ref_n) >= 20)
    np.testing.assert_array_equal(got[~near], ref[~near])
    if yaw == 0.0:                       # facing the object
        assert got.sum() > 20


def test_novelty_mask_gate():
    gt, depth, inv_k, c2w = novelty_inputs(0.0)
    free = np.zeros_like(depth)
    free[:2, :5] = depth[:2, :5]          # too few pixels to count
    mask, n = tknn.novelty_mask_from_pcd_nn(t(gt), t(free), t(inv_k),
                                            t(c2w))
    assert not mask.numpy().any() and int(n) <= 10
    mask, n = tknn.novelty_mask_from_pcd_nn(t(gt), t(depth), t(inv_k),
                                            t(c2w), min_pixels=10 ** 6)
    assert not mask.numpy().any() and int(n) > 20
