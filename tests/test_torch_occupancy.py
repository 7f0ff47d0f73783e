"""The occupancy update and the sweep field, JAX package against the
PyTorch port on the CPU.

  * occ_update on FakeSim depth frames (64x64, 13 frames, a 160x160 map
    at 5 cm) and on random depth at random poses: equal to rtol 1e-6 (in
    practice bit for bit: the port follows the JAX package's compiled
    arithmetic, so every vote lands in the same cell; counts are whole
    numbers in f32);
  * sweep_field on random free maps: cost to atol 1e-3 (in practice
    equal) and parent exact, also when max_iters stops the relaxation
    early; SweepSearch.plan: the same paths, on the whole grid and on the
    free-space window of a large grid.
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene, FakeSim
from fisher_nerf_customized_tpu.ops.camera import Camera
from fisher_nerf_customized_tpu.planning import occupancy as jocc
from fisher_nerf_customized_tpu.planning import sweep as jsweep
from fisher_nerf_customized_tpu.planning.astar import _collision_cost
from fisher_nerf_customized_tpu_torch.planning import occupancy as tocc
from fisher_nerf_customized_tpu_torch.planning import sweep as tsweep

IMG = 64
GRID = 160
CELL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under the suite's six
    workers, torch's default of one thread per core oversubscribes the
    CPU beside XLA's own pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(frames, cam, mc, grid=GRID):
    occ = np.zeros((3, grid, grid), np.float32)
    occ[0] = 1.0
    jm, tm = jnp.asarray(occ), torch.from_numpy(occ)
    out = []
    for depth, c2w in frames:
        jm, jcp = jocc.occ_update(jm, jnp.asarray(depth), jnp.asarray(c2w),
                                  cam, CELL, jnp.asarray(mc), 0.2, 1.5, 3.0)
        tm, tcp = tocc.occ_update(tm, torch.from_numpy(depth),
                                  torch.from_numpy(c2w), cam, CELL,
                                  torch.from_numpy(mc), 0.2, 1.5, 3.0)
        out.append((np.asarray(jm), tm.numpy(), np.asarray(jcp),
                    tcp.numpy()))
    return out


def test_occ_update_matches_jax_on_fake_sim_frames():
    cam = Camera(fx=IMG / 2, fy=IMG / 2, cx=IMG / 2, cy=IMG / 2, width=IMG,
                 height=IMG)
    sim = FakeSim(BoxScene.multi_room(seed=3), cam, forward_step=0.25,
                  turn_angle=30.0)
    obs = [sim.reset(yaw=0.3)]
    for a in np.random.default_rng(0).choice([1, 1, 2, 3], 12):
        obs.append(sim.step(int(a)))
    frames = [(np.array(o["depth"], np.float32),
               np.array(o["c2w"], np.float32)) for o in obs]
    mc = np.asarray(frames[0][1][[0, 2], 3], np.float32)
    for ref, got, ref_cp, got_cp in _run_both(frames, cam, mc):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got_cp, ref_cp)
    # the frames voted: free, occupied and unknown cells all present
    labels = got.argmax(axis=0)
    assert {0, 1, 2} <= set(np.unique(labels).tolist())


@pytest.mark.parametrize("seed", [0, 1])
def test_occ_update_matches_jax_on_random_depth(seed):
    """Dense random depth at random yaws and positions: ~100k votes per
    frame, many of them near cell edges."""
    img = 96
    cam = Camera(fx=img / 2, fy=img / 2, cx=img / 2, cy=img / 2, width=img,
                 height=img)
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(4):
        yaw = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) \
            @ np.diag([-1.0, -1.0, 1.0])
        c2w[:3, 3] = [rng.uniform(-1, 1), 1.25, rng.uniform(-1, 1)]
        frames.append((rng.uniform(0.3, 3.5, (img, img)).astype(np.float32),
                       c2w))
    mc = np.asarray([0.013, -0.021], np.float32)
    for ref, got, _r, _g in _run_both(frames, cam, mc, grid=200):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_discretize_coords_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-30, 30, 500).astype(np.float32)
    z = rng.uniform(-30, 30, 500).astype(np.float32)
    mc = np.asarray([0.3, -0.2], np.float32)
    ref = jocc.discretize_coords(jnp.asarray(x), jnp.asarray(z), (768, 700),
                                 0.05, jnp.asarray(mc))
    got = tocc.discretize_coords(torch.from_numpy(x), torch.from_numpy(z),
                                 (768, 700), torch.tensor(0.05),
                                 torch.from_numpy(mc))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _free_map(rng, h, w, p_obstacle):
    occ = (rng.uniform(size=(h, w)) < p_obstacle).astype(np.uint8)
    occ = cv2.dilate(occ, np.ones((3, 3), np.uint8))
    free = occ == 0
    ys, xs = np.nonzero(free)
    i = rng.integers(len(ys))
    return occ, free, (int(ys[i]), int(xs[i]))


@pytest.mark.parametrize("seed,max_iters", [(0, 600), (1, 600), (2, 9),
                                            (3, 600)])
def test_sweep_field_matches_jax(seed, max_iters):
    rng = np.random.default_rng(seed)
    occ, free, start = _free_map(rng, int(rng.integers(40, 110)),
                                 int(rng.integers(40, 110)),
                                 [0.004, 0.02, 0.004, 0.06][seed])
    tier = _collision_cost(cv2.distanceTransform(free.astype(np.uint8),
                                                 cv2.DIST_L1, 5))
    ref_c, ref_p = jsweep.sweep_field(jnp.asarray(free),
                                      jnp.asarray(tier, jnp.float32),
                                      jnp.asarray(start, jnp.int32),
                                      max_iters=max_iters)
    got_c, got_p, rounds = tsweep.sweep_field(
        torch.from_numpy(free), torch.from_numpy(tier.astype(np.float32)),
        start, max_iters=max_iters, check_every=4)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    assert got_p.dtype == torch.int8 and 0 < rounds <= max_iters
    assert (got_c.numpy() < 3e38).sum() > 10


@pytest.mark.parametrize("window", [False, True])
def test_sweep_search_plans_like_jax(window):
    """Paths to 40 goals (half of them free cells); with `window` the free
    space sits in the middle of a 200x200 grid and the port sweeps only
    its window."""
    rng = np.random.default_rng(5)
    occ, free, start = _free_map(rng, 70, 90, 0.01)
    if window:
        big_occ = np.ones((200, 200), np.uint8)
        big_occ[60:130, 50:140] = occ
        occ, free = big_occ, big_occ == 0
        start = (start[0] + 60, start[1] + 50)
    ref = jsweep.SweepSearch(occ, free.astype(np.uint8), start)
    got = tsweep.SweepSearch(occ, free.astype(np.uint8), start, device="cpu")
    assert (got.window != ((0, occ.shape[0]), (0, occ.shape[1]))) == window
    n_paths = 0
    fy, fx = np.nonzero(free)
    for i in range(40):
        j = int(rng.integers(len(fy)))
        goal = (int(fy[j]), int(fx[j])) if i % 2 else (
            int(rng.integers(occ.shape[0])), int(rng.integers(occ.shape[1])))
        a, b = ref.plan(goal), got.plan(goal)
        np.testing.assert_array_equal(b, a)
        n_paths += len(b) > 0
    assert n_paths > 5
    np.testing.assert_array_equal(got.parent, ref.parent)
