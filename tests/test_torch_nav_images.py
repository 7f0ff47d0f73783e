"""The navigation images, the port against the JAX package (whose images
cv2 draws and writes): MapVisualizer.render and save_occ_map_png pixel
for pixel, their PNGs read back with cv2 equal; a FisherRF episode with
policy.save_nav_images in both packages (test_engine.py's episode_cfg,
21 steps): the same planning_vis/plan_*.png per planning event and
nav_images/topdown_*.png at steps 0 and 20, equal; and render_bev on
both final maps (the port's K1 twin against the JAX package's XLA
engine: PSNR of one against the other at least 40 dB).
"""
import os

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fisher_nerf_customized_tpu.engine import driver as jdriver
from fisher_nerf_customized_tpu.engine import visualization as jvis
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene as JScene
from fisher_nerf_customized_tpu.envs.fake_sim import FakeSim as JSim
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.engine import visualization as tvis
from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene as TScene
from fisher_nerf_customized_tpu_torch.envs.fake_sim import FakeSim as TSim
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

from test_engine import IMG, episode_cfg
from test_torch_episode import port_cfg

STEPS = 21
SETTINGS = settings(max_examples=25, deadline=None)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def visualizers(seed):
    """Both packages' MapVisualizer after the same seeded walk."""
    rng = np.random.default_rng(seed)
    scene = JScene.default(seed=seed)
    free = scene.gt_free_map(0.1, np.array([96, 80]), np.zeros(2))
    out = [m.MapVisualizer(free, 0.1, np.zeros(2), vis_range=3.0)
           for m in (jvis, tvis)]
    c2w = np.eye(4)
    c2w[1, 3] = 1.25
    for _ in range(int(rng.integers(1, 12))):
        yaw = rng.uniform(-np.pi, np.pi)
        c2w[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]]
        c2w[[0, 2], 3] = rng.uniform(-5, 5, 2)
        obj = rng.uniform(-5, 5, 3)
        for v in out:
            v.update_fow_sim(c2w)
            v.update_object(obj)
    return out


@SETTINGS
@given(st.integers(0, 2 ** 31 - 1))
def test_render_matches_cv2(seed):
    ref, got = visualizers(seed)
    np.testing.assert_array_equal(got.render(), ref.render())


def test_saved_topdown_png_matches(tmp_path):
    ref, got = visualizers(3)
    ref.save_vis_seen(str(tmp_path / "jax"), 7)
    got.save_vis_seen(str(tmp_path / "port"), 7)
    name = "topdown_00007.png"
    a = cv2.imread(str(tmp_path / "port" / name), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)
    assert a.shape == b.shape == ref.gt_free.shape + (3,)
    np.testing.assert_array_equal(a, b)


@SETTINGS
@given(st.integers(0, 2 ** 31 - 1), st.integers(0, 40), st.booleans(),
       st.booleans())
def test_occ_map_png_matches_cv2(tmp_path_factory, seed, n_cand, agent,
                                 frontier):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(8, 64, 2)
    occ = rng.random((3, h, w)).astype(np.float32)
    occ[:, rng.random((h, w)) < 0.3] = 0.5          # argmax ties
    cands = np.stack([rng.integers(-2, w + 2, n_cand),
                      rng.integers(-2, h + 2, n_cand)], 1)
    scores = rng.random(n_cand) * rng.choice([0.0, 1.0, 50.0])
    kw = dict(candidates=cands, scores=scores,
              agent_cell=(rng.integers(0, w), rng.integers(0, h))
              if agent else None,
              frontier=(rng.random((h, w)) < 0.05).astype(np.uint8)
              if frontier else None)
    tmp = tmp_path_factory.mktemp("occ")
    jvis.save_occ_map_png(occ, str(tmp / "jax.png"), **kw)
    tvis.save_occ_map_png(occ, str(tmp / "port.png"), **kw)
    a = cv2.imread(str(tmp / "port.png"), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(tmp / "jax.png"), cv2.IMREAD_UNCHANGED)
    assert a.shape == (h, w, 3)
    np.testing.assert_array_equal(a, b)


def run(pkg, tmp_path):
    cfg = episode_cfg(tmp_path / pkg, steps=STEPS)
    cfg.policy.save_nav_images = True
    if pkg == "jax":
        cam_t, scene_t, sim_t, drv, kw = JCamera, JScene, JSim, jdriver, {}
        sim_kw = dict(device_obs=False)
    else:
        cfg = port_cfg(cfg)
        cam_t, scene_t, sim_t, drv = TCamera, TScene, TSim, tdriver
        kw = sim_kw = dict(device="cpu")
    cam = cam_t(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                width=IMG, height=IMG)
    scene = scene_t(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                    obstacles=[((1.0, 0.0, 1.0), (1.8, 1.8, 1.8))])
    sim = sim_t(scene, cam, forward_step=0.15, turn_angle=30.0, seed=3,
                **sim_kw)
    actions = []
    sim_step = sim.step

    def step(a):
        actions.append(int(a))
        return sim_step(a)

    sim.step = step
    mapper = drv.ActiveMapper(cfg, sim, scene=scene, seed=0, **kw)
    result = mapper.test_navigation(n_eval_poses=0)
    return actions, result, mapper


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nav")
    return run("jax", tmp), run("torch", tmp)


def pngs(mapper, sub):
    d = os.path.join(mapper.eval_dir, sub)
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_nav_images_episode_matches(episodes):
    (ja, jres, jm), (ta, tres, tm) = episodes
    assert ta == ja and tres["steps"] == jres["steps"] == STEPS
    plans = pngs(tm, "planning_vis")
    assert plans == pngs(jm, "planning_vis")
    assert len(plans) == tres["planning_events"] >= 1
    assert pngs(tm, "nav_images") == pngs(jm, "nav_images") == \
        ["topdown_00000.png", "topdown_00020.png"]
    grid = tuple(int(g) for g in tm.planner.grid_dim[::-1])
    for sub, names in (("planning_vis", plans),
                       ("nav_images", pngs(tm, "nav_images"))):
        for name in names:
            a = cv2.imread(os.path.join(tm.eval_dir, sub, name),
                           cv2.IMREAD_UNCHANGED)
            b = cv2.imread(os.path.join(jm.eval_dir, sub, name),
                           cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(a, b, err_msg=name)
            if sub == "planning_vis":
                assert a.shape == grid + (3,)


def test_render_bev_matches(episodes):
    (_ja, _jr, jm), (_ta, _tr, tm) = episodes
    got = tm.planner.render_bev(tm.slam)
    want = jm.planner.render_bev(jm.slam)
    a, b = got["render"].numpy(), np.asarray(want["render"])
    assert a.shape == b.shape == (IMG, IMG, 3)
    assert np.isfinite(a).all() and 0.0 < a.mean() < 1.0
    mse = float(np.mean((a - b) ** 2))
    assert mse == 0.0 or 10 * np.log10(1.0 / mse) >= 40.0, mse
