"""The whole map-query slice, JAX package against the PyTorch port on the
same frames: build a map without an optimiser (init, then _densify every
map_every frames, keyframes every keyframe_every frames), render it at
the keyframe poses, sum H_train over the keyframes and score candidate
poses by EIG.  Small size: 64x64 frames, 5 frames, 8 candidates.

Tolerances: the map after init + _densify matches exactly in n_active
and to rtol 1e-5 in its parameters; renders to atol 1e-3; H_train to
rtol 1e-2 (the JAX package runs its XLA engines on the CPU, which never
stop a tile early, while the port's twins stop at T < 1e-4 as the
kernels do); pose_eval by ranking: Spearman >= 0.99 and the same argmax.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import spearmanr

from fisher_nerf_customized_tpu.config import get_cfg_defaults as jcfg
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene, FakeSim
from fisher_nerf_customized_tpu.models import slam as jslam
from fisher_nerf_customized_tpu.ops.camera import Camera
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.models import slam as tslam
from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
    PARAM_KEYS, state_from_numpy, state_to_numpy)
from fisher_nerf_customized_tpu_torch.planning.candidates import (
    generate_candidates)

YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "mp3d_gaussian_FR_eccv.yaml")
IMG = 64
ACTIONS = [2, 1, 2, 1]          # 5 frames with the first


def make_cfg(get_defaults, workdir):
    cfg = get_defaults()
    cfg.merge_from_file(YAML)
    cfg.SLAM.Dataset.Calibration.merge_from_other(dict(
        fx=IMG / 2, fy=IMG / 2, cx=IMG / 2, cy=IMG / 2, width=IMG,
        height=IMG))
    cfg.workdir = str(workdir)
    cfg.run_name = "slice"
    cfg.map_every = 2
    cfg.keyframe_every = 2
    cfg.tpu.capacity = 4096
    cfg.tpu.pose_chunk = 8
    return cfg


def build_map(mod, slam, frames, to_w2c):
    """init + _densify + keyframes.append, as GaussianSLAM does before its
    Adam phase; `mod` is either package's models.slam module."""
    color, depth, w2c = frames[0]
    slam.init(color, depth, w2c)
    cfg = slam.cfg
    for t in range(1, len(frames)):
        color, depth, w2c = frames[t]
        c, d = slam._prep_inputs(color, depth)
        if (t + 1) % int(cfg.map_every) == 0:
            ds = slam.mc.downsample_pcd
            slam._ensure_capacity((IMG // ds) * (IMG // ds))
            slam.state, dropped, _n, overflow = mod._densify(
                slam.state, c, d, to_w2c(w2c), float(t), slam.camera,
                slam.settings, slam.mc)
            assert int(dropped) == 0
            slam._maybe_bump_tile_capacity(int(overflow), 2)
        if (t + 1) % int(cfg.keyframe_every) == 0:
            slam.keyframes.append(c, d, w2c, t)
            slam.keyframe_time_indices.append(t)
        slam.poses_w2c.append(w2c)
        slam.frame_idx = t


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    cam = Camera(fx=IMG / 2, fy=IMG / 2, cx=IMG / 2, cy=IMG / 2, width=IMG,
                 height=IMG)
    sim = FakeSim(BoxScene.multi_room(seed=3), cam, forward_step=0.25,
                  turn_angle=30.0)
    obs = [sim.reset(yaw=0.3)] + [sim.step(a) for a in ACTIONS]
    frames = [(np.array(o["rgb"]), np.array(o["depth"]),
               np.linalg.inv(o["c2w"]).astype(np.float32)) for o in obs]
    js = jslam.GaussianSLAM(make_cfg(jcfg, tmp / "jax"))
    ts = tslam.GaussianSLAM(make_cfg(tcfg, tmp / "torch"), device="cpu")
    build_map(jslam, js, frames, jnp.asarray)
    build_map(tslam, ts, frames, ts._w2c)
    cands = generate_candidates(np.array([[0.0, 0.0]], np.float32), 8, 1.0,
                                0.5, 1.25, np.random.default_rng(0))
    return dict(js=js, ts=ts, frames=frames, cands=cands, tmp=tmp)


def test_map_after_init_and_densify_matches(built):
    js, ts = built["js"], built["ts"]
    n = js.n_active
    assert ts.n_active == n
    assert len(ts.keyframes) == len(js.keyframes) == 3
    got = state_to_numpy(ts.state)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(got[k][:n],
                                   np.asarray(getattr(js.state, k))[:n],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["timestep"][:n],
                                  np.asarray(js.state.timestep)[:n])
    assert ts.settings.max_per_tile == js.settings.max_per_tile


def test_render_at_pose_matches(built):
    js, ts = built["js"], built["ts"]
    for _color, _depth, w2c in built["frames"][::2]:
        c2w = np.linalg.inv(w2c)
        ref = js.render_at_pose(c2w)
        got = ts.render_at_pose(c2w)
        for k in ("render", "depth", "depth_acc", "sil"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       atol=1e-3, err_msg=k)


def test_render_masked_and_batched_match(built):
    """render_at_pose with a visibility mask, and render_at_poses (one
    call for several poses) against per-pose renders and the JAX mask."""
    js, ts = built["js"], built["ts"]
    c2ws = np.stack([np.linalg.inv(f[2]) for f in built["frames"][:3]])
    mask = np.random.default_rng(1).uniform(size=ts.n_active) < 0.5
    ref = js.render_at_pose(c2ws[1], mask=mask)
    got = ts.render_at_pose(c2ws[1], mask=mask)
    for k in ("render", "depth", "depth_acc", "sil"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-3, err_msg=k)
    batch = ts.render_at_poses(c2ws)
    for i, c2w in enumerate(c2ws):
        one = ts.render_at_pose(c2w)
        for k in one:
            assert torch.equal(batch[k][i], one[k])


def test_compute_hessian_matches(built):
    js, ts = built["js"], built["ts"]
    w2c = built["frames"][2][2]
    ref = np.asarray(js.compute_Hessian(w2c, return_points=True))
    got = ts.compute_Hessian(w2c, return_points=True).numpy()
    assert ref.max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-12)
    assert ts.compute_Hessian(w2c).shape == (ts.state.capacity * 4,)


def test_h_train_matches(built):
    js, ts = built["js"], built["ts"]
    ref = np.asarray(js.compute_H_train())
    got = ts.compute_H_train().numpy()
    assert ref.max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-12)


def test_h_train_top_up_and_window(built):
    """compute_H_train's top-up (cached prefix + appended keyframes)
    equals a full recompute, and its strided window (h_train_window below
    the keyframe count) matches the JAX package's."""
    js, ts = built["js"], built["ts"]
    full = ts._h_train_over(ts.keyframes.stacked_w2cs())
    prefix_key = (len(ts.keyframes) - 1,) + ts._h_train_key()[1:]
    ts._h_train_cache = (prefix_key, ts._h_train_over(
        ts.keyframes.stacked_w2cs()[:-1]))
    torch.testing.assert_close(ts.compute_H_train(), full, rtol=1e-5,
                               atol=1e-12)
    # window 1 of 3 keyframes: ids [0], scaled by 3 (a 2-pose batch is
    # avoided: the JAX package's vmapped top-k orders exact depth ties
    # differently at batch 2 on the CPU, and this map has such ties)
    js.h_train_window = ts.h_train_window = 1
    js._h_train_cache = ts._h_train_cache = None
    try:
        ref = np.asarray(js.compute_H_train())
        got = ts.compute_H_train().numpy()
    finally:
        js.h_train_window = ts.h_train_window = 96
        js._h_train_cache = ts._h_train_cache = None
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-12)
    assert not np.allclose(got, full.numpy())


def test_pose_eval_ranks_like_jax(built):
    js, ts = built["js"], built["ts"]
    ref = np.asarray(js.pose_eval(built["cands"])[0])
    got = ts.pose_eval(built["cands"])[0].numpy()
    assert got.shape == ref.shape == (8,)
    assert spearmanr(got, ref).correlation >= 0.99
    assert int(np.argmax(got)) == int(np.argmax(ref))


def test_jax_checkpoint_loads_into_port(built):
    """A map written by the JAX GaussianSLAM.save is read by the port's
    load unchanged, and scores the candidates like the JAX map does."""
    js = built["js"]
    path = js.save(js.frame_idx)
    port = tslam.GaussianSLAM(make_cfg(tcfg, built["tmp"] / "load"),
                              device="cpu")
    port.load(path)
    n = js.n_active
    assert port.n_active == n and len(port.keyframes) == len(js.keyframes)
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(
            getattr(port.state, k).numpy()[:n],
            np.asarray(getattr(js.state, k))[:n])
    ref = np.asarray(js.pose_eval(built["cands"])[0])
    got = port.pose_eval(built["cands"])[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-2)
    assert int(np.argmax(got)) == int(np.argmax(ref))


def test_state_numpy_round_trip(built):
    ts = built["ts"]
    arrs = state_to_numpy(ts.state)
    back = state_from_numpy(arrs, ts.state.capacity + 16, device="cpu")
    assert int(back.n_active) == ts.n_active
    assert back.capacity == ts.state.capacity + 16
    for k in PARAM_KEYS:
        assert torch.equal(getattr(back, k)[:ts.n_active],
                           getattr(ts.state, k)[:ts.n_active])


def test_port_checkpoint_round_trips(built):
    """The port's save writes the JAX package's format: the port and the
    JAX GaussianSLAM both load it back to the same map and keyframes."""
    ts = built["ts"]
    path = ts.save(ts.frame_idx)
    back = tslam.GaussianSLAM(make_cfg(tcfg, built["tmp"] / "rt"),
                              device="cpu")
    back.load(path)
    jback = jslam.GaussianSLAM(make_cfg(jcfg, built["tmp"] / "rtj"))
    jback.load(path)
    n = ts.n_active
    assert back.n_active == jback.n_active == n
    assert back.keyframes.ids == jback.keyframes.ids == ts.keyframes.ids
    for k in PARAM_KEYS:
        want = getattr(ts.state, k).numpy()[:n]
        assert np.array_equal(getattr(back.state, k).numpy()[:n], want)
        assert np.array_equal(np.asarray(getattr(jback.state, k))[:n], want)


def test_add_gaussians_and_grow_match_jax():
    """Candidates past the capacity are dropped (masked in the port,
    scattered to index `cap` with mode="drop" in JAX); growth appends
    empty slots."""
    from fisher_nerf_customized_tpu.models import gaussian_state as jgs
    from fisher_nerf_customized_tpu_torch.models import gaussian_state as tgs
    rng = np.random.default_rng(2)
    m = 40
    new = {k: rng.normal(size=(m, w)).astype(np.float32) for k, w in
           zip(PARAM_KEYS, (3, 3, 4, 1, 3))}
    mask = rng.uniform(size=m) < 0.7
    js, _ = jgs.add_gaussians(jgs.empty_state(24), {k: jnp.asarray(v) for k, v
                                                    in new.items()},
                              jnp.asarray(mask), 0.0)
    ts, _ = tgs.add_gaussians(tgs.empty_state(24, device="cpu"),
                              {k: torch.from_numpy(v) for k, v in
                               new.items()}, torch.from_numpy(mask), 0.0)
    js, jd = jgs.add_gaussians(js, {k: jnp.asarray(v) for k, v in
                                    new.items()}, jnp.asarray(mask), 3.0)
    ts, td = tgs.add_gaussians(ts, {k: torch.from_numpy(v) for k, v in
                                    new.items()}, torch.from_numpy(mask), 3.0)
    assert int(jd) == int(td) > 0 and int(ts.n_active) == int(js.n_active)
    for k in PARAM_KEYS + ("timestep",):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)))
    grown, jgrown = tgs.grow_state(ts, 40), jgs.grow_state(js, 40)
    assert grown.capacity == 40 and int(grown.n_active) == int(ts.n_active)
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(getattr(grown, k).numpy(),
                                      np.asarray(getattr(jgrown, k)))


@pytest.mark.parametrize("n", [7, 8])
def test_median_averages_middle_pair_like_jnp(n):
    x = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    assert float(tslam._median(torch.from_numpy(x))) == \
        pytest.approx(float(jnp.median(jnp.asarray(x))), rel=1e-6)
