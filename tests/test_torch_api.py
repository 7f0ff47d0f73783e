"""The port's last public helpers against the JAX package's on the CPU:
the one-pose fisher_diag, mark_visible, project_cov2d_packed, the
geometry helpers, camera_from_intrinsics, AstarPlanner.CheckCollision,
profile_trace and MetricsLogger's wandb channel.  Inputs are numpy
arrays from a seed, passed through both packages.

Tolerances, each with its reason:
  * fisher_diag against JAX's (its XLA engine): rtol 5e-3 / atol 1e-8, as
    tests/test_torch_fisher.py (the XLA engine never stops a tile early,
    the port stops it at T < 1e-4); against the port's fisher_diag_batch
    at the identity pose: equal to the bit (the same call);
  * mark_visible: equal to the bit (z_view written out as JAX's dot
    computes it, a strict threshold);
  * project_cov2d_packed, pose_matrix, transform_points: rtol 1e-6 (the
    same f32 arithmetic; a product may round in another order);
  * compute_next_campos_torch: atol 1e-5 against the float64 numpy
    compute_next_campos, as tests/test_geometry.py holds JAX's, and rtol
    1e-6 against JAX's compute_next_campos_jax;
  * camera_from_intrinsics, CheckCollision, the wandb calls and the JSONL
    records: equal.
"""
import json
import logging
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.ops import camera as jcamera
from fisher_nerf_customized_tpu.ops import fisher as jfisher
from fisher_nerf_customized_tpu.ops import projection as jproj
from fisher_nerf_customized_tpu.ops.rasterize import RenderSettings as JSettings
from fisher_nerf_customized_tpu.utils import geometry as jgeo
from fisher_nerf_customized_tpu.utils import logging_utils as jlog
from fisher_nerf_customized_tpu_torch.ops import camera as tcamera
from fisher_nerf_customized_tpu_torch.ops import fisher as tfisher
from fisher_nerf_customized_tpu_torch.ops import projection as tproj
from fisher_nerf_customized_tpu_torch.ops.rasterize import (
    RenderSettings as TSettings)
from fisher_nerf_customized_tpu_torch.utils import geometry as tgeo
from fisher_nerf_customized_tpu_torch.utils import logging_utils as tlog

CAMKW = dict(fx=32.0, fy=32.0, cx=32.0, cy=32.0, width=64, height=64)
TILE, K, CHUNK, GV = 16, 64, 16, 2e-3


def scene(seed, n=600):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 2, n),
                      rng.uniform(0.5, 6, n)], -1).astype(np.float32)
    means[:20, 2] = -1.0                              # behind the camera
    scales = rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.2, 0.9, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors


# ---- fisher_diag -----------------------------------------------------------

@pytest.mark.parametrize("full_chain", [False, True])
def test_fisher_diag_matches_jax(full_chain):
    arrays = scene(11)
    active = np.arange(len(arrays[0])) < 560
    ref = jfisher.fisher_diag(
        jcamera.Camera(**CAMKW), *(jnp.asarray(x) for x in arrays),
        grad_value=GV, active=jnp.asarray(active),
        settings=JSettings(tile_size=TILE, max_per_tile=K, chunk=CHUNK),
        full_chain=full_chain)
    cam, st = tcamera.Camera(**CAMKW), TSettings(tile_size=TILE,
                                                  max_per_tile=K, chunk=CHUNK)
    args = [torch.from_numpy(x) for x in arrays]
    got = tfisher.fisher_diag(cam, *args, grad_value=GV,
                              active=torch.from_numpy(active), settings=st,
                              full_chain=full_chain)
    assert got["H"].shape == (len(active), 4)
    assert np.abs(np.asarray(ref["H"])).max() > 0
    np.testing.assert_allclose(got["H"].numpy(), np.asarray(ref["H"]),
                               rtol=5e-3, atol=1e-8)
    np.testing.assert_array_equal(got["visible"].numpy(),
                                  np.asarray(ref["visible"]))
    assert not got["visible"][:20].any()
    np.testing.assert_allclose(got["radii"].numpy(), np.asarray(ref["radii"]),
                               rtol=1e-6)
    # the batch of one at the identity pose, to the bit
    batch = tfisher.fisher_diag_batch(
        cam, torch.eye(4)[None], *args, grad_value=GV,
        active=torch.from_numpy(active), settings=st, full_chain=full_chain)
    for k in ("H", "radii", "visible"):
        assert torch.equal(got[k], batch[k][0]), k


# ---- mark_visible, project_cov2d_packed ------------------------------------

def test_mark_visible_frustum_semantics():
    """tests/test_rasterize.py::test_mark_visible_frustum_semantics on the
    port: z_view > 0.001, nothing else."""
    pts = torch.tensor([[0, 0, 1.0], [0, 0, -1.0], [0, 0, 0.0005],
                        [100, 100, 5.0]])
    vis = tproj.mark_visible(pts, torch.eye(4))
    assert vis.dtype == torch.bool
    assert vis.tolist() == [True, False, False, True]
    w2c_flip = torch.diag(torch.tensor([1.0, 1.0, -1.0, 1.0]))
    assert tproj.mark_visible(pts, w2c_flip).tolist() == [False, True, False,
                                                          False]


def test_mark_visible_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-3, 3, (10000, 3)).astype(np.float32)
    # a band of points within rounding of the threshold
    pts[:500, 2] = 0.001 + rng.normal(0, 1e-9, 500).astype(np.float32)
    q = rng.normal(size=4).astype(np.float32)
    w2c = np.asarray(jgeo.pose_matrix(jnp.asarray(q), jnp.asarray(
        rng.normal(0, 0.5, 3).astype(np.float32))))
    for m in (np.eye(4, dtype=np.float32), w2c):
        ref = np.asarray(jproj.mark_visible(jnp.asarray(pts),
                                            jnp.asarray(m)))
        got = tproj.mark_visible(torch.from_numpy(pts),
                                 torch.from_numpy(np.array(m)))
        np.testing.assert_array_equal(got.numpy(), ref)
        assert 0 < ref.sum() < len(ref)


def test_project_cov2d_packed_matches_jax():
    means, scales, quats, _opac, _colors = scene(12)
    cov = np.array(jproj.build_cov3d(jnp.asarray(scales),
                                     jnp.asarray(quats)))
    ref = jproj.project_cov2d_packed(jnp.asarray(means), jnp.asarray(cov),
                                     jcamera.Camera(**CAMKW))
    got = tproj.project_cov2d_packed(torch.from_numpy(means),
                                     torch.from_numpy(cov),
                                     tcamera.Camera(**CAMKW))
    for g, r in zip(got, ref):
        assert g.shape == (len(means), 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


# ---- geometry ----------------------------------------------------------------

def test_pose_matrix_and_transform_points_match_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    pts = rng.normal(size=(5, 40, 3)).astype(np.float32)
    ref_m = np.array(jgeo.pose_matrix(jnp.asarray(q), jnp.asarray(t)))
    got_m = tgeo.pose_matrix(torch.from_numpy(q), torch.from_numpy(t))
    np.testing.assert_allclose(got_m.numpy(), ref_m, rtol=1e-6, atol=1e-7)
    ref_p = np.asarray(jgeo.transform_points(jnp.asarray(ref_m),
                                             jnp.asarray(pts)))
    got_p = tgeo.transform_points(torch.from_numpy(ref_m),
                                  torch.from_numpy(pts))
    np.testing.assert_allclose(got_p.numpy(), ref_p, rtol=1e-6, atol=1e-6)
    # one matrix over one cloud
    got_1 = tgeo.transform_points(torch.from_numpy(ref_m[0]),
                                  torch.from_numpy(pts[0]))
    np.testing.assert_allclose(got_1.numpy(), ref_p[0], rtol=1e-6, atol=1e-6)
    inv = tgeo.invert_se3(got_m)
    np.testing.assert_allclose((got_m @ inv).numpy(),
                               np.tile(np.eye(4), (5, 1, 1)), atol=1e-5)


@pytest.mark.parametrize("action", [0, 1, 2, 3, 7])
def test_compute_next_campos_torch(action):
    """tests/test_geometry.py::test_compute_next_campos_jax_matches_numpy
    on the port, with an unknown id (the pose unchanged) and the id as an
    int tensor."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(4,)).astype(np.float32)
    H = np.array(jgeo.pose_matrix(jnp.asarray(q), jnp.asarray(
        rng.normal(size=3).astype(np.float32))))
    ref_np = jgeo.compute_next_campos(H, action, 0.065, 10.0)
    np.testing.assert_allclose(
        tgeo.compute_next_campos(H, action, 0.065, 10.0), ref_np, atol=0)
    ref_jax = np.asarray(jgeo.compute_next_campos_jax(jnp.asarray(H), action,
                                                      0.065, 10.0))
    for a in (action, torch.tensor(action, dtype=torch.int32)):
        got = tgeo.compute_next_campos_torch(torch.from_numpy(H), a, 0.065,
                                             10.0)
        assert got.dtype == torch.float32 and got.shape == (4, 4)
        np.testing.assert_allclose(got.numpy(), ref_np, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), ref_jax, rtol=1e-6,
                                   atol=1e-7)
    if action not in (1, 2, 3):
        assert torch.equal(got, torch.from_numpy(H))


def test_compute_next_campos_torch_turns_back():
    H = torch.eye(4, dtype=torch.float64)
    out = tgeo.compute_next_campos_torch(H, 1, forward_step_size=0.5)
    np.testing.assert_allclose(out[:3, 3].numpy(), [0, 0, 0.5], atol=1e-12)
    back = tgeo.compute_next_campos_torch(
        tgeo.compute_next_campos_torch(H, 2), 3)
    np.testing.assert_allclose(back.numpy(), H.numpy(), atol=1e-12)


# ---- camera, planner -----------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(near=0.05, far=12.5)])
def test_camera_from_intrinsics_matches_jax(kw):
    K = np.array([[200.0, 0, 127.5], [0, 210.0, 96.5], [0, 0, 1]], np.float32)
    ref = jcamera.camera_from_intrinsics(K, 256, 192, **kw)
    for k_in in (K, torch.from_numpy(K)):
        got = tcamera.camera_from_intrinsics(k_in, 256, 192, **kw)
        assert got._fields == ref._fields
        assert tuple(got) == tuple(ref)
        assert all(type(a) is type(b) for a, b in zip(got, ref))


def test_check_collision_matches_jax():
    from fisher_nerf_customized_tpu.config import get_cfg_defaults as jcfg
    from fisher_nerf_customized_tpu.planning.planner import (
        AstarPlanner as JPlanner)
    from fisher_nerf_customized_tpu_torch.config import (
        get_cfg_defaults as tcfg)
    from fisher_nerf_customized_tpu_torch.planning.planner import (
        AstarPlanner as TPlanner)
    rng = np.random.default_rng(8)
    occ = np.zeros((64, 80), np.uint8)
    for _ in range(12):
        y, x = rng.integers(0, 60), rng.integers(0, 76)
        occ[y:y + rng.integers(1, 5), x:x + rng.integers(1, 5)] = 1
    jp = JPlanner(jcfg())
    tp = TPlanner(tcfg(), device="cpu")
    pairs = rng.integers(0, 64, (200, 4))
    got = [tp.CheckCollision(p[:2], p[2:], occ) for p in pairs]
    ref = [jp.CheckCollision(p[:2], p[2:], occ) for p in pairs]
    assert got == ref
    assert 0 < sum(got) < len(got)


# ---- profile_trace ------------------------------------------------------------

def test_profile_trace(tmp_path):
    with tlog.profile_trace(None):
        x = torch.ones(3) + 1
    with tlog.profile_trace(""):
        x = x * 2
    d = tmp_path / "trace"
    with tlog.profile_trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list(d.glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    with pytest.raises(ValueError):
        with tlog.profile_trace(str(d)):
            torch.ones(8).sum()
            raise ValueError("inside the block")
    assert len(list(d.glob("*.json"))) == 2


# ---- MetricsLogger's wandb channel (fault v) -------------------------------

def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(ln).items() if k != "t"}
                for ln in f]


def _log_both(tmp_path, use_wandb):
    out = []
    for name, mod in (("jax", jlog), ("torch", tlog)):
        lg = mod.MetricsLogger(str(tmp_path / name / str(use_wandb)), "run",
                               use_wandb=use_wandb)
        lg.log(0, psnr=np.float32(12.5), n=3)
        lg.log(25, psnr=14.0, completeness=0.25)
        lg.close()
        out.append(_records(lg.path))
    return out


def test_use_wandb_warns_when_absent(tmp_path, caplog, monkeypatch):
    """The reference's rule: without wandb, warn and carry on; the JSONL
    stream is the same as without use_wandb, in both packages."""
    monkeypatch.setitem(sys.modules, "wandb", None)    # import fails
    with caplog.at_level(logging.WARNING):
        ref, got = _log_both(tmp_path, True)
    warned = [r for r in caplog.records
              if r.getMessage() == "wandb requested but unavailable"]
    assert len(warned) == 2, [r.getMessage() for r in caplog.records]
    assert got == ref == _log_both(tmp_path, False)[1]
    assert got[0] == dict(step=0, psnr=12.5, n=3.0)
    # a rank other than 0 neither writes nor starts wandb
    lg = tlog.MetricsLogger(str(tmp_path / "rank1"), "run", use_wandb=True,
                            enabled=False)
    lg.log(0, psnr=1.0)
    lg.close()
    assert not (tmp_path / "rank1").exists()


def test_use_wandb_calls_match_jax(tmp_path, monkeypatch):
    """With a stub wandb module both packages make the same init and log
    calls."""
    calls = []

    class Run:
        def log(self, metrics, step=None):
            calls.append(("log", {k: float(v) for k, v in metrics.items()},
                          step))

    def init(**kw):
        calls.append(("init", kw))
        return Run()

    monkeypatch.setitem(sys.modules, "wandb",
                        types.SimpleNamespace(init=init))
    ref_recs, got_recs = _log_both(tmp_path, True)
    assert got_recs == ref_recs
    half = len(calls) // 2
    assert len(calls) == 6 and calls[:half] == calls[half:]
    assert calls[0] == ("init", dict(project="active_mapping", name="run"))
    assert calls[1] == ("log", dict(psnr=12.5, n=3.0), 0)


def _wandb_episode(pkg, tmp_path, steps):
    """A hermetic episode of tests/test_engine.py's settings with
    use_wandb set (as `--set use_wandb True` sets it): (actions, result,
    the JSONL records)."""
    from test_engine import IMG, episode_cfg
    cfg = episode_cfg(tmp_path / pkg, steps=steps)
    if pkg == "jax":
        from fisher_nerf_customized_tpu.engine import driver
        from fisher_nerf_customized_tpu.envs import fake_sim
        kw, sim_kw = {}, dict(device_obs=False)
    else:
        from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults
        from fisher_nerf_customized_tpu_torch.engine import driver
        from fisher_nerf_customized_tpu_torch.envs import fake_sim
        port_cfg = get_cfg_defaults()
        port_cfg.merge_from_other(cfg.to_dict())
        cfg, kw, sim_kw = port_cfg, dict(device="cpu"), dict(device="cpu")
    cfg.use_wandb = True
    cam = (jcamera if pkg == "jax" else tcamera).Camera(
        fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2, width=IMG,
        height=IMG)
    scene = fake_sim.BoxScene(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                              obstacles=[((1.0, 0.0, 1.0), (1.8, 1.8, 1.8))])
    sim = fake_sim.FakeSim(scene, cam, forward_step=0.15, turn_angle=30.0,
                           seed=3, **sim_kw)
    actions = []
    sim_step = sim.step
    sim.step = lambda a: (actions.append(int(a)), sim_step(a))[1]
    mapper = driver.ActiveMapper(cfg, sim, scene=scene, seed=0, **kw)
    result = mapper.test_navigation(
        n_eval_poses=0, recon_gt_points=scene.sample_surface_points(2000))
    mapper.mlog.close()
    return actions, result, _records(mapper.mlog.path)


def test_use_wandb_episode_runs_in_both_packages(tmp_path, caplog,
                                                 monkeypatch):
    """Fault v: with use_wandb and no wandb installed the port's episode
    runs to its end with the reference's warning and takes the JAX
    package's actions."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with caplog.at_level(logging.WARNING):
            ref = _wandb_episode("jax", tmp_path, 14)
            got = _wandb_episode("torch", tmp_path, 14)
    finally:
        torch.set_num_threads(n)
    warned = [r for r in caplog.records
              if r.getMessage() == "wandb requested but unavailable"]
    assert len(warned) == 2
    assert got[1]["steps"] == ref[1]["steps"] == 14
    assert got[1]["planning_events"] >= 1
    assert got[0] == ref[0] and len(got[0]) == 14
    assert [r["step"] for r in got[2]] == [r["step"] for r in ref[2]] == [0]
