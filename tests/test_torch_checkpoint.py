"""Checkpoint and resume of the port's episode, on the CPU at the settings
of tests/test_engine.py (episode_cfg, 48x48, FakeSim seed 3, mapper seed
0), 26 steps with the reconstruction metric at steps 0 and 25.
checkpoint_interval 9 puts an in-loop checkpoint at step 12 (the offset
is map_every // 2 = 3) and another at 21; the group written at step 12
is copied aside as the run passes it.

  - The port resumes its own step-12 checkpoint in a fresh mapper and
    runs to 26: the same actions as the uninterrupted run, the same
    coverage, map size and recon curve.
  - The port resumes the JAX package's step-12 checkpoint (the JAX sim
    with host frames, so that its point cloud is the numpy stream) and
    takes the JAX run's actions from there.
  - A file of the group written at step 21 over the step-12 group (a
    torn checkpoint) is refused; a newer params file than the commit
    record is passed over for the record's.
"""
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from fisher_nerf_customized_tpu.engine import driver as jdriver
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene as JScene
from fisher_nerf_customized_tpu.envs.fake_sim import FakeSim as JSim
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene as TScene
from fisher_nerf_customized_tpu_torch.envs.fake_sim import FakeSim as TSim
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

from test_engine import IMG, episode_cfg

STEPS = 26
CK_T = 12                  # the in-loop checkpoint copied aside
INTERVAL = 9               # checkpoints at t = 12 and 21


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite's six workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(pkg, workdir, steps=STEPS, interval=INTERVAL, eval_dir=None):
    """(mapper, sim, scene, actions list) of one package."""
    cfg = episode_cfg(workdir, steps=steps)
    cfg.checkpoint_interval = interval
    if pkg == "jax":
        cam_t, scene_t, sim_t, drv, kw = JCamera, JScene, JSim, jdriver, {}
        sim_kw = dict(device_obs=False)
    else:
        jcfg = cfg
        cfg = tcfg()
        cfg.merge_from_other(jcfg.to_dict())
        cam_t, scene_t, sim_t, drv, kw = (TCamera, TScene, TSim, tdriver,
                                          dict(device="cpu"))
        sim_kw = kw
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
    mapper = drv.ActiveMapper(cfg, sim, scene=scene, seed=0,
                              eval_dir=eval_dir, **kw)
    return mapper, sim, scene, actions


def run_with_snapshot(pkg, tmp):
    """The uninterrupted run, its step-CK_T checkpoint group copied to
    <tmp>/<pkg>_ck: (result, actions, mapper, the copy's path)."""
    mapper, _sim, scene, actions = make(pkg, tmp / pkg)
    snap = str(tmp / f"{pkg}_ck")

    def on_step(t, _obs):
        if t == CK_T:
            shutil.copytree(mapper.eval_dir, snap)

    result = mapper.test_navigation(
        n_eval_poses=0, recon_gt_points=scene.sample_surface_points(4000),
        on_step=on_step)
    return result, actions, mapper, snap


def resume_port(tmp, ck_dir, name):
    """A fresh port mapper on a copy of ck_dir, resumed and run to STEPS:
    (result, its actions, mapper)."""
    eval_dir = str(tmp / name)
    shutil.copytree(ck_dir, eval_dir)
    mapper, _sim, scene, actions = make("torch", tmp / name, eval_dir=eval_dir)
    mapper.resume(os.path.join(eval_dir, f"params{CK_T}.npz"))
    result = mapper.test_navigation(
        n_eval_poses=0, recon_gt_points=scene.sample_surface_points(4000))
    return result, actions, mapper


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    full = run_with_snapshot("torch", tmp)
    resumed = resume_port(tmp, full[3], "resumed")
    return tmp, full, resumed


def test_port_resume_takes_the_same_actions(port_runs):
    _tmp, (res_a, act_a, m_a, _snap), (res_b, act_b, m_b) = port_runs
    assert len(act_a) == STEPS
    assert act_b == act_a[CK_T + 1:]
    assert res_b["steps"] == res_a["steps"] == STEPS
    assert res_b["coverage_2d_pct"] == res_a["coverage_2d_pct"]
    assert m_b.slam.n_active == m_a.slam.n_active
    assert m_b.slam.keyframe_time_indices == m_a.slam.keyframe_time_indices
    np.testing.assert_array_equal(m_b.global_pcl.get(), m_a.global_pcl.get())
    # the running metric restored from the record: the same curve
    assert [s["step"] for s in m_b.metrics.steps] == [0, 25]
    assert m_b.metrics.steps == m_a.metrics.steps
    assert res_b["recon"] == res_a["recon"]


def test_port_checkpoint_record(port_runs):
    """The commit record and its group at step 12: every aux file names
    the step, d_gt_min is float64, the curve holds step 0 only."""
    _tmp, (_r, _a, m_a, snap), (_rb, _ab, m_b) = port_runs
    with np.load(os.path.join(snap, "episode_state.npz")) as ep:
        assert int(ep["t"]) == CK_T and int(ep["resume_t"]) == CK_T + 1
        assert ep["inc_recon_d_gt_min"].dtype == np.float64
        assert not bool(ep["pcl_1000_saved"])
    for name in ("keyframes.npz", "astar.npz", "global_pcl.npz"):
        with np.load(os.path.join(snap, name)) as d:
            assert int(d["ckpt_t"]) == CK_T, name
    with open(os.path.join(snap, "metrics_curve.yaml")) as f:
        assert [s["step"] for s in yaml.safe_load(f)["steps"]] == [0]
    assert os.path.exists(os.path.join(snap, f"params{CK_T}.npz"))


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """The JAX package's step-12 group (no steps on its files, d_gt_min
    in float32): the port continues with the JAX run's actions."""
    res_j, act_j, m_j, snap = run_with_snapshot("jax", tmp_path)
    res_t, act_t, m_t = resume_port(tmp_path, snap, "from_jax")
    assert act_t == act_j[CK_T + 1:]
    assert res_t["steps"] == res_j["steps"] == STEPS
    assert res_t["coverage_2d_pct"] == pytest.approx(
        res_j["coverage_2d_pct"], abs=1e-9)
    assert m_t.slam.n_active == m_j.slam.n_active
    assert [s["step"] for s in m_t.metrics.steps] == [0, 25]
    for k in res_j["recon"]:
        np.testing.assert_allclose(res_t["recon"][k], res_j["recon"][k],
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["keyframes.npz", "astar.npz",
                                  "global_pcl.npz", "episode_rng.pkl"])
def test_torn_checkpoint_is_refused(port_runs, name):
    """The step-21 version of one file over the step-12 group."""
    tmp, (_r, _a, m_a, snap), _resumed = port_runs
    torn = str(tmp / f"torn_{name}")
    shutil.copytree(snap, torn)
    shutil.copy(os.path.join(m_a.eval_dir, name), os.path.join(torn, name))
    mapper, _sim, _scene, _act = make("torch", tmp / "torn", eval_dir=torn)
    with pytest.raises(tdriver.TornCheckpointError, match=name):
        mapper.resume(os.path.join(torn, f"params{CK_T}.npz"))


def test_resume_prefers_the_committed_params(port_runs):
    """A params file newer than the record (here garbage) is passed over
    for params{t} of the record."""
    tmp, (_r, _a, _m, snap), _resumed = port_runs
    ck = str(tmp / "bogus")
    shutil.copytree(snap, ck)
    bogus = os.path.join(ck, f"params{CK_T + 999}.npz")
    with open(bogus, "wb") as f:
        f.write(b"truncated")
    mapper, _sim, _scene, _act = make("torch", tmp / "bogus", eval_dir=ck)
    mapper.resume(bogus)
    # frame 0 is the map's init frame, frame t + 1 that of step t
    assert mapper.slam.frame_idx == CK_T + 1
    assert mapper._resume_t == CK_T + 1
