"""The frontier-only navigator, JAX package against the PyTorch port on
the CPU: both FrontierNavigators on the JAX package's
tests/test_engine.py::test_frontier_episode_runs settings (48x48 frames,
a 6 m room with one obstacle, episode_cfg's 10 cm map, FakeSim seed 5,
20 steps) and on a 3x3-room apartment at the eccv config's 5 cm map for
60 steps, with the same ground-truth cloud.

The two take the same actions and end for the same reason, and their
recon metrics (every 25 steps and at the end) agree at rtol 1e-9: both
find the nearest neighbours with scipy's cKDTree on the CPU.  With
`explore.planner_backend: astar` both navigate by the host A* search.
The port's navigation entry point writes the JAX CLI's files.
"""
import json
import os

import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.engine.navigator import (
    FrontierNavigator as JNav)
from fisher_nerf_customized_tpu.envs import fake_sim as jsim
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch import cli
from fisher_nerf_customized_tpu_torch.engine.navigator import (
    FrontierNavigator as TNav)
from fisher_nerf_customized_tpu_torch.envs import fake_sim as tsim
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

from test_engine import IMG, episode_cfg
from test_torch_episode import port_cfg

YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "mp3d_gaussian_FR_eccv.yaml")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def navigate(pkg, cfg, scene_args, gt, sim_seed, img=IMG, focal=IMG,
             turn=30.0, step=0.15):
    if pkg == "jax":
        mod, cam_t, nav_t, kw, sim_kw = jsim, JCamera, JNav, {}, dict(
            device_obs=False)
    else:
        cfg = port_cfg(cfg)
        mod, cam_t, nav_t = tsim, TCamera, TNav
        kw = sim_kw = dict(device="cpu")
    cam = cam_t(fx=float(focal), fy=float(focal), cx=img / 2, cy=img / 2,
                width=img, height=img)
    scene = (mod.BoxScene.multi_room(seed=scene_args) if isinstance(
        scene_args, int) else mod.BoxScene(**scene_args))
    sim = mod.FakeSim(scene, cam, forward_step=step, turn_angle=turn,
                      seed=sim_seed, **sim_kw)
    actions = []
    sim_step = sim.step

    def recording(a):
        actions.append(int(a))
        return sim_step(a)

    sim.step = recording
    nav = nav_t(cfg, sim, scene=scene, eval_dir=os.path.join(
        cfg.workdir, pkg), seed=0, **kw)
    result = nav.frontier_test_navigation(recon_gt_points=gt)
    return actions, result, nav


ROOM = dict(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
            obstacles=[((1.0, 0.0, 1.0), (1.8, 1.8, 1.8))])


def compare(ref, got):
    (ja, jr, jn), (ta, tr, tn) = ref, got
    assert ta == ja
    assert tr["steps"] == jr["steps"] and tr["done_reason"] == jr[
        "done_reason"]
    for k, v in jr["recon"].items():
        np.testing.assert_allclose(tr["recon"][k], v, rtol=1e-9, err_msg=k)
    np.testing.assert_allclose(tr["auc"], jr["auc"], rtol=1e-9)
    assert [s["step"] for s in tn.metrics.steps] == [
        s["step"] for s in jn.metrics.steps]
    for a, b in zip(tn.metrics.steps, jn.metrics.steps):
        for k in ("comp_distance", "completeness_ratio", "acc_distance"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-9, err_msg=k)
    np.testing.assert_array_equal(tn.global_pcl.get(), jn.global_pcl.get())


@pytest.mark.parametrize("backend", ["sweep", "astar"])
def test_navigator_matches_jax(backend, tmp_path):
    gt = jsim.BoxScene(**ROOM).sample_surface_points(3000)
    runs = []
    for pkg in ("jax", "torch"):
        cfg = episode_cfg(tmp_path, policy="frontier", steps=20)
        cfg.explore.planner_backend = backend
        runs.append(navigate(pkg, cfg, ROOM, gt, sim_seed=5))
    compare(*runs)
    assert runs[1][1]["steps"] >= 5
    assert runs[1][1]["recon"]["completeness_ratio"] > 2.0


def test_navigator_on_an_apartment_matches_jax(tmp_path):
    """60 steps on a 3x3-room apartment at the eccv config's 5 cm map,
    64x64 frames, 30-degree turns: the spin, then FBE goals."""
    from fisher_nerf_customized_tpu.config import get_cfg_defaults as jcfg
    gt = jsim.BoxScene.multi_room(seed=7).sample_surface_points(20000)
    runs = []
    for pkg in ("jax", "torch"):
        cfg = jcfg()
        cfg.merge_from_file(YAML)
        cfg.workdir = str(tmp_path)
        cfg.num_frames = 60
        cfg.turn_angle = 30.0
        cfg.forward_step_size = 0.25
        runs.append(navigate(pkg, cfg, 7, gt, sim_seed=0, img=64,
                             focal=32, turn=30.0, step=0.25))
    compare(*runs)
    assert runs[1][0].count(1) > 10          # it moved after the spin


def test_main_navigation_writes_its_files(tmp_path):
    out = cli.main_navigation([
        "--device", "cpu", "--log_dir", str(tmp_path), "--name", "nav",
        "--max_steps", "30", "--img_size", "48"])["fake_room_0"]
    assert out["policy"] == "frontier" and out["steps"] == 30
    assert np.isfinite(out["recon"]["completeness_ratio"])
    scene_dir = tmp_path / "nav" / "fake_room_0"
    assert os.path.exists(scene_dir / "pointcloud" / "global_pcl_30.ply")
    with open(scene_dir / "result.json") as f:
        assert json.load(f)["steps"] == 30
