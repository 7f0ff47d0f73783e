"""The FisherRF episode loop, JAX package against the PyTorch port on the
CPU: both ActiveMappers on the settings of tests/test_engine.py
(episode_cfg: 48x48 frames, a 10 cm map, queue 8, FakeSim seed 3,
mapper seed 0) for 26 steps, with the reconstruction metric (at steps 0
and 25, against a 4000-point ground-truth cloud) and the evaluation over
8 held-out poses; and the port's entry point.  The JAX sim hands out
host frames (device_obs=False), so that its point cloud takes the numpy
stream the port reproduces.

The two runs must take the same actions.  At every planning event the
path-EIG scores must agree to rtol 1e-2 (test_torch_path_eval.py's
tolerance) with the same -inf padding; the runs may part only at an
event whose two best JAX scores lie within that tolerance of each other
and whose choices differ, and then the actions are compared up to that
event.  At least one planning event must run path EIG and choose the
same path in both.  With the same actions the two metrics_curve.yaml
must agree to rtol 1e-6 at each recon step, and the eval aggregates
within PSNR 0.05 dB, SSIM and lpips_proxy 1e-3, depth MAE rtol 1e-2 (the
maps differ in the last bits: the JAX package runs its XLA engines on
the CPU, which never stop a tile early).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from fisher_nerf_customized_tpu.engine import driver as jdriver
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene as JScene
from fisher_nerf_customized_tpu.envs.fake_sim import FakeSim as JSim
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch import cli
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene as TScene
from fisher_nerf_customized_tpu_torch.envs.fake_sim import FakeSim as TSim
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

from test_engine import IMG, episode_cfg

RTOL = 1e-2
STEPS = 26
EVAL_POSES = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under the suite's six
    workers, torch's default of one thread per core oversubscribes the
    CPU beside XLA's own pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jax_cfg):
    cfg = tcfg()
    cfg.merge_from_other(jax_cfg.to_dict())
    return cfg


def run_episode(pkg, tmp_path, monkeypatch, steps=STEPS):
    """One episode; returns (actions taken, path-score arrays, result,
    mapper)."""
    cfg = episode_cfg(tmp_path / pkg, steps=steps)
    if pkg == "jax":
        cam_t, scene_t, sim_t, drv, kw = JCamera, JScene, JSim, jdriver, {}
        sim_kw = dict(device_obs=False)
    else:
        cfg = port_cfg(cfg)
        cam_t, scene_t, sim_t, drv, kw = (TCamera, TScene, TSim, tdriver,
                                          dict(device="cpu"))
        sim_kw = kw
    cam = cam_t(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                width=IMG, height=IMG)
    scene = scene_t(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                    obstacles=[((1.0, 0.0, 1.0), (1.8, 1.8, 1.8))])
    sim = sim_t(scene, cam, forward_step=0.15, turn_angle=30.0, seed=3,
                **sim_kw)
    actions, scores = [], []
    sim_step = sim.step

    def step(a):
        actions.append(int(a))
        return sim_step(a)

    sim.step = step
    score_fn = drv.path_eig_scores

    def recording(*args, **kwargs):
        s = score_fn(*args, **kwargs)
        scores.append(np.asarray(s) if pkg == "jax" else s.numpy())
        return s

    monkeypatch.setattr(drv, "path_eig_scores", recording)
    mapper = drv.ActiveMapper(cfg, sim, scene=scene, seed=0, **kw)
    result = mapper.test_navigation(
        n_eval_poses=EVAL_POSES,
        recon_gt_points=scene.sample_surface_points(4000))
    return actions, scores, result, mapper


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("episode")
    with pytest.MonkeyPatch.context() as mp:
        ref = run_episode("jax", tmp, mp)
    with pytest.MonkeyPatch.context() as mp:
        got = run_episode("torch", tmp, mp)
    return ref, got


def same_actions(episodes) -> bool:
    (ja, _js, _jr, _jm), (ta, _ts, _tr, _tm) = episodes
    return ta == ja


def test_episodes_take_the_same_actions(episodes):
    (ja, jscores, jres, _jm), (ta, tscores, tres, tm) = episodes
    assert len(tscores) == len(jscores) >= 1
    n_compared = len(ja)
    same_choices = 0
    for i, (ref, got) in enumerate(zip(jscores, tscores)):
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        live = np.isfinite(ref)
        np.testing.assert_allclose(got[live], ref[live], rtol=RTOL)
        if int(np.argmax(got)) == int(np.argmax(ref)):
            same_choices += 1
            continue
        top2 = np.sort(ref[live])[-2:]
        assert abs(top2[1] - top2[0]) <= RTOL * abs(top2[1]), (
            f"planning event {i}: the choices differ and the best two "
            f"scores {top2} are not within rtol {RTOL}")
        n_compared = tm.plan_log[i]["t"]
        break
    assert same_choices >= 1
    assert ta[:n_compared] == ja[:n_compared]
    assert tres["steps"] == jres["steps"] == STEPS
    if n_compared == len(ja):
        assert ta == ja
        assert tres["coverage_2d_pct"] == pytest.approx(
            jres["coverage_2d_pct"], abs=1e-9)
        assert tres["n_gaussians"] == jres["n_gaussians"]


def test_episode_recon_curves_match(episodes):
    """The two metrics_curve.yaml, recon step by recon step (rtol 1e-6),
    and the final recon and AUC."""
    (_ja, _js, jres, jm), (_ta, _ts, tres, tm) = episodes
    assert same_actions(episodes)
    docs = []
    for m in (jm, tm):
        with open(os.path.join(m.eval_dir, "metrics_curve.yaml")) as f:
            docs.append(yaml.safe_load(f))
    ref, got = docs
    assert [s["step"] for s in got["steps"]] == \
        [s["step"] for s in ref["steps"]] == [0, 25]
    for rs, gs in zip(ref["steps"], got["steps"]):
        assert gs.keys() == rs.keys()
        for k in rs:
            np.testing.assert_allclose(gs[k], rs[k], rtol=1e-6,
                                       err_msg=f"step {rs['step']} {k}")
    np.testing.assert_allclose(got["auc"], ref["auc"], rtol=1e-6)
    for k in jres["recon"]:
        np.testing.assert_allclose(tres["recon"][k], jres["recon"][k],
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(tres["auc"], jres["auc"], rtol=1e-6)
    assert len(tm.global_pcl.get()) == len(jm.global_pcl.get())


def test_episode_eval_matches(episodes):
    """The eval aggregates over the same 8 poses: PSNR within 0.05 dB,
    SSIM and lpips_proxy within 1e-3, depth MAE to rtol 1e-2; the seen
    flags equal."""
    (_ja, _js, jres, _jm), (_ta, _ts, tres, _tm) = episodes
    assert same_actions(episodes)
    ref, got = jres["eval"], tres["eval"]
    assert got.keys() == ref.keys()
    assert got["n_poses"] == ref["n_poses"] == EVAL_POSES
    assert got["n_seen"] == ref["n_seen"]
    print("eval gaps (port - JAX):",
          {k: got[k] - ref[k] for k in ref if k not in ("n_poses", "n_seen")})
    for k, tol in (("psnr", 0.05), ("psnr_seen", 0.05), ("ssim", 1e-3),
                   ("ssim_seen", 1e-3), ("lpips_proxy", 1e-3)):
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])
    for k in ("depth_mae", "depth_mae_seen"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-2, err_msg=k)


def test_episode_result_and_timer(episodes):
    _ref, (_a, scores, res, mapper) = episodes
    assert res["done_reason"] == "max_steps"
    assert res["planning_events"] == len(mapper.plan_log) == len(scores)
    assert 0.0 < res["coverage_2d_pct"] <= 100.0
    for phase in ("tracking_mapping", "occupancy", "pcl", "recon_metric",
                  "eval", "plan.global", "plan.sweep", "plan.global.wait",
                  "plan.actions", "plan.h_train", "plan.path_eig",
                  "recon_metric.new_points", "recon_metric.surface",
                  "recon_metric.running_min"):
        assert res["timing"][phase]["count"] >= 1, phase
    for name in ("eval.json", "gaussians_based_results.txt",
                 "eval_psnr_map.png", "metrics_curve.yaml",
                 "ep_metrics.jsonl"):
        assert os.path.exists(os.path.join(mapper.eval_dir, name)), name


def test_entry_point_runs_an_episode(tmp_path, capsys):
    """python -m fisher_nerf_customized_tpu_torch, on the CPU at a small
    size: one JSON line per scene, with eval, recon and auc, the held-out
    curve of --eval_every, and the files of a finished episode."""
    argv = ["--scenes_list", "fake_room_0", "--max_steps", "8",
            "--policy", "gaussians_based", "--eval_poses", "4",
            "--eval_every", "4",
            "--img_size", "48", "--device", "cpu",
            "--log_dir", str(tmp_path), "--name", "cli",
            "--set", "mapping.num_iters", "4", "tpu.capacity", "8192",
            "policy.planning_queue_size", "5", "turn_angle", "30.0",
            "--set", "explore.sample_view_num", "16", "explore.cell_size",
            "0.1", "tpu.pose_chunk", "4"]
    results = cli.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)["fake_room_0"]
    assert out == json.loads(json.dumps(results["fake_room_0"],
                                        default=float))
    assert out["steps"] == 8 and out["planning_events"] >= 1
    assert out["eval"]["n_poses"] == 4 and np.isfinite(out["eval"]["psnr"])
    assert {"recon", "auc"} <= out.keys()
    scene_dir = tmp_path / "cli" / "fake_room_0"
    for name in ("result.json", "eval.json", "gaussians_based_results.txt",
                 "eval_psnr_map.png", "metrics_curve.yaml",
                 "recon_metrics.yaml", "pointcloud/global_pcl_8.ply",
                 "params8.npz", "astar.npz", "global_pcl.npz",
                 "episode_rng.pkl", "episode_state.npz"):
        assert os.path.exists(scene_dir / name), name
    # the held-out curve of --eval_every 4 at step 4, the recon at step 0
    with open(scene_dir / "metrics_curve.yaml") as f:
        steps = {s["step"]: s for s in yaml.safe_load(f)["steps"]}
    assert np.isfinite(steps[4]["eval_psnr"])
    assert "completeness_ratio" in steps[0]


# flags and settings of code paths the port now has: each case holds that
# the setting is accepted where it was refused


def small_sim():
    cam = TCamera(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                  width=IMG, height=IMG)
    return TSim(TScene(), cam, device="cpu")


@pytest.mark.parametrize("flag", [["--sim", "habitat"], ["--dino_gate"],
                                  ["--dino_weights", "dino.pth"],
                                  ["--lpips_weights", "alex.pth"],
                                  ["--ensemble_dir", "ensemble"],
                                  ["--object_scene", "--dino_gate"]])
def test_entry_point_refuses_unported_flags(flag, tmp_path, monkeypatch):
    """No flag is refused any more.  Each is accepted and reaches its
    code: --sim habitat asks for habitat-sim (not installed here;
    tests/test_torch_habitat_adapter.py runs it on a mock), the
    checkpoint flags (--lpips_weights, --dino_weights on the object
    branch) and --ensemble_dir raise FileNotFoundError for a missing
    file, as the JAX package's loaders do, and --dino_gate reaches the
    driver (its bank made on the object branch only)."""
    argv = ["--device", "cpu", "--log_dir", str(tmp_path)]
    if flag[0] == "--sim":
        monkeypatch.setitem(sys.modules, "habitat", None)
        with pytest.raises(ImportError, match="habitat-sim"):
            cli.main(argv + flag + ["--dataset", "MP3D"])
        return
    if flag[0] == "--lpips_weights":
        with pytest.raises(FileNotFoundError):
            cli.main(argv + [flag[0], str(tmp_path / flag[1])])
        return
    if flag[0] == "--ensemble_dir":
        missing = str(tmp_path / flag[1])
        args = cli.build_parser().parse_args(argv + [flag[0], missing])
        assert cli.load_config(args).policy.ensemble_dir == missing
        with pytest.raises(FileNotFoundError):
            cli.main(argv + [flag[0], missing, "--policy", "UPEN_fbe",
                             "--img_size", "48", "--set", "tpu.capacity",
                             "8192"])
        return
    args = cli.build_parser().parse_args(argv + flag)
    cfg = port_cfg(episode_cfg(tmp_path))
    if flag[0] == "--dino_weights":
        missing = str(tmp_path / flag[1])
        assert args.dino_weights == flag[1]
        assert tdriver.ActiveMapper(cfg, small_sim(), device="cpu",
                                    dino_weights=missing).dino_bank is None
        with pytest.raises(FileNotFoundError):
            tdriver.ActiveMapper(cfg, small_sim(), device="cpu",
                                 object_scene=True, dino_weights=missing)
        return
    assert args.dino_gate
    mapper = tdriver.ActiveMapper(cfg, small_sim(), device="cpu",
                                  object_scene=args.object_scene,
                                  dino_gate=args.dino_gate)
    assert (mapper.dino_bank is not None) == args.object_scene


@pytest.mark.parametrize("key,value", [("tpu.pipeline_planning", True),
                                       ("policy.save_nav_images", True),
                                       ("policy.name", "upen_rrt")])
def test_driver_refuses_unported_settings(key, value, tmp_path):
    """Pipelined planning, the navigation images and the UPEN policies
    are accepted (the driver constructs)."""
    cfg = port_cfg(episode_cfg(tmp_path))
    cfg.merge_from_list([key, value])
    mapper = tdriver.ActiveMapper(cfg, small_sim(), device="cpu")
    if key == "policy.name":
        assert mapper.upen is not None and mapper.upen.use_rrt
    elif key == "tpu.pipeline_planning":
        assert mapper.pipeline_planning and mapper._plan_prep is None
    else:
        assert mapper.upen is None and mapper.cfg.policy.save_nav_images
        assert mapper.planner.eval_dir == mapper.eval_dir
