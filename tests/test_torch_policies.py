"""ActiveMapper's baseline policies, JAX package against the PyTorch
port on the CPU: FBE (`frontier`: first valid path, no H_train, no path
EIG), `random_walk` (ActiveMapper's numpy generator picks the queue) and
action replay (`traj_actions` under `gaussians_based`), each on the
settings of tests/test_engine.py (episode_cfg: 48x48 frames, FakeSim
seed 3, mapper seed 0) for 26 steps with the reconstruction metric at
steps 0 and 25 and the evaluation over 8 held-out poses.  The JAX sim
hands out host frames (device_obs=False), so that its point cloud takes
the numpy stream the port reproduces.

Each pair must take the same actions, stop at the same step for the same
reason, cover the same cells (1e-9) with as many Gaussians, agree on the
metrics_curve.yaml recon steps to rtol 1e-6 and on the evaluation within
test_torch_episode.py's tolerances (PSNR 0.05 dB, SSIM and lpips_proxy
1e-3, depth MAE rtol 1e-2).  None of the three scores a path or a pose:
path_eig_scores and compute_H_train are counted in both packages.

checkpoint_interval 9 puts an in-loop checkpoint at step 12 (the offset
is map_every // 2 = 3); the group is copied aside as the run passes it,
and the `frontier` and `random_walk` episodes resumed from it in both
packages must take the JAX package's actions.  Last, the entry point
(`--policy frontier`, `--policy random_walk`) writes result.json, and
the planner's repaired positional signatures bind as the JAX package's.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from fisher_nerf_customized_tpu.engine import driver as jdriver
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene as JScene
from fisher_nerf_customized_tpu.envs.fake_sim import FakeSim as JSim
from fisher_nerf_customized_tpu.models.slam import GaussianSLAM as JSLAM
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch import cli
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene as TScene
from fisher_nerf_customized_tpu_torch.envs.fake_sim import FakeSim as TSim
from fisher_nerf_customized_tpu_torch.models.slam import \
    GaussianSLAM as TSLAM
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

from test_engine import IMG, episode_cfg

STEPS = 26
EVAL_POSES = 8
CK_T = 12                  # the in-loop checkpoint copied aside
INTERVAL = 9
# the replayed list: 20 actions drawn once from a seeded generator, so
# the replay ends on `traj_end` before max_steps
REPLAY = [int(a) for a in
          np.random.default_rng(7).choice([1, 1, 1, 2, 3], size=20)]
POLICIES = ["frontier", "random_walk", "replay"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the suite's six workers
    share the CPU beside XLA's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(pkg, workdir, policy, eval_dir=None):
    """(mapper, scene, actions list) of one package on episode_cfg; replay
    runs REPLAY under gaussians_based."""
    cfg = episode_cfg(workdir, steps=STEPS,
                      policy="gaussians_based" if policy == "replay"
                      else policy)
    cfg.checkpoint_interval = INTERVAL
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
    mapper = drv.ActiveMapper(
        cfg, sim, scene=scene, seed=0, eval_dir=eval_dir,
        traj_actions=REPLAY if policy == "replay" else None, **kw)
    return mapper, scene, actions


class Counts:
    """Wraps path_eig_scores (as engine/driver.py names it) and
    compute_H_train (the SLAM class's method) of one package to count
    their calls, and ActiveMapper.plan_best_path to keep the action list
    of each planning event."""

    def __init__(self, mp, drv, slam_cls):
        self.path_eig = self.h_train = 0
        self.plans = []
        score_fn, h_fn = drv.path_eig_scores, slam_cls.compute_H_train
        plan_fn = drv.ActiveMapper.plan_best_path

        def plan(*a, **k):
            actions, path = plan_fn(*a, **k)
            self.plans.append(list(actions) if actions else None)
            return actions, path

        def scores(*a, **k):
            self.path_eig += 1
            return score_fn(*a, **k)

        def h_train(*a, **k):
            self.h_train += 1
            return h_fn(*a, **k)

        mp.setattr(drv, "path_eig_scores", scores)
        mp.setattr(slam_cls, "compute_H_train", h_train)
        mp.setattr(drv.ActiveMapper, "plan_best_path", plan)


def run(pkg, tmp, policy):
    """The uninterrupted run, its step-CK_T group copied to
    <tmp>/<pkg>_<policy>_ck: (result, actions, mapper, copy, counts)."""
    drv, slam_cls = (jdriver, JSLAM) if pkg == "jax" else (tdriver, TSLAM)
    with pytest.MonkeyPatch.context() as mp:
        counts = Counts(mp, drv, slam_cls)
        mapper, scene, actions = make(pkg, tmp / f"{pkg}_{policy}", policy)
        snap = str(tmp / f"{pkg}_{policy}_ck")

        def on_step(t, _obs):
            if t == CK_T:
                shutil.copytree(mapper.eval_dir, snap)

        result = mapper.test_navigation(
            n_eval_poses=EVAL_POSES,
            recon_gt_points=scene.sample_surface_points(4000),
            on_step=on_step)
    return result, actions, mapper, snap, counts


def resume(pkg, tmp, policy, snap):
    """A fresh mapper of one package on a copy of a step-CK_T group,
    resumed and run to STEPS: (result, its actions)."""
    eval_dir = str(tmp / f"{pkg}_{policy}_resumed")
    shutil.copytree(snap, eval_dir)
    mapper, scene, actions = make(pkg, tmp / f"{pkg}_{policy}_resumed",
                                  policy, eval_dir=eval_dir)
    mapper.resume(os.path.join(eval_dir, f"params{CK_T}.npz"))
    result = mapper.test_navigation(
        n_eval_poses=0, recon_gt_points=scene.sample_surface_points(4000))
    return result, actions


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted runs of each policy in both packages, made once
    on first use: policy -> (policy, JAX run, port run, tmp)."""
    tmp = tmp_path_factory.mktemp("policies")
    made = {}

    def get(policy):
        if policy not in made:
            made[policy] = (policy, run("jax", tmp, policy),
                            run("torch", tmp, policy), tmp)
        return made[policy]

    return get


@pytest.fixture(params=POLICIES)
def episodes(request, runs):
    return runs(request.param)


def test_same_actions_and_end(episodes):
    policy, (jres, ja, _jm, _js, _jc), (tres, ta, _tm, _ts, _tc), _ = episodes
    assert ta == ja
    assert tres["steps"] == jres["steps"]
    assert tres["done_reason"] == jres["done_reason"]
    if policy == "replay":
        assert ta == REPLAY and jres["done_reason"] == "traj_end"
        assert jres["steps"] == len(REPLAY)
    else:
        assert len(ja) == jres["steps"] == STEPS
    if policy == "random_walk":
        assert tres["planning_events"] == 0
        # the queue is the generator's: forward three times in five
        assert set(ja) <= {1, 2, 3} and ja.count(1) > len(ja) // 3


def test_coverage_and_map_size(episodes):
    _p, (jres, _ja, jm, _js, _jc), (tres, _ta, tm, _ts, _tc), _ = episodes
    assert tres["coverage_2d_pct"] == pytest.approx(
        jres["coverage_2d_pct"], abs=1e-9)
    assert tres["n_gaussians"] == jres["n_gaussians"]
    assert tm.slam.n_active == jm.slam.n_active


def test_recon_curves_match(episodes):
    """The two metrics_curve.yaml, recon step by recon step (rtol 1e-6),
    the final recon and AUC."""
    policy, (jres, _ja, jm, _js, _jc), (tres, _ta, tm, _ts, _tc), _ = \
        episodes
    docs = []
    for m in (jm, tm):
        with open(os.path.join(m.eval_dir, "metrics_curve.yaml")) as f:
            docs.append(yaml.safe_load(f))
    ref, got = docs
    want = [0] if policy == "replay" else [0, 25]
    assert [s["step"] for s in got["steps"]] == \
        [s["step"] for s in ref["steps"]] == want
    for rs, gs in zip(ref["steps"], got["steps"]):
        assert gs.keys() == rs.keys()
        for k in rs:
            np.testing.assert_allclose(gs[k], rs[k], rtol=1e-6,
                                       err_msg=f"step {rs['step']} {k}")
    for k in jres["recon"]:
        np.testing.assert_allclose(tres["recon"][k], jres["recon"][k],
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(tres["auc"], jres["auc"], rtol=1e-6)


def test_eval_matches(episodes):
    _p, (jres, _ja, _jm, _js, _jc), (tres, _ta, _tm, _ts, _tc), _ = episodes
    ref, got = jres["eval"], tres["eval"]
    assert got.keys() == ref.keys()
    assert got["n_poses"] == ref["n_poses"] == EVAL_POSES
    assert got["n_seen"] == ref["n_seen"]
    for k, tol in (("psnr", 0.05), ("psnr_seen", 0.05), ("ssim", 1e-3),
                   ("ssim_seen", 1e-3), ("lpips_proxy", 1e-3)):
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])
    for k in ("depth_mae", "depth_mae_seen"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-2, err_msg=k)


def test_no_path_or_pose_scoring(episodes):
    """FBE takes the first valid path (JAX driver.py:387, best = 0), the
    random walk and the replay plan nothing: no path EIG and no H_train in
    either package.  FBE plans the same action lists in both."""
    policy, (_jr, _ja, _jm, _js, jc), (tres, _ta, tm, _ts, tc), _ = episodes
    for c in (jc, tc):
        assert (c.path_eig, c.h_train) == (0, 0)
    assert tc.plans == jc.plans
    assert tres["planning_events"] == len(tm.plan_log)
    if policy == "frontier":
        assert len(jc.plans) >= 1 and None not in jc.plans
        assert [p["best"] for p in tm.plan_log] == [0] * len(jc.plans)
    else:
        assert jc.plans == [] and tm.plan_log == []


@pytest.mark.parametrize("policy", ["frontier", "random_walk"])
def test_resumed_episode_takes_the_jax_actions(policy, runs):
    """Both packages resume their own step-12 group; the port's resumed run
    takes the JAX package's resumed actions, which are the uninterrupted
    run's (ActiveMapper's, the planner's, SLAM's and cloud's numpy generators
    are in episode_rng.pkl, the queue in episode_state.npz)."""
    _p, j, t, tmp = runs(policy)
    jres, ja = resume("jax", tmp, policy, j[3])
    tres, ta = resume("torch", tmp, policy, t[3])
    assert ta == ja == j[1][CK_T + 1:]
    assert tres["steps"] == jres["steps"] == STEPS
    assert tres["coverage_2d_pct"] == pytest.approx(
        jres["coverage_2d_pct"], abs=1e-9)
    assert tres["n_gaussians"] == jres["n_gaussians"]


@pytest.mark.parametrize("policy", ["frontier", "random_walk"])
def test_entry_point_writes_the_result(policy, tmp_path, capsys):
    """python -m fisher_nerf_customized_tpu_torch --policy <policy> on the
    CPU at 48x48: one JSON line, result.json with the same result."""
    argv = ["--scenes_list", "fake_room_0", "--max_steps", "8",
            "--policy", policy, "--eval_poses", "4",
            "--img_size", "48", "--device", "cpu",
            "--log_dir", str(tmp_path), "--name", "cli",
            "--set", "mapping.num_iters", "4", "tpu.capacity", "8192",
            "policy.planning_queue_size", "5", "turn_angle", "30.0",
            "explore.cell_size", "0.1"]
    cli.main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = out["fake_room_0"]
    assert out["policy"] == policy and out["steps"] == 8
    with open(tmp_path / "cli" / "fake_room_0" / "result.json") as f:
        assert json.load(f) == out
    assert out["eval"]["n_poses"] == 4 and np.isfinite(out["eval"]["psnr"])
    assert os.path.exists(tmp_path / "cli" / "fake_room_0"
                          / f"{policy}_results.txt")


def test_repaired_planner_signatures_bind_positionally(tmp_path):
    """Calls written for the JAX package's positional order: the planner's
    constructor (slam_config, eval_dir, seed), update_occ_map's ignored
    `downsample`, global_planning_frontier(expansion, visualize,
    agent_pose) and global_planning(..., expansion, visualize,
    agent_pose, last_goal, slam): the same maps, goals and candidates in
    both packages, on test_torch_planner.py's frames."""
    from fisher_nerf_customized_tpu.config import get_cfg_defaults as jcfg
    from fisher_nerf_customized_tpu.planning.planner import \
        AstarPlanner as JPlanner
    from fisher_nerf_customized_tpu_torch.planning.planner import \
        AstarPlanner as TPlanner
    from test_torch_planner import ACTIONS, IMG as PIMG, backproject, \
        make_cfg
    cam = JCamera(fx=PIMG / 2, fy=PIMG / 2, cx=PIMG / 2, cy=PIMG / 2,
                  width=PIMG, height=PIMG)
    sim = JSim(JScene.multi_room(seed=11), cam, forward_step=0.065 * 4,
               turn_angle=30.0)
    obs = [sim.reset()] + [sim.step(a) for a in ACTIONS]
    frames = [(np.array(o["depth"], np.float32),
               np.array(o["c2w"], np.float32)) for o in obs]
    jp = JPlanner(make_cfg(jcfg), str(tmp_path / "j"), 4)
    tp = TPlanner(make_cfg(tcfg), str(tmp_path / "t"), 4, "cpu")
    assert (jp.eval_dir, tp.eval_dir) == (str(tmp_path / "j"),
                                          str(tmp_path / "t"))
    for p in (jp, tp):
        p.init(frames[0][1], cam.intrinsics, img_size=(PIMG, PIMG))
        p.set_clearance(0.18)
        for t, (depth, c2w) in enumerate(frames):
            p.update_occ_map(depth, c2w, t, 4)
    np.testing.assert_array_equal(tp._occ_index_np(), jp._occ_index_np())
    pose = frames[-1][1].astype(np.float64)[:3, 3]
    jgoal, _ = jp.global_planning_frontier(1, False, pose)
    tgoal, _ = tp.global_planning_frontier(1, False, pose)
    assert tgoal is not None
    np.testing.assert_array_equal(tgoal, np.asarray(jgoal))
    pts = np.concatenate([backproject(d, c, cam) for d, c in frames[::2]])
    ref = jp.global_planning(None, pts, None, 1, False, pose, None, None)
    got = tp.global_planning(None, pts, None, 1, False, pose, None, None)
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
