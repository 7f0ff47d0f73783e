"""The known-environment mode, JAX package against the PyTorch port on the
CPU.

- init_known_env: both planners seed the eccv config's 768x768 map (5 cm)
  from the same ground-truth cloud; the occupancy map is equal on every
  cell and channel, the free-vote lines included (the JAX package draws
  them with cv2.line, the port with utils/raster.py::draw_lines), also
  when the lines are a draw of the occupied cells.  In both, the seeded
  votes never win the argmax (a vote share <= 1 ties or loses to the
  unknown channel's 1.0), so the known free space is the 3x3 start
  (ROADMAP.md queue 3 n);
- cover_fov_2d and build_frontier_cells: equal coverage and frontier
  cells after a sequence of FakeSim poses, on the seeded map and on the
  free space the walk itself observed, and equal frontier points and
  FBE goal from build_frontiers;
- draw_lines against cv2.line on random segments, ends on the grid's
  border and outside it included;
- a 10-step `--object_scene --known_env` episode in both packages (the
  JAX package's tests/test_object_episode.py::
  test_known_env_novelty_episode setup: 48x48 frames, a 6 m room, the
  object at (0, 1.8), the empty room's 40 000-point cloud, the agent
  facing the object): the same actions and the object found at the same
  step; the port's object SLAM is fed the JAX package's Hutchinson
  draws, as in tests/test_torch_object_episode.py;
- a resume in known-environment mode: the checkpoint holds no coverage,
  so in both packages the resumed planner has none and plans from the
  unknown cells of its restored map; both take the same actions to the
  end;
- the port's entry point with --known_env.
"""
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.config import get_cfg_defaults as jcfg
from fisher_nerf_customized_tpu.engine import driver as jdriver
from fisher_nerf_customized_tpu.envs import fake_sim as jsim
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu.planning.planner import (
    AstarPlanner as JPlanner)
from fisher_nerf_customized_tpu_torch import cli
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.envs import fake_sim as tsim
from fisher_nerf_customized_tpu_torch.models import object_slam as tos
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera
from fisher_nerf_customized_tpu_torch.planning.planner import (
    AstarPlanner as TPlanner)
from fisher_nerf_customized_tpu_torch.utils.raster import draw_lines

from test_engine import IMG, episode_cfg
from test_torch_episode import port_cfg
from test_torch_object_episode import jax_probe_draw

YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "mp3d_gaussian_FR_eccv.yaml")
STEPS = 10
CK_T = 7                   # the in-loop checkpoint (checkpoint_interval 4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def planners():
    jc, tc = jcfg(), tcfg()
    jc.merge_from_file(YAML)
    tc.merge_from_file(YAML)
    return JPlanner(jc, seed=0), TPlanner(tc, seed=0, device="cpu")


def apartment(seed=11):
    scene = jsim.BoxScene.multi_room(seed=seed)
    cam = JCamera(fx=32.0, fy=32.0, cx=32.0, cy=32.0, width=64, height=64)
    sim = jsim.FakeSim(scene, cam, forward_step=0.25, turn_angle=30.0,
                       seed=0, device_obs=False)
    return scene, sim


def occ_np(planner):
    m = planner.occ_map
    return m.numpy() if isinstance(m, torch.Tensor) else np.asarray(m)


@pytest.mark.parametrize("max_lines", [20000, 700])
def test_init_known_env_matches_jax(max_lines):
    scene, sim = apartment()
    cloud = scene.sample_surface_points(120000)
    jp, tp = planners()
    for p in (jp, tp):
        p.init_known_env(sim.c2w, cloud, intrinsic=sim.intrinsics,
                         img_size=(64, 64), max_lines=max_lines)
    np.testing.assert_array_equal(occ_np(tp), occ_np(jp))
    np.testing.assert_array_equal(tp._known_free, jp._known_free)
    np.testing.assert_array_equal(tp.cam_pos, jp.cam_pos)
    np.testing.assert_array_equal(tp.map_center, jp.map_center)
    assert not tp.covered.any() and tp.covered.shape == jp.covered.shape
    # the reference's votes leave only the start's 3x3 free
    assert tp._known_free.sum() == 9
    assert occ_np(tp)[1].max() > 0.9 and occ_np(tp)[2].max() > 2.9


def test_coverage_and_frontier_cells_match_jax():
    scene, sim = apartment()
    cloud = scene.sample_surface_points(120000)
    jp, tp = planners()
    for p in (jp, tp):
        p.init_known_env(sim.c2w, cloud, intrinsic=sim.intrinsics,
                         img_size=(64, 64))
    actions = [2, 2, 1, 1, 3, 1, 1, 1, 2, 1, 1, 3, 3, 1, 1]
    poses = []
    for t, a in enumerate(actions):
        obs = sim.step(a)
        poses.append(obs["c2w"])
        for p in (jp, tp):
            p.update_occ_map(obs["depth"], obs["c2w"], t)
            p.cover_fov_2d(obs["c2w"])
        np.testing.assert_array_equal(tp.covered, jp.covered)
    assert tp.covered.any()
    np.testing.assert_array_equal(tp.build_frontier_cells(),
                                  jp.build_frontier_cells())
    # the same probes on the free space the walk observed
    observed = tp._occ_index_np() == 2
    for p in (jp, tp):
        p._known_free = observed.copy()
        p.covered[:] = False
    for c2w in poses:
        for p in (jp, tp):
            p.cover_fov_2d(c2w)
        np.testing.assert_array_equal(tp.covered, jp.covered)
    assert tp.covered.sum() > 300
    cells = tp.build_frontier_cells()
    assert len(cells) > 20
    np.testing.assert_array_equal(cells, jp.build_frontier_cells())
    ref_pts, ref_free = jp.build_frontiers(None)
    got_pts, got_free = tp.build_frontiers(None)
    np.testing.assert_array_equal(got_free, ref_free)
    np.testing.assert_array_equal(tp.frontier, jp.frontier)
    np.testing.assert_array_equal(np.asarray(got_pts), np.asarray(ref_pts))
    ref_goal, _ = jp.global_planning_frontier()
    got_goal, _ = tp.global_planning_frontier()
    np.testing.assert_array_equal(got_goal, ref_goal)


@pytest.mark.parametrize("h,w", [(1, 1), (7, 31), (40, 23), (64, 64)])
def test_draw_lines_matches_cv2(h, w):
    rng = np.random.default_rng(h * 100 + w)
    n = 400
    on_border = np.stack([rng.choice([0, w - 1], n), rng.integers(0, h, n)],
                         1)
    inside = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
    outside = np.stack([rng.integers(-20, w + 20, n),
                        rng.integers(-20, h + 20, n)], 1)
    pairs = [(inside, inside[::-1]), (on_border, inside),
             (on_border, on_border[::-1]), (outside, inside),
             (outside, outside[::-1])]
    for p0, p1 in pairs:
        ref = np.zeros((h, w), np.uint8)
        for a, b in zip(p0, p1):
            cv2.line(ref, (int(a[0]), int(a[1])), (int(b[0]), int(b[1])),
                     1, 1)
        np.testing.assert_array_equal(draw_lines((h, w), p0, p1), ref)
        for a, b in zip(p0[:40], p1[:40]):
            one = np.zeros((h, w), np.uint8)
            cv2.line(one, (int(a[0]), int(a[1])), (int(b[0]), int(b[1])),
                     1, 1)
            np.testing.assert_array_equal(draw_lines((h, w), a, b), one)


def run(pkg, tmp_path, mp, resume_from=None):
    """The known-env object episode: (actions, the step the object SLAM
    started at, result, mapper, the checkpoint copy's directory)."""
    cfg = episode_cfg(tmp_path / pkg, steps=STEPS)
    cfg.map_obj_every = 2
    cfg.explore_object.sample_view_num = 6
    cfg.checkpoint_interval = 4
    if pkg == "jax":
        mod, cam_t, drv, kw, sim_kw = jsim, JCamera, jdriver, {}, dict(
            device_obs=False)
    else:
        cfg = port_cfg(cfg)
        mod, cam_t, drv = tsim, TCamera, tdriver
        kw = sim_kw = dict(device="cpu")
        mp.setattr(tos.GaussianObjectSLAM, "probe_draw", jax_probe_draw)
    cam = cam_t(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                width=IMG, height=IMG)
    scene = mod.BoxScene(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                         obstacles=[])
    obj = mod.SimObject(scene, semantic_id=100, size=(0.5, 1.2, 0.5),
                        start_xz=(0.0, 1.8), speed=0.03, seed=2)
    sim = mod.FakeSim(scene, cam, forward_step=0.15, turn_angle=30.0,
                      dynamic_object=obj, seed=2, **sim_kw)
    empty = jsim.BoxScene(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                          obstacles=[])
    gt_cloud = empty.sample_surface_points(40000)
    eval_dir = os.path.join(cfg.workdir, cfg.run_name)
    if resume_from is not None:
        shutil.copytree(resume_from, eval_dir)
    mapper = drv.ActiveMapper(cfg, sim, scene=scene, seed=0,
                              eval_dir=eval_dir, object_scene=True,
                              known_env_points=gt_cloud, **kw)
    actions, found = [], []
    sim_step = sim.step

    def step(a):
        actions.append(int(a))
        return sim_step(a)

    sim.step = step
    snap = str(tmp_path / f"{pkg}_ck")
    covered_after_resume = "not resumed"
    if resume_from is not None:
        mapper.resume(os.path.join(eval_dir, f"params{CK_T}.npz"))
        covered_after_resume = mapper.planner.covered
    else:
        sim.reset(yaw=0.0)                 # facing the object

    def on_step(t, _obs):
        if mapper.obj_slam is not None and not found:
            found.append(t)
        if t == CK_T and resume_from is None:
            shutil.copytree(eval_dir, snap)

    result = mapper.test_navigation(n_eval_poses=0, on_step=on_step)
    return dict(actions=actions, found=found, result=result, mapper=mapper,
                snap=snap, covered_after_resume=covered_after_resume)


_RUNS = {}


def episodes(tmp_path_factory):
    if not _RUNS:
        tmp = tmp_path_factory.mktemp("known_env")
        with pytest.MonkeyPatch.context() as mp:
            _RUNS["jax"] = run("jax", tmp, mp)
        with pytest.MonkeyPatch.context() as mp:
            _RUNS["torch"] = run("torch", tmp, mp)
        _RUNS["tmp"] = tmp
    return _RUNS["tmp"], _RUNS["jax"], _RUNS["torch"]


def test_known_env_object_episode_matches_jax(tmp_path_factory):
    _tmp, ref, got = episodes(tmp_path_factory)
    assert got["result"]["steps"] == ref["result"]["steps"] == STEPS
    assert got["found"] and got["found"] == ref["found"]
    print(f"object found at step {got['found'][0]}; actions "
          f"{got['actions']}")
    assert got["actions"] == ref["actions"]
    tm, jm = got["mapper"], ref["mapper"]
    assert tm.obj_slam is not None and tm.obj_slam.n_active > 0
    np.testing.assert_array_equal(tm.planner.covered, jm.planner.covered)
    np.testing.assert_array_equal(tm.global_obj_pcl, jm.global_obj_pcl)


def test_known_env_resume_has_no_coverage(tmp_path_factory):
    """Each package resumes its own step-7 checkpoint: the planner has no
    coverage mask afterwards (the JAX checkpoint stores none), the novelty
    mask still runs, and the two take the same actions to step 10."""
    tmp, ref, got = episodes(tmp_path_factory)
    res = {}
    for pkg, full in (("jax", ref), ("torch", got)):
        with pytest.MonkeyPatch.context() as mp:
            res[pkg] = run(pkg, tmp / "resume", mp, resume_from=full["snap"])
        assert res[pkg]["covered_after_resume"] is None
        assert res[pkg]["mapper"].planner.covered is None
        assert res[pkg]["result"]["steps"] == STEPS
        assert len(res[pkg]["actions"]) == STEPS - CK_T - 1
    assert res["torch"]["actions"] == res["jax"]["actions"]


def test_entry_point_runs_known_env(tmp_path):
    out = cli.main(["--device", "cpu", "--log_dir", str(tmp_path),
                    "--name", "cli", "--max_steps", "4", "--img_size", "48",
                    "--eval_poses", "0", "--known_env",
                    "--set", "tpu.capacity", "8192"])["fake_room_0"]
    assert out["steps"] == 4
    assert os.path.exists(tmp_path / "cli" / "fake_room_0" / "result.json")
