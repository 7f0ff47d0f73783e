"""The planner, JAX package against the PyTorch port on the CPU: the same
update_occ_map sequence (FakeSim depth frames, 64x64, on the 768x768
map at the eccv config's 5 cm) and the same Gaussian points (the frames
back-projected) through both AstarPlanners.

Tolerance: exact.  The label map, the frontier mask and points, the
setup_start maps (dilated obstacles, C-space inflation, the free space
connected to the start), global_planning's candidate poses (same seed,
the uniform pose_eval stub) and action_planning's paths and action lists
are equal, and both planners leave their numpy streams in the same
state.
"""
import os

import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.config import get_cfg_defaults as jcfg
from fisher_nerf_customized_tpu.engine.actions import (
    action_planning as jaction_planning)
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene, FakeSim
from fisher_nerf_customized_tpu.ops.camera import Camera
from fisher_nerf_customized_tpu.planning import candidates as jcand
from fisher_nerf_customized_tpu.planning.planner import (
    AstarPlanner as JPlanner)
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.engine.actions import action_planning
from fisher_nerf_customized_tpu_torch.planning import candidates as tcand
from fisher_nerf_customized_tpu_torch.planning.planner import (
    AstarPlanner as TPlanner)

YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "mp3d_gaussian_FR_eccv.yaml")
IMG = 64
ACTIONS = [2, 2, 2, 1, 1, 1, 3, 1, 1, 2, 2, 1, 1, 1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under the suite's six
    workers, torch's default of one thread per core oversubscribes the
    CPU beside XLA's own pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cfg(get_defaults):
    cfg = get_defaults()
    cfg.merge_from_file(YAML)
    cfg.explore.sample_view_num = 48
    return cfg


def backproject(depth, c2w, cam, stride=2):
    ys, xs = np.mgrid[0:IMG:stride, 0:IMG:stride]
    z = depth[::stride, ::stride]
    pts = np.stack([(xs - cam.cx) / cam.fx * z, (ys - cam.cy) / cam.fy * z,
                    z], -1).reshape(-1, 3)
    return (pts @ c2w[:3, :3].T + c2w[:3, 3]).astype(np.float32)


@pytest.fixture(scope="module")
def planners():
    cam = Camera(fx=IMG / 2, fy=IMG / 2, cx=IMG / 2, cy=IMG / 2, width=IMG,
                 height=IMG)
    sim = FakeSim(BoxScene.multi_room(seed=11), cam, forward_step=0.065 * 4,
                  turn_angle=30.0)
    obs = [sim.reset()] + [sim.step(a) for a in ACTIONS]
    frames = [(np.array(o["depth"], np.float32),
               np.array(o["c2w"], np.float32)) for o in obs]
    jp, tp = JPlanner(make_cfg(jcfg), seed=4), \
        TPlanner(make_cfg(tcfg), seed=4, device="cpu")
    for p in (jp, tp):
        p.init(frames[0][1], cam.intrinsics, img_size=(IMG, IMG))
        p.set_clearance(0.18)
        for t, (depth, c2w) in enumerate(frames):
            p.update_occ_map(depth, c2w, t)
    points = np.concatenate([backproject(d, c, cam) for d, c in frames[::2]])
    return dict(jp=jp, tp=tp, frames=frames, points=points, cam=cam)


def test_label_map_matches(planners):
    jp, tp = planners["jp"], planners["tp"]
    ref, got = jp._occ_index_np(), tp._occ_index_np()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    assert {0, 1, 2} <= set(np.unique(got).tolist())
    np.testing.assert_array_equal(tp.cam_pos, jp.cam_pos)
    assert tp.clearance_cells == jp.clearance_cells == 4


@pytest.mark.parametrize("with_points", [True, False])
def test_build_frontiers_matches(planners, with_points):
    jp, tp = planners["jp"], planners["tp"]
    pts = planners["points"] if with_points else None
    ref_w, ref_free = jp.build_frontiers(pts)
    got_w, got_free = tp.build_frontiers(pts)
    np.testing.assert_array_equal(got_free, ref_free)
    np.testing.assert_array_equal(tp.frontier, jp.frontier)
    np.testing.assert_array_equal(tp.target_frontier, jp.target_frontier)
    np.testing.assert_array_equal(got_w, ref_w)
    assert got_w is not None and len(got_w) >= 1 and got_free.sum() > 100


def test_setup_start_maps_match(planners):
    jp, tp = planners["jp"], planners["tp"]
    c2w = planners["frames"][-1][1]
    start = jp.convert_to_map(c2w[[0, 2], 3])[[1, 0]]
    np.testing.assert_array_equal(tp.convert_to_map(c2w[[0, 2], 3])[[1, 0]],
                                  start)
    for p in (jp, tp):
        p.setup_start(start, planners["points"], len(planners["frames"]) - 1)
    np.testing.assert_array_equal(tp.occ_map_np, jp.occ_map_np)
    np.testing.assert_array_equal(tp.free_space_np, jp.free_space_np)
    assert tp.free_space_np[start[0], start[1]]


def test_global_and_action_planning_match(planners):
    jp, tp = planners["jp"], planners["tp"]
    frames, pts = planners["frames"], planners["points"]
    c2w = frames[-1][1].astype(np.float64)
    t = len(frames) - 1
    ref = jp.global_planning(None, pts, agent_pose=c2w[:3, 3])
    got = tp.global_planning(None, pts, agent_pose=c2w[:3, 3])
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    for k in ("means3D", "scales", "opacity", "shs"):
        np.testing.assert_array_equal(got[2][k], ref[2][k])
    assert tp.rng.integers(1 << 30) == jp.rng.integers(1 << 30)

    ref_a = jaction_planning(np.asarray(ref[0]), c2w, jp, pts, t, 0.065,
                             10.0, 30)
    got_a = action_planning(got[0], c2w, tp, pts, t, 0.065, 10.0, 30)
    assert got_a[1] == ref_a[1] and got_a[3] == ref_a[3]
    assert len(got_a[1]) >= 2
    for a, b in zip(got_a[2], ref_a[2]):
        np.testing.assert_array_equal(a, b)
    assert tp._search.rounds > 5


def test_add_obstacle_matches(planners):
    jp, tp = planners["jp"], planners["tp"]
    c2w = planners["frames"][-1][1]
    ahead = c2w[:3, 3] + c2w[:3, 2] * 0.1
    for p in (jp, tp):
        p.add_obstacle((ahead[0], ahead[2]))
    np.testing.assert_array_equal(tp._occ_index_np(), jp._occ_index_np())
    np.testing.assert_array_equal(tp.occ_map.numpy(), np.asarray(jp.occ_map))


def test_random_candidates_and_gaussians_match(planners):
    free = planners["tp"].build_frontiers(None)[1]
    grid_dim = np.array([768, 768])
    mc = planners["tp"].map_center
    agent = planners["frames"][-1][1][:3, 3]
    r_j, r_t = np.random.default_rng(9), np.random.default_rng(9)
    ref = jcand.sample_random_candidates(agent, free, grid_dim, 0.05, mc, r_j)
    got = tcand.sample_random_candidates(agent, free, grid_dim, 0.05, mc, r_t)
    assert len(got) > 0
    np.testing.assert_array_equal(got, ref)
    cells = np.random.default_rng(1).uniform(-2, 2, (30, 2))
    ref = jcand.generate_random_gaussians(cells, 0.05, 1.25, r_j)
    got = tcand.generate_random_gaussians(cells, 0.05, 1.25, r_t)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert r_t.integers(1 << 30) == r_j.integers(1 << 30)
