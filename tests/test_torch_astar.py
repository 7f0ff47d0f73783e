"""The host A* search (`explore.planner_backend: astar`), JAX package
against the PyTorch port on the CPU.

Tolerance: exact.  On the JAX package's tests/test_planning.py grids
(a corridor, a wall with a gap, a wall with none) and on random grids,
the L1 obstacle distances, the search trees (cost, parent, collision
cost per cell) and the paths, with and without the line-of-sight
shortcut, are equal, also over several goals of one search (the tree is
reused); check_collision_free agrees on random segments.  Both
AstarPlanners with the astar backend plan the first event of
tests/test_torch_planner.py's scan (its frames, points and candidate
poses) to the same paths and action lists.
"""
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.engine.actions import (
    action_planning as jaction_planning)
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene, FakeSim
from fisher_nerf_customized_tpu.ops.camera import Camera
from fisher_nerf_customized_tpu.planning import astar as jastar
from fisher_nerf_customized_tpu.planning.planner import (
    AstarPlanner as JPlanner)
from fisher_nerf_customized_tpu_torch.engine.actions import action_planning
from fisher_nerf_customized_tpu_torch.planning import astar as tastar
from fisher_nerf_customized_tpu_torch.planning.planner import (
    AstarPlanner as TPlanner)

from test_torch_planner import ACTIONS, IMG, backproject, jcfg, make_cfg, tcfg


def corridor():
    occ = np.zeros((64, 64), np.uint8)
    occ[:, :4] = 1
    occ[:, -4:] = 1
    occ[:4, :] = 1
    occ[-4:, :] = 1
    return occ, (10, 10), [(50, 50), (12, 40), (40, 12)]


def wall_with_gap():
    occ = np.zeros((64, 64), np.uint8)
    occ[:2, :] = 1
    occ[-2:, :] = 1
    occ[:, :2] = 1
    occ[:, -2:] = 1
    occ[20:24, 5:55] = 1
    return occ, (10, 30), [(40, 30), (60, 5), (5, 60)]


def wall_without_gap():
    occ = np.zeros((32, 32), np.uint8)
    occ[14:18, :] = 1
    return occ, (5, 16), [(28, 16), (30, 2)]


def random_grid(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(30, 56, 2)
    occ = np.zeros((h, w), np.uint8)
    for _ in range(rng.integers(3, 9)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        occ[y:y + rng.integers(2, 15), x:x + rng.integers(2, 15)] = 1
    free_cells = np.argwhere(occ == 0)
    pick = free_cells[rng.choice(len(free_cells), 5, replace=False)]
    goals = [tuple(p) for p in pick[1:]] + [tuple(np.argwhere(occ)[0])]
    return occ, tuple(pick[0]), goals


GRIDS = [corridor(), wall_with_gap(), wall_without_gap()] + [
    random_grid(s) for s in range(4)]


@pytest.mark.parametrize("shortcut", [True, False])
@pytest.mark.parametrize("grid", range(len(GRIDS)))
def test_search_matches_jax(grid, shortcut):
    occ, start, goals = GRIDS[grid]
    free = (1 - occ).astype(np.uint8)
    js = jastar.AstarSearch(occ, free, start)
    ts = tastar.AstarSearch(occ, free, start)
    np.testing.assert_array_equal(ts.dist_obs, js.dist_obs)
    found = 0
    for goal in goals:
        ref = js.plan(np.array(goal), shortcut=shortcut)
        got = ts.plan(np.array(goal), shortcut=shortcut)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(ts.tree, js.tree)
        found += len(got) > 0
    if grid < 2:
        assert found == len(goals)
    if grid == 2:
        assert found == 0


@pytest.mark.parametrize("seed", range(3))
def test_collision_check_matches_jax(seed):
    occ, _start, _goals = random_grid(10 + seed)
    h, w = occ.shape
    rng = np.random.default_rng(seed)
    hits = 0
    for _ in range(200):
        p1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        p2 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        ref = jastar.check_collision_free(p1, p2, occ)
        assert tastar.check_collision_free(p1, p2, occ) == ref
        hits += ref
    assert 0 < hits < 200


@pytest.fixture(scope="module")
def astar_planners():
    cam = Camera(fx=IMG / 2, fy=IMG / 2, cx=IMG / 2, cy=IMG / 2, width=IMG,
                 height=IMG)
    sim = FakeSim(BoxScene.multi_room(seed=11), cam, forward_step=0.065 * 4,
                  turn_angle=30.0)
    obs = [sim.reset()] + [sim.step(a) for a in ACTIONS]
    frames = [(np.array(o["depth"], np.float32),
               np.array(o["c2w"], np.float32)) for o in obs]
    jc, tc = make_cfg(jcfg), make_cfg(tcfg)
    jc.explore.planner_backend = tc.explore.planner_backend = "astar"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jp, tp = JPlanner(jc, seed=4), TPlanner(tc, seed=4, device="cpu")
    for p in (jp, tp):
        p.init(frames[0][1], cam.intrinsics, img_size=(IMG, IMG))
        p.set_clearance(0.18)
        for t, (depth, c2w) in enumerate(frames):
            p.update_occ_map(depth, c2w, t)
    torch.set_num_threads(n)
    points = np.concatenate([backproject(d, c, cam) for d, c in frames[::2]])
    return jp, tp, frames, points


def test_astar_backend_plans_the_first_event(astar_planners):
    jp, tp, frames, pts = astar_planners
    c2w = frames[-1][1].astype(np.float64)
    t = len(frames) - 1
    ref = jp.global_planning(None, pts, agent_pose=c2w[:3, 3])
    got = tp.global_planning(None, pts, agent_pose=c2w[:3, 3])
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    ref_a = jaction_planning(np.asarray(ref[0]), c2w, jp, pts, t, 0.065,
                             10.0, 30)
    got_a = action_planning(got[0], c2w, tp, pts, t, 0.065, 10.0, 30)
    assert isinstance(tp._search, tastar.AstarSearch)
    assert got_a[1] == ref_a[1] and got_a[3] == ref_a[3]
    assert len(got_a[1]) >= 2
    for a, b in zip(got_a[2], ref_a[2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tp._search.tree, jp._search.tree)
