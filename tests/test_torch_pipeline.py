"""Pipelined planning (tpu.pipeline_planning) and FakeSim's prefetch, the
JAX package against the PyTorch port on the CPU.

Both ActiveMappers run the settings of tests/test_engine.py (episode_cfg:
48x48 frames, a 10 cm map, queue 8, FakeSim seed 3, mapper seed 0) with
pipelined planning for 18 steps: they must take the same actions, plan at
the same steps (each event's stage-1 preparation made at the same step),
and end with the same n_active; the port's preparations must be consumed
and its prefetched frames taken.  The JAX sim hands out host frames
(device_obs=False), as in test_torch_episode.py.

A preparation is not checkpointed (in neither package), so a run resumed
between a preparation and its planning event plans that event anew from
another map and another point of the planner's random stream: in both
packages the resumed run parts from the uninterrupted one, the same way
(ROADMAP fault u).

FakeSim: prefetch then step equals a plain step to the bit, a step with
another action than the prefetched one renders anew, prefetch does
nothing while the object moves between steps, and SimObject's
moving_forward_and_back walks the JAX package's trajectory.
"""
import os
import shutil
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.engine import driver as jdriver
from fisher_nerf_customized_tpu.envs import fake_sim as jsim
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.envs import fake_sim as tsim
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

from test_engine import IMG, episode_cfg

STEPS = 18
CUT_T = 10          # between the preparation at step 9 and its event at 11


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Requeued(Exception):
    pass


class CutAt:
    """A cluster manager that asks for an exit at the top of step k."""

    def __init__(self, k):
        self.k, self.polls = k, 0

    def should_exit(self):
        self.polls += 1
        return self.polls == self.k + 1

    def requeue(self, exit_code: int = 0):
        raise Requeued()

    def armed(self):
        return nullcontext()


def make(pkg, workdir, eval_dir=None):
    """(mapper, actions list, planning log) of a pipelined episode; the log
    holds (t, expansion, step of the pending preparation or None) per
    plan_best_path call and (t, step of the pending preparation) per
    prepare_planning call."""
    cfg = episode_cfg(workdir, steps=STEPS)
    cfg.tpu.pipeline_planning = True
    if pkg == "jax":
        cam_t, sim_m, drv, kw = JCamera, jsim, jdriver, {}
        sim_kw = dict(device_obs=False)
    else:
        port = tcfg()
        port.merge_from_other(cfg.to_dict())
        cfg = port
        cam_t, sim_m, drv = TCamera, tsim, tdriver
        kw = sim_kw = dict(device="cpu")
    cam = cam_t(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                width=IMG, height=IMG)
    scene = sim_m.BoxScene(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                           obstacles=[((1.0, 0.0, 1.0), (1.8, 1.8, 1.8))])
    sim = sim_m.FakeSim(scene, cam, forward_step=0.15, turn_angle=30.0,
                        seed=3, **sim_kw)
    actions, log = [], dict(plans=[], preps=[])
    sim_step = sim.step
    sim.step = lambda a: (actions.append(int(a)), sim_step(a))[1]
    mapper = drv.ActiveMapper(cfg, sim, scene=scene, seed=0,
                              eval_dir=eval_dir, **kw)
    plan, prep = mapper.plan_best_path, mapper.prepare_planning

    def pending():
        return None if mapper._plan_prep is None else mapper._plan_prep[0]

    def planning(c2w, expansion, t):
        log["plans"].append((t, expansion, pending()))
        return plan(c2w, expansion, t)

    def preparing(c2w, t):
        out = prep(c2w, t)
        log["preps"].append((t, pending()))
        return out

    mapper.plan_best_path, mapper.prepare_planning = planning, preparing
    return mapper, actions, log


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    out = {}
    for pkg in ("jax", "torch"):
        mapper, actions, log = make(pkg, tmp / pkg)
        result = mapper.test_navigation(n_eval_poses=0)
        out[pkg] = (mapper, actions, log, result)
    return out


def test_pipelined_episodes_take_the_same_actions(episodes):
    jm, ja, jlog, jres = episodes["jax"]
    tm, ta, tlog, tres = episodes["torch"]
    assert len(ta) == STEPS and tres["steps"] == jres["steps"] == STEPS
    assert ta == ja
    assert tlog == jlog
    assert tm.slam.n_active == jm.slam.n_active
    # a preparation was taken by a later planning event
    consumed = [p for p in tlog["plans"] if p[2] is not None and p[1] == 1]
    assert consumed and tm.plan_preps["consumed"] == len(consumed) >= 1
    assert tm.plan_preps["made"] == tm.plan_preps["consumed"] \
        + tm.plan_preps["dropped"] + (tm._plan_prep is not None)
    # every step whose action was the queue's head took the prefetched frame
    assert tm.sim.prefetch_hits >= STEPS - len(tlog["plans"]) - 1
    assert tres["coverage_2d_pct"] == pytest.approx(jres["coverage_2d_pct"],
                                                    abs=1e-6)


def test_resumed_pipelined_episode_parts_in_both_packages(episodes,
                                                          tmp_path):
    """A checkpoint taken between a preparation (step CUT_T - 1) and its
    planning event: the resumed run prepares anew at step CUT_T and parts
    from the uninterrupted run, and the two packages' resumed runs take
    the same actions."""
    resumed = {}
    for pkg in ("jax", "torch"):
        _m, full_actions, full_log, _res = episodes[pkg]
        assert (CUT_T - 1, CUT_T - 1) in full_log["preps"]
        cut, cut_actions, _log = make(pkg, tmp_path / pkg / "cut")
        cut.cm = CutAt(CUT_T)
        with pytest.raises(Requeued):
            cut.test_navigation(n_eval_poses=0)
        assert cut._plan_prep is not None and cut_actions == \
            full_actions[:CUT_T]
        eval_dir = str(tmp_path / pkg / "resumed" / "ep")
        shutil.copytree(cut.eval_dir, eval_dir)
        res, res_actions, res_log = make(pkg, tmp_path / pkg / "resumed",
                                         eval_dir=eval_dir)
        res.resume(os.path.join(eval_dir, f"params{CUT_T - 1}.npz"))
        res.test_navigation(n_eval_poses=0)
        assert res_log["preps"][0] == (CUT_T, CUT_T)
        resumed[pkg] = cut_actions + res_actions
        assert len(resumed[pkg]) == STEPS
        assert resumed[pkg] != full_actions
    assert resumed["torch"] == resumed["jax"]


ACTIONS = (2, 1, 1, 1, 1, 1, 1, 3, 1, 2, 2, 1)


def small_sims(obj_kwargs=None, object_dynamic=False):
    """The same scene in both packages (a 4 m room, one box), 64x64."""
    cam = dict(fx=32.0, fy=32.0, cx=32.0, cy=32.0, width=64, height=64)
    sims = []
    for m, cam_t, kw in ((jsim, JCamera, {}), (tsim, TCamera,
                                               dict(device="cpu"))):
        scene = m.BoxScene(room_lo=(-2, 0, -2), room_hi=(2, 2.5, 2),
                           obstacles=[((0.6, 0.0, 0.6), (1.2, 1.5, 1.2))])
        obj = None if obj_kwargs is None else m.SimObject(scene, **obj_kwargs)
        sims.append(m.FakeSim(scene, cam_t(**cam), forward_step=0.25,
                              turn_angle=30.0, dynamic_object=obj,
                              object_dynamic=object_dynamic, **kw))
    return sims


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_obs(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(_host(a[k]), _host(b[k]), err_msg=k)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_prefetch_then_step_equals_a_plain_step(pkg):
    obj = dict(start_xz=(-0.8, 0.9), size=(0.4, 1.0, 0.4))
    for obj_kwargs in (None, obj):
        a = small_sims(obj_kwargs)[pkg == "torch"]
        b = small_sims(obj_kwargs)[pkg == "torch"]
        a.reset(start_xz=(0.2, -0.1), yaw=0.3)
        b.reset(start_xz=(0.2, -0.1), yaw=0.3)
        blocked = 0
        for action in ACTIONS:
            a.prefetch(action)
            oa, ob = a.step(action), b.step(action)
            assert_same_obs(oa, ob)
            assert a.collided_last == b.collided_last
            blocked += a.collided_last
        assert blocked >= 1                 # a blocked forward among them
        if pkg == "torch":
            assert a.prefetch_hits == len(ACTIONS) and b.prefetch_hits == 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_mismatched_action_renders_anew(pkg):
    a = small_sims()[pkg == "torch"]
    b = small_sims()[pkg == "torch"]
    a.prefetch(1)
    assert_same_obs(a.step(2), b.step(2))
    # the stale frame is gone: the next step renders anew too
    assert_same_obs(a.step(1), b.step(1))
    if pkg == "torch":
        assert a.prefetch_hits == 0


def test_prefetch_is_a_noop_while_the_object_moves():
    obj = dict(start_xz=(-0.8, 0.9), size=(0.4, 1.0, 0.4), seed=2)
    jsim_, tsim_ = small_sims(obj, object_dynamic=True)
    ref = small_sims(obj, object_dynamic=True)[1]
    for env in (jsim_, tsim_):
        env.prefetch(2)
        assert getattr(env, "_prefetched", None) is None
    for _ in range(4):
        for env in (tsim_, ref):
            env.dynamic_object.moving_randomly()
        tsim_.prefetch(2)
        assert_same_obs(tsim_.step(2), ref.step(2))
    assert tsim_.prefetch_hits == 0


def test_moving_forward_and_back_matches_jax():
    jsim_, tsim_ = small_sims(dict(start_xz=(-1.0, 1.2), speed=0.15,
                                   seed=1))
    jo, to = jsim_.dynamic_object, tsim_.dynamic_object
    jo.yaw = to.yaw = 0.7
    flips = 0
    for _ in range(50):
        d = to._dir
        jo.moving_forward_and_back()
        to.moving_forward_and_back()
        flips += to._dir != d
        np.testing.assert_array_equal(to.pos, jo.pos)
        assert to._dir == jo._dir
    assert flips >= 2
