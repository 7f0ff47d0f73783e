"""Graceful preemption of the port's episode (utils/cluster.py and the
poll at the top of ActiveMapper's step), on the CPU at the settings of
tests/test_engine.py (episode_cfg, 48x48, FakeSim seed 3, mapper seed 0).

A SIGUSR1 sent to the process at the end of step SIG_T - 1 makes the
loop checkpoint step SIG_T - 1 with resume_t = SIG_T at the top of step
SIG_T and requeue; the tests' manager raises from `requeue` instead of
exiting.  A fresh mapper resumes that checkpoint and must take the
uninterrupted run's actions, with ground-truth poses and with optimized
tracking.  The tracked poses after the resume equal the uninterrupted
run's to the bit up to the first mapping event after the resume
(poses_w2c is saved, so forward_prop has its two poses); from that event
on they agree to 1e-5, since the checkpoint holds the keyframes in
float16 (the JAX package's format) and the event's window maps from
them.  The handlers are armed only while test_navigation runs: every
test checks that the process's handlers are the ones it started with.

In a process group the ranks agree the exit flag at every step (one
all-reduce MAX).  Two gloo ranks, spawned once for the module (the
`ranks` fixture: a 300 s wall limit and a 60 s collective timeout, so
that ranks that part fail rather than hang), run the episode at
mesh_axes.data = 2: uninterrupted; with a SIGUSR1 sent to rank 1 only;
resumed from that checkpoint; and with a time budget that runs out on
rank 1 only.  scontrol is a stub on PATH that records who called it.
This module imports no JAX at its top: the spawned ranks import it.
"""
import os
import shutil
import signal
import stat

import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene, FakeSim
from fisher_nerf_customized_tpu_torch.ops.camera import Camera
from fisher_nerf_customized_tpu_torch.utils.cluster import (
    SIGNALS, ClusterStateManager, get_cluster_manager)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def handlers_untouched():
    """Each test leaves the process's SIGTERM and SIGUSR1 handlers as it
    found them."""
    before = {sig: signal.getsignal(sig) for sig in SIGNALS}
    yield
    assert {sig: signal.getsignal(sig) for sig in SIGNALS} == before


class Requeued(Exception):
    pass


class RaisingManager(ClusterStateManager):
    """requeue raises instead of exiting the test process."""

    def requeue(self, exit_code: int = 0):
        raise Requeued()


def test_cluster_manager_signal_flag():
    cm = ClusterStateManager()
    with cm.armed():
        assert signal.getsignal(signal.SIGUSR1) == cm._handler
        assert not cm.should_exit()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert cm.should_exit()
    assert cm.should_exit()                 # the flag outlives the block
    cm = ClusterStateManager()
    with cm.armed():
        os.kill(os.getpid(), signal.SIGTERM)
        assert cm.should_exit()


def test_cluster_manager_time_budget():
    assert ClusterStateManager(time_to_run=-1.0).should_exit()
    assert not ClusterStateManager(time_to_run=3600.0).should_exit()
    assert not ClusterStateManager().should_exit()
    assert get_cluster_manager() is get_cluster_manager()


def test_requeue_exits(monkeypatch):
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    with pytest.raises(SystemExit) as exc:
        ClusterStateManager().requeue(3)
    assert exc.value.code == 3


def make(workdir, steps, tracked, manager=None, eval_dir=None):
    """(mapper, scene, actions list) of a port episode."""
    from test_engine import episode_cfg
    cfg_dict = episode_cfg(workdir, steps=steps).to_dict()
    if tracked:
        cfg_dict["tracking"].update(use_gt_poses=False, num_iters=4)
    return make_from(cfg_dict, manager, eval_dir)


def make_from(cfg_dict, manager=None, eval_dir=None):
    """make() from the config as a dict (a spawned rank imports no JAX)."""
    cfg = tcfg()
    cfg.merge_from_other(cfg_dict)
    img = int(cfg.SLAM.Dataset.Calibration.width)
    cam = Camera(fx=float(img), fy=float(img), cx=img / 2, cy=img / 2,
                 width=img, height=img)
    scene = BoxScene(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                     obstacles=[((1.0, 0.0, 1.0), (1.8, 1.8, 1.8))])
    sim = FakeSim(scene, cam, forward_step=0.15, turn_angle=30.0, seed=3,
                  device="cpu")
    actions = []
    sim_step = sim.step

    def step(a):
        actions.append(int(a))
        return sim_step(a)

    sim.step = step
    mapper = tdriver.ActiveMapper(
        cfg, sim, scene=scene, seed=0, eval_dir=eval_dir, device="cpu",
        cluster_manager=manager or ClusterStateManager())
    return mapper, scene, actions


def test_time_budget_checkpoints_step_0(tmp_path):
    mapper, _scene, actions = make(tmp_path, 8, tracked=False,
                                   manager=RaisingManager(time_to_run=-1.0))
    with pytest.raises(Requeued):
        mapper.test_navigation(n_eval_poses=0)
    assert actions == []
    with np.load(os.path.join(mapper.eval_dir, "episode_state.npz")) as ep:
        assert int(ep["t"]) == 0 and int(ep["resume_t"]) == 0
        assert ep["queue"].tolist() == [2, 2, 2]       # the init scan


@pytest.mark.parametrize("tracked,steps,sig_t", [(False, 20, 12),
                                                 (True, 14, 8)])
def test_signalled_episode_resumes_the_same(tmp_path, tracked, steps, sig_t):
    full, _scene, act_full = make(tmp_path / "full", steps, tracked)
    tracked_frames = []
    track_pose = full.slam._track_pose
    full.slam._track_pose = lambda c, d: (tracked_frames.append(1),
                                          track_pose(c, d))[1]
    res_full = full.test_navigation(n_eval_poses=0)
    assert len(act_full) == steps and res_full["planning_events"] >= 2
    assert len(tracked_frames) == (steps if tracked else 0)

    cut, _scene, act_cut = make(tmp_path / "cut", steps, tracked,
                                manager=RaisingManager())

    def on_step(t, _obs):
        if t == sig_t - 1:
            os.kill(os.getpid(), signal.SIGUSR1)

    with pytest.raises(Requeued):
        cut.test_navigation(n_eval_poses=0, on_step=on_step)
    assert act_cut == act_full[:sig_t]
    ck = sig_t - 1
    with np.load(os.path.join(cut.eval_dir, "episode_state.npz")) as ep:
        assert int(ep["t"]) == ck and int(ep["resume_t"]) == sig_t
        np.testing.assert_array_equal(ep["sim_c2w"][0], cut.sim.c2w)
    assert os.path.exists(os.path.join(cut.eval_dir, f"params{ck}.npz"))

    eval_dir = str(tmp_path / "resumed" / "ep")
    shutil.copytree(cut.eval_dir, eval_dir)
    res, _scene, act_res = make(tmp_path / "resumed", steps, tracked,
                                eval_dir=eval_dir)
    res.resume(os.path.join(eval_dir, f"params{ck}.npz"))
    result = res.test_navigation(n_eval_poses=0)
    assert act_res == act_full[sig_t:]
    assert result["steps"] == res_full["steps"] == steps
    assert result["coverage_2d_pct"] == res_full["coverage_2d_pct"]
    assert res.slam.n_active == full.slam.n_active
    assert res.slam.keyframe_time_indices == full.slam.keyframe_time_indices
    got, ref = np.stack(res.slam.poses_w2c), np.stack(full.slam.poses_w2c)
    assert got.shape == ref.shape
    # step t is the SLAM's frame t + 1, and maps when (t + 2) % map_every
    # is 0; poses_w2c[t + 1] is its pose, tracked before its event
    map_every = int(full.cfg.map_every)
    t_map = next(t for t in range(sig_t, steps) if (t + 2) % map_every == 0)
    np.testing.assert_array_equal(got[:t_map + 2], ref[:t_map + 2])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_requeue_without_scontrol(monkeypatch, tmp_path):
    """A rank other than 0 exits without calling scontrol."""
    log = _scontrol_stub(tmp_path, monkeypatch)
    monkeypatch.setenv("SLURM_JOB_ID", "4242")
    monkeypatch.setenv("TEST_RANK", "0")
    with pytest.raises(SystemExit) as exc:
        ClusterStateManager().requeue(5, call_scontrol=False)
    assert exc.value.code == 5 and not log.exists()
    with pytest.raises(SystemExit):
        ClusterStateManager().requeue(5)
    assert log.read_text().split() == ["0", "requeue", "4242"]


def test_single_process_poll_makes_no_collective(tmp_path, monkeypatch):
    """Without a process group the poll is the manager's flag alone."""
    import torch.distributed as dist

    def refuse(*_a, **_kw):
        raise AssertionError("a collective in one process")

    monkeypatch.setattr(dist, "all_reduce", refuse)
    monkeypatch.setattr(dist, "barrier", refuse)
    mapper, _scene, _actions = make(tmp_path, 8, tracked=False,
                                    manager=RaisingManager(time_to_run=-1.0))
    with pytest.raises(Requeued):
        mapper.test_navigation(n_eval_poses=0)
    assert "exit_poll" not in mapper.timer.totals


# ---- two ranks (fault w) -----------------------------------------------------

WORLD = 2
STEPS2 = 14
SIG_T2 = 10


def _scontrol_stub(tmp_path, monkeypatch=None):
    """An `scontrol` on PATH that appends "$TEST_RANK $@" to a log; the
    log's path."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    log = tmp_path / "scontrol.log"
    stub = bin_dir / "scontrol"
    stub.write_text(f'#!/bin/sh\necho "$TEST_RANK $@" >> "{log}"\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    if monkeypatch is not None:
        monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}"
                           f"{os.environ['PATH']}")
    return log


def _rank_episodes(rank, world, _port, cfgs, bin_dir):
    """One rank: the uninterrupted episode, the episode with a SIGUSR1 to
    rank 1 at the end of step SIG_T2 - 1, its resume, and the episode
    whose time budget runs out on rank 1 only.  Returns numpy-free
    results."""
    import torch.distributed as dist
    os.environ.update(SLURM_JOB_ID="4242", TEST_RANK=str(rank),
                      PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    out = {}
    full, _scene, act = make_from(cfgs["full"])
    res = full.test_navigation(n_eval_poses=0)
    out["full"] = dict(actions=act, steps=res["steps"],
                       polls=res["timing"]["exit_poll"]["count"])

    def on_step(t, _obs):
        if rank == 1 and t == SIG_T2 - 1:
            os.kill(os.getpid(), signal.SIGUSR1)

    for name, cm, kw in (
            ("cut", ClusterStateManager(), dict(on_step=on_step)),
            ("budget", ClusterStateManager(
                time_to_run=-1.0 if rank == 1 else None), {})):
        mapper, _scene, act = make_from(cfgs[name], manager=cm)
        try:
            mapper.test_navigation(n_eval_poses=0, **kw)
            code = None
        except SystemExit as exc:
            code = exc.code
        out[name] = dict(actions=act, exit_code=code,
                         polls=mapper.timer.counts["exit_poll"])
    dist.barrier()
    res_m, _scene, act = make_from(cfgs["cut"])
    res_m.resume(os.path.join(res_m.eval_dir, f"params{SIG_T2 - 1}.npz"))
    dist.barrier()              # every rank has read the checkpoint
    res = res_m.test_navigation(n_eval_poses=0)
    out["resumed"] = dict(actions=act, steps=res["steps"],
                          n_active=res_m.slam.n_active)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_engine import episode_cfg
    from fisher_nerf_customized_tpu_torch.parallel.launch import run_ranks
    tmp = tmp_path_factory.mktemp("preempt2")
    cfgs = {}
    for name in ("full", "cut", "budget"):
        cfg = episode_cfg(tmp / name, steps=STEPS2)
        cfg.tpu.mesh_axes.data = WORLD
        cfgs[name] = cfg.to_dict()
    log = _scontrol_stub(tmp)
    out = run_ranks(_rank_episodes, WORLD, args=(cfgs, str(tmp / "bin")),
                    timeout_s=300, collective_timeout_s=60, threads=1)
    return out, tmp, log.read_text().splitlines() if log.exists() else []


def test_ranks_stop_together_on_one_ranks_signal(ranks):
    out, tmp, scontrol = ranks
    for r in out:
        assert r["full"]["steps"] == STEPS2
        assert r["full"]["polls"] == STEPS2      # one agreed poll a step
        assert r["cut"]["exit_code"] == 0
        assert r["cut"]["actions"] == r["full"]["actions"][:SIG_T2]
        assert r["cut"]["polls"] == SIG_T2 + 1
    assert out[0]["full"]["actions"] == out[1]["full"]["actions"]
    ck = SIG_T2 - 1
    eval_dir = tmp / "cut" / "ep"
    with np.load(eval_dir / "episode_state.npz") as ep:
        assert int(ep["t"]) == ck and int(ep["resume_t"]) == SIG_T2
    assert (eval_dir / f"params{ck}.npz").exists()
    # scontrol ran once for the signal and once for the budget, by rank 0
    assert scontrol == ["0 requeue 4242", "0 requeue 4242"]


def test_time_budget_of_one_rank_stops_both(ranks):
    out, tmp, _scontrol = ranks
    for r in out:
        assert r["budget"]["exit_code"] == 0
        assert r["budget"]["actions"] == [] and r["budget"]["polls"] == 1
    with np.load(tmp / "budget" / "ep" / "episode_state.npz") as ep:
        assert int(ep["t"]) == 0 and int(ep["resume_t"]) == 0


def test_two_rank_resume_takes_the_uninterrupted_actions(ranks):
    out, _tmp, _scontrol = ranks
    for r in out:
        assert r["resumed"]["steps"] == STEPS2
        assert (r["cut"]["actions"] + r["resumed"]["actions"]
                == r["full"]["actions"])
    assert out[0]["resumed"]["n_active"] == out[1]["resumed"]["n_active"]
