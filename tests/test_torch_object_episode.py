"""The object branch's episode, JAX package against the PyTorch port on
the CPU: both ActiveMappers on the settings of the JAX package's
tests/test_object_episode.py (48x48 frames, a 6 m room with a 0.5 x 1.2
x 0.5 m SimObject at (0, 1.8), episode_cfg for 16 steps, an object
mapping event every 2 steps), static under `fisher` and random-walking
under `topt` with 2 probes.  The JAX sim hands out host frames
(device_obs=False), as in tests/test_torch_episode.py; the port's object
SLAM is fed the JAX package's Hutchinson draws (`JaxDraws`).

The two runs must take the same actions, hold the same object cloud
(global_obj_pcl, equal) and record the same object reconstruction at the
end (rtol 1e-6: the same cloud against the same ground truth).  Should
the actions part (the maps differ in the last bits, ROADMAP.md queue 3 g,
and an object planning event can then rank two paths apart), the test
asserts the equal prefix up to the first object planning event, the
cloud up to it, and prints the step where they part.

The JAX run's in-loop checkpoint at step 12 (checkpoint_interval 9) is
copied aside, and the port resumes it: the object cloud and the object
curve come back, and the episode runs on to step 16.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.engine import driver as jdriver
from fisher_nerf_customized_tpu.engine import object_planning as jop
from fisher_nerf_customized_tpu.envs import fake_sim as jsim
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.engine import object_planning as top
from fisher_nerf_customized_tpu_torch.envs import fake_sim as tsim
from fisher_nerf_customized_tpu_torch.models import object_slam as tos
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

from test_engine import IMG, episode_cfg
from test_torch_episode import port_cfg
from test_torch_object_slam import JaxDraws

STEPS = 16
CK_T = 12                  # the in-loop checkpoint copied aside


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_probe_draw(self, seed, n_probes):
    draws = self.__dict__.setdefault(
        "_jax_draws", JaxDraws(self.start_frame_idx, self.camera.height,
                               self.camera.width))
    return draws(seed, n_probes)


def run(pkg, tmp_path, mp, criterion, dynamic, seed, resume_from=None):
    cfg = episode_cfg(tmp_path / pkg, steps=STEPS)
    cfg.checkpoint_interval = 9
    cfg.map_obj_every = 2
    cfg.keyframe_obj_every = 2
    cfg.criterion = criterion
    cfg.explore_object.sample_view_num = 8 if criterion == "fisher" else 6
    if criterion != "fisher":
        cfg.tpu.hutchinson_probes = 2
    if pkg == "jax":
        mod, cam_t, drv, op, kw = jsim, JCamera, jdriver, jop, {}
        sim_kw = dict(device_obs=False)
    else:
        cfg = port_cfg(cfg)
        mod, cam_t, drv, op = tsim, TCamera, tdriver, top
        kw = sim_kw = dict(device="cpu")
        mp.setattr(tos.GaussianObjectSLAM, "probe_draw", jax_probe_draw)
    cam = cam_t(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                width=IMG, height=IMG)
    scene = mod.BoxScene(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                         obstacles=[])
    obj = mod.SimObject(scene, semantic_id=100, size=(0.5, 1.2, 0.5),
                        start_xz=(0.0, 1.8), speed=0.03, seed=seed)
    sim = mod.FakeSim(scene, cam, forward_step=0.15, turn_angle=30.0,
                      dynamic_object=obj, seed=seed, **sim_kw)
    actions, events, clouds = [], [], []
    sim_step = sim.step

    def step(a):
        actions.append(int(a))
        return sim_step(a)

    sim.step = step
    plan = op.plan_best_object_path

    def recording(*args, **kwargs):
        events.append(len(actions))
        return plan(*args, **kwargs)

    mp.setattr(op, "plan_best_object_path", recording)
    eval_dir = os.path.join(cfg.workdir, cfg.run_name)
    if resume_from is not None:
        shutil.copytree(resume_from, eval_dir)
    mapper = drv.ActiveMapper(cfg, sim, scene=scene, seed=0,
                              eval_dir=eval_dir, object_scene=True,
                              dynamic_scene=dynamic, **kw)
    snap = str(tmp_path / f"{pkg}_ck")
    resumed = None
    if resume_from is not None:
        mapper.resume(os.path.join(eval_dir, f"params{CK_T}.npz"))
        resumed = dict(cloud=mapper.global_obj_pcl.copy(),
                       curve=list(mapper.object_metrics.steps))

    def on_step(t, _obs):
        clouds.append(len(mapper.global_obj_pcl))
        if t == CK_T and resume_from is None:
            shutil.copytree(eval_dir, snap)

    result = mapper.test_navigation(n_eval_poses=0, on_step=on_step)
    gt = obj.sample_surface_points(2000, frame="object")
    m = mapper.record_object_metrics(result["steps"], gt)
    return dict(actions=actions, events=events, clouds=clouds, m=m,
                mapper=mapper, result=result, obj=obj, snap=snap,
                resumed=resumed)


_RUNS = {}


def episodes(criterion, dynamic, seed, tmp_path_factory):
    """Both packages' runs of one setting, once per module."""
    if criterion not in _RUNS:
        tmp = tmp_path_factory.mktemp(f"obj_{criterion}")
        with pytest.MonkeyPatch.context() as mp:
            ref = run("jax", tmp, mp, criterion, dynamic, seed)
        with pytest.MonkeyPatch.context() as mp:
            got = run("torch", tmp, mp, criterion, dynamic, seed)
        _RUNS[criterion] = (tmp, ref, got)
    return _RUNS[criterion]


@pytest.mark.parametrize("criterion,dynamic,seed",
                         [("fisher", False, 0), ("topt", True, 1)])
def test_object_episode_matches_jax(criterion, dynamic, seed,
                                    tmp_path_factory):
    _tmp, ref, got = episodes(criterion, dynamic, seed, tmp_path_factory)
    jm, tm = ref["mapper"], got["mapper"]
    assert tm.obj_slam is not None and jm.obj_slam is not None
    assert tm.obj_slam.n_active > 0
    assert got["result"]["steps"] == ref["result"]["steps"] >= 10
    assert got["events"] and ref["events"], "no object planning event"
    # the object Gaussians lie near the object (the JAX test's check)
    pts = tm.obj_slam.gaussian_points
    d = np.linalg.norm(pts[:, [0, 2]] - got["obj"].translation[[0, 2]], axis=1)
    assert np.median(d) < 1.2
    if got["actions"] != ref["actions"]:
        split = next(i for i, (a, b) in enumerate(
            zip(got["actions"], ref["actions"])) if a != b)
        first = ref["events"][0]
        print(f"{criterion}: the actions part at step {split} (first object "
              f"planning event at step {first})")
        assert split >= first
        assert got["actions"][:first] == ref["actions"][:first]
        assert got["clouds"][:first] == ref["clouds"][:first]
        return
    assert got["events"] == ref["events"]
    np.testing.assert_array_equal(tm.global_obj_pcl, jm.global_obj_pcl)
    assert got["m"] is not None
    for k, v in ref["m"].items():
        np.testing.assert_allclose(got["m"][k], v, rtol=1e-6, err_msg=k)
    assert np.isfinite(got["m"]["completeness_ratio"])


def test_port_resumes_a_jax_object_checkpoint(tmp_path_factory):
    """The JAX run's step-12 group: the port restores its object cloud and
    object curve (the object SLAM is not in a checkpoint and starts anew
    at the next detection, as in the JAX package) and runs on to step 16,
    the cloud only growing."""
    tmp, ref, _got = episodes("fisher", False, 0, tmp_path_factory)
    with np.load(os.path.join(ref["snap"], "episode_state.npz")) as ep:
        saved = np.asarray(ep["obj_pcl"], np.float32)
    assert len(saved) > 0
    with pytest.MonkeyPatch.context() as mp:
        res = run("torch", tmp / "resume", mp, "fisher", False, 0,
                  resume_from=ref["snap"])
    np.testing.assert_array_equal(res["resumed"]["cloud"], saved)
    assert [s["step"] for s in res["resumed"]["curve"]] == [0]
    assert res["resumed"]["curve"] == ref["mapper"].object_metrics.steps[:1]
    assert res["result"]["steps"] == STEPS
    assert len(res["actions"]) == STEPS - CK_T - 1
    np.testing.assert_array_equal(
        res["mapper"].global_obj_pcl[:len(saved)], saved)
