"""The habitat adapter, JAX package against the PyTorch port on the CPU,
without habitat: both packages' HabitatSim on the JAX package's mock
habitat.Env (tests/test_habitat_adapter.py).

Tolerances: none.  The helpers are the same numpy arithmetic and are
held equal to the bit; the port's observations, moved back with .cpu(),
equal the JAX package's arrays to the bit; the two mock-env object
episodes (the JAX test's 14-step config, the port's object SLAM fed the
JAX package's Hutchinson draws) take the same actions, and the port's
resume teleports the mock agent to the checkpointed pose to the bit.
"""
import copy
import gzip
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.engine import driver as jdriver
from fisher_nerf_customized_tpu.envs import habitat_adapter as jha
from fisher_nerf_customized_tpu_torch import cli
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.envs import habitat_adapter as tha
from fisher_nerf_customized_tpu_torch.models import object_slam as tos

import test_habitat_adapter as jt
from test_torch_episode import port_cfg
from test_torch_object_episode import jax_probe_draw

STEPS = 14


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the helpers ---------------------------------------------------------------

@pytest.mark.parametrize("ds", ["MP3D", "gibson", "replica", "hm3d",
                                "habitat_test_scenes"])
def test_paths_equal(ds):
    for scene in ("SceneA", "00800-TEEsavR23oF"):
        assert (tha.scene_asset_path(ds, "/d", scene, "val", "sd")
                == jha.scene_asset_path(ds, "/d", scene, "val", "sd"))
        assert (tha.episode_file_path(ds, "/d", "val", scene)
                == jha.episode_file_path(ds, "/d", "val", scene))
    for fn in (tha.scene_asset_path, jha.scene_asset_path):
        with pytest.raises(ValueError):
            fn("nope", "/d", "x")


def test_episodes_and_difficulty_equal(tmp_path):
    path = str(tmp_path / "SceneA.json.gz")
    jt._write_episode_gz(path)
    got = tha.load_pointnav_episodes(path, "SceneA")
    assert got == jha.load_pointnav_episodes(path, "SceneA")
    assert len(got["episodes"]) == 1
    assert tha.load_pointnav_episodes(str(tmp_path / "no.json.gz"),
                                      "X") == {"episodes": []}
    plain = str(tmp_path / "eps.json")
    with gzip.open(path, "rt") as f, open(plain, "w") as g:
        g.write(f.read())
    assert tha.load_pointnav_episodes(plain, "Other") == \
        jha.load_pointnav_episodes(plain, "Other")
    a = [{"info": {"geodesic_distance": d}} for d in (2.0, 7.0, 8.0, 13.5)]
    b = json.loads(json.dumps(a))
    tha.add_difficulty(a)
    jha.add_difficulty(b)
    assert a == b


def test_intrinsics_depth_and_overrides_equal():
    for w, h, fov in ((256, 256, 90.0), (640, 480, 79.0)):
        np.testing.assert_array_equal(tha.intrinsics_from_hfov(w, h, fov),
                                      jha.intrinsics_from_hfov(w, h, fov))
    d = np.random.default_rng(0).uniform(0, 1, (8, 8)).astype(np.float32)
    np.testing.assert_array_equal(tha.unnormalize_depth(d, 0.5, 10.0),
                                  jha.unnormalize_depth(d, 0.5, 10.0))
    a, b = jt._mock_config(), jt._mock_config()
    kw = dict(turn_angle=10, forward_step=0.065, max_steps=1000,
              img_width=256, img_height=192, scene="/x/S.glb",
              scene_dataset="/x/ds.json", split="val")
    tha.apply_sensor_overrides(a, **kw)
    jha.apply_sensor_overrides(b, **kw)
    assert repr(a) == repr(b)


def test_pose_noise_equal():
    for seed in (0, 3):
        ta = tha.PoseNoiseModel(noise_dir="/nonexistent", noise_level=0.7,
                                seed=seed)
        ja = jha.PoseNoiseModel(noise_dir="/nonexistent", noise_level=0.7,
                                seed=seed)
        for aid in (1, 2, 3, 0, 1):
            np.testing.assert_array_equal(ta.add_pose_noise(np.ones(3), aid),
                                          ja.add_pose_noise(np.ones(3), aid))


def test_rotation_maths_equal():
    rng = np.random.default_rng(1)
    for _ in range(50):
        q = rng.normal(size=4)
        pos = rng.normal(size=3)
        np.testing.assert_array_equal(tha.quat_wxyz_to_rotmat(*q),
                                      jha.quat_wxyz_to_rotmat(*q))
        np.testing.assert_array_equal(tha.sensor_c2w(pos, q),
                                      jha.sensor_c2w(pos, q))
        R = jha.quat_wxyz_to_rotmat(*q)
        np.testing.assert_array_equal(tha.rotmat_to_quat_wxyz(R),
                                      jha.rotmat_to_quat_wxyz(R))
    # the trace <= 0 branch
    R = np.diag([1.0, -1.0, -1.0])
    np.testing.assert_array_equal(tha.rotmat_to_quat_wxyz(R),
                                  jha.rotmat_to_quat_wxyz(R))


@pytest.mark.parametrize("form", [16, 7])
def test_set_agent_state_equal(form):
    yaw = 0.9
    if form == 16:
        pose = jha.sensor_c2w([0.7, 9.9, -1.2],
                              (np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0))
    else:
        pose = np.array([1.5, 0.0, 2.5, np.cos(0.2), 0, np.sin(0.2), 0])
    a, b = jt._MockSim(), jt._MockSim()
    tha.set_agent_state(a, pose)
    jha.set_agent_state(b, pose)
    for sa, sb in ((a._state, b._state),
                   *zip(a._state.sensor_states.values(),
                        b._state.sensor_states.values())):
        np.testing.assert_array_equal(sa.position, sb.position)
        assert vars(sa.rotation) == vars(sb.rotation)
    with pytest.raises(ValueError):
        tha.set_agent_state(a, np.zeros(5))


# -- HabitatSim on the mock env --------------------------------------------------

def make_pair(tmp_path, seed=5):
    """Both packages' HabitatSim, each on its own mock env."""
    j_sim, j_env = jt._make_hsim(tmp_path, seed=seed)
    made = {}

    def factory(config):
        made["env"] = jt._MockEnv(config)
        return made["env"]

    t_sim = tha.HabitatSim(jt._args(tmp_path), port_cfg(jt._slam_cfg()),
                           "SceneA", env_factory=factory,
                           config=jt._mock_config(), seed=seed, device="cpu")
    return j_sim, j_env, t_sim, made["env"]


def assert_obs_equal(got, ref):
    assert set(got) == set(ref)
    assert isinstance(got["rgb"], torch.Tensor)
    assert isinstance(got["depth"], torch.Tensor)
    np.testing.assert_array_equal(got["rgb"].cpu().numpy(), ref["rgb"])
    np.testing.assert_array_equal(got["depth"].cpu().numpy(), ref["depth"])
    np.testing.assert_array_equal(got["c2w"], ref["c2w"])
    np.testing.assert_array_equal(got["semantic"], ref["semantic"])


def test_habitat_sim_observations_equal(tmp_path):
    j_sim, j_env, t_sim, t_env = make_pair(tmp_path)
    assert t_env.config.habitat.simulator.turn_angle == 10
    assert t_env.config.habitat.environment.max_episode_steps == 77
    assert t_env.seeded == j_env.seeded == 5
    assert t_env.reset_count == 1
    assert len(t_sim) == len(j_sim) == 1
    assert t_sim.get_episode_info(0) == j_sim.get_episode_info(0)
    np.testing.assert_array_equal(t_sim.intrinsics, j_sim.intrinsics)
    assert t_sim.device == torch.device("cpu")
    assert_obs_equal(t_sim.get_observations(), j_sim.get_observations())
    assert_obs_equal(t_sim.reset(), j_sim.reset())
    for a in (1, 2, 1, 3, 3, 1, 0):
        assert_obs_equal(t_sim.step(a), j_sim.step(a))
    assert t_env.steps == j_env.steps
    np.testing.assert_array_equal(t_sim.c2w, j_sim.c2w)
    for p in ((0.0, 0.0), (9.0, 0.0), (1.5, 0.0, 1.5), (0.5, 1.0, -2.0)):
        assert t_sim.is_navigable(p) == j_sim.is_navigable(p)


def test_normalized_depth_equal(tmp_path):
    j_sim, _j, t_sim, _t = make_pair(tmp_path)
    for s in (j_sim, t_sim):
        s.normalized_depth, s.min_depth, s.max_depth = True, 0.5, 5.0
    assert_obs_equal(t_sim.get_observations(), j_sim.get_observations())


def test_render_at_equal_and_restores_state(tmp_path):
    j_sim, _j, t_sim, t_env = make_pair(tmp_path)
    t_sim.step(1)
    j_sim.step(1)
    before = t_sim.c2w.copy()
    state = copy.deepcopy(t_env.sim.get_agent_state())
    q = (np.cos(0.6), 0.0, np.sin(0.6), 0.0)
    for pose in (jha.sensor_c2w([2.0, 1.25, 0.5], q),
                 jha.sensor_c2w([-2.0, 1.25, -0.5], (1.0, 0.0, 0.0, 0.0))):
        rgb, depth = t_sim.render_at(pose)
        ref_rgb, ref_depth = j_sim.render_at(pose)
        np.testing.assert_array_equal(rgb.cpu().numpy(), ref_rgb)
        np.testing.assert_array_equal(depth.cpu().numpy(), ref_depth)
    np.testing.assert_array_equal(t_sim.c2w, before)
    # the whole state comes back (a copy, the same values)
    after = t_env.sim.get_agent_state()
    np.testing.assert_array_equal(after.position, state.position)
    for k, s in state.sensor_states.items():
        np.testing.assert_array_equal(after.sensor_states[k].position,
                                      s.position)
        assert vars(after.sensor_states[k].rotation) == vars(s.rotation)
    # set_pose teleports as the JAX package's does
    pose = jha.sensor_c2w([0.7, 9.9, -1.2], q)
    t_sim.set_pose(pose)
    j_sim.set_pose(pose)
    np.testing.assert_array_equal(t_sim.c2w, j_sim.c2w)


def test_scene_surface_equal(tmp_path):
    j_sim, _j, t_sim, _t = make_pair(tmp_path)
    t_scene, j_scene = tha.HabitatScene(t_sim), jha.HabitatScene(j_sim)
    np.testing.assert_array_equal(
        t_scene.sample_navigable(np.random.default_rng(0), 64),
        j_scene.sample_navigable(np.random.default_rng(0), 64))
    np.testing.assert_array_equal(t_scene.gt_free_map(0.5, (16, 12),
                                                      (0.25, -0.5)),
                                  j_scene.gt_free_map(0.5, (16, 12),
                                                      (0.25, -0.5)))
    assert t_scene.is_navigable((0.0, 0.0, 0.0))
    assert not t_scene.is_navigable((9.0, 0.0, 0.0))
    assert t_scene.sample_surface_points(100) is None


def test_spawned_object_walks_as_in_jax(tmp_path):
    j_sim, j_env, t_sim, t_env = make_pair(tmp_path)
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    objs = [s.spawn_object("objs/wheeled_robot", scale=0.3, semantic_id=42,
                           gt_points=pts) for s in (t_sim, j_sim)]
    assert t_env.sim._tmpl_mgr.template.scale == [0.3, 0.3, 0.3]
    assert t_env.sim._rigid_mgr.objects[0].semantic_id == 42
    assert t_sim.dynamic_object is objs[0]
    for _ in range(40):
        for o in objs:
            o.moving_randomly()
        np.testing.assert_array_equal(objs[0].translation,
                                      objs[1].translation)
    for _ in range(10):
        for o in objs:
            o.moving_forward_and_back()
    np.testing.assert_array_equal(objs[0].object_pose(),
                                  objs[1].object_pose())
    for frame in ("world", "object"):
        np.testing.assert_array_equal(
            objs[0].sample_surface_points(8, np.random.default_rng(0), frame),
            objs[1].sample_surface_points(8, np.random.default_rng(0), frame))
    bare = tha.HabitatSimObject(t_env.sim._rigid_mgr.objects[0],
                                t_sim.is_navigable)
    assert bare.sample_surface_points(10) is None


# -- the mock-env object episode in both packages ------------------------------

def episode_cfg(workdir, steps):
    """tests/test_habitat_adapter.py's episode config (JAX)."""
    cfg = jt._slam_cfg()
    cfg.workdir = str(workdir)
    cfg.run_name = "hab_ep"
    cfg.policy.name = "gaussians_based"
    cfg.policy.planning_queue_size = 6
    cfg.num_frames = steps
    cfg.map_every = 5
    cfg.keyframe_every = 4
    cfg.downsample_pcd = 2
    cfg.mapping.num_iters = 6
    cfg.turn_angle = 30.0
    cfg.forward_step_size = 0.15
    cfg.explore.cell_size = 0.1
    cfg.explore.sample_view_num = 8
    cfg.tpu.capacity = 8192
    cfg.tpu.tile_size = 8
    cfg.tpu.max_per_tile = 256
    cfg.tpu.pose_chunk = 4
    return cfg


def run_episode(pkg, tmp_path, mp):
    cfg = episode_cfg(tmp_path / pkg, STEPS)
    made = {}

    def factory(config):
        made["env"] = jt._MockEnv(config)
        return made["env"]

    if pkg == "jax":
        mod, drv, kw = jha, jdriver, {}
    else:
        cfg = port_cfg(cfg)
        mod, drv, kw = tha, tdriver, dict(device="cpu")
        mp.setattr(tos.GaussianObjectSLAM, "probe_draw", jax_probe_draw)
    sim = mod.HabitatSim(jt._args(tmp_path), cfg, "SceneA",
                         env_factory=factory, config=jt._mock_config(),
                         seed=3, **kw)
    gt_pts = np.random.default_rng(1).uniform(
        -0.3, 0.3, (200, 3)).astype(np.float32)
    sim.spawn_object("objs/wheeled_robot", scale=0.3, semantic_id=42,
                     gt_points=gt_pts)
    mapper = drv.ActiveMapper(cfg, sim, scene=mod.HabitatScene(sim), seed=0,
                              object_scene=True, dynamic_scene=True, **kw)
    result = mapper.test_navigation(n_eval_poses=6)
    return dict(mapper=mapper, sim=sim, env=made["env"], result=result,
                cfg=cfg, factory=factory, mod=mod, drv=drv, kw=kw)


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hab_ep")
    with pytest.MonkeyPatch.context() as mp:
        ref = run_episode("jax", tmp, mp)
    with pytest.MonkeyPatch.context() as mp:
        got = run_episode("torch", tmp, mp)
    return tmp, ref, got


def test_mock_env_episodes_take_the_same_actions(episodes):
    _tmp, ref, got = episodes
    assert got["result"]["steps"] == ref["result"]["steps"] >= 8
    assert len(got["env"].steps) >= 8
    assert got["env"].steps == ref["env"].steps
    assert got["mapper"].obj_slam is not None
    np.testing.assert_array_equal(got["sim"].dynamic_object.translation,
                                  ref["sim"].dynamic_object.translation)
    assert got["result"]["eval"]["n_poses"] == 6
    for k in ("psnr", "ssim", "depth_mae"):
        assert np.isfinite(got["result"]["eval"][k])
    np.testing.assert_allclose(got["result"]["coverage_2d_pct"],
                               ref["result"]["coverage_2d_pct"], rtol=0)


def test_mock_env_resume_replays_the_pose(episodes):
    tmp, _ref, got = episodes
    mapper, sim = got["mapper"], got["sim"]
    t = mapper.slam.frame_idx
    mapper.save_checkpoint(t, sim_c2w=sim.c2w)
    expect = sim.c2w.copy()
    sim2 = tha.HabitatSim(jt._args(tmp), got["cfg"], "SceneA",
                          env_factory=got["factory"],
                          config=jt._mock_config(), seed=3, device="cpu")
    m2 = tdriver.ActiveMapper(got["cfg"], sim2, scene=tha.HabitatScene(sim2),
                              seed=0, device="cpu")
    m2.resume(os.path.join(mapper.eval_dir, f"params{t}.npz"))
    np.testing.assert_array_equal(sim2.c2w, expect)
    assert m2.slam.n_active == mapper.slam.n_active


# -- the entry point with --sim habitat ------------------------------------------

def test_entry_point_needs_habitat(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "habitat", None)
    with pytest.raises(ImportError, match="habitat-sim is not installed"):
        cli.main(["--device", "cpu", "--sim", "habitat", "--dataset", "MP3D",
                  "--log_dir", str(tmp_path)])


def test_entry_point_runs_on_a_mock_habitat(tmp_path, monkeypatch):
    """`--sim habitat --object_scene` through cli.main with a mock habitat
    module: the episode runs, evaluates and spawns the wheeled robot;
    the scene has no cloud, so no recon."""
    envs = []

    def env(config):
        envs.append(jt._MockEnv(config))
        return envs[-1]

    mock = types.SimpleNamespace(Env=env,
                                 get_config=lambda path: jt._mock_config())
    monkeypatch.setitem(sys.modules, "habitat", mock)
    out = cli.main(["--device", "cpu", "--sim", "habitat", "--dataset",
                    "MP3D", "--scenes_list", "SceneA", "--img_size",
                    str(jt.IMG), "--max_steps", "6", "--eval_poses", "4",
                    "--object_scene", "--log_dir", str(tmp_path), "--set",
                    "tpu.capacity", "8192", "mapping.num_iters", "2",
                    "tpu.tile_size", "8", "explore.sample_view_num", "8"])
    res = out["SceneA"]
    assert res["steps"] == 6 and res["eval"]["n_poses"] == 4
    assert "recon" not in res
    assert envs[0].config.habitat.simulator.scene.endswith("SceneA.glb")
    assert envs[0].sim._tmpl_mgr.path.endswith(
        "habitat_example_objects_0.2/wheeled_robot")
    assert len(envs[0].steps) == 6
