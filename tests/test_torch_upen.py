"""The UPEN baseline, JAX package against the PyTorch port on the CPU:
the occupancy UNet with the JAX package's weights carried across
(params_from_jax; forward atol 1e-5), three Adam steps against optax
(losses rtol 1e-4, parameters atol 1e-5), the ensemble's bootstrap
training, ensembles saved by either package loaded by the other, the ego
grid (to the bit), the geocentric registration over 5 poses (warp atol
1e-6, fused grid atol 1e-5, argmax equal), crop_at (exact),
predict_action in FBE and RRT mode (the same goal from the same
generator state), the offline dataset (1 scene x 8 steps, equal) and the
trainer; then both packages' ActiveMappers on test_engine.py's
episode_cfg under UPEN_fbe and under UPEN_rrt with the JAX ensemble
carried across (the same actions and UPEN goals), and the port's entry
point with --policy UPEN_fbe and --ensemble_dir at 48x48.
"""
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.engine import driver as jdriver
from fisher_nerf_customized_tpu.envs import offline_dataset as jds
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene as JScene
from fisher_nerf_customized_tpu.envs.fake_sim import FakeSim as JSim
from fisher_nerf_customized_tpu.models import predictors as jp
from fisher_nerf_customized_tpu.models import semantic_grid as jsg
from fisher_nerf_customized_tpu.models import upen as jup
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch import cli
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.envs import offline_dataset as tds
from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene as TScene
from fisher_nerf_customized_tpu_torch.envs.fake_sim import FakeSim as TSim
from fisher_nerf_customized_tpu_torch.models import predictors as tp
from fisher_nerf_customized_tpu_torch.models import semantic_grid as tsg
from fisher_nerf_customized_tpu_torch.models import upen as tup
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera
from fisher_nerf_customized_tpu_torch.tools import train_predictors

from test_engine import IMG, episode_cfg
from test_torch_episode import port_cfg

UPEN_STEPS = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carried(jax_pred) -> tp.OccupancyPredictor:
    """A port predictor holding a JAX predictor's weights."""
    got = tp.OccupancyPredictor(tp.member_generator(0, 0), device="cpu")
    got.model.load_state_dict(tp.params_from_jax(jax_pred.params))
    return got


def carry_ensemble(jax_ens, port_ens):
    for j, t in zip(jax_ens.members, port_ens.members):
        t.model.load_state_dict(tp.params_from_jax(j.params))


def seeded_inputs(seed, n=2, size=64):
    """NHWC inputs and (n, size, size) labels of a learnable task: each
    input is its label's one-hot, 0.8 of it, plus 0.2 of uniform noise.
    (With labels drawn apart from the inputs the expected gradient is
    zero: what is left is rounding noise, which Adam's normalization
    scales up to the learning rate, in either package.)"""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, (n, size, size))
    x = np.eye(3, dtype=np.float32)[y] * 0.8 \
        + 0.2 * rng.random((n, size, size, 3)).astype(np.float32)
    return x, y


def depth_frames(n=6, size=64, cam_seed=2):
    """Host depth frames and poses (x, z, yaw) of a FakeSim walk."""
    cam = JCamera(fx=size / 2, fy=size / 2, cx=size / 2, cy=size / 2,
                  width=size, height=size)
    sim = JSim(JScene.default(seed=cam_seed), cam, device_obs=False)
    obs = sim.reset()
    out = []
    for a in [2, 1, 1, 3, 1, 2, 2, 1][:n]:
        obs = sim.step(a)
        c2w = obs["c2w"]
        fwd = c2w[:3, :3] @ np.array([0.0, 0.0, 1.0])
        out.append((np.asarray(obs["depth"]), sim.intrinsics,
                    (float(c2w[0, 3]), float(c2w[2, 3]),
                     float(np.arctan2(fwd[0], fwd[2]))), float(c2w[1, 3])))
    return out


def test_unet_forward_matches_flax():
    ref = jp.OccupancyPredictor(jax.random.PRNGKey(3), base=16)
    x, _y = seeded_inputs(0)
    got = carried(ref).logits(x).detach().numpy()
    want = np.asarray(ref.model.apply(ref.params, x))
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # and back: the state dict as the flax tree
    tree = tp.params_to_jax(carried(ref).model.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree,
                           jax.device_get(ref.params))


def test_init_follows_flax_defaults():
    """Biases zero; each kernel a normal truncated at 2 standard
    deviations with flax lecun_normal's scale (its sample deviation that
    of the JAX package's kernel within 5 % on layers of 4096 weights or
    more), so that an untrained ensemble is drawn as the JAX package's
    is; the members differ, and the same seed gives the same members."""
    got = tp.PredictorEnsemble(n_members=2, seed=0, device="cpu")
    ref = jp.PredictorEnsemble(n_members=2, seed=0)
    for m_t, m_j in zip(got.members, ref.members):
        sd_t = m_t.model.state_dict()
        sd_j = tp.params_from_jax(m_j.params)
        for k, v in sd_t.items():
            if k.endswith("bias"):
                assert not v.any(), k
                continue
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert float(v.abs().max()) <= 2 * std * (1 + 1e-6), k
            if v.numel() >= 4096:
                assert float(v.std()) == pytest.approx(
                    float(sd_j[k].std()), rel=0.05), k
                assert float(v.std()) == pytest.approx(
                    np.sqrt(1.0 / fan_in), rel=0.05), k
    again = tp.PredictorEnsemble(n_members=2, seed=0, device="cpu")
    w = [m.model.head.weight for m in got.members]
    assert not torch.equal(w[0], w[1])
    assert torch.equal(w[0], again.members[0].model.head.weight)


def test_train_steps_match_optax():
    ref = jp.OccupancyPredictor(jax.random.PRNGKey(5), base=16)
    got = carried(ref)
    x, y = seeded_inputs(2)
    for step in range(3):
        lj, lt = ref.train_step(x, y), got.train_step(x, y)
        np.testing.assert_allclose(lt, lj, rtol=1e-4, err_msg=f"step {step}")
    want = tp.params_from_jax(ref.params)
    for k, v in got.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_ensemble_training_matches():
    """The bootstrap subsets, shuffles and batches are the JAX package's
    draws: the same losses and predictions from the same weights."""
    x, y = seeded_inputs(3, n=6, size=32)
    ref = jp.PredictorEnsemble(n_members=2, seed=1)
    got = tp.PredictorEnsemble(n_members=2, seed=1, device="cpu")
    carry_ensemble(ref, got)
    lj = ref.train(x, y, epochs=1, batch_size=4, dataset_percentage=0.8,
                   seed=4)
    lt = got.train(x, y, epochs=1, batch_size=4, dataset_percentage=0.8,
                   seed=4)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    mj, vj, aj = ref.predict(x[:2])
    mt, vt, at = got.predict(x[:2])
    assert at.shape == np.asarray(aj).shape == (2, 2, 32, 32, 3)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5)


def test_ensembles_load_across_packages(tmp_path):
    x, _y = seeded_inputs(4, n=1)
    jax_ens = jp.PredictorEnsemble(n_members=2, seed=7)
    jax_ens.save(str(tmp_path / "jax"))
    port_ens = tp.PredictorEnsemble(n_members=2, seed=3, device="cpu")
    port_ens.load(str(tmp_path / "jax"))
    for a, b in zip(port_ens.predict(x)[:2], jax_ens.predict(x)[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    port_ens.members[0].train_step(x, _y)        # weights of its own
    port_ens.save(str(tmp_path / "port"))
    back = jp.PredictorEnsemble(n_members=2, seed=0)
    back.load(str(tmp_path / "port"))
    for a, b in zip(port_ens.predict(x)[:2], back.predict(x)[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    with open(tmp_path / "port" / "member_0.pkl", "rb") as f:
        tree = pickle.load(f)
    assert type(tree) is dict and type(tree["params"]) is dict
    # a missing ensemble raises as the JAX loader does
    for ens in (tp.PredictorEnsemble(n_members=1, device="cpu"),
                jp.PredictorEnsemble(n_members=1)):
        with pytest.raises(FileNotFoundError):
            ens.load(str(tmp_path / "missing"))


def test_frozen_dict_pickle_is_refused(tmp_path):
    from flax.core import FrozenDict
    ref = jp.OccupancyPredictor(jax.random.PRNGKey(0), base=16)
    path = tmp_path / "member_0.pkl"
    with open(path, "wb") as f:
        pickle.dump(FrozenDict(jax.device_get(ref.params)), f)
    with pytest.raises(TypeError, match="FrozenDict"):
        tp.OccupancyPredictor(tp.member_generator(0, 0),
                              device="cpu").load(str(path))


def test_ego_grid_is_bit_equal():
    for depth, intr, _pose, cam_h in depth_frames(n=6):
        for kw in ({}, dict(cam_height=cam_h, grid_dim=48, cell_size=0.07)):
            want = jup.ego_grid_from_depth(depth, intr, **kw)
            got = tup.ego_grid_from_depth(torch.from_numpy(depth), intr, **kw)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)


def test_register_ego_matches():
    frames = depth_frames(n=5)
    ref = jsg.SemanticGrid(grid_dim=(96, 96), cell_size=0.1)
    got = tsg.SemanticGrid(grid_dim=(96, 96), cell_size=0.1, device="cpu")
    origin = frames[0][2]
    ref.set_origin(origin)
    got.set_origin(origin)
    for depth, intr, pose, cam_h in frames:
        ego = jup.ego_grid_from_depth(depth, intr, grid_dim=32,
                                      cam_height=cam_h)
        rel = np.asarray(pose, np.float64) - ref.origin_pose
        warped = np.asarray(jsg._warp_ego_to_geo(
            jax.numpy.asarray(ego), jax.numpy.asarray(
                [rel[0] / 0.1, rel[1] / 0.1], jax.numpy.float32),
            jax.numpy.asarray(rel[2], jax.numpy.float32),
            jax.numpy.zeros((96, 96))))
        np.testing.assert_allclose(got.warp(ego, pose).numpy(), warped,
                                   atol=1e-6)
        ref.register_ego(ego, pose)
        got.register_ego(torch.from_numpy(ego), pose)
        np.testing.assert_allclose(got.proj_grid.numpy(), ref.proj_grid,
                                   atol=1e-5)
        np.testing.assert_array_equal(got.proj_grid.numpy().argmax(0),
                                      ref.proj_grid.argmax(0))


def test_crop_at_is_exact():
    rng = np.random.default_rng(6)
    ref = jsg.SemanticGrid(grid_dim=(80, 96), cell_size=0.1)
    got = tsg.SemanticGrid(grid_dim=(80, 96), cell_size=0.1, device="cpu")
    ref.set_origin((0.3, -0.2, 0.1))
    got.set_origin((0.3, -0.2, 0.1))
    ref.proj_grid = rng.random((3, 80, 96)).astype(np.float32)
    got.proj_grid = torch.from_numpy(ref.proj_grid.copy())
    for pose in [(0.3, -0.2, 0.0), (2.05, 1.33, 1.0), (-4.5, 3.9, 0.0),
                 (9.0, 9.0, 0.0)]:
        for crop in (32, 64):
            np.testing.assert_array_equal(got.crop_at(pose, crop).numpy(),
                                          ref.crop_at(pose, crop))


def twin_upens(use_rrt, n_frames=6):
    """Both packages' UPEN (2 members, the JAX weights carried across)
    after the same frames."""
    ref = jup.UPEN(options=None, n_members=2, seed=0, use_rrt=use_rrt,
                   grid_dim=(96, 96))
    got = tup.UPEN(options=None, n_members=2, seed=0, use_rrt=use_rrt,
                   grid_dim=(96, 96), device="cpu")
    carry_ensemble(ref.ensemble, got.ensemble)
    frames = depth_frames(n=n_frames)
    for u in (ref, got):
        u.init(frames[0][2])
    for depth, intr, pose, cam_h in frames:
        ref.observe(depth, intr, pose, cam_height=cam_h)
        got.observe(torch.from_numpy(depth), intr, pose, cam_height=cam_h)
    return ref, got, frames[-1][2]


@pytest.mark.parametrize("use_rrt", [False, True], ids=["fbe", "rrt"])
def test_predict_action_gives_the_same_goal(use_rrt):
    ref, got, pose = twin_upens(use_rrt)
    mj, uj = ref._predict(pose)
    mt, ut = got._predict(pose)
    np.testing.assert_allclose(mt, mj, atol=1e-5)
    np.testing.assert_allclose(ut, uj, atol=1e-5)
    for k in range(3):
        got.rng.bit_generator.state = ref.rng.bit_generator.state
        gj, ij = ref.predict_action(pose)
        gt, it = got.predict_action(pose)
        assert it == ij
        assert it["mode"] == ("rrt" if use_rrt else "fbe")
        np.testing.assert_array_equal(np.asarray(gt), np.asarray(gj))


def test_offline_dataset_matches():
    cam_j = JCamera(fx=24.0, fy=24.0, cx=24.0, cy=24.0, width=48, height=48)
    cam_t = TCamera(fx=24.0, fy=24.0, cx=24.0, cy=24.0, width=48, height=48)
    xj, yj = jds.generate_offline_dataset(cam_j, n_scenes=1,
                                          steps_per_scene=8, grid_dim=32)
    xt, yt = tds.generate_offline_dataset(cam_t, n_scenes=1,
                                          steps_per_scene=8, grid_dim=32,
                                          device="cpu")
    assert xt.shape == xj.shape == (8, 32, 32, 3) and yt.dtype == yj.dtype
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    xr, yr = tds.generate_offline_dataset(cam_t, n_scenes=1,
                                          steps_per_scene=4, grid_dim=32,
                                          traj_policy="random", device="cpu")
    xjr, yjr = jds.generate_offline_dataset(cam_j, n_scenes=1,
                                            steps_per_scene=4, grid_dim=32,
                                            traj_policy="random")
    np.testing.assert_array_equal(xr, xjr)
    np.testing.assert_array_equal(yr, yjr)


def test_train_predictors_tool(tmp_path, capsys):
    out_dir = str(tmp_path / "ens")
    out = train_predictors.main([
        "--out_dir", out_dir, "--n_scenes", "1", "--steps_per_scene", "10",
        "--epochs", "1", "--ensemble_size", "2", "--batch_size", "4",
        "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert line["n_train"] + line["n_val"] == 10 and line["n_val"] == 2
    assert np.isfinite(line["final_losses"]).all()
    assert len(line["final_losses"]) == 2 and 0 <= line["val_miou"] <= 1
    for name in ("member_0.pkl", "member_1.pkl", "offline_dataset.npz"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    # the trained members load into a fresh UPEN (the port's and the JAX
    # package's) and predict as the trained ensemble does
    x, _y = tds.load_dataset(os.path.join(out_dir, "offline_dataset.npz"))
    trained = tp.PredictorEnsemble(n_members=2, device="cpu")
    trained.load(out_dir)
    fresh = tup.UPEN(options=None, n_members=2, seed=5, device="cpu",
                     ensemble_dir=out_dir)
    ref = jp.PredictorEnsemble(n_members=2, seed=5)
    ref.load(out_dir)
    for a, b, c in zip(fresh.ensemble.predict(x[:2])[:2],
                       trained.predict(x[:2])[:2], ref.predict(x[:2])[:2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5)


# -- the episode ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ensemble(tmp_path_factory):
    """The JAX package's UPEN ensemble (4 members, seed 0), saved."""
    path = str(tmp_path_factory.mktemp("jax_ensemble"))
    jp.PredictorEnsemble(n_members=4, seed=0).save(path)
    return path


def run_upen(pkg, tmp_path, mp, policy, ensemble_dir=None):
    cfg = episode_cfg(tmp_path / pkg, policy=policy, steps=UPEN_STEPS)
    if ensemble_dir:
        cfg.policy.ensemble_dir = ensemble_dir
    if pkg == "jax":
        cam_t, scene_t, sim_t, drv, kw = JCamera, JScene, JSim, jdriver, {}
        sim_kw = dict(device_obs=False)
        upen_cls = jup.UPEN
    else:
        cfg = port_cfg(cfg)
        cam_t, scene_t, sim_t, drv = TCamera, TScene, TSim, tdriver
        kw = sim_kw = dict(device="cpu")
        upen_cls = tup.UPEN
    cam = cam_t(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                width=IMG, height=IMG)
    scene = scene_t(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                    obstacles=[((1.0, 0.0, 1.0), (1.8, 1.8, 1.8))])
    sim = sim_t(scene, cam, forward_step=0.15, turn_angle=30.0, seed=3,
                **sim_kw)
    actions, goals = [], []
    sim_step = sim.step

    def step(a):
        actions.append(int(a))
        return sim_step(a)

    sim.step = step
    predict = upen_cls.predict_action

    def recording(self, pose):
        goal, info = predict(self, pose)
        goals.append((len(actions), np.asarray(goal).tolist(), info))
        return goal, info

    mp.setattr(upen_cls, "predict_action", recording)
    mapper = drv.ActiveMapper(cfg, sim, scene=scene, seed=0, **kw)
    result = mapper.test_navigation(n_eval_poses=0)
    return actions, goals, result, mapper


@pytest.mark.parametrize("policy", ["UPEN_fbe", "UPEN_rrt"])
def test_upen_episodes_take_the_same_actions(policy, jax_ensemble,
                                             tmp_path):
    ens = jax_ensemble if policy == "UPEN_rrt" else None
    with pytest.MonkeyPatch.context() as mp:
        ja, jg, jres, jm = run_upen("jax", tmp_path, mp, policy, ens)
    with pytest.MonkeyPatch.context() as mp:
        ta, tg, tres, tm = run_upen("torch", tmp_path, mp, policy, ens)
    assert tm.upen is not None and tm.upen.use_rrt == (policy == "UPEN_rrt")
    assert len(tg) == len(jg) >= 2
    assert [g[2]["mode"] for g in tg] == [g[2]["mode"] for g in jg]
    if policy == "UPEN_rrt":
        assert any(g[2]["mode"] == "rrt" for g in tg)
    assert tg == jg
    assert ta == ja
    assert tres["steps"] == jres["steps"] == UPEN_STEPS
    # replans whose goal had a path (the others queue random actions; at
    # this map's 20 cm UPEN cells the RRT waypoints, 5 edges of 1.2 m
    # out, lie beyond the room's mapped space in both packages)
    assert tres["planning_events"] <= len(tg)
    if policy == "UPEN_fbe":
        assert tres["planning_events"] >= 1
    assert tres["timing"]["upen_observe"]["count"] == UPEN_STEPS
    np.testing.assert_allclose(tm.upen.sgrid.proj_grid.numpy(),
                               jm.upen.sgrid.proj_grid, atol=1e-5)
    assert tres["coverage_2d_pct"] == pytest.approx(jres["coverage_2d_pct"],
                                                    abs=1e-9)
    assert tres["n_gaussians"] == jres["n_gaussians"]


def test_upen_resume_starts_a_new_grid(tmp_path):
    """UPEN's grid is not in the checkpoint: a resumed episode starts a
    new grid at its first step (the JAX package's fails there)."""
    with pytest.MonkeyPatch.context() as mp:
        _a, _g, res, mapper = run_upen("torch", tmp_path, mp, "UPEN_fbe")
    c2w = mapper.sim.c2w.copy()
    mapper.save_checkpoint(res["steps"] - 1, sim_c2w=c2w,
                           resume_t=res["steps"])
    cfg = mapper.cfg
    cfg.num_frames = UPEN_STEPS + 4
    again = tdriver.ActiveMapper(cfg, mapper.sim, scene=mapper.scene,
                                 seed=0, eval_dir=mapper.eval_dir,
                                 device="cpu")
    again.resume(os.path.join(mapper.eval_dir,
                              f"params{res['steps'] - 1}.npz"))
    out = again.test_navigation(n_eval_poses=0)
    assert out["steps"] == UPEN_STEPS + 4
    assert again.upen.step_count == 4
    np.testing.assert_array_equal(again.upen.sgrid.origin_pose,
                                  np.asarray(again._pose_xzyaw(c2w)))


def test_entry_point_runs_upen(jax_ensemble, tmp_path, capsys):
    """The port's CLI with --policy UPEN_fbe and the JAX-saved ensemble,
    at 48x48 on the CPU."""
    argv = ["--scenes_list", "fake_room_0", "--max_steps", "10",
            "--policy", "UPEN_fbe", "--ensemble_dir", jax_ensemble,
            "--eval_poses", "0", "--img_size", "48", "--device", "cpu",
            "--log_dir", str(tmp_path), "--name", "cli",
            "--set", "mapping.num_iters", "4", "tpu.capacity", "8192",
            "policy.planning_queue_size", "5", "turn_angle", "30.0",
            "explore.cell_size", "0.1"]
    args = cli.build_parser().parse_args(argv)
    assert cli.load_config(args).policy.ensemble_dir == jax_ensemble
    results = cli.main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == json.loads(json.dumps(results, default=float))
    res = out["fake_room_0"]
    assert res["policy"] == "UPEN_fbe" and res["steps"] == 10
    assert res["timing"]["planning"]["count"] >= 1       # UPEN replans
    assert res["timing"]["upen_observe"]["count"] == 10
    assert os.path.exists(tmp_path / "cli" / "fake_room_0" / "result.json")
