"""The episode's sharded dispatches on two ranks (gloo, spawned processes
on the CPU) against the JAX package's at mesh_axes.data = 2 on the
conftest's virtual CPU devices, at the sizes of
tests/test_sharded_episode.py: 32x32, capacity 4096, F 8.

The two ranks run, in one spawned group (the `ranks` fixture, a 240 s
wall limit and a 60 s collective timeout): the four episode-path
factories on the same seeded inputs as the JAX side, then a 22-step
gaussians_based episode with mesh_axes.data = 2, hashing the Gaussian
state after every mapping event.  In this process: the JAX package's
factories and its data = 2 episode, and the port's single-rank episodes
(data = 1, and data = 2 clamped to 1 for want of ranks).

Tolerances, each with its reason:
  * sharded port against the unsharded port: tests/test_sharded_episode.py's
    sharded-against-single tolerances (the float reduction order);
  * port against JAX: the mapping phase's losses rtol 1e-4 and each
    parameter within 2 lr per Adam step (tests/test_torch_mapping.py);
    pose scores rtol 5e-3 (tests/test_torch_fisher.py), H_train and path
    EIG rtol 1e-2 (tests/test_torch_slice.py, tests/test_torch_path_eval.py):
    the port's Fisher stops a tile at T < 1e-4, JAX's XLA engine never;
  * the episodes: the same step count, n_gaussians within 25 % and the
    completeness within 15 points (tests/test_sharded_episode.py);
  * the ranks' states: equal to the bit after every mapping event.

This module imports no JAX at its top: the spawned ranks import it to
find their function.
"""
import hashlib

import numpy as np
import pytest
import torch

WORLD = 2
STEPS = 22
LR_KEYS = dict(means3D="lr_means3D", rgb_colors="lr_rgb",
               unnorm_rotations="lr_rots", logit_opacities="lr_logit_op",
               log_scales="lr_log_scales")


def _state_hash(state) -> str:
    return hashlib.sha1(b"".join(
        getattr(state, k).detach().cpu().numpy().tobytes()
        for k in state._fields)).hexdigest()


def _port_cfg(d):
    from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults
    cfg = get_cfg_defaults()
    cfg.merge_from_other(d)
    return cfg


def _scene():
    from fisher_nerf_customized_tpu_torch.envs.fake_sim import (BoxScene,
                                                                FakeSim)
    from fisher_nerf_customized_tpu_torch.ops.camera import Camera
    img = 32
    cam = Camera(fx=float(img), fy=float(img), cx=img / 2, cy=img / 2,
                 width=img, height=img)
    scene = BoxScene(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                     obstacles=[((1.0, 0.0, 1.0), (1.8, 1.8, 1.8))])
    return FakeSim(scene, cam, forward_step=0.15, turn_angle=30.0, seed=3,
                   device="cpu"), scene


def run_port_episode(cfg_dict):
    """The port's 22-step episode (tests/test_sharded_episode.py's
    _run_episode): (result, mapper, the state's hash after each mapping
    event, the actions taken)."""
    from fisher_nerf_customized_tpu_torch.engine.driver import ActiveMapper
    sim, scene = _scene()
    actions = []
    sim_step = sim.step

    def step(a):
        actions.append(int(a))
        return sim_step(a)

    sim.step = step
    mapper = ActiveMapper(_port_cfg(cfg_dict), sim, scene=scene, seed=0,
                          device="cpu")
    slam, hashes = mapper.slam, []
    event = slam._mapping_event

    def hashed(*a, **kw):
        event(*a, **kw)
        hashes.append((slam.frame_idx + 1, _state_hash(slam.state)))

    slam._mapping_event = hashed
    result = mapper.test_navigation(
        n_eval_poses=0, recon_gt_points=scene.sample_surface_points(4000))
    mapper.mlog.close()
    return result, mapper, hashes, actions


def _port_ranks(rank, world, _port, inp):
    """The factories and the episode on one rank; numpy results."""
    from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
        PARAM_KEYS, state_from_numpy)
    from fisher_nerf_customized_tpu_torch.models.slam import GaussianSLAM
    from fisher_nerf_customized_tpu_torch.parallel.sharding import (
        sharded_fisher_hsum, sharded_mapping_phase, sharded_path_eig,
        sharded_pose_scores)

    def t(x):
        return torch.from_numpy(np.asarray(x))

    slam = GaussianSLAM(_port_cfg(inp["cfg2"]), device="cpu")
    assert slam.mesh is not None and slam.mesh_data == world
    state = state_from_numpy(inp["state"], inp["capacity"], device="cpu")
    fisher = (slam.mesh, slam.fisher_camera, slam.fisher_settings)
    mc = slam.mc._replace(frames_per_iter=8, num_iters=24)
    new_state, losses, ga, dn, overflow = sharded_mapping_phase(
        slam.mesh, slam.camera, slam.settings, mc)(
            state, t(inp["colors"]), t(inp["depths"]), t(inp["w2cs"]),
            inp["choices"])
    out = dict(mapping=dict(losses=losses.numpy(), ga=ga.numpy(),
                            dn=dn.numpy(), overflow=int(overflow),
                            n_active=int(new_state.n_active),
                            **{k: getattr(new_state, k).numpy()
                               for k in PARAM_KEYS}))
    pose = sharded_pose_scores(*fisher, slam.fisher_full_chain,
                               slam.fisher_grad_value)
    out["pose"] = pose(state, t(inp["pose_w2cs"]), t(inp["h_inv"])).numpy()
    out["pose_async"] = pose(state, t(inp["pose_w2cs"]), t(inp["h_inv"]),
                             async_op=True).wait().numpy()
    out["hsum"] = sharded_fisher_hsum(
        *fisher, slam.fisher_full_chain, slam.fisher_grad_value)(
            state, t(inp["hsum_w2cs"]), t(inp["weights"])).numpy()
    pe = inp["path"]
    out["path_eig"] = sharded_path_eig(*fisher, False,
                                       slam.fisher_grad_value)(
        state, t(pe["h_train"]), t(pe["w2cs"]), t(pe["valid"]),
        t(pe["lengths"]), t(pe["final_eigs"]), 1e-6, 0.0, 1.0, 30.0,
        100.0).numpy()
    result, mapper, hashes, actions = run_port_episode(inp["episode_cfg"])
    out["episode"] = dict(result=result, hashes=hashes, actions=actions,
                          calls=dict(mapper.slam.sharded_calls))
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (six suite workers beside
    XLA's pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """tests/test_sharded_episode.py's inputs, as numpy: a JAX GaussianSLAM
    initialised on a FakeSim frame and 4 frames, the frame choices, pose
    chunks, weights and paths."""
    from test_sharded_episode import _cfg, _slam_with_frames
    tmp = tmp_path_factory.mktemp("sharded")
    slam, frames = _slam_with_frames(tmp, n_frames=4)
    st = slam.state
    rng = np.random.default_rng(0)
    pose_w2cs = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    pose_w2cs[:, 0, 3] = rng.uniform(-0.3, 0.3, 8)
    pose_w2cs[:, 2, 3] = rng.uniform(-0.3, 0.3, 8)
    hsum_w2cs = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    hsum_w2cs[:, 0, 3] = rng.uniform(-0.3, 0.3, 8)
    p, a = 8, 2
    path_w2cs = np.tile(np.eye(4, dtype=np.float32), (p, a, 1, 1))
    path_w2cs[..., 0, 3] = rng.uniform(-0.3, 0.3, (p, a))
    valid = np.ones((p, a), bool)
    valid[-1, 1] = False
    return dict(
        jax_slam=slam, cfg2=_cfg(tmp, data_axis=2).to_dict(),
        state={k: np.asarray(getattr(st, k)) for k in st._fields},
        capacity=int(st.capacity),
        colors=np.stack([np.asarray(f["rgb"], np.float32) for f in frames]),
        depths=np.stack([np.asarray(f["depth"], np.float32)
                         for f in frames]),
        w2cs=np.stack([np.linalg.inv(f["c2w"]) for f in frames]).astype(
            np.float32),
        choices=rng.integers(0, len(frames), size=(3, 8)).astype(np.int32),
        pose_w2cs=pose_w2cs,
        h_inv=rng.uniform(0.5, 2.0, (st.capacity, 4)).astype(np.float32),
        hsum_w2cs=hsum_w2cs,
        weights=np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32),
        path=dict(w2cs=path_w2cs, valid=valid,
                  lengths=rng.integers(2, 8, p).astype(np.int32),
                  final_eigs=rng.uniform(-1, 1, p).astype(np.float32),
                  h_train=rng.uniform(0.1, 1.0, (st.capacity, 4)).astype(
                      np.float32)),
        episode_cfg=_cfg(tmp / "port2", data_axis=2, steps=STEPS).to_dict(),
        episode_cfg1=_cfg(tmp / "port1", data_axis=1, steps=STEPS).to_dict(),
        episode_cfg_clamp=_cfg(tmp / "clamp", data_axis=2,
                               steps=STEPS).to_dict(),
        tmp=tmp)


@pytest.fixture(scope="module")
def ranks(inputs):
    from fisher_nerf_customized_tpu_torch.parallel.launch import run_ranks
    inp = {k: v for k, v in inputs.items() if k not in ("jax_slam", "tmp")}
    return run_ranks(_port_ranks, WORLD, args=(inp,), timeout_s=240,
                     threads=1)


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-process episodes: data = 1, and data = 2 clamped
    to 1 (one rank)."""
    return (run_port_episode(inputs["episode_cfg1"]),
            run_port_episode(inputs["episode_cfg_clamp"]))


def _jax(inputs):
    from fisher_nerf_customized_tpu.parallel.mesh import make_mesh
    return inputs["jax_slam"], make_mesh(data=WORLD)


def _port_state(inputs):
    from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
        state_from_numpy)
    return state_from_numpy(inputs["state"], inputs["capacity"],
                            device="cpu")


def _port_slam(inputs):
    from fisher_nerf_customized_tpu_torch.models.slam import GaussianSLAM
    return GaussianSLAM(_port_cfg(inputs["episode_cfg1"]), device="cpu")


def test_sharded_mapping_phase_matches(ranks, inputs):
    import jax.numpy as jnp
    from fisher_nerf_customized_tpu.parallel.sharding import (
        sharded_mapping_phase as jphase)
    from fisher_nerf_customized_tpu_torch.models.slam import (
        _mapping_phase_impl)
    jslam, mesh = _jax(inputs)
    mc = jslam.mc._replace(frames_per_iter=8, num_iters=24)
    ref = jphase(mesh, jslam.camera, jslam.settings, mc)(
        jslam.state, jnp.asarray(inputs["colors"]),
        jnp.asarray(inputs["depths"]), jnp.asarray(inputs["w2cs"]),
        jnp.asarray(inputs["choices"]))
    tslam = _port_slam(inputs)
    single = _mapping_phase_impl(
        _port_state(inputs), *(torch.from_numpy(inputs[k]) for k in
                               ("colors", "depths", "w2cs")),
        inputs["choices"], tslam.camera, tslam.settings,
        tslam.mc._replace(frames_per_iter=8, num_iters=24))
    for out in ranks:
        got = out["mapping"]
        assert got["n_active"] == int(single[0].n_active) \
            == int(ref[0].n_active)
        for k in ("means3D", "logit_opacities"):
            np.testing.assert_allclose(got[k], getattr(single[0], k).numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)
        np.testing.assert_allclose(got["losses"], single[1].numpy(),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["ga"], single[2].numpy(), rtol=2e-3,
                                   atol=1e-7)
        np.testing.assert_array_equal(got["dn"], single[3].numpy())
        np.testing.assert_allclose(got["losses"], np.asarray(ref[1]),
                                   rtol=1e-4)
        n_steps = len(got["losses"])
        for k, lr_key in LR_KEYS.items():
            err = np.abs(got[k] - np.asarray(getattr(ref[0], k)))
            assert err.max() <= 2 * getattr(mc, lr_key) * n_steps + 1e-6, k
    for k in LR_KEYS:
        assert np.array_equal(ranks[0]["mapping"][k], ranks[1]["mapping"][k])


def test_sharded_pose_scores_matches(ranks, inputs):
    import jax.numpy as jnp
    from fisher_nerf_customized_tpu.parallel.sharding import (
        sharded_pose_scores as jscores)
    from fisher_nerf_customized_tpu_torch.models.slam import _pose_scores
    jslam, mesh = _jax(inputs)
    ref = np.asarray(jscores(mesh, jslam.fisher_camera, jslam.fisher_settings,
                             jslam.fisher_engine, jslam.fisher_full_chain,
                             jslam.fisher_grad_value)(
        jslam.state, jnp.asarray(inputs["pose_w2cs"]),
        jnp.asarray(inputs["h_inv"])))
    ts = _port_slam(inputs)
    single = _pose_scores(_port_state(inputs),
                          torch.from_numpy(inputs["pose_w2cs"]),
                          torch.from_numpy(inputs["h_inv"]), ts.fisher_camera,
                          ts.fisher_settings, ts.fisher_full_chain,
                          ts.fisher_grad_value).numpy()
    for out in ranks:
        np.testing.assert_allclose(out["pose"], single, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(out["pose_async"], out["pose"])
        np.testing.assert_allclose(out["pose"], ref, rtol=5e-3)
    np.testing.assert_array_equal(ranks[0]["pose"], ranks[1]["pose"])


def test_sharded_hsum_matches(ranks, inputs):
    import jax.numpy as jnp
    from fisher_nerf_customized_tpu.parallel.sharding import (
        sharded_fisher_hsum as jhsum)
    from fisher_nerf_customized_tpu_torch.models.slam import _fisher_batch
    jslam, mesh = _jax(inputs)
    ref = np.asarray(jhsum(mesh, jslam.fisher_camera, jslam.fisher_settings,
                           jslam.fisher_engine, jslam.fisher_full_chain,
                           jslam.fisher_grad_value)(
        jslam.state, jnp.asarray(inputs["hsum_w2cs"]),
        jnp.asarray(inputs["weights"])))
    ts = _port_slam(inputs)
    single = _fisher_batch(_port_state(inputs),
                           torch.from_numpy(inputs["hsum_w2cs"]),
                           ts.fisher_camera, ts.fisher_settings,
                           ts.fisher_full_chain, ts.fisher_grad_value)
    single = single["H"][:5].sum(dim=0).numpy()
    assert single.max() > 0
    for out in ranks:
        np.testing.assert_allclose(out["hsum"], single, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(out["hsum"], ref, rtol=1e-2, atol=1e-12)
    np.testing.assert_array_equal(ranks[0]["hsum"], ranks[1]["hsum"])


def test_sharded_path_eig_matches(ranks, inputs):
    import jax.numpy as jnp
    from fisher_nerf_customized_tpu.parallel.sharding import (
        sharded_path_eig as jpath_eig)
    from fisher_nerf_customized_tpu_torch.engine.path_eval import (
        path_eig_scores)
    jslam, mesh = _jax(inputs)
    pe = inputs["path"]
    args = ("h_train", "w2cs", "valid", "lengths", "final_eigs")
    ref = np.asarray(jpath_eig(mesh, jslam.fisher_camera,
                               jslam.fisher_settings, False,
                               jslam.fisher_engine, jslam.fisher_grad_value)(
        jslam.state, *(jnp.asarray(pe[k]) for k in args), 1e-6, 0.0, 1.0,
        30.0, 100.0))
    ts = _port_slam(inputs)
    single = path_eig_scores(_port_state(inputs),
                             *(torch.from_numpy(pe[k]) for k in args),
                             ts.fisher_camera, ts.fisher_settings, 1e-6, 0.0,
                             1.0, 30.0, False, 100.0,
                             ts.fisher_grad_value).numpy()
    for out in ranks:
        np.testing.assert_allclose(out["path_eig"], single, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out["path_eig"], ref, rtol=1e-2)
    np.testing.assert_array_equal(ranks[0]["path_eig"], ranks[1]["path_eig"])


def test_sharded_episode_matches(ranks, single, inputs):
    """The port's 22-step episode on two ranks runs through the sharded
    factories, its ranks' states equal to the bit after every mapping
    event, and lands where JAX's data = 2 episode and the port's
    single-rank episode land."""
    from test_sharded_episode import _run_episode
    (r0, r1) = (out["episode"] for out in ranks)
    assert r0["hashes"] == r1["hashes"] and len(r0["hashes"]) >= 3
    assert r0["actions"] == r1["actions"]
    for key in ("mapping", "pose", "h_train"):
        assert r0["calls"][key] > 0, key
    assert r0["result"]["planning_events"] > 0
    jm, jr = _run_episode(inputs["tmp"] / "jax2", data_axis=2, steps=STEPS)
    assert jm.slam.sharded_calls["mapping"] > 0
    (tr1, tm1, _h1, _a1), _clamped = single
    assert tm1.slam.sharded_calls["mapping"] == 0
    got = r0["result"]
    for ref in (jr, tr1):
        assert got["steps"] == ref["steps"]
        assert np.isfinite(got["recon"]["completeness_ratio"])
        assert abs(got["n_gaussians"] - ref["n_gaussians"]) \
            <= 0.25 * max(ref["n_gaussians"], 1)
        assert abs(got["recon"]["completeness_ratio"]
                   - ref["recon"]["completeness_ratio"]) <= 15.0


def test_data_axis_clamps_in_one_process(single):
    """mesh_axes.data = 2 in one process runs unsharded, as the JAX
    package does on one device, and equals the data = 1 episode."""
    (r1, m1, h1, a1), (r2, m2, h2, a2) = single
    assert m2.slam.mesh is None and m2.slam.mesh_data == 1
    assert m2.slam.sharded_calls == dict(mapping=0, pose=0, h_train=0)
    assert h2 == h1 and a2 == a1
    assert r2["steps"] == r1["steps"]
    assert r2["n_gaussians"] == r1["n_gaussians"]
