"""The port's parallel/ library paths on two ranks (gloo, spawned
processes on the CPU) against the JAX package's on the conftest's
virtual CPU devices, at the sizes of tests/test_parallel.py: 64x64,
tile 8, K 64, 2048 Gaussians with inactive slots; a 32x32 slice for the
mapping step and the pose scores.

The two ranks run every scenario in one spawned group (the `ranks`
fixture, a 180 s wall limit and a 60 s collective timeout), from the
same seeded numpy inputs the JAX side gets.  Tolerances, each with its
reason:
  * sharded port against the unsharded port: the JAX tests' own
    sharded-against-single tolerances (only the float reduction order
    differs);
  * port against JAX, render: atol 1e-3 (the port's blend stops a tile
    at T < 1e-4, JAX's XLA blend never stops; tests/test_torch_slice.py);
  * port against JAX, Fisher: rtol 1e-4, atol 1e-7 (tests/test_parallel.py)
    for the model-axis diagonal; pose scores rtol 5e-3
    (tests/test_torch_fisher.py: the same stop, summed over all rows);
  * mapping and multi-scene steps against JAX: losses rtol 1e-4, each
    parameter within 2 lr per Adam step (tests/test_torch_mapping.py);
  * multi_scene_occ_update: equal to the bit.

This module imports no JAX at its top: the spawned ranks import it to
find their function.
"""
import numpy as np
import pytest
import torch

WORLD = 2
IMG = 32
CAM64 = dict(fx=32.0, fy=32.0, cx=32.0, cy=32.0, width=64, height=64)
SETTINGS = dict(tile_size=8, max_per_tile=64, chunk=16)
N_GAUSS = 2048
STEPS = 3
LR_KEYS = dict(means3D="lr_means3D", rgb_colors="lr_rgb",
               unnorm_rotations="lr_rots", logit_opacities="lr_logit_op",
               log_scales="lr_log_scales")


def random_gaussians(n, seed):
    """tests/test_parallel.py's scene, as numpy."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(0, 2.0, n),
                      rng.uniform(0.5, 6.0, n)], -1).astype(np.float32)
    scales = rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.2, 0.9, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    active = np.ones((n,), bool)
    active[-n // 8:] = False            # some inactive slots on one shard
    return means, scales, quats, opac, colors, active


def multi_scene_inputs():
    """tests/test_parallel.py's multi-scene step at 4 scenes."""
    img, s, n = 16, 4, 128
    rng = np.random.default_rng(0)
    params = dict(
        means3D=np.stack([rng.uniform(-1, 1, (s, n)),
                          rng.uniform(0, 2, (s, n)),
                          rng.uniform(0.5, 3, (s, n))], -1).astype(np.float32),
        rgb_colors=rng.uniform(0, 1, (s, n, 3)).astype(np.float32),
        unnorm_rotations=np.tile(np.array([1.0, 0, 0, 0], np.float32),
                                 (s, n, 1)),
        logit_opacities=np.zeros((s, n, 1), np.float32),
        log_scales=np.full((s, n, 3), -2.5, np.float32))
    colors = rng.uniform(0, 1, (s, img, img, 3)).astype(np.float32)
    depths = rng.uniform(1, 2.5, (s, img, img)).astype(np.float32)
    w2cs = np.tile(np.eye(4, dtype=np.float32), (s, 1, 1))
    cam = dict(fx=float(img), fy=float(img), cx=img / 2, cy=img / 2,
               width=img, height=img)
    mc = dict(num_iters=1, sil_thres=0.5, depth_weight=1.0, im_weight=0.5,
              prune_enabled=False, prune_every=40, prune_start=0,
              prune_stop=1000, prune_thresh=1e-4, prune_big_after=100,
              lr_means3D=1e-3, lr_rgb=2.5e-3, lr_rots=1e-3,
              lr_logit_op=0.05, lr_log_scales=0.01, depth_error_ratio=10.0,
              downsample_pcd=2)
    return dict(params=params, n_active=np.full((s,), n, np.int32),
                colors=colors, depths=depths, w2cs=w2cs, cam=cam, mc=mc,
                settings=dict(tile_size=8, max_per_tile=32, chunk=16))


def _shard(x, rank, world=WORLD):
    per = len(x) // world
    return x[rank * per:(rank + 1) * per]


def _port_scenarios(rank, world, _port, inp):
    """Every scenario on one rank of the spawned group; numpy results."""
    from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
        PARAM_KEYS, adam_init, state_from_numpy)
    from fisher_nerf_customized_tpu_torch.models.slam import MappingConfig
    from fisher_nerf_customized_tpu_torch.ops.camera import Camera
    from fisher_nerf_customized_tpu_torch.ops.rasterize import RenderSettings
    from fisher_nerf_customized_tpu_torch.parallel import (
        fisher_diag_gaussian_sharded, make_mesh, mapping_step_sharded,
        multi_scene_occ_update, pose_eval_sharded, render_gaussian_sharded)
    from fisher_nerf_customized_tpu_torch.parallel.sharding import (
        full_train_step, multi_scene_train_step)

    def t(x):
        return torch.from_numpy(np.asarray(x))

    mesh_d = make_mesh(data=world)
    mesh_m = make_mesh(data=1, model=world)
    out = dict(mesh=dict(data=(mesh_d.shape, mesh_d.coords,
                               mesh_d.devices.tolist()),
                         model=(mesh_m.shape, mesh_m.coords,
                                mesh_m.devices.tolist())))

    # the Gaussian-axis render and Fisher diagonal, each rank its shard
    cam = Camera(**CAM64)
    st = RenderSettings(**SETTINGS)
    for key, seed, fn in (
            ("render", 0, render_gaussian_sharded(mesh_m, cam, st)),
            ("fisher", 3, fisher_diag_gaussian_sharded(mesh_m, cam, st))):
        arrs = [t(_shard(a, rank, world)) for a in random_gaussians(N_GAUSS,
                                                                    seed)]
        res = fn(*arrs, torch.eye(4))
        out[key] = {k: v.detach().numpy() for k, v in res.items()}

    # pose scores and the mapping step on the 32x32 slice's state
    sl = inp["slice"]
    cam32 = Camera(**sl["cam"])
    st32 = RenderSettings(**sl["settings"])
    state = state_from_numpy(sl["state"], sl["capacity"], device="cpu")
    out["pose_eval"] = {
        fc: pose_eval_sharded(mesh_d, state, t(sl["w2cs"]), t(sl["h_inv"]),
                              cam32, st32, full_chain=fc).numpy()
        for fc in (False, True)}
    mc = MappingConfig(**sl["mc"])
    step = mapping_step_sharded(mesh_d, cam32, st32, mc)
    params = {k: v.clone() for k, v in state.params().items()}
    params["logit_opacities"] = params["logit_opacities"] - 2.0
    opt, losses = adam_init(params), []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, state.n_active,
                                 t(sl["colors"]), t(sl["depths"]),
                                 t(sl["frame_w2cs"]))
        losses.append(float(loss))
    out["mapping_step"] = dict(losses=np.asarray(losses),
                               **{k: params[k].numpy() for k in PARAM_KEYS})
    new_state, loss, scores = full_train_step(mesh_d, cam32, st32, mc)(
        state, t(sl["colors"]), t(sl["depths"]), t(sl["frame_w2cs"]),
        t(sl["w2cs"]), t(sl["h_inv"]))
    out["full_train_step"] = dict(loss=float(loss), scores=scores.numpy(),
                                  **{k: getattr(new_state, k).numpy()
                                     for k in PARAM_KEYS})

    # scene parallelism
    ms = inp["multi_scene"]
    states = state_from_numpy(dict(ms["params"], n_active=ms["n_active"]),
                              ms["n_active"][0], device="cpu")
    fn = multi_scene_train_step(mesh_d, Camera(**ms["cam"]),
                                RenderSettings(**ms["settings"]),
                                MappingConfig(**ms["mc"]))
    new_states, _opts, ms_losses = fn(states, None, t(ms["colors"]),
                                      t(ms["depths"]), t(ms["w2cs"]))
    out["multi_scene"] = dict(
        losses=ms_losses.numpy(),
        **{k: np.stack([getattr(s, k).numpy() for s in new_states])
           for k in PARAM_KEYS})
    oc = inp["occ"]
    occs, cams = multi_scene_occ_update(mesh_d, cam32)(
        t(oc["occs"]), t(oc["depths"]), t(oc["c2ws"]), oc["cell"],
        t(oc["centers"]), 0.2, 1.5, 3.0)
    out["occ"] = dict(occs=occs.numpy(), cams=cams.numpy())
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The seeded numpy inputs: the 32x32 slice's state and frames from
    the JAX package's GaussianSLAM and FakeSim (tests/test_parallel.py's
    build_slam), the multi-scene step's and the occupancy updates'."""
    from test_parallel import build_slam
    slam, sim = build_slam(tmp_path_factory.mktemp("parallel"))
    rng = np.random.default_rng(0)
    w2cs = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    w2cs[:, 0, 3] = rng.uniform(-0.2, 0.2, 8)
    frames = [sim.get_observations()] + [sim.step(a) for a in (2, 1, 3)]
    colors = np.stack([np.asarray(f["rgb"], np.float32) for f in frames])
    depths = np.stack([np.asarray(f["depth"], np.float32) for f in frames])
    c2ws = np.stack([np.asarray(f["c2w"], np.float32) for f in frames])
    st = slam.state
    state = {k: np.asarray(getattr(st, k)) for k in st._fields}
    cam = slam.camera
    sl = dict(state=state, capacity=int(st.capacity),
              cam=dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                       width=cam.width, height=cam.height),
              settings={k: getattr(slam.settings, k) for k in
                        ("tile_size", "max_per_tile", "chunk", "max_depth")},
              mc=slam.mc._asdict(),
              w2cs=w2cs, h_inv=rng.uniform(0.5, 2.0, (st.capacity, 4)).astype(
                  np.float32),
              colors=colors, depths=depths,
              frame_w2cs=np.linalg.inv(c2ws).astype(np.float32))
    occ = np.zeros((4, 3, 64, 64), np.float32)
    occ[:, 0] = 1.0
    occ_in = dict(occs=occ, depths=depths, c2ws=c2ws, cell=0.1,
                  centers=np.zeros((4, 2), np.float32))
    return dict(slice=sl, multi_scene=multi_scene_inputs(), occ=occ_in,
                jax_slam=slam)


@pytest.fixture(scope="module")
def ranks(inputs):
    from fisher_nerf_customized_tpu_torch.parallel.launch import run_ranks
    inp = {k: v for k, v in inputs.items() if k != "jax_slam"}
    return run_ranks(_port_scenarios, WORLD, args=(inp,), timeout_s=180,
                     threads=1)


def _jax_mesh(data=1, model=1):
    from fisher_nerf_customized_tpu.parallel import make_mesh
    return make_mesh(data=data, model=model)


def test_make_mesh_shapes_and_coordinates(ranks):
    from fisher_nerf_customized_tpu_torch.parallel import make_mesh
    for r, out in enumerate(ranks):
        shape, coords, devices = out["mesh"]["data"]
        assert shape == {"data": 2, "model": 1} == _jax_mesh(2).shape
        assert coords == {"data": r, "model": 0}
        assert devices == [[0], [1]]
        shape, coords, devices = out["mesh"]["model"]
        assert shape == {"data": 1, "model": 2} == _jax_mesh(1, 2).shape
        assert coords == {"data": 0, "model": r}
        assert devices == [[0, 1]]
    one = make_mesh()                   # no process group: the 1 x 1 mesh
    assert one.shape == {"data": 1, "model": 1}
    assert one.coords == {"data": 0, "model": 0}
    x = torch.arange(6.0).reshape(3, 2)
    ax = one.axis("data")
    assert ax.psum(x) is x and ax.all_gather(x) is x
    assert ax.shard(8) == (0, 8)


def _gaussians(seed, jax_side):
    arrs = random_gaussians(N_GAUSS, seed)
    if jax_side:
        import jax.numpy as jnp
        return [jnp.asarray(a) for a in arrs]
    return [torch.from_numpy(a) for a in arrs]


def test_render_gaussian_sharded_matches(ranks):
    import jax.numpy as jnp
    from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
    from fisher_nerf_customized_tpu.ops.rasterize import (
        RenderSettings as JSettings)
    from fisher_nerf_customized_tpu.parallel import (
        render_gaussian_sharded as jrender_sharded)
    from fisher_nerf_customized_tpu_torch.ops.camera import Camera
    from fisher_nerf_customized_tpu_torch.ops.rasterize import (
        RenderSettings, render)
    ref = jrender_sharded(_jax_mesh(1, 2), JCamera(**CAM64),
                          JSettings(**SETTINGS))(*_gaussians(0, True),
                                                 jnp.eye(4))
    means, scales, quats, opac, colors, active = _gaussians(0, False)
    single = render(Camera(**CAM64), means, scales, quats, opac, colors,
                    active=active, settings=RenderSettings(**SETTINGS))
    for r, out in enumerate(ranks):
        got = out["render"]
        for k in ("color", "depth", "final_t"):
            np.testing.assert_allclose(got[k], single[k].detach().numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=1e-3,
                                       err_msg=k)
        np.testing.assert_array_equal(
            got["radii"], _shard(single["radii"].numpy(), r))
        np.testing.assert_array_equal(got["radii"],
                                      _shard(np.asarray(ref["radii"]), r))
        assert int(got["overflow"]) == int(ref["overflow"])
    assert np.array_equal(ranks[0]["render"]["color"],
                          ranks[1]["render"]["color"])


def test_fisher_diag_gaussian_sharded_matches(ranks):
    import jax.numpy as jnp
    from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
    from fisher_nerf_customized_tpu.ops.rasterize import (
        RenderSettings as JSettings)
    from fisher_nerf_customized_tpu.parallel import (
        fisher_diag_gaussian_sharded as jfisher_sharded)
    from fisher_nerf_customized_tpu_torch.ops.camera import Camera
    from fisher_nerf_customized_tpu_torch.ops.fisher import fisher_diag_batch
    from fisher_nerf_customized_tpu_torch.ops.rasterize import RenderSettings
    ref = jfisher_sharded(_jax_mesh(1, 2), JCamera(**CAM64),
                          JSettings(**SETTINGS))(*_gaussians(3, True),
                                                 jnp.eye(4))
    means, scales, quats, opac, colors, active = _gaussians(3, False)
    single = fisher_diag_batch(Camera(**CAM64), torch.eye(4)[None], means,
                               scales, quats, opac, colors, active=active,
                               settings=RenderSettings(**SETTINGS))
    h_single = single["H"][0].numpy()
    assert np.abs(h_single).max() > 0
    for r, out in enumerate(ranks):
        got = out["fisher"]
        np.testing.assert_allclose(got["H"], _shard(h_single, r), rtol=1e-5,
                                   atol=1e-12)
        np.testing.assert_allclose(got["H"], _shard(np.asarray(ref["H"]), r),
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_array_equal(got["visible"],
                                      _shard(np.asarray(ref["visible"]), r))


def test_pose_eval_sharded_matches(ranks, inputs):
    import jax.numpy as jnp
    from fisher_nerf_customized_tpu.parallel import (
        pose_eval_sharded as jpose_eval)
    from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
        state_from_numpy)
    from fisher_nerf_customized_tpu_torch.models.slam import _pose_scores
    from fisher_nerf_customized_tpu_torch.ops.camera import Camera
    from fisher_nerf_customized_tpu_torch.ops.rasterize import RenderSettings
    sl, jslam = inputs["slice"], inputs["jax_slam"]
    state = state_from_numpy(sl["state"], sl["capacity"], device="cpu")
    for fc in (False, True):
        ref = np.asarray(jpose_eval(_jax_mesh(2), jslam.state,
                                    jnp.asarray(sl["w2cs"]),
                                    jnp.asarray(sl["h_inv"]), jslam.camera,
                                    jslam.settings, full_chain=fc))
        single = _pose_scores(state, torch.from_numpy(sl["w2cs"]),
                              torch.from_numpy(sl["h_inv"]),
                              Camera(**sl["cam"]),
                              RenderSettings(**sl["settings"]), fc).numpy()
        for out in ranks:
            got = out["pose_eval"][fc]
            np.testing.assert_allclose(got, single, rtol=1e-5)
            np.testing.assert_allclose(got, ref, rtol=5e-3)
        assert np.array_equal(ranks[0]["pose_eval"][fc],
                              ranks[1]["pose_eval"][fc])


def _within_adam_bound(got, ref, mc, steps):
    for k, lr_key in LR_KEYS.items():
        lr = mc[lr_key]
        err = np.abs(got[k] - ref[k])
        assert err.max() <= 2 * lr * steps + 1e-6, (k, err.max(), lr)


def test_mapping_step_sharded_matches(ranks, inputs):
    import jax.numpy as jnp
    from fisher_nerf_customized_tpu.models.gaussian_state import (
        adam_init as jadam_init)
    from fisher_nerf_customized_tpu.parallel import (
        mapping_step_sharded as jstep_sharded)
    from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
        adam_init, state_from_numpy)
    from fisher_nerf_customized_tpu_torch.models.slam import MappingConfig
    from fisher_nerf_customized_tpu_torch.ops.camera import Camera
    from fisher_nerf_customized_tpu_torch.ops.rasterize import RenderSettings
    from fisher_nerf_customized_tpu_torch.parallel import (
        make_mesh, mapping_step_sharded)
    sl, jslam = inputs["slice"], inputs["jax_slam"]
    step = jstep_sharded(_jax_mesh(2), jslam.camera, jslam.settings,
                         jslam.mc)
    params = jslam.state.params()
    params["logit_opacities"] = params["logit_opacities"] - 2.0
    opt, ref_losses = jadam_init(params), []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, jslam.state.n_active,
                                 jnp.asarray(sl["colors"]),
                                 jnp.asarray(sl["depths"]),
                                 jnp.asarray(sl["frame_w2cs"]))
        ref_losses.append(float(loss))
    ref = {k: np.asarray(v) for k, v in params.items()}
    # the port unsharded: the same step on the 1 x 1 mesh of this process
    state = state_from_numpy(sl["state"], sl["capacity"], device="cpu")
    one = mapping_step_sharded(make_mesh(), Camera(**sl["cam"]),
                               RenderSettings(**sl["settings"]),
                               MappingConfig(**sl["mc"]))
    tp = {k: v.clone() for k, v in state.params().items()}
    tp["logit_opacities"] = tp["logit_opacities"] - 2.0
    topt, single_losses = adam_init(tp), []
    for _ in range(STEPS):
        tp, topt, loss = one(tp, topt, state.n_active,
                             *(torch.from_numpy(sl[k]) for k in
                               ("colors", "depths", "frame_w2cs")))
        single_losses.append(float(loss))
    assert ref_losses[-1] < ref_losses[0]
    for out in ranks:
        got = out["mapping_step"]
        np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-4)
        np.testing.assert_allclose(got["losses"], single_losses, rtol=1e-4,
                                   atol=1e-6)
        _within_adam_bound(got, ref, sl["mc"], STEPS)
        for k in ("means3D", "logit_opacities"):
            np.testing.assert_allclose(got[k], tp[k].numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=k)
    for k in LR_KEYS:
        assert np.array_equal(ranks[0]["mapping_step"][k],
                              ranks[1]["mapping_step"][k]), k


def test_full_train_step_matches(ranks, inputs):
    import jax.numpy as jnp
    from fisher_nerf_customized_tpu.parallel.sharding import (
        full_train_step as jfull_step)
    sl, jslam = inputs["slice"], inputs["jax_slam"]
    state, loss, scores = jfull_step(_jax_mesh(2), jslam.camera,
                                     jslam.settings, jslam.mc)(
        jslam.state, *(jnp.asarray(sl[k]) for k in
                       ("colors", "depths", "frame_w2cs", "w2cs", "h_inv")))
    ref = {k: np.asarray(getattr(state, k)) for k in LR_KEYS}
    for out in ranks:
        got = out["full_train_step"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-4)
        np.testing.assert_allclose(got["scores"], np.asarray(scores),
                                   rtol=5e-3)
        _within_adam_bound(got, ref, sl["mc"], 1)
    assert np.array_equal(ranks[0]["full_train_step"]["scores"],
                          ranks[1]["full_train_step"]["scores"])


def test_multi_scene_train_step_matches(ranks, inputs):
    import jax
    import jax.numpy as jnp
    from fisher_nerf_customized_tpu.models.gaussian_state import (
        adam_init as jadam_init)
    from fisher_nerf_customized_tpu.models.slam import (
        MappingConfig as JMappingConfig)
    from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
    from fisher_nerf_customized_tpu.ops.rasterize import (
        RenderSettings as JSettings)
    from fisher_nerf_customized_tpu.parallel.sharding import (
        multi_scene_train_step as jmulti)
    ms = inputs["multi_scene"]
    params = {k: jnp.asarray(v) for k, v in ms["params"].items()}
    fn = jmulti(_jax_mesh(2), JCamera(**ms["cam"]), JSettings(**ms["settings"]),
                JMappingConfig(**ms["mc"]))
    new_params, _opt, losses = fn(params, jax.vmap(jadam_init)(params),
                                  jnp.asarray(ms["n_active"]),
                                  jnp.asarray(ms["colors"]),
                                  jnp.asarray(ms["depths"]),
                                  jnp.asarray(ms["w2cs"]))
    ref = {k: np.asarray(v) for k, v in new_params.items()}
    assert len(np.unique(np.round(np.asarray(losses), 6))) > 1
    for out in ranks:
        got = out["multi_scene"]
        np.testing.assert_allclose(got["losses"], np.asarray(losses),
                                   rtol=1e-4)
        _within_adam_bound(got, ref, ms["mc"], 1)
        assert not np.allclose(got["means3D"], ms["params"]["means3D"])


def test_multi_scene_occ_update_is_bitwise(ranks, inputs):
    import jax.numpy as jnp
    from fisher_nerf_customized_tpu.parallel import (
        multi_scene_occ_update as jocc_update)
    oc, jslam = inputs["occ"], inputs["jax_slam"]
    occs, cams = jocc_update(_jax_mesh(2), jslam.camera)(
        jnp.asarray(oc["occs"]), jnp.asarray(oc["depths"]),
        jnp.asarray(oc["c2ws"]), oc["cell"], jnp.asarray(oc["centers"]),
        0.2, 1.5, 3.0)
    assert np.asarray(occs)[:, 1].sum() > 0
    for out in ranks:
        np.testing.assert_array_equal(out["occ"]["occs"], np.asarray(occs))
        np.testing.assert_array_equal(out["occ"]["cams"], np.asarray(cams))
