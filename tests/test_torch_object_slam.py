"""The object branch's SLAM, JAX package against the PyTorch port on the
CPU: SimObject and the semantic frames, GaussianObjectSLAM's init and
masked mapping events, the outside-mask prune, the object H_train (full
and topped up), the pose scores under every criterion and the object path
scores.  48x48 frames, tile 8, the settings of the JAX package's
tests/test_object_slam.py; the JAX package runs its Pallas forward and
backward blends (`tpu.blend_backward = "pallas"`, interpret mode), whose
conventions K1 and K2 follow.

The Hutchinson probes: torch cannot reproduce jax.random, so the port's
`probe_draw` is fed the JAX package's own draws for the same keys
(`JaxDraws`: fold_in(PRNGKey(start + 7919), kf_id) per keyframe, the
c-th split of PRNGKey(start) for the c-th draw of the stream, and
fold_in of it by pose index for candidate poses).

Tolerances, each with its reason:
  * SimObject positions and semantic frames: exact (the same numpy
    stream, and the raycast follows the JAX package's arithmetic);
  * mapping: n_active exact; losses rtol 1e-4; parameters per group
    |port - JAX| <= 2 lr x (Adam steps taken), as tests/test_torch_mapping
    .py (an eps = 1e-15 Adam step moves a coordinate by lr in its
    gradient's sign, and a gradient at the f32 noise floor can take
    opposite signs in the two packages);
  * Hessians from the same map and probes: rtol 1e-4 with an atol of
    1e-6 of the largest entry (f32 sums over pixels in another order);
  * scores: rtol 1e-4 (fisher), 1e-5 (topt, dopt: sums over 8192 rows of
    terms that agree to 1e-4), with the same argmax;
  * block T-opt and D-opt scores: rtol 1e-2 and the same argmax.  A
    K-probe block is rank-deficient; its eigenvalues near 0 come out of
    the two packages' f32 eigensolvers (eigvalsh) at the solvers' own
    rounding, and 1/(ev + 1e-6) or log(ev + 1e-6) magnify that, so the
    scores part by a few 1e-3 even from blocks that agree to 1e-4
    (tests/test_torch_hutchinson.py holds the blocks themselves).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.config import get_cfg_defaults as jcfg
from fisher_nerf_customized_tpu.envs import fake_sim as jsim
from fisher_nerf_customized_tpu.models import object_slam as jos
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.envs import fake_sim as tsim
from fisher_nerf_customized_tpu_torch.models import object_slam as tos
from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
    PARAM_KEYS, state_to_numpy)
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

IMG = 48
LR_KEYS = dict(means3D="lr_means3D", rgb_colors="lr_rgb",
               unnorm_rotations="lr_rots", logit_opacities="lr_logit_op",
               log_scales="lr_log_scales")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def obj_cfg(get_defaults, tmp_path, probes=4):
    cfg = get_defaults()
    cfg.SLAM.Dataset.Calibration.merge_from_other(dict(
        fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
        width=IMG, height=IMG))
    cfg.workdir = str(tmp_path)
    cfg.map_obj_every = 2
    cfg.keyframe_obj_every = 2
    cfg.downsample_pcd = 1
    cfg.mapping.num_iters = 8
    cfg.tpu.capacity = 4096
    cfg.tpu.tile_size = 8
    cfg.tpu.max_per_tile = 512
    cfg.tpu.hutchinson_probes = probes
    cfg.tpu.blend_backward = "pallas"       # read by the JAX package only
    return cfg


def make_sims(seed=0, start_xz=(0.0, 1.5)):
    out = []
    for mod, cam_cls in ((jsim, JCamera), (tsim, TCamera)):
        cam = cam_cls(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                      width=IMG, height=IMG)
        scene = mod.BoxScene(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                             obstacles=[])
        obj = mod.SimObject(scene, semantic_id=100, size=(0.5, 1.0, 0.5),
                            start_xz=start_xz, seed=seed)
        kw = {} if mod is jsim else dict(device="cpu")
        out.append(mod.FakeSim(scene, cam, forward_step=0.1, turn_angle=30.0,
                               dynamic_object=obj, **kw))
    return out


class JaxDraws:
    """The JAX GaussianObjectSLAM's probe draws, named as the port's
    GaussianObjectSLAM names them."""

    def __init__(self, start_frame_idx: int, height: int = IMG,
                 width: int = IMG):
        self.start = start_frame_idx
        self.shape = (height, width, 3)
        self._key = jax.random.PRNGKey(start_frame_idx)
        self._subs = []

    def key(self, c):
        while len(self._subs) <= c:
            self._key, sub = jax.random.split(self._key)
            self._subs.append(sub)
        return self._subs[c]

    def __call__(self, seed, n_probes):
        tag, *ids = seed
        if tag == "kf":
            k = jax.random.fold_in(jax.random.PRNGKey(self.start + 7919),
                                   ids[0])
        elif tag == "key":
            k = self.key(ids[0])
        else:
            k = jax.random.fold_in(self.key(ids[0]), ids[1])
        z = jax.random.normal(k, (n_probes,) + self.shape, jnp.float32)
        return torch.from_numpy(np.array(z))


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_sim_object_walk_and_semantic_frames_match_jax():
    jsm, tsm = make_sims(seed=1)
    jobs = jsm.reset(start_xz=(0.0, 0.0), yaw=0.0)
    tobs = tsm.reset(start_xz=(0.0, 0.0), yaw=0.0)
    for i in range(50):
        np.testing.assert_array_equal(tsm.dynamic_object.pos,
                                      jsm.dynamic_object.pos)
        assert tsm.dynamic_object.yaw == jsm.dynamic_object.yaw
        if i % 5 == 0:
            np.testing.assert_array_equal(tobs["semantic"], jobs["semantic"])
            np.testing.assert_array_equal(host(tobs["depth"]),
                                          host(jobs["depth"]))
        jsm.dynamic_object.moving_randomly()
        tsm.dynamic_object.moving_randomly()
        jobs, tobs = jsm.get_observations(), tsm.get_observations()
    assert (tobs["semantic"] == 100).sum() > 0
    pts_t = tsm.dynamic_object.sample_surface_points(500, frame="object")
    pts_j = jsm.dynamic_object.sample_surface_points(500, frame="object")
    np.testing.assert_array_equal(pts_t, pts_j)


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """Both packages' object SLAM over the same frames: init and 5
    track_rgbd steps, 3 masked mapping events."""
    tmp = tmp_path_factory.mktemp("objslam")
    jsm, tsm = make_sims()
    js = jos.GaussianObjectSLAM(obj_cfg(jcfg, tmp / "j"))
    ts = tos.GaussianObjectSLAM(obj_cfg(tcfg, tmp / "t"), device="cpu")
    losses = {"jax": [], "torch": []}
    jobs = jsm.reset(start_xz=(0.0, 0.0), yaw=0.0)
    tobs = tsm.reset(start_xz=(0.0, 0.0), yaw=0.0)
    n0 = []
    for t, a in enumerate([None, 1, 2, 3, 1, 1]):
        if a is not None:
            jobs, tobs = jsm.step(a), tsm.step(a)
        mask = np.asarray(jobs["semantic"]) == 100
        w2c = np.linalg.inv(jobs["c2w"])
        if t == 0:
            n0 = [js.init(jobs["rgb"], jobs["depth"], w2c, mask),
                  ts.init(tobs["rgb"], tobs["depth"], w2c, mask)]
            continue
        for slam, obs, key in ((js, jobs, "jax"), (ts, tobs, "torch")):
            before = slam.last_losses
            slam.track_rgbd(obs["rgb"], obs["depth"], gt_w2c=w2c,
                            obj_mask_2d=mask, step=t)
            if slam.last_losses is not before:
                losses[key].append(host(slam.last_losses))
    return dict(js=js, ts=ts, jsm=jsm, tsm=tsm, losses=losses, n0=n0,
                mask=mask, w2c=w2c)


def test_object_init_and_mapping_events_match_jax(mapped):
    js, ts = mapped["js"], mapped["ts"]
    assert mapped["n0"][0] == mapped["n0"][1] > 0
    assert len(mapped["losses"]["jax"]) == len(mapped["losses"]["torch"]) == 3
    for got, ref in zip(mapped["losses"]["torch"], mapped["losses"]["jax"]):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert ts.n_active == js.n_active > 0
    assert ts.state.capacity == js.state.capacity == 8192
    # the overflow guard doubles K from 64 alike in both
    assert ts.settings.max_per_tile == js.settings.max_per_tile >= 64
    assert ts.keyframes.ids == js.keyframes.ids
    assert ts.rng.integers(1 << 30) == js.rng.integers(1 << 30)
    n = ts.n_active
    got = state_to_numpy(ts.state)
    n_steps = 3 * ts.mc.num_iters
    for k in PARAM_KEYS:
        err = np.abs(got[k][:n] - np.asarray(getattr(js.state, k))[:n])
        lr = getattr(ts.mc, LR_KEYS[k])
        assert err.max() <= 2 * lr * n_steps + 1e-6, (k, err.max(), lr)


def test_project_outside_mask_matches_jax(mapped):
    js, ts = mapped["js"], mapped["ts"]
    # the same Gaussians in both, with the mask of a shifted frame
    st = {k: np.asarray(v) for k, v in js.state._asdict().items()}
    mask = np.roll(mapped["mask"], 5, axis=1)
    opac = 1 / (1 + np.exp(-st["logit_opacities"][:, 0]))
    ref = jos._project_outside_mask(
        jnp.asarray(st["means3D"]), js.state.n_active,
        jnp.asarray(mapped["w2c"], jnp.float32), jnp.asarray(mask),
        jnp.asarray(opac), js.camera, 0.01)
    got = tos._project_outside_mask(
        torch.from_numpy(st["means3D"]), int(js.state.n_active),
        torch.from_numpy(mapped["w2c"].astype(np.float32)),
        torch.from_numpy(mask), torch.from_numpy(opac), ts.camera, 0.01)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(host(g), np.asarray(r))
    assert host(got[0]).sum() > 0 and host(got[1]).sum() > 0


@pytest.fixture(scope="module")
def same_map(mapped, tmp_path_factory):
    """A port object SLAM carrying the JAX one's map, keyframes and masks
    (set_from_numpy), fed the JAX draws; and the JAX one, its draws
    restarted."""
    js = mapped["js"]
    cfg = obj_cfg(tcfg, tmp_path_factory.mktemp("same"))
    ts = tos.GaussianObjectSLAM(cfg, device="cpu")
    kf = js.keyframes
    ts.set_from_numpy(
        {k: np.asarray(v) for k, v in js.state._asdict().items()},
        keyframes=dict(colors=[np.asarray(c) for c in kf.colors],
                       depths=[np.asarray(d) for d in kf.depths],
                       w2cs=list(kf.w2cs), ids=list(kf.ids)),
        masks=js.keyframe_masks, poses_w2c=js.poses_w2c)
    ts.settings = ts.settings._replace(max_per_tile=js.settings.max_per_tile)
    ts.probe_draw = JaxDraws(ts.start_frame_idx)
    js._key = jax.random.PRNGKey(js.start_frame_idx)
    js._h11_cache = None
    return js, ts


def assert_h_close(got, ref, rtol=1e-4):
    got, ref = host(got), np.asarray(ref)
    assert np.isfinite(got).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-6 * np.abs(ref).max())


def test_h_train_full_and_topped_up_match_jax(same_map):
    js, ts = same_map
    n_kf = len(js.keyframes)
    assert n_kf >= 3
    full_t = ts.compute_H_train_obj()
    assert_h_close(full_t, js.compute_H_train_obj())
    # drop the last keyframe, sum, append it again: the top-up must equal
    # the full sum (each keyframe's probes depend on its id alone)
    last = (ts.keyframes.colors.pop(), ts.keyframes.depths.pop(),
            ts.keyframes.w2cs.pop(), ts.keyframes.ids.pop())
    ts._h11_cache = None
    ts.compute_H_train_obj()
    ts.keyframes.append(last[0], last[1], last[2], last[3])
    topped = ts.compute_H_train_obj()
    np.testing.assert_allclose(host(topped), host(full_t), rtol=1e-6,
                               atol=1e-7 * float(full_t.abs().max()))


@pytest.mark.parametrize("criterion", ["fisher", "topt", "dopt"])
def test_pose_scores_match_jax(same_map, criterion):
    js, ts = same_map
    c2w = np.linalg.inv(js.poses_w2c[-1])
    poses = np.stack([c2w] * 10).astype(np.float32)
    rng = np.random.default_rng(0)
    poses[:, [0, 2], 3] += rng.uniform(-0.4, 0.4, (10, 2))
    # both streams from their start: the scores draw one key each
    js._key = jax.random.PRNGKey(js.start_frame_idx)
    ts._draws = 0
    if criterion == "fisher":
        ref, _ = js.pose_eval(poses)
        got, _ = ts.pose_eval(poses)
        rtol = 1e-4
    else:
        ref, _ = js.pose_eval_popgs(poses, criterion=criterion, K=2)
        got, _ = ts.pose_eval_popgs(poses, criterion=criterion, K=2)
        rtol = 1e-5
    ref, got = np.asarray(ref), host(got)
    assert np.isfinite(got).all() and len(np.unique(got)) > 1
    np.testing.assert_allclose(got, ref, rtol=rtol)
    assert int(got.argmax()) == int(ref.argmax())


@pytest.mark.parametrize("criterion", ["topt", "dopt"])
def test_pose_scores_blocks_match_jax(same_map, criterion):
    js, ts = same_map
    c2w = np.linalg.inv(js.poses_w2c[-1])
    poses = np.tile(c2w.astype(np.float32), (3, 1, 1))
    poses[1, 0, 3] += 0.2
    poses[2, 2, 3] -= 0.3
    js._key = jax.random.PRNGKey(js.start_frame_idx)
    js._blocks_cache = None
    ts._draws = 0
    ts._blocks_cache = None
    ref, _ = js.pose_eval_popgs_blocks(poses, criterion=criterion, K=2)
    got, _ = ts.pose_eval_popgs_blocks(poses, criterion=criterion, K=2)
    ref, got = np.asarray(ref), host(got)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-2)
    assert int(got.argmax()) == int(ref.argmax())


@pytest.mark.parametrize("criterion", ["fisher", "topt"])
def test_object_path_scores_match_jax(same_map, criterion):
    js, ts = same_map
    c2w = np.linalg.inv(js.poses_w2c[-1]).astype(np.float32)
    p_max, n_acc, probes = 4, 3, 2
    rng = np.random.default_rng(1)
    w2cs = np.tile(np.linalg.inv(c2w), (p_max, n_acc, 1, 1)).astype(
        np.float32)
    w2cs[..., [0, 2], 3] += rng.uniform(-0.3, 0.3, (p_max, n_acc, 2))
    valid = np.ones((p_max, n_acc), bool)
    valid[3, 1:] = False
    lengths = np.array([7, 12, 3, 1], np.int32)
    fe = rng.uniform(-2, 2, p_max).astype(np.float32)
    h11 = np.asarray(js.compute_H_train_obj(n_probes=probes))
    lam = 1e-6 if criterion == "topt" else 0.1
    keys = jnp.stack([jax.random.PRNGKey(100 + i)
                      for i in range(n_acc * p_max)]).reshape(n_acc, p_max, 2)
    params = js.state.params()
    ref = jos.object_path_scores(
        params, js.state.n_active, jnp.asarray(h11), jnp.asarray(w2cs),
        jnp.asarray(valid), jnp.asarray(lengths), jnp.asarray(fe), keys, lam,
        1.0, 30.0, js.camera, js.settings, probes, criterion)

    def draws(s):
        return torch.stack([torch.from_numpy(np.array(jax.random.normal(
            keys[s, p], (probes, IMG, IMG, 3), jnp.float32)))
            for p in range(p_max)])
    got = tos.object_path_scores(
        ts.state.params(), ts.state.n_active, torch.from_numpy(h11),
        torch.from_numpy(w2cs), torch.from_numpy(valid),
        torch.from_numpy(lengths), torch.from_numpy(fe), draws, lam, 1.0,
        30.0, ts.camera, ts.settings, criterion)
    ref, got = np.asarray(ref), host(got)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert int(got.argmax()) == int(ref.argmax())


def test_single_pose_estimates_match_jax(same_map):
    """compute_Hessian, estimate_diag_JtJ_simple and estimate_block_JtJ at
    one pose, each one draw of the stream."""
    js, ts = same_map
    w2c = np.asarray(js.poses_w2c[-1], np.float32)
    js._key = jax.random.PRNGKey(js.start_frame_idx)
    ts._draws = 0
    assert_h_close(ts.compute_Hessian(w2c, return_points=True),
                   js.compute_Hessian(w2c, return_points=True))
    got, n_vis = ts.estimate_diag_JtJ_simple(w2c, K=2)
    ref, ref_vis = js.estimate_diag_JtJ_simple(w2c, K=2)
    assert n_vis == ref_vis > 0
    assert_h_close(got, ref)
    got_b, got_idx = ts.estimate_block_JtJ(w2c, K=2)
    ref_b, ref_idx = js.estimate_block_JtJ(w2c, K=2)
    np.testing.assert_array_equal(got_idx, ref_idx)
    assert_h_close(got_b, ref_b)
