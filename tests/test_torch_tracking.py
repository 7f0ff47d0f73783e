"""Optimized tracking, JAX package against the PyTorch port on the CPU.

The map: the JAX package maps the 5 FakeSim frames of
tests/test_torch_mapping.py (64x64, its Pallas forward and backward
blends in interpret mode), and the port gets the same state; the
tracked frame is the next one, from a start pose moved by (2, -1, 3) cm
and about 1 degree.  Then the same tracked run in both packages from
scratch, and the port alone recovering a perturbed pose.

Tolerances, each with its reason:
  * quaternion helpers: atol 1e-6 (the same f32 formulas);
  * the loss and depth loss: rtol 1e-4; the (q, t) gradient: 1e-4 of its
    largest component (the renders agree to f32 rounding; the SUM over
    4096 pixels rounds in another order);
  * a tracking phase's best pose: within 2 lr x num_iters per coordinate
    (Adam's steps have size about lr whatever the gradient's size, so a
    component near 0 can take opposite signs in the two packages; each
    step can part them by at most about 2 lr), its best loss rtol 1e-4
    (the loss of poses that agree to that bound differs by much less
    near a minimum), the last step's depth loss rtol 1e-3 (taken at the
    last pre-step pose, not at a minimum);
  * tracked poses of the two runs: within the same bound, summed over
    the phases they ran.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.config import get_cfg_defaults as jcfg
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene, FakeSim
from fisher_nerf_customized_tpu.models import slam as jslam
from fisher_nerf_customized_tpu.ops.camera import Camera
from fisher_nerf_customized_tpu.utils import geometry as jgeo
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.engine.eval import evaluate_ate
from fisher_nerf_customized_tpu_torch.models import gaussian_state as tgs
from fisher_nerf_customized_tpu_torch.models import slam as tslam
from fisher_nerf_customized_tpu_torch.utils import geometry as tgeo

from test_torch_mapping import ACTIONS, IMG, make_cfg

N_ITERS = 8
SHIFT = np.array([0.02, -0.01, 0.03], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rot(axis, ang):
    c, s = np.cos(ang), np.sin(ang)
    i, j = [a for a in range(3) if a != axis]
    m = np.eye(3)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.asarray(jgeo.quat_to_rotmat(jnp.asarray(q, jnp.float32)))


@pytest.mark.parametrize("case", ["random", "x180", "y180", "z180"])
def test_quaternion_helpers_match_jax(case):
    rng = np.random.default_rng(0)
    if case == "random":
        mats = random_rotations(rng, 64)
    else:
        # near 180 degrees about one axis, so that the candidate with that
        # axis' component is taken; a few near 0 take the w candidate
        axis = "xyz".index(case[0])
        angs = np.concatenate([np.pi - rng.uniform(0, 1e-3, 12),
                               rng.uniform(0, 1e-3, 4)])
        mats = np.stack([rot(axis, a) @ rot((axis + 1) % 3,
                                            rng.uniform(-1e-3, 1e-3))
                         for a in angs]).astype(np.float32)
    mats = mats.astype(np.float32)
    ref_q = np.asarray(jgeo.rotmat_to_quat(jnp.asarray(mats)))
    got_q = tgeo.rotmat_to_quat(torch.from_numpy(mats)).numpy()
    np.testing.assert_allclose(got_q, ref_q, atol=1e-6)
    if case != "random":
        diag = np.einsum("nii->ni", mats)
        q_abs = np.stack([1 + diag.sum(1), 1 + diag[:, 0] - diag[:, 1]
                          - diag[:, 2], 1 - diag[:, 0] + diag[:, 1]
                          - diag[:, 2], 1 - diag[:, 0] - diag[:, 1]
                          + diag[:, 2]], 1)
        assert set(q_abs.argmax(1).tolist()) == {0, "xyz".index(case[0]) + 1}
    ref_m = np.asarray(jgeo.quat_to_rotmat(jnp.asarray(ref_q)))
    np.testing.assert_allclose(
        tgeo.quat_to_rotmat(torch.from_numpy(ref_q)).numpy(), ref_m,
        atol=1e-6)
    q2 = rng.normal(size=ref_q.shape).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.quat_mult(torch.from_numpy(ref_q), torch.from_numpy(q2)).numpy(),
        np.asarray(jgeo.quat_mult(jnp.asarray(ref_q), jnp.asarray(q2))),
        atol=1e-6)


def frames_of(actions, sim=None):
    cam = Camera(fx=IMG / 2, fy=IMG / 2, cx=IMG / 2, cy=IMG / 2, width=IMG,
                 height=IMG)
    sim = sim or FakeSim(BoxScene.multi_room(seed=3), cam, forward_step=0.25,
                         turn_angle=30.0)
    obs = [sim.reset(yaw=0.3)] + [sim.step(a) for a in actions]
    return [(np.array(o["rgb"]), np.array(o["depth"]),
             np.linalg.inv(o["c2w"]).astype(np.float32)) for o in obs]


def tracking_cfg(get_defaults, workdir):
    cfg = make_cfg(get_defaults, workdir)
    cfg.tracking.num_iters = N_ITERS
    return cfg


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The JAX package's map of the 5 frames, the port's copy of it, and
    the next frame with its pose."""
    tmp = tmp_path_factory.mktemp("tracking")
    frames = frames_of(ACTIONS + [1])
    js = jslam.GaussianSLAM(make_cfg(jcfg, tmp / "jax"))
    for color, depth, w2c in frames[:-1]:
        js.track_rgbd(color, depth, gt_w2c=w2c)
    state = {k: np.asarray(getattr(js.state, k))
             for k in tgs.PARAM_KEYS + ("timestep", "n_active")}
    return dict(js=js, state=state, frames=frames, tmp=tmp,
                tc=js.tc._replace(num_iters=N_ITERS),
                poses=list(js.poses_w2c))


def port_slam(scene, cfg):
    ts = tslam.GaussianSLAM(cfg, device="cpu")
    ts.state = tgs.state_from_numpy(scene["state"], scene["js"].state.capacity,
                                    device="cpu")
    ts.poses_w2c = list(scene["js"].poses_w2c)
    ts.initialized = True
    return ts


def start_pose(w2c):
    """The frame's pose moved by SHIFT and turned about 1 degree, as a
    wxyz quaternion and a translation."""
    w2c = w2c.copy()
    w2c[:3, :3] = (rot(1, 0.017) @ w2c[:3, :3]).astype(np.float32)
    w2c[:3, 3] += SHIFT
    q = np.asarray(jgeo.rotmat_to_quat(jnp.asarray(w2c[:3, :3])))
    return q, w2c[:3, 3].copy()


def inputs(scene, **tc):
    """(JAX slam, port slam, q0, t0, color, depth) for the next frame,
    both slams with the tracking settings `tc` over the module's."""
    js = scene["js"]
    js.tc = scene["tc"]._replace(**tc)
    js.poses_w2c = list(scene["poses"])
    js.forward_prop = True
    ts = port_slam(scene, tracking_cfg(tcfg, scene["tmp"] / "port"))
    ts.tc = ts.tc._replace(**tc)
    assert ts.tc == js.tc
    color, depth, w2c = scene["frames"][-1]
    q0, t0 = start_pose(w2c)
    return js, ts, q0, t0, color, depth


@pytest.mark.parametrize("sil,outlier", [(True, False), (False, False),
                                         (True, True), (False, True)])
def test_tracking_loss_and_gradient_match_jax(scene, sil, outlier):
    js, ts, q0, t0, color, depth = inputs(
        scene, use_sil_for_loss=sil, ignore_outlier_depth_loss=outlier)
    # an even pixel count: the median averages the two middle errors
    assert depth.size % 2 == 0
    params = js.state.params()
    fn = jax.value_and_grad(
        lambda q, t: jslam._tracking_loss(
            q, t, params, js.state.n_active, jnp.asarray(color),
            jnp.asarray(depth), js.camera, js.settings, js.tc),
        argnums=(0, 1), has_aux=True)
    (ref_loss, ref_dl), (ref_gq, ref_gt) = fn(jnp.asarray(q0),
                                              jnp.asarray(t0))
    q = torch.from_numpy(q0).requires_grad_()
    t = torch.from_numpy(t0).requires_grad_()
    loss, depth_l = tslam._tracking_loss(
        q, t, ts.state.params(), ts.state.n_active, torch.from_numpy(color),
        torch.from_numpy(depth), ts.camera, ts.settings, ts.tc)
    gq, gt_ = torch.autograd.grad(loss, [q, t])
    assert float(ref_loss) > 0 and float(ref_dl) > 0
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    np.testing.assert_allclose(float(depth_l), float(ref_dl), rtol=1e-4)
    for got, ref in ((gq, ref_gq), (gt_, ref_gt)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-4 * np.abs(ref).max())


def test_tracking_phase_matches_jax(scene):
    js, ts, q0, t0, color, depth = inputs(scene)
    ref = jslam._tracking_phase(js.state, jnp.asarray(q0), jnp.asarray(t0),
                                jnp.asarray(color), jnp.asarray(depth),
                                js.camera, js.settings, js.tc)
    got = tslam._tracking_phase(ts.state, torch.from_numpy(q0),
                                torch.from_numpy(t0),
                                torch.from_numpy(color),
                                torch.from_numpy(depth), ts.camera,
                                ts.settings, ts.tc)
    best_q, best_t, best_loss, depth_l, losses = got
    assert losses.shape == (N_ITERS,) and bool(torch.isfinite(losses).all())
    # the phase improves on its start and keeps the best post-step pose
    assert float(best_loss) == float(losses.min()) < float(losses[0])
    np.testing.assert_allclose(float(best_loss), float(ref[2]), rtol=1e-4)
    np.testing.assert_allclose(float(depth_l), float(ref[3]), rtol=1e-3)
    tc = ts.tc
    assert np.abs(best_q.numpy() - np.asarray(ref[0])).max() \
        <= 2 * tc.lr_rot * N_ITERS
    assert np.abs(best_t.numpy() - np.asarray(ref[1])).max() \
        <= 2 * tc.lr_trans * N_ITERS


def count_phases(monkeypatch, module):
    calls = []
    fn = module._tracking_phase

    def counting(*args, **kwargs):
        calls.append(args[-1].num_iters)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, "_tracking_phase", counting)
    return calls


def test_track_pose_forward_prop_and_doubling_match_jax(scene, monkeypatch):
    """_track_pose from three prior poses (the constant-velocity guess)
    with a depth-loss threshold low enough that both packages double."""
    js, ts, _q0, _t0, color, depth = inputs(
        scene, depth_loss_thres=1.0, use_depth_loss_thres=True)
    assert ts.forward_prop
    # the frame's pose two frames back and one frame back, as if the
    # camera had been moving by SHIFT per frame
    w2c = scene["frames"][-1][2]
    priors = []
    for back in (3, 2, 1):
        p = w2c.copy()
        p[:3, 3] -= back * SHIFT / 2
        priors.append(p)
    js.poses_w2c, ts.poses_w2c = list(priors), list(priors)
    j_calls = count_phases(monkeypatch, jslam)
    t_calls = count_phases(monkeypatch, tslam)
    ref = js._track_pose(jnp.asarray(color), jnp.asarray(depth))
    got = ts._track_pose(torch.from_numpy(color), torch.from_numpy(depth))
    assert j_calls == t_calls == [N_ITERS, 2 * N_ITERS]
    # the start: q_prev (x) (conj(q_prev2) (x) q_prev), 2 t_prev - t_prev2
    assert np.abs(got[:3, 3] - ref[:3, 3]).max() \
        <= 2 * ts.tc.lr_trans * 3 * N_ITERS
    assert np.abs(got[:3, :3] - ref[:3, :3]).max() \
        <= 4 * ts.tc.lr_rot * 3 * N_ITERS
    np.testing.assert_allclose(got[3], [0, 0, 0, 1])


def test_constant_velocity_start_matches_jax(scene, monkeypatch):
    """The start pose of the first phase: both packages are handed the
    same poses and their first phase's (q0, t0) is captured."""
    js, ts, _q0, _t0, color, depth = inputs(scene,
                                            use_depth_loss_thres=False)
    rng = np.random.default_rng(4)
    priors = []
    for i in range(3):
        p = np.eye(4, dtype=np.float32)
        p[:3, :3] = random_rotations(rng, 1)[0]
        p[:3, 3] = rng.normal(size=3)
        priors.append(p)
    js.poses_w2c, ts.poses_w2c = list(priors), list(priors)
    starts = {}

    def capture(name, n_out):
        def phase(state, q0, t0, *rest):
            starts[name] = (np.asarray(q0), np.asarray(t0))
            return (q0, t0, 0.0, 0.0, None)[:n_out]
        return phase

    monkeypatch.setattr(jslam, "_tracking_phase", capture("jax", 4))
    monkeypatch.setattr(tslam, "_tracking_phase", capture("port", 5))
    js._track_pose(jnp.asarray(color), jnp.asarray(depth))
    ts._track_pose(torch.from_numpy(color), torch.from_numpy(depth))
    np.testing.assert_allclose(starts["port"][0], starts["jax"][0], atol=1e-6)
    np.testing.assert_allclose(starts["port"][1], starts["jax"][1], atol=1e-6)


def test_tracked_run_matches_jax(tmp_path, monkeypatch):
    """The mapping test's 5 frames with ground-truth poses, then 3 tracked
    frames (a mapping event on the tracked pose between them), in both
    packages: the same number of phases and steps, and the tracked poses
    within the Adam bound."""
    frames = frames_of(ACTIONS + [1, 2, 1])
    js = jslam.GaussianSLAM(tracking_cfg(jcfg, tmp_path / "jax"))
    ts = tslam.GaussianSLAM(tracking_cfg(tcfg, tmp_path / "port"),
                            device="cpu")
    j_calls = count_phases(monkeypatch, jslam)
    t_calls = count_phases(monkeypatch, tslam)
    for i, (color, depth, w2c) in enumerate(frames):
        tracked = i >= 5
        for slam in (js, ts):
            slam.use_gt_poses = not tracked
            slam.track_rgbd(color, depth, gt_w2c=w2c)
    assert j_calls == t_calls and len(t_calls) >= 3
    bound_t = 2 * ts.tc.lr_trans * sum(t_calls)
    for got, ref in zip(ts.poses_w2c[5:], js.poses_w2c[5:]):
        assert np.abs(got[:3, 3] - ref[:3, 3]).max() <= bound_t
        np.testing.assert_allclose(got[:3, :3], ref[:3, :3],
                                   atol=4 * ts.tc.lr_rot * sum(t_calls))
    assert ts.n_active == js.n_active


def test_tracking_recovers_pose_perturbation(tmp_path):
    """The port version of tests/test_knn_tracking.py's test: a map from 9
    frames with ground-truth poses, then 3 tracked forward steps; the
    mean translation error stays under the 3 cm step."""
    img = 48
    cfg = tcfg()
    cfg.SLAM.Dataset.Calibration.merge_from_other(dict(
        fx=float(img), fy=float(img), cx=img / 2, cy=img / 2,
        width=img, height=img))
    cfg.workdir = str(tmp_path)
    cfg.downsample_pcd = 1
    cfg.tracking.use_gt_poses = False
    cfg.tracking.num_iters = 60
    cfg.tracking.lrs.cam_trans = 0.004
    cfg.tracking.lrs.cam_unnorm_rots = 0.001
    cfg.tracking.use_depth_loss_thres = False
    cfg.tpu.capacity = 8192
    cfg.tpu.tile_size = 8
    cfg.tpu.max_per_tile = 512
    cfg.map_every = 2
    cfg.keyframe_every = 2
    cfg.mapping.num_iters = 15

    from fisher_nerf_customized_tpu_torch.envs.fake_sim import (
        BoxScene as TScene, FakeSim as TSim)
    from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCam
    cam = TCam(fx=float(img), fy=float(img), cx=img / 2, cy=img / 2,
               width=img, height=img)
    sim = TSim(TScene(room_lo=(-2, 0, -2), room_hi=(2, 2.5, 2),
                      obstacles=[((0.5, 0, 0.8), (1.0, 1.5, 1.3))]), cam,
               forward_step=0.03, turn_angle=10.0, device="cpu")
    slam = tslam.GaussianSLAM(cfg, device="cpu")
    slam.use_gt_poses = True
    obs = sim.reset(yaw=0.3)
    slam.init(obs["rgb"], obs["depth"], np.linalg.inv(obs["c2w"]))
    for a in (2, 1, 3, 1, 3, 1, 2, 1):
        obs = sim.step(a)
        slam.track_rgbd(obs["rgb"], obs["depth"],
                        gt_w2c=np.linalg.inv(obs["c2w"]))
    slam.use_gt_poses = False
    errs, gt_c2ws = [], []
    for _ in range(3):
        obs = sim.step(1)
        slam.track_rgbd(obs["rgb"], obs["depth"])
        est_c2w = np.linalg.inv(slam.poses_w2c[-1])
        gt_c2ws.append(obs["c2w"])
        errs.append(np.linalg.norm(obs["c2w"][:3, 3] - est_c2w[:3, 3]))
    assert np.mean(errs) < 0.03, f"tracking errors: {errs}"
    est = np.linalg.inv(np.stack(slam.poses_w2c[-3:]))
    assert evaluate_ate(np.stack(gt_c2ws), est) < 0.03


# The JAX package's position errors (m) on the first four tracked frames
# of chip_smoke.py's `tracking` phase (fake_apartment_0 at the full width
# of configs/mp3d_gaussian_FR_eccv.yaml, optimized tracking): the init
# frame again, then three 10-degree turns of the scripted init scan.
# chip_smoke.py holds the port's tracked frames on the card to them.
JAX_SCAN_ERRORS_M = (0.0315608, 0.182126, 0.460087, 0.728978)


def test_jax_tracking_drifts_on_the_init_scan(tmp_path):
    """The reference's tracking with the shipped settings cannot follow the
    init scan's 10-degree turns (a phase moves each quaternion component
    by at most 40 x 0.0004): its position errors grow frame by frame.  The
    frames come before the first mapping event and the first planning
    event, so they are the same on every device."""
    import zlib
    img = 256
    cfg = jcfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..",
                                     "configs", "mp3d_gaussian_FR_eccv.yaml"))
    cfg.workdir = str(tmp_path)
    cfg.tracking.use_gt_poses = False
    assert int(cfg.SLAM.Dataset.Calibration.width) == img
    cam = Camera(fx=img / 2, fy=img / 2, cx=img / 2, cy=img / 2, width=img,
                 height=img)
    seed = zlib.crc32(b"fake_apartment_0") % (2 ** 31)
    sim = FakeSim(BoxScene.multi_room(seed=seed), cam,
                  forward_step=float(cfg.forward_step_size),
                  turn_angle=float(cfg.turn_angle))
    slam = jslam.GaussianSLAM(cfg)
    obs = sim.get_observations()
    slam.init(obs["rgb"], obs["depth"], np.linalg.inv(obs["c2w"]))
    errs = []
    for action in (None, 2, 2, 2):
        if action is not None:
            obs = sim.step(action)
        slam.track_rgbd(obs["rgb"], obs["depth"],
                        gt_w2c=np.linalg.inv(obs["c2w"]))
        est = np.linalg.inv(slam.poses_w2c[-1])
        errs.append(float(np.linalg.norm(est[:3, 3] - obs["c2w"][:3, 3])))
    np.testing.assert_allclose(errs, JAX_SCAN_ERRORS_M, rtol=1e-2)
