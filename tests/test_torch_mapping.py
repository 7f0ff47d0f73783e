"""The mapping path, JAX package against the PyTorch port on the CPU.

Small units first (Adam, prune_compact, keyframe selection), then the
slice driven by `GaussianSLAM.track_rgbd` in both packages on the same
FakeSim frames: 64x64, 5 frames, a mapping event every 2 frames (each
densify + 2 Adam steps of 2 frames over a window of 4), capacity 4096.
The JAX package runs its Pallas forward and backward blends
(`tpu.blend_backward = "pallas"`, interpret mode on the CPU), whose
conventions K1 and K2 follow; both packages draw the windows and frame
choices from the same numpy stream.

Tolerances, each with its reason:
  * Adam against JAX: rtol 1e-6 (same f32 arithmetic; the bias
    corrections' pow may round differently in the last bit);
  * per-event losses: rtol 1e-4 (renders agree to f32 rounding, and the
    parameters as below);
  * parameters: per group, |port - JAX| <= 2 lr x (Adam steps taken).
    With eps = 1e-15 Adam's first step moves every coordinate whose
    gradient is nonzero by lr in the gradient's sign, whatever its size,
    so a gradient at the f32 noise floor can take opposite signs in the
    two packages; each step can then part them by at most about 2 lr.
    Most coordinates agree far closer, which the test also checks;
  * n_active after compaction: exact; render PSNR: 0.05 dB.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.config import get_cfg_defaults as jcfg
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene, FakeSim
from fisher_nerf_customized_tpu.models import gaussian_state as jgs
from fisher_nerf_customized_tpu.models import keyframes as jkf
from fisher_nerf_customized_tpu.models import slam as jslam
from fisher_nerf_customized_tpu.ops.camera import Camera
from fisher_nerf_customized_tpu.ops.image import calc_psnr as jcalc_psnr
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.models import gaussian_state as tgs
from fisher_nerf_customized_tpu_torch.models import keyframes as tkf
from fisher_nerf_customized_tpu_torch.models import slam as tslam
from fisher_nerf_customized_tpu_torch.models.gaussian_state import PARAM_KEYS
from fisher_nerf_customized_tpu_torch.ops.image import calc_psnr

YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "mp3d_gaussian_FR_eccv.yaml")
IMG = 64
ACTIONS = [2, 1, 2, 1]          # 5 frames with the first
LR_KEYS = dict(means3D="lr_means3D", rgb_colors="lr_rgb",
               unnorm_rotations="lr_rots", logit_opacities="lr_logit_op",
               log_scales="lr_log_scales")


def param_dict(rng, n):
    return {k: rng.normal(size=(n, w)).astype(np.float32)
            for k, w in zip(PARAM_KEYS, (3, 3, 4, 1, 3))}


def test_adam_matches_jax():
    rng = np.random.default_rng(0)
    params = param_dict(rng, 50)
    lrs = dict(means3D=1e-3, rgb_colors=2.5e-3, unnorm_rotations=1e-3,
               logit_opacities=0.05, log_scales=0.0)     # one frozen group
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jo, to = jgs.adam_init(jp), tgs.adam_init(tp)
    for _step in range(5):
        grads = param_dict(rng, 50)
        grads["means3D"][:5] = 0.0                        # zero gradients
        grads["rgb_colors"][5:10] *= 1e-12                # at the noise floor
        jp, jo = jgs.adam_step(jo, jp, {k: jnp.asarray(v) for k, v in
                                        grads.items()}, lrs, eps=1e-15)
        tp, to = tgs.adam_step(to, tp, {k: torch.from_numpy(v) for k, v in
                                        grads.items()}, lrs, eps=1e-15)
    assert to.count == int(jo.count) == 5
    for k in PARAM_KEYS:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(to.nu[k].numpy(), np.asarray(jo.nu[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
    np.testing.assert_array_equal(tp["log_scales"].numpy(),
                                  params["log_scales"])
    order = np.random.default_rng(1).permutation(50)
    moved = tgs.adam_permute(to, torch.from_numpy(order))
    assert torch.equal(moved.mu["means3D"], to.mu["means3D"][order])


def test_prune_compact_matches_jax():
    rng = np.random.default_rng(2)
    cap, n = 40, 31
    params = param_dict(rng, cap)
    ts = rng.uniform(0, 9, cap).astype(np.float32)
    keep = rng.uniform(size=cap) < 0.6
    jstate = jgs.GaussianState(**{k: jnp.asarray(v) for k, v in
                                  params.items()}, timestep=jnp.asarray(ts),
                               n_active=jnp.asarray(n, jnp.int32))
    tstate = tgs.GaussianState(**{k: torch.from_numpy(v) for k, v in
                                  params.items()}, timestep=torch.from_numpy(ts),
                               n_active=torch.tensor(n, dtype=torch.int32))
    jnew, jorder = jgs.prune_compact(jstate, jnp.asarray(keep))
    tnew, torder = tgs.prune_compact(tstate, torch.from_numpy(keep))
    assert int(tnew.n_active) == int(jnew.n_active) == int(keep[:n].sum())
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    for k in PARAM_KEYS + ("timestep",):
        np.testing.assert_array_equal(getattr(tnew, k).numpy(),
                                      np.asarray(getattr(jnew, k)))


@pytest.mark.parametrize("seed", [0, 1])
def test_select_keyframes_overlap_matches_jax(seed):
    """Same ids from the same seed, and the stream left in the same
    state."""
    rng = np.random.default_rng(seed)
    jbuf, tbuf = jkf.KeyframeBuffer(48, 64), tkf.KeyframeBuffer(48, 64)
    for i in range(9):
        w2c = np.eye(4, dtype=np.float32)
        ang = rng.uniform(-0.6, 0.6)
        w2c[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]]
        w2c[:3, 3] = rng.uniform(-0.5, 0.5, 3)
        for buf in (jbuf, tbuf):
            buf.append(np.zeros((48, 64, 3), np.float32),
                       np.zeros((48, 64), np.float32), w2c, i)
    depth = rng.uniform(0.5, 4.0, (1, 48, 64)).astype(np.float32)
    depth[0, :10] = 0.0
    intr = np.array([[40, 0, 32], [0, 40, 24], [0, 0, 1]], np.float32)
    pose = jbuf.w2cs[3]
    r_j, r_t = np.random.default_rng(7 + seed), np.random.default_rng(7 + seed)
    ref = jkf.select_keyframes_overlap(depth, pose, intr, jbuf, 5, rng=r_j)
    got = tkf.select_keyframes_overlap(depth, pose, intr, tbuf, 5, rng=r_t)
    assert got == ref and len(got) > 0
    assert r_t.integers(1 << 30) == r_j.integers(1 << 30)


def make_cfg(get_defaults, workdir):
    cfg = get_defaults()
    cfg.merge_from_file(YAML)
    cfg.SLAM.Dataset.Calibration.merge_from_other(dict(
        fx=IMG / 2, fy=IMG / 2, cx=IMG / 2, cy=IMG / 2, width=IMG,
        height=IMG))
    cfg.workdir = str(workdir)
    cfg.run_name = "mapping"
    cfg.map_every = 2
    cfg.keyframe_every = 2
    cfg.mapping.num_iters = 4
    cfg.tpu.mapping_frames_per_iter = 2
    cfg.mapping_window_size = 4
    cfg.tpu.capacity = 4096
    cfg.tpu.blend_backward = "pallas"       # read by the JAX package only
    # prune every step at opacity 0.5, so that the soft kill and the
    # compaction release slots (about 40 % of them here)
    cfg.mapping.pruning_dict.prune_every = 1
    cfg.mapping.pruning_dict.removal_opacity_threshold = 0.5
    return cfg


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mapping")
    cam = Camera(fx=IMG / 2, fy=IMG / 2, cx=IMG / 2, cy=IMG / 2, width=IMG,
                 height=IMG)
    sim = FakeSim(BoxScene.multi_room(seed=3), cam, forward_step=0.25,
                  turn_angle=30.0)
    obs = [sim.reset(yaw=0.3)] + [sim.step(a) for a in ACTIONS]
    frames = [(np.array(o["rgb"]), np.array(o["depth"]),
               np.linalg.inv(o["c2w"]).astype(np.float32)) for o in obs]
    js = jslam.GaussianSLAM(make_cfg(jcfg, tmp / "jax"))
    ts = tslam.GaussianSLAM(make_cfg(tcfg, tmp / "torch"), device="cpu")
    assert js.settings.diff_backend == js.settings.fwd_backend == "pallas"
    events = dict(jax=[], torch=[])
    compactions = []

    def recording_prune_compact(state, keep):
        new_state, order = tgs.prune_compact(state, keep)
        compactions.append((int(state.n_active), int(new_state.n_active)))
        return new_state, order

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tslam, "prune_compact", recording_prune_compact)
        for color, depth, w2c in frames:
            for name, slam in (("jax", js), ("torch", ts)):
                before = slam.last_losses
                slam.track_rgbd(color, depth, gt_w2c=w2c)
                if slam.last_losses is not before:
                    events[name].append(dict(
                        losses=np.asarray(slam.last_losses, np.float64)
                        if name == "jax" else slam.last_losses.numpy(),
                        n_active=slam.n_active))
    return dict(js=js, ts=ts, frames=frames, events=events,
                compactions=compactions)


def test_track_rgbd_fires_the_same_events(mapped):
    ev = mapped["events"]
    assert len(ev["torch"]) == len(ev["jax"]) == 2
    js, ts = mapped["js"], mapped["ts"]
    assert ts.keyframes.ids == js.keyframes.ids == [0, 1, 3]
    assert ts.frame_idx == js.frame_idx == len(mapped["frames"]) - 1
    # both consumed the same draws (windows, pixels, frame choices)
    assert ts.rng.integers(1 << 30) == js.rng.integers(1 << 30)


def test_mapping_losses_match(mapped):
    for got, ref in zip(mapped["events"]["torch"], mapped["events"]["jax"]):
        assert got["losses"].shape == ref["losses"].shape == (2,)
        assert np.isfinite(got["losses"]).all()
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)


def test_n_active_after_compaction_matches(mapped):
    # one compaction per event, each releasing soft-killed slots
    assert len(mapped["compactions"]) == 2
    assert all(after < before for before, after in mapped["compactions"])
    for got, ref in zip(mapped["events"]["torch"], mapped["events"]["jax"]):
        assert got["n_active"] == ref["n_active"]
    assert mapped["ts"].n_active == mapped["js"].n_active


@pytest.mark.parametrize("key", PARAM_KEYS)
def test_parameters_match_within_adam_steps(mapped, key):
    js, ts = mapped["js"], mapped["ts"]
    n = js.n_active
    got = getattr(ts.state, key).numpy()[:n]
    ref = np.asarray(getattr(js.state, key))[:n]
    n_steps = sum(len(e["losses"]) for e in mapped["events"]["jax"])
    lr = getattr(ts.mc, LR_KEYS[key])
    err = np.abs(got - ref)
    assert err.max() <= 2 * lr * n_steps + 1e-6, (key, err.max(), lr)
    # the bound is for the few coordinates whose gradient sits at the
    # noise floor; all but 1 % agree to 1e-3 of lr
    assert np.mean(err > 1e-3 * lr + 1e-6) < 0.01, key


def test_render_psnr_matches(mapped):
    js, ts = mapped["js"], mapped["ts"]
    for color, _depth, w2c in mapped["frames"]:
        c2w = np.linalg.inv(w2c)
        ref = float(jcalc_psnr(js.render_at_pose(c2w)["render"],
                               jnp.asarray(color)))
        got = float(calc_psnr(ts.render_at_pose(c2w)["render"],
                              torch.from_numpy(color)))
        assert abs(got - ref) < 0.05
        assert got > 10.0


def test_mesh_data_axis_clamps_in_one_process(tmp_path):
    """tpu.mesh_axes.data = 2 no longer raises: in one process it clamps
    to 1 and the mapping events run unsharded, equal to the bit to
    data = 1 (the sharded paths: tests/test_torch_sharded_episode.py).
    One torch thread: the CPU's multithreaded scatter-adds in the
    backward do not sum in a fixed order."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        states = _clamp_runs(tmp_path)
    finally:
        torch.set_num_threads(n_threads)
    for k in PARAM_KEYS:
        assert torch.equal(getattr(states[0], k), getattr(states[1], k)), k


def _clamp_runs(tmp_path):
    rng = np.random.default_rng(0)
    color = rng.uniform(0, 1, (IMG, IMG, 3)).astype(np.float32)
    depth = rng.uniform(1, 3, (IMG, IMG)).astype(np.float32)
    states = []
    for data in (2, 1):
        cfg = make_cfg(tcfg, tmp_path)
        cfg.tpu.mesh_axes.data = data
        slam = tslam.GaussianSLAM(cfg, device="cpu")
        assert slam.mesh is None and slam.mesh_data == 1
        for _ in range(4):
            slam.track_rgbd(color, depth, gt_w2c=np.eye(4, dtype=np.float32))
        assert slam.last_losses is not None
        assert slam.sharded_calls == dict(mapping=0, pose=0, h_train=0)
        states.append(slam.state)
    return states
