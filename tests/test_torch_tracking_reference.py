"""Optimized tracking, the port against the benchmark's plain reference
(benchmark/reference/tracking.py, loaded by path) on the CPU, and the
port's tracking spans and counters.

The map: 300 seeded random Gaussians (of 512 slots) in front of a 48x48
camera, 196 of them a wall 4.3-4.7 m away that covers the view (its
silhouette is above the 0.89 threshold at about 40 % of the pixels) and
104 between 2 and 3.5 m; its render at a true pose, with 5 % of the
depth pixels zeroed and 2 % made outliers, is the frame; the start pose is the true
one moved by (2, -1, 3) cm and turned about 1 degree.  The reference
renders its own silhouette, so each check also holds the masks.

Tolerances, each with its reason (the port's CPU path and the reference
evaluate the same float32 formulas, but the port's blend backward is
written by hand where the reference's comes from autograd, and its sums
run in another order):
  * the loss, a SUM over 2 304 pixels: rtol 1e-5 (a float32 sum in another
    order parts by a few ulps of its terms' total);
  * the gradient of (q, t): relative L2 1e-4 of each (the backward's
    per-pixel terms reduce in another order over 300 Gaussians; the
    bfloat16 reference lies 1e-2 to 1e-1 away);
  * the first Adam step: relative L2 1e-5 of the change (the same float32
    update from gradients that agree to 1e-4 moves each component by
    lr x (1 + O(eps / |g|)));
  * an 8-step phase: its best loss rtol 1e-4 and its best pose within
    1e-6 (each step moves a coordinate by about lr whatever the
    gradient's size, so poses agree to float32 rounding unless a
    component's gradient changes sign, which the seeded map here avoids;
    the bfloat16 pose cannot resolve a step of 4e-4 at 1).
"""
import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults
from fisher_nerf_customized_tpu_torch.models import gaussian_state as tgs
from fisher_nerf_customized_tpu_torch.models import slam as tslam
from fisher_nerf_customized_tpu_torch.ops.camera import Camera
from fisher_nerf_customized_tpu_torch.utils import logging_utils
from fisher_nerf_customized_tpu_torch.utils.geometry import (quat_to_rotmat,
                                                             rotmat_to_quat)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 48
N_GAUSS, CAPACITY = 300, 512
N_ITERS = 8


def _reference():
    """benchmark/reference as the package `bench_reference`, loaded from
    its path (its modules import one another relatively)."""
    name = "bench_reference"
    if name not in sys.modules:
        path = os.path.join(ROOT, "benchmark", "reference")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(path, "__init__.py"),
            submodule_search_locations=[path])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return (importlib.import_module(name + ".tracking"),
            importlib.import_module(name + ".gaussians"))


rtrack, rgauss = _reference()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot(axis, ang):
    c, s = np.cos(ang), np.sin(ang)
    i, j = [a for a in range(3) if a != axis]
    m = np.eye(3)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


@pytest.fixture(scope="module")
def scene():
    """The port's state, camera and settings, the reference's camera, the
    frame (colour, depth) and the start pose (q0, t0)."""
    rng = np.random.default_rng(11)
    grid = np.linspace(-4.2, 4.2, 14)
    gx, gy = (a.ravel() for a in np.meshgrid(grid, grid))
    n_wall = gx.size
    n_free = N_GAUSS - n_wall
    d = dict(
        means3D=np.concatenate([
            np.stack([gx + rng.uniform(-0.1, 0.1, n_wall),
                      gy + rng.uniform(-0.1, 0.1, n_wall),
                      rng.uniform(4.3, 4.7, n_wall)], 1),
            np.stack([rng.uniform(-1.5, 1.5, n_free),
                      rng.uniform(-1.5, 1.5, n_free),
                      rng.uniform(2.0, 3.5, n_free)], 1)]),
        log_scales=np.log(np.concatenate([
            rng.uniform(0.2, 0.35, (n_wall, 3)),
            rng.uniform(0.05, 0.2, (n_free, 3))])),
        unnorm_rotations=rng.normal(size=(N_GAUSS, 4)),
        logit_opacities=rng.normal(1.5, 1.0, (N_GAUSS, 1)),
        rgb_colors=rng.uniform(0, 1, (N_GAUSS, 3)),
        n_active=N_GAUSS)
    state = tgs.state_from_numpy(d, CAPACITY, device="cpu")
    cam = Camera(fx=IMG / 2, fy=IMG / 2, cx=IMG / 2, cy=IMG / 2, width=IMG,
                 height=IMG)
    settings = tslam.RenderSettings(tile_size=16, max_per_tile=256, chunk=64)
    ref_cam = rgauss.Camera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                            width=IMG, height=IMG, near=cam.near,
                            dilation=cam.dilation)
    true_w2c = np.eye(4, dtype=np.float32)
    true_w2c[:3, :3] = _rot(1, 0.05) @ _rot(0, -0.03)
    true_w2c[:3, 3] = [0.05, -0.02, 0.1]
    with torch.no_grad():
        out = rgauss.render(state.params(), N_GAUSS, torch.from_numpy(true_w2c),
                            ref_cam, settings.max_per_tile)
    color = out["im"].clone()
    depth = out["depth"].clone()
    flat = depth.reshape(-1)
    pick = torch.from_numpy(rng.permutation(flat.numel()))
    n_zero, n_out = flat.numel() // 20, flat.numel() // 50
    flat[pick[:n_zero]] = 0.0
    flat[pick[n_zero:n_zero + n_out]] += 3.0
    start = true_w2c.copy()
    start[:3, :3] = (_rot(1, 0.017) @ start[:3, :3]).astype(np.float32)
    start[:3, 3] += [0.02, -0.01, 0.03]
    start = torch.from_numpy(start)
    return dict(state=state, cam=cam, settings=settings, ref_cam=ref_cam,
                color=color, depth=depth, q0=rotmat_to_quat(start[:3, :3]),
                t0=start[:3, 3].clone())


def tracking(sil, outlier, num_iters=N_ITERS):
    return tslam.TrackingConfig(
        num_iters=num_iters, sil_thres=0.89, depth_weight=1.0, im_weight=0.5,
        lr_trans=0.002, lr_rot=0.0004, use_sil_for_loss=sil,
        ignore_outlier_depth_loss=outlier, depth_loss_thres=20000.0,
        use_depth_loss_thres=True)


def ref_tracking(tc):
    return rtrack.Tracking(
        sil_thres=tc.sil_thres, depth_weight=tc.depth_weight,
        im_weight=tc.im_weight, use_sil_for_loss=tc.use_sil_for_loss,
        ignore_outlier_depth_loss=tc.ignore_outlier_depth_loss,
        lr_rot=tc.lr_rot, lr_trans=tc.lr_trans)


def port_first_step(sc, tc):
    q = sc["q0"].clone().requires_grad_()
    t = sc["t0"].clone().requires_grad_()
    loss, depth_l = tslam._tracking_loss(
        q, t, sc["state"].params(), sc["state"].n_active, sc["color"],
        sc["depth"], sc["cam"], sc["settings"], tc)
    gq, gt_ = torch.autograd.grad(loss, [q, t])
    return loss.detach(), depth_l.detach(), gq, gt_


def ref_first_step(sc, tc, dtype=torch.float32):
    params = {k: v.to(dtype) for k, v in sc["state"].params().items()}
    return rtrack.pose_grad(
        sc["q0"].to(dtype), sc["t0"].to(dtype), params, N_GAUSS,
        sc["color"].to(dtype), sc["depth"].to(dtype), sc["ref_cam"],
        ref_tracking(tc), sc["settings"].max_per_tile,
        sc["settings"].tile_size, sc["settings"].chunk)


def rel(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def test_quaternion_to_rotation_matches_the_port():
    q = torch.from_numpy(np.random.default_rng(2).normal(size=(16, 4))
                         .astype(np.float32))
    for row in q:
        torch.testing.assert_close(rtrack.quat_to_rotmat(row),
                                   quat_to_rotmat(row), atol=1e-6, rtol=0)


@pytest.mark.parametrize("sil,outlier", [(True, False), (False, False),
                                         (True, True), (False, True)])
def test_loss_gradient_and_first_step_match_the_reference(scene, sil,
                                                          outlier):
    tc = tracking(sil, outlier)
    loss, depth_l, gq, gt_ = port_first_step(scene, tc)
    want = ref_first_step(scene, tc)
    mask = want["mask"]
    # the options bite: the silhouette and the outlier cut drop pixels
    base = (scene["depth"] > 0) & torch.isfinite(want["sil"])
    assert 0 < int(mask.sum()) <= int(base.sum())
    assert (int(mask.sum()) < int(base.sum())) == (sil or outlier)
    if sil:
        assert bool((want["sil"][base] <= tc.sil_thres).any())
    assert float(want["loss"]) > 0
    np.testing.assert_allclose(float(loss), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(depth_l), float(want["depth_l"]),
                               rtol=1e-5)
    assert rel(gq, want["gq"]) < 1e-4 and rel(gt_, want["gt"]) < 1e-4
    # the first Adam step, the port's form, from the same gradient
    q1, t1, _opt = rtrack.adam_step(
        scene["q0"], scene["t0"], gq, gt_,
        rtrack.adam_init(scene["q0"], scene["t0"]), 1, ref_tracking(tc))
    bq, bt, _bl, _dl, losses = tslam._tracking_phase(
        scene["state"], scene["q0"], scene["t0"], scene["color"],
        scene["depth"], scene["cam"], scene["settings"],
        tc._replace(num_iters=1))
    assert float(losses[0]) == float(loss)
    assert rel(bq - scene["q0"], q1 - scene["q0"]) < 1e-5
    assert rel(bt - scene["t0"], t1 - scene["t0"]) < 1e-5


@pytest.mark.parametrize("sil,outlier", [(True, False), (False, True)])
def test_phase_and_its_best_pose_match_the_reference(scene, sil, outlier):
    tc = tracking(sil, outlier)
    bq, bt, best_loss, depth_l, losses = tslam._tracking_phase(
        scene["state"], scene["q0"], scene["t0"], scene["color"],
        scene["depth"], scene["cam"], scene["settings"], tc)
    rq, rt, r_loss, r_dl, r_losses = rtrack.phase(
        scene["q0"], scene["t0"], scene["state"].params(), N_GAUSS,
        scene["color"], scene["depth"], scene["ref_cam"], ref_tracking(tc),
        N_ITERS, scene["settings"].max_per_tile, scene["settings"].tile_size,
        scene["settings"].chunk)
    # the phase improves on its start and keeps the best post-step pose
    assert min(r_losses) < r_losses[0]
    np.testing.assert_allclose(losses.numpy(), r_losses, rtol=1e-4)
    np.testing.assert_allclose(float(best_loss), r_loss, rtol=1e-4)
    np.testing.assert_allclose(float(depth_l), float(r_dl), rtol=1e-4)
    np.testing.assert_allclose(bq.numpy(), rq.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(bt.numpy(), rt.numpy(), atol=1e-6, rtol=0)


def test_bfloat16_reference_fails_the_tolerances(scene):
    """The control: the reference one precision below the configuration's
    misses the loss, gradient and step tolerances above."""
    tc = tracking(True, False)
    want = ref_first_step(scene, tc)
    low = ref_first_step(scene, tc, torch.bfloat16)
    assert abs(float(low["loss"]) / float(want["loss"]) - 1) > 1e-5
    assert max(rel(low["gq"], want["gq"]), rel(low["gt"], want["gt"])) > 1e-4
    q0 = scene["q0"].to(torch.bfloat16)
    t0 = scene["t0"].to(torch.bfloat16)
    q1, _t1, _opt = rtrack.adam_step(
        q0, t0, want["gq"].to(torch.bfloat16), want["gt"].to(torch.bfloat16),
        rtrack.adam_init(q0, t0), 1, ref_tracking(tc))
    q1w, _t1w, _opt = rtrack.adam_step(
        scene["q0"], scene["t0"], want["gq"], want["gt"],
        rtrack.adam_init(scene["q0"], scene["t0"]), 1, ref_tracking(tc))
    assert rel(q1.double() - q0.double(), q1w - scene["q0"]) > 1e-5


# -- spans and counters -------------------------------------------------------
def _slam(scene, doubled: bool, tmp_path):
    cfg = get_cfg_defaults()
    cfg.SLAM.Dataset.Calibration.merge_from_other(dict(
        fx=IMG / 2, fy=IMG / 2, cx=IMG / 2, cy=IMG / 2, width=IMG,
        height=IMG))
    cfg.workdir = str(tmp_path)
    cfg.tpu.capacity = CAPACITY
    cfg.tpu.max_per_tile = 256
    cfg.tracking.use_gt_poses = False
    cfg.tracking.num_iters = 3
    # a threshold every frame meets, or none
    cfg.tracking.depth_loss_thres = 0.0 if doubled else 1e9
    slam = tslam.GaussianSLAM(cfg, device="cpu")
    slam.state = scene["state"]
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = quat_to_rotmat(scene["q0"]).numpy()
    w2c[:3, 3] = scene["t0"].numpy()
    slam.poses_w2c = [w2c, w2c]
    slam.initialized = True
    return slam


@pytest.mark.parametrize("doubled", [False, True])
def test_tracked_frame_spans_and_counters(scene, doubled, tmp_path):
    store = logging_utils.STORE
    slam = _slam(scene, doubled, tmp_path)
    names = ("track.frame", "track.phase", "track.step", "track.step.loss",
             "track.step.grad", "track.step.adam")
    before = {n: {r.id for r in store.records(n)} for n in names}
    counted = {n: len(store.counters.get(n, ())) for n in ("track.iters",
                                                           "track.doubled")}
    slam._track_pose(scene["color"], scene["depth"])
    new = {n: [r for r in store.records(n) if r.id not in before[n]]
           for n in names}
    iters = 3 + (6 if doubled else 0)
    assert len(new["track.frame"]) == 1
    assert len(new["track.phase"]) == (2 if doubled else 1)
    for n in names[2:]:
        assert len(new[n]) == iters, n
    frame = new["track.frame"][0]
    assert all(r.parent_id == frame.id for r in new["track.phase"])
    phases = {r.id for r in new["track.phase"]}
    steps = {r.id for r in new["track.step"]}
    assert all(r.parent_id in phases for r in new["track.step"])
    for n in names[3:]:
        assert all(r.parent_id in steps for r in new[n])
    vals = {n: [v for _t, v in store.counts(n)[counted[n]:]]
            for n in counted}
    assert vals == {"track.iters": [iters], "track.doubled": [int(doubled)]}
