"""Gaussian-SLAM runtime: mapping and map queries.

The module functions mirror the JAX package's models/slam.py.  A map is
started by back-projecting the first frame (`_init_first_frame`); every
`map_every` frames a mapping event adds Gaussians where the map is
missing (`_densify`) and then runs `num_iters` Adam steps on the
depth-L1 + L1/SSIM loss over a window of keyframes
(`_mapping_phase_impl`: frozen tile bins per window frame, a soft-kill
opacity prune, one compaction at the end).  The map is rendered at poses
(`_render_rgbd`, `_render_pose`) and scored by Fisher information
(`_fisher_batch`, `_pose_scores`).  `GaussianSLAM` keeps the reference's
host API: init / track_rgbd / render_at_pose(s) / compute_Hessian /
compute_H_train / pose_eval(_async) / gaussian_points / prune_invisible /
delete_gaussians_by_index / save / load, and the reference's legacy
in-SLAM planning (get_top_down_map, uncertainty_scores, global_planning
with DBSCAN targeting, DFS_acq_score_planning), whose pose chunks are
scored by `_pose_point_scores` (K3, 11-wide).

Without ground-truth poses (`tracking.use_gt_poses false`) each frame's
pose is tracked (`_track_pose`): from the constant-velocity guess,
`num_iters` Adam steps on (quaternion, translation) against the
silhouette-masked SUM loss of one render (`_tracking_loss`, the Gaussians
held fixed), keeping the best candidate, and twice the steps again when
the depth loss stays at `depth_loss_thres` or above (`_tracking_phase`).
With `mapping.use_gaussian_splatting_densification` each mapping event
ends with a gradient clone/split (gaussian_state.gs_densify), whose
children's offsets come from `densify_draw`.

With `tpu.mesh_axes.data` > 1 in a process group of that many ranks
(parallel/distributed.py) the mapping event, the pose scores, H_train
and the driver's path EIG run through parallel/sharding.py's factories,
each rank computing its shard; in one process the setting clamps to 1,
as the JAX package's does on one device.

Every tensor of a GaussianSLAM lives on its `device` ("cuda" by
default); the ops pick the CUDA kernels for CUDA tensors and their plain
twins for CPU tensors.  Renders are differentiable: the blend's backward
is the K2 kernel (ops/rasterize.py BlendFunction).
"""
from __future__ import annotations

import functools
import logging
import os
from typing import NamedTuple

import numpy as np
import torch

from ..config import ConfigNode
from ..ops.camera import Camera
from ..ops.binning import tile_bin
from ..ops.fisher import fisher_diag_batch
from ..ops.image import calc_ssim
from ..ops.projection import preprocess
from ..ops.rasterize import RenderSettings, render, render_prebinned
from ..utils.geometry import (invert_se3, quat_mult, quat_to_rotmat,
                              rotmat_to_quat)
from ..utils.io import atomic_save_npy, atomic_savez
from ..utils.logging_utils import count, span
from .gaussian_state import (GaussianState, PARAM_KEYS, adam_init, adam_step,
                             add_gaussians, empty_state, grow_state,
                             gs_densify, prune_compact, state_from_numpy,
                             state_to_numpy)
from .keyframes import KeyframeBuffer, select_keyframes_overlap

logger = logging.getLogger(__name__)


class MappingConfig(NamedTuple):
    """Mapping hyperparameters, lifted from the YAML."""
    num_iters: int
    sil_thres: float
    depth_weight: float
    im_weight: float
    prune_enabled: bool
    prune_every: int
    prune_start: int
    prune_stop: int
    prune_thresh: float
    prune_big_after: int
    lr_means3D: float
    lr_rgb: float
    lr_rots: float
    lr_logit_op: float
    lr_log_scales: float
    depth_error_ratio: float
    downsample_pcd: int
    frames_per_iter: int = 1


def _gaussian_rendervars(params: dict, w2c):
    means_cam = params["means3D"] @ w2c[:3, :3].T + w2c[:3, 3]
    scales = torch.exp(params["log_scales"])
    opac = torch.sigmoid(params["logit_opacities"][:, 0])
    return means_cam, scales, params["unnorm_rotations"], opac


def _render_rgbd(camera, settings, params, n_active, w2c, bg_white=False,
                 bins=None, with_depth_sq=False):
    """One pass over [r, g, b, z] (+ z² when `with_depth_sq`).  The
    silhouette is 1 - final_t: the blended constant-ones channel would
    telescope to exactly that, so it is not blended."""
    means_cam, scales, quats, opac = _gaussian_rendervars(params, w2c)
    z = means_cam[:, 2:3]
    cols = [params["rgb_colors"], z]
    if with_depth_sq:
        cols.append(z * z)
    colors = torch.cat(cols, dim=-1)
    cch = colors.shape[-1]
    bg = torch.zeros(cch, device=colors.device)
    if bg_white:
        bg[:3] = 1.0
    if bins is not None:
        out = render_prebinned(camera, means_cam, scales, quats, opac,
                               colors, bins, bg=bg, settings=settings)
    else:
        active = torch.arange(means_cam.shape[0],
                              device=means_cam.device) < n_active
        out = render(camera, means_cam, scales, quats, opac, colors, bg=bg,
                     active=active, settings=settings)
    res = dict(im=out["color"][..., :3], depth=out["color"][..., 3],
               sil=1.0 - out["final_t"], med_depth=out["depth"],
               final_t=out["final_t"], radii=out["radii"],
               overflow=out["overflow"])
    if with_depth_sq:
        res["depth_sq"] = out["color"][..., 4]
    return res


def _mapping_loss(params, n_active, w2c, gt_color, gt_depth, camera,
                  settings, mc: MappingConfig, bins=None):
    """The mapping loss of the render at w2c (see `_rgbd_loss`)."""
    out = _render_rgbd(camera, settings, params, n_active, w2c, bins=bins)
    return _rgbd_loss(out["im"], out["depth"], gt_color, gt_depth, mc)


def _rgbd_loss(im, depth, gt_color, gt_depth, mc: MappingConfig):
    """Weighted depth L1 over gt_depth > 0 plus (0.8 L1 + 0.2 (1 - SSIM))
    on the color, of a rendered (im, depth) pair."""
    mask = ((gt_depth > 0) & torch.isfinite(depth)).detach()
    denom = torch.clamp(mask.sum(), min=1)
    depth_l1 = torch.sum(torch.abs(gt_depth - depth) * mask) / denom
    im_l1 = torch.mean(torch.abs(im - gt_color))
    ssim = calc_ssim(im, gt_color)
    im_loss = 0.8 * im_l1 + 0.2 * (1.0 - ssim)
    return mc.depth_weight * depth_l1 + mc.im_weight * im_loss


@torch.no_grad()
def _bin_frame(params, active, w2c, camera: Camera,
               settings: RenderSettings):
    means_cam, scales, quats, _opac = _gaussian_rendervars(params, w2c)
    prep = preprocess(means_cam, scales, quats, camera, active=active)
    return tile_bin(prep.mean2d, prep.radius, prep.depth, prep.valid,
                    camera.width, camera.height, settings.tile_size,
                    settings.max_per_tile)


def _mapping_phase_impl(state: GaussianState, kf_colors, kf_depths, kf_w2cs,
                        frame_choices, camera: Camera,
                        settings: RenderSettings, mc: MappingConfig,
                        axis=None):
    """One mapping event: `num_iters // frames_per_iter` Adam steps, each on
    the mean loss of the window frames `frame_choices[it]`, with periodic
    opacity pruning.

    kf_colors (B, H, W, 3), kf_depths (B, H, W), kf_w2cs (B, 4, 4): the
    window; frame_choices (n_steps, F) host ints into it.  The tile bins
    are made once per window frame from the phase's starting parameters
    and frozen (splats move far less than a pixel per step); frames with
    the same pose share one binning, which is exact (a binning depends on
    the parameters and the pose alone).  Pruning inside the loop is a soft
    kill (logit opacity -1e10: alpha 0, gradient 0, the frozen bins stay
    valid), followed by one compaction.  The Adam state is fresh per
    event.  Returns (state, losses (n_steps,), ga, dn, bin_overflow): ga
    and dn are the densification statistics (sum of |dL/d means3D| and
    the count of steps it was nonzero, per slot), bin_overflow the
    binning truncation summed over the B window frames.

    axis: a mesh axis (parallel/mesh.py::Axis) to shard the minibatch
    over (parallel/sharding.py::sharded_mapping_phase): this rank takes
    its block of the columns of frame_choices, and the gradients and
    loss are pmean'd over the axis before the densify statistics and the
    (replicated) Adam step, so that the update is the single-rank mean
    over the whole minibatch up to float reduction order."""
    frame_choices = np.asarray(frame_choices)
    if axis is not None:
        lo, hi = axis.shard(frame_choices.shape[1])
        frame_choices = frame_choices[:, lo:hi]
    lrs = dict(means3D=mc.lr_means3D, rgb_colors=mc.lr_rgb,
               unnorm_rotations=mc.lr_rots, logit_opacities=mc.lr_logit_op,
               log_scales=mc.lr_log_scales)
    # the spans map.bin, map.step (.loss, .grad, .adam) and map.compact
    # cover the phase (utils/logging_utils.py)
    with span("map.bin"):
        params = {k: v.detach() for k, v in state.params().items()}
        opt = adam_init(params)
        active = state.active

        by_pose: dict[bytes, object] = {}
        frame_bins = []
        for w2c_host, w2c in zip(kf_w2cs.cpu().numpy(), kf_w2cs):
            key = w2c_host.tobytes()
            if key not in by_pose:
                by_pose[key] = _bin_frame(params, active, w2c, camera,
                                          settings)
            frame_bins.append(by_pose[key])
        bin_overflow = torch.stack([b.overflow for b in frame_bins]).sum()

        cap = state.capacity
        ga = torch.zeros(cap, device=active.device)
        dn = torch.zeros(cap, device=active.device)
    losses = []
    for it, frames in enumerate(frame_choices):
        with span("map.step"):
            leaves = {k: v.requires_grad_() for k, v in params.items()}
            with span("map.step.loss"):
                loss = torch.stack([
                    _mapping_loss(leaves, state.n_active, kf_w2cs[i],
                                  kf_colors[i], kf_depths[i], camera,
                                  settings, mc, bins=frame_bins[i])
                    for i in frames.tolist()]).mean()
            with span("map.step.grad"):
                grads = torch.autograd.grad(loss, [leaves[k]
                                                   for k in PARAM_KEYS])
                if axis is not None:
                    *grads, loss = axis.pmean_all(
                        list(grads) + [loss.detach().reshape(1)])
                    loss = loss[0]
            grads = dict(zip(PARAM_KEYS, grads))
            with span("map.step.adam"):
                with torch.no_grad():
                    gnorm = torch.linalg.norm(grads["means3D"], dim=-1)
                    ga += gnorm
                    dn += (gnorm > 0).float()
                params, opt = adam_step(opt, {k: v.detach() for k, v in
                                              leaves.items()}, grads, lrs,
                                        eps=1e-15)
                if (mc.prune_enabled and mc.prune_start <= it <= mc.prune_stop
                        and it % mc.prune_every == 0):
                    logit = params["logit_opacities"]
                    kill = active & (torch.sigmoid(logit[:, 0])
                                     < mc.prune_thresh)
                    params["logit_opacities"] = torch.where(
                        kill[:, None], torch.full_like(logit, -1e10), logit)
            losses.append(loss.detach())

    with span("map.compact"):
        new_state = state.replace_params(params)
        if mc.prune_enabled:
            # one compaction releases exactly the soft-killed slots
            keep = params["logit_opacities"][:, 0] > -1e9
            new_state, order = prune_compact(new_state, keep)
            ga, dn = ga[order], dn[order]
        losses = torch.stack(losses)
    return new_state, losses, ga, dn, bin_overflow


def _median(x):
    """Median of all elements, averaging the two middle values of an even
    count as jnp.median does (torch.median returns the lower one)."""
    v = torch.sort(x.reshape(-1)).values
    m = v.numel()
    if m % 2:
        return v[m // 2]
    return 0.5 * (v[m // 2 - 1] + v[m // 2])


class TrackingConfig(NamedTuple):
    """Tracking hyperparameters, lifted from the YAML."""
    num_iters: int
    sil_thres: float
    depth_weight: float
    im_weight: float
    lr_trans: float
    lr_rot: float
    use_sil_for_loss: bool
    ignore_outlier_depth_loss: bool
    depth_loss_thres: float
    use_depth_loss_thres: bool


def _tracking_loss(cam_q, cam_t, params, n_active, gt_color, gt_depth,
                   camera: Camera, settings: RenderSettings,
                   tc: TrackingConfig):
    """The camera-only loss of one [r, g, b, z] render at the pose
    (cam_q, cam_t): SUMs of the depth L1 and the color L1 over the mask
    gt_depth > 0, finite render depth, and (with the options) an error
    under 10 x its median and a silhouette (1 - final T) above
    sil_thres.  The Gaussians are held fixed; only cam_q and cam_t carry
    gradients.  Binned per call: the bins depend on the pose.  Returns
    (loss, depth_l)."""
    R = quat_to_rotmat(cam_q)
    p = {k: v.detach() for k, v in params.items()}
    means_cam = p["means3D"] @ R.T + cam_t
    z = means_cam[:, 2:3]
    colors = torch.cat([p["rgb_colors"], z], dim=-1)
    active = torch.arange(means_cam.shape[0],
                          device=means_cam.device) < n_active
    out = render(camera, means_cam, torch.exp(p["log_scales"]),
                 p["unnorm_rotations"],
                 torch.sigmoid(p["logit_opacities"][:, 0]), colors,
                 active=active, settings=settings)
    depth = out["color"][..., 3]
    im = out["color"][..., :3]
    with torch.no_grad():
        mask = (gt_depth > 0) & torch.isfinite(depth)
        if tc.ignore_outlier_depth_loss:
            err = torch.abs(gt_depth - depth) * (gt_depth > 0)
            mask = mask & (err < 10.0 * _median(err))
        if tc.use_sil_for_loss:
            mask = mask & (1.0 - out["final_t"] > tc.sil_thres)
    depth_l = torch.sum(torch.abs(gt_depth - depth) * mask)
    im_l = torch.sum(torch.abs(im - gt_color) * mask[..., None])
    return tc.depth_weight * depth_l + tc.im_weight * im_l, depth_l


def _tracking_phase(state: GaussianState, cam_q0, cam_t0, gt_color,
                    gt_depth, camera: Camera, settings: RenderSettings,
                    tc: TrackingConfig):
    """`num_iters` Adam steps on (cam_q, cam_t), in the JAX package's own
    form (b1 0.9, b2 0.999, eps 1e-8, f32 bias corrections, lr_rot and
    lr_trans), keeping the best candidate as the reference does: the loss
    is taken at the pose before the step, and when it is the lowest so
    far the pose after the step is kept.  No host read inside the loop.
    Returns (best_q, best_t, best_loss, the last iteration's depth_l,
    the losses (num_iters,))."""
    params = state.params()
    q, t = cam_q0.detach(), cam_t0.detach()
    mq, vq = torch.zeros_like(q), torch.zeros_like(q)
    mt, vt = torch.zeros_like(t), torch.zeros_like(t)
    best_loss = torch.full((), float("inf"), device=q.device)
    best_q, best_t = q, t
    losses = []
    for k in range(1, tc.num_iters + 1):
        q, t = q.requires_grad_(), t.requires_grad_()
        loss, depth_l = _tracking_loss(q, t, params, state.n_active,
                                       gt_color, gt_depth, camera, settings,
                                       tc)
        gq, gt_ = torch.autograd.grad(loss, [q, t])
        with torch.no_grad():
            kk = torch.tensor(float(k))
            bc1 = float(1.0 - torch.tensor(0.9) ** kk)
            bc2 = float(1.0 - torch.tensor(0.999) ** kk)
            mq = 0.9 * mq + 0.1 * gq
            vq = 0.999 * vq + 0.001 * gq * gq
            q = q - tc.lr_rot * (mq / bc1) / (torch.sqrt(vq / bc2) + 1e-8)
            mt = 0.9 * mt + 0.1 * gt_
            vt = 0.999 * vt + 0.001 * gt_ * gt_
            t = t - tc.lr_trans * (mt / bc1) / (torch.sqrt(vt / bc2) + 1e-8)
            loss = loss.detach()
            better = loss < best_loss
            best_loss = torch.where(better, loss, best_loss)
            best_q = torch.where(better, q, best_q)
            best_t = torch.where(better, t, best_t)
        losses.append(loss)
    return best_q, best_t, best_loss, depth_l.detach(), torch.stack(losses)


def _backproject(depth, color, w2c, camera: Camera, ds: int):
    """World points, colors and projective scales of the ds-strided grid."""
    h, w = depth.shape
    dev = depth.device
    ys = torch.arange(0, h, ds, dtype=torch.float32, device=dev)
    xs = torch.arange(0, w, ds, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    zs = depth[::ds, ::ds]
    px = (gx - camera.cx) / camera.fx
    py = (gy - camera.cy) / camera.fy
    pts_cam = torch.stack([px * zs, py * zs, zs], dim=-1).reshape(-1, 3)
    c2w = invert_se3(w2c)
    pts_w = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    cols = color[::ds, ::ds].reshape(-1, 3)
    z = zs.reshape(-1)
    scale = ds * z / ((camera.fx + camera.fy) / 2.0)
    m = pts_w.shape[0]
    rot = torch.zeros(m, 4, device=dev)
    rot[:, 0] = 1.0
    params = dict(
        means3D=pts_w,
        rgb_colors=cols,
        unnorm_rotations=rot,
        logit_opacities=torch.zeros(m, 1, device=dev),
        log_scales=torch.log(torch.clamp(scale, min=1e-6))[:, None].repeat(1, 3),
    )
    return params, z


def _init_first_frame(state: GaussianState, color, depth, w2c,
                      min_depth: float, camera: Camera, ds: int = 1):
    """Back-project the first frame on the ds-strided pixel grid where
    depth > min_depth.  Returns (state, dropped, n_added)."""
    params, z = _backproject(depth, color, w2c, camera, ds)
    mask = z > min_depth
    new_state, dropped = add_gaussians(state, params, mask, 0.0)
    return new_state, dropped, mask.sum(dtype=torch.int32)


def _densify(state: GaussianState, color, depth, w2c, time_idx,
             camera: Camera, settings: RenderSettings, mc: MappingConfig):
    """Back-project pixels where the map is missing: silhouette below
    threshold, or the render is behind the ground truth with a large
    error.  Returns (state, dropped, n_candidates, overflow)."""
    out = _render_rgbd(camera, settings, state.params(), state.n_active, w2c)
    sil, rdepth = out["sil"], out["depth"]

    non_presence_sil = sil < mc.sil_thres
    depth_error = torch.abs(depth - rdepth) * (depth > 0)
    err_med = _median(depth_error)
    non_presence_depth = (rdepth > depth) & (
        depth_error > mc.depth_error_ratio * err_med)
    non_presence = (non_presence_sil | non_presence_depth) & (depth > 0.01)

    ds = mc.downsample_pcd
    h, w = camera.height, camera.width
    # any-in-block downsample of the mask, candidates on the strided grid
    blocks = non_presence[:(h // ds) * ds, :(w // ds) * ds]
    blocks = blocks.reshape(h // ds, ds, w // ds, ds)
    cand_mask = blocks.any(dim=3).any(dim=1).reshape(-1)

    params, z = _backproject(depth, color, w2c, camera, ds)
    cand_mask = cand_mask & (z > 0.01)
    new_state, dropped = add_gaussians(state, params, cand_mask, time_idx)
    return (new_state, dropped, cand_mask.sum(dtype=torch.int32),
            out["overflow"])


def _render_pose(state: GaussianState, w2c, camera: Camera,
                 settings: RenderSettings, white_bg: bool, mask=None):
    """Render [rgb, z, z²] at a pose (the span render.pose); `mask`
    (capacity,) bool hides Gaussians (opacity 0)."""
    with span("render.pose"):
        params = state.params()
        if mask is not None:
            params = dict(params)
            params["logit_opacities"] = torch.where(
                mask[:, None], params["logit_opacities"],
                torch.full_like(params["logit_opacities"], float("-inf")))
        return _render_rgbd(camera, settings, params, state.n_active, w2c,
                            bg_white=white_bg, with_depth_sq=True)


def _render_pose_batch(state: GaussianState, w2cs, camera: Camera,
                       settings: RenderSettings, white_bg: bool):
    """Render P poses; outputs stacked on a leading pose dimension."""
    outs = [_render_pose(state, w2c, camera, settings, white_bg)
            for w2c in w2cs]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _fisher_batch(state: GaussianState, w2cs, camera: Camera,
                  settings: RenderSettings, full_chain: bool = False,
                  grad_value: float = 1e-3):
    params = state.params()
    active = torch.arange(state.capacity,
                          device=w2cs.device) < state.n_active
    return fisher_diag_batch(camera, w2cs, params["means3D"],
                             torch.exp(params["log_scales"]),
                             params["unnorm_rotations"],
                             torch.sigmoid(params["logit_opacities"][:, 0]),
                             params["rgb_colors"], active=active,
                             settings=settings, full_chain=full_chain,
                             grad_value=grad_value)


def _pose_scores(state: GaussianState, w2cs, h_train_inv, camera: Camera,
                 settings: RenderSettings, full_chain: bool = False,
                 grad_value: float = 1e-3):
    out = _fisher_batch(state, w2cs, camera, settings, full_chain,
                        grad_value)
    return torch.sum(out["H"] * h_train_inv[None], dim=(1, 2))


def _sum_rows4(x):
    """Sum over a last axis of 4, left to right (the order of the JAX
    package's compiled row sum)."""
    return ((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]


def _pose_point_scores(state: GaussianState, w2cs, n_poses: int,
                       h_train_inv, camera: Camera, settings: RenderSettings,
                       full_chain: bool = False, grad_value: float = 1e-3):
    """Each pose's view score sum(H ⊙ H_train_inv) and, per Gaussian, the
    largest of its row sums over the first n_poses poses of w2cs (the
    rows past n_poses are padding, masked to -inf), from one batched
    Fisher call."""
    out = _fisher_batch(state, w2cs, camera, settings, full_chain,
                        grad_value)
    pt = _sum_rows4(out["H"] * h_train_inv[None])                # (P, cap)
    ok = (torch.arange(w2cs.shape[0], device=w2cs.device) < n_poses)[:, None]
    return pt.sum(dim=1), torch.where(
        ok, pt, torch.full_like(pt, -float("inf"))).amax(dim=0)


@torch.no_grad()
def _seen_from_poses(state: GaussianState, w2cs, n_poses: int,
                     camera: Camera):
    """(capacity,) bool: the Gaussian has radius > 0 (the reference's
    prune-invisible criterion) at any of the first n_poses poses of w2cs
    (P, 4, 4); the rows past n_poses are padding and masked.
    Preprocess only, one batched call over P poses."""
    means_cam = (state.means3D @ w2cs[:, :3, :3].transpose(-1, -2)
                 + w2cs[:, None, :3, 3])                      # (P, C, 3)
    nb, cap = means_cam.shape[:2]
    prep = preprocess(means_cam, torch.exp(state.log_scales).expand(
        nb, cap, 3), state.unnorm_rotations.expand(nb, cap, 4), camera,
        active=state.active)
    pose_ok = torch.arange(nb, device=w2cs.device) < n_poses
    return ((prep.radius > 0) & pose_ok[:, None]).any(dim=0)


def _pad_poses(w2cs: np.ndarray, ck: int) -> np.ndarray:
    """Pad a pose chunk to ck poses with identities."""
    pad = ck - len(w2cs)
    if pad <= 0:
        return w2cs
    return np.concatenate([w2cs, np.tile(np.eye(4, dtype=np.float32),
                                         (pad, 1, 1))])


class GaussianSLAM:
    """Host-side orchestrator with the reference GaussianSLAM query API."""

    def __init__(self, cfg: ConfigNode, eval_dir: str | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.eval_dir = eval_dir or os.path.join(cfg.workdir, cfg.run_name)
        calib = cfg.SLAM.Dataset.Calibration
        self.camera = Camera(fx=float(calib.fx), fy=float(calib.fy),
                             cx=float(calib.cx), cy=float(calib.cy),
                             width=int(calib.width), height=int(calib.height))
        tpu = cfg.tpu
        self.settings = RenderSettings(
            tile_size=int(tpu.tile_size),
            max_per_tile=int(tpu.max_per_tile),
            chunk=min(int(tpu.get("blend_chunk", 256)),
                      int(tpu.max_per_tile)),
            max_depth=float(tpu.max_depth))
        # Fisher/EIG renders use bigger tiles
        fisher_k = int(tpu.get("fisher_max_per_tile", tpu.max_per_tile))
        self.fisher_settings = RenderSettings(
            tile_size=int(tpu.get("fisher_tile_size", tpu.tile_size)),
            max_per_tile=fisher_k, chunk=min(64, fisher_k),
            max_depth=float(tpu.max_depth))
        # EIG renders at reduced resolution; grad_value scales by the
        # factor so H keeps its full-resolution magnitude
        # (H ~ grad_value² * n_pixels), and the camera's dilation by 1/s²
        fs = max(int(tpu.get("fisher_downsample", 1)), 1)
        self.fisher_downsample = fs
        self.fisher_camera = self.camera.downsampled(fs)
        self.fisher_grad_value = 1e-3 * fs
        # reduced projection chain for H_train and pose_eval, as in the
        # JAX package (its path-EIG scoring uses the full chain)
        self.fisher_full_chain = bool(tpu.get("fisher_full_chain", False))
        mp = cfg.mapping
        self.mc = MappingConfig(
            num_iters=int(mp.num_iters),
            sil_thres=float(mp.sil_thres),
            depth_weight=float(mp.loss_weights.depth),
            im_weight=float(mp.loss_weights.im),
            prune_enabled=bool(mp.prune_gaussians),
            prune_every=int(mp.pruning_dict.prune_every),
            prune_start=int(mp.pruning_dict.start_after),
            prune_stop=int(mp.pruning_dict.stop_after),
            prune_thresh=float(mp.pruning_dict.removal_opacity_threshold),
            prune_big_after=int(mp.pruning_dict.remove_big_after),
            lr_means3D=float(mp.lrs.means3D),
            lr_rgb=float(mp.lrs.rgb_colors),
            lr_rots=float(mp.lrs.unnorm_rotations),
            lr_logit_op=float(mp.lrs.logit_opacities),
            lr_log_scales=float(mp.lrs.log_scales),
            depth_error_ratio=float(mp.densify_dict.depth_error_ratio),
            downsample_pcd=int(cfg.downsample_pcd),
            frames_per_iter=int(tpu.get("mapping_frames_per_iter", 1)))
        tr = cfg.tracking
        self.tc = TrackingConfig(
            num_iters=int(tr.num_iters),
            sil_thres=float(tr.sil_thres),
            depth_weight=float(tr.loss_weights.depth),
            im_weight=float(tr.loss_weights.im),
            lr_trans=float(tr.lrs.cam_trans),
            lr_rot=float(tr.lrs.cam_unnorm_rots),
            use_sil_for_loss=bool(tr.use_sil_for_loss),
            ignore_outlier_depth_loss=bool(tr.ignore_outlier_depth_loss),
            depth_loss_thres=float(tr.depth_loss_thres),
            use_depth_loss_thres=bool(tr.use_depth_loss_thres))
        self.use_gt_poses = bool(tr.use_gt_poses)
        self.forward_prop = bool(tr.forward_prop)
        self.intrinsics = self.camera.intrinsics
        self.state = empty_state(int(tpu.capacity), device=self.device)
        self.pose_chunk = int(tpu.pose_chunk)
        self._init_mesh(tpu.get("mesh_axes", None))
        # H_train keyframe budget per planning event (0 = exact full sum)
        self.h_train_window = int(tpu.get("h_train_window", 96))

        self.keyframes = KeyframeBuffer(self.camera.height, self.camera.width)
        self.keyframe_time_indices: list[int] = []
        self.poses_w2c: list[np.ndarray] = []
        self.frame_idx = -1
        self.initialized = False
        # the JAX package's numpy stream: one seed gives both packages the
        # same keyframe windows and frame choices
        self.rng = np.random.default_rng(0)
        self.last_losses = None   # (n_steps,) losses of the latest event
        self._param_version = 0   # bumped on any Gaussian-param mutation
        self.selection = 0        # the legacy global_planning's round count

    # -- helpers ------------------------------------------------------------
    def _init_mesh(self, axes):
        """The multi-rank mode (tpu.mesh_axes.data > 1): the mesh over the
        process group, made once, through which the mapping event, the
        pose scores, H_train and the driver's path EIG are dispatched.
        `data` is clamped to the ranks there are (one process runs
        unsharded, as the JAX package on one device); frames_per_iter is
        raised and pose_chunk rounded up to multiples of it."""
        self.mesh = None
        self.mesh_data = 1
        data = int(axes.data) if axes is not None else 1
        model = int(axes.model) if axes is not None else 1
        if data > 1:
            from ..parallel.distributed import world_size
            n = world_size()
            if data * model > n:
                logger.warning(
                    "mesh_axes data=%d model=%d needs %d ranks, have %d "
                    "-> clamping data axis", data, model, data * model, n)
                data = max(n // model, 1)
        if data > 1:
            from ..parallel.mesh import make_mesh
            self.mesh = make_mesh(data=data, model=model)
            self.mesh_data = data
            f = self.mc.frames_per_iter
            if f % data:
                newf = data * -(-f // data)
                logger.info("sharded mapping: frames_per_iter %d -> %d "
                            "(multiple of data axis %d)", f, newf, data)
                self.mc = self.mc._replace(frames_per_iter=newf)
            self.pose_chunk = data * -(-self.pose_chunk // data)
        # the sharded dispatches made (the multi-rank tests read them)
        self.sharded_calls = dict(mapping=0, pose=0, h_train=0)

    @property
    def state(self) -> GaussianState:
        return self._state

    @state.setter
    def state(self, s: GaussianState):
        self._state = s
        self._state_epoch = getattr(self, "_state_epoch", 0) + 1

    @property
    def n_active(self) -> int:
        c = getattr(self, "_n_active_cache", None)
        if c is not None and c[0] == self._state_epoch:
            return c[1]
        n = int(self.state.n_active)
        self._n_active_cache = (self._state_epoch, n)
        return n

    @property
    def gaussian_points(self) -> np.ndarray:
        """Active world-frame means (N, 3) as numpy, for the planner;
        pulled once per state version."""
        c = getattr(self, "_gpts_cache", None)
        if c is not None and c[0] == self._state_epoch:
            return c[1]
        pts = self.state.means3D[:self.n_active].detach().cpu().numpy()
        self._gpts_cache = (self._state_epoch, pts)
        return pts

    def get_gaussian_xyz(self) -> torch.Tensor:
        return torch.as_tensor(self.gaussian_points, device=self.device)

    def _maybe_bump_tile_capacity(self, overflow: int, n_renders: int):
        """Adaptive per-tile capacity: double `max_per_tile` (up to
        tpu.max_per_tile_limit) when the truncated fraction of splat-tile
        entries exceeds tpu.overflow_bump_ratio."""
        st = self.settings
        limit = int(self.cfg.tpu.get("max_per_tile_limit", 1024))
        if st.max_per_tile >= limit or n_renders <= 0:
            return
        n_tiles = (-(-self.camera.width // st.tile_size)
                   * -(-self.camera.height // st.tile_size))
        frac = overflow / float(n_renders * n_tiles * st.max_per_tile)
        if frac > float(self.cfg.tpu.get("overflow_bump_ratio", 1e-3)):
            self.settings = st._replace(
                max_per_tile=min(2 * st.max_per_tile, limit))

    def _ensure_capacity(self, incoming: int):
        cap = self.state.capacity
        need = self.n_active + incoming
        if need > cap:
            growth = int(self.cfg.tpu.capacity_growth)
            new_cap = cap
            while new_cap < need:
                new_cap *= growth
            self.state = grow_state(self.state, new_cap)

    def _prep_inputs(self, color, depth):
        """(H, W, 3) float color in [0, 1] and (H, W) depth, as float32
        tensors on the SLAM device."""
        color = torch.as_tensor(color, device=self.device)
        if color.dtype == torch.uint8:
            color = color.float() / 255.0
        color = color.float()
        if color.dim() == 3 and color.shape[0] == 3:     # (3,H,W) -> (H,W,3)
            color = color.movedim(0, -1)
        depth = torch.as_tensor(depth, device=self.device).float()
        if depth.dim() == 3:
            depth = depth.reshape(depth.shape[-2], depth.shape[-1])
        return color, depth

    def _w2c(self, w2c) -> torch.Tensor:
        return torch.as_tensor(np.asarray(w2c, np.float32), device=self.device)

    # -- reference API ------------------------------------------------------
    def init(self, color, depth, w2c=None):
        """First-frame initialization: back-project the downsample_pcd-
        strided pixel grid where depth > 10*cell_size into Gaussians."""
        color, depth = self._prep_inputs(color, depth)
        w2c = np.eye(4, dtype=np.float32) if w2c is None \
            else np.asarray(w2c, np.float32)
        self.frame_idx = 0
        self.poses_w2c = [w2c]
        cell = float(self.cfg.explore.cell_size)
        h, w = depth.shape
        ds = self.mc.downsample_pcd
        self._ensure_capacity((h // ds) * (w // ds))
        state, _dropped, n_added = _init_first_frame(
            self.state, color, depth, self._w2c(w2c), 10.0 * cell,
            self.camera, ds)
        self.state = state
        self._param_version += 1
        self.keyframes.append(color, depth, w2c, 0)
        self.keyframe_time_indices.append(0)
        self.initialized = True
        return int(n_added)

    def track_rgbd(self, color, depth, gt_w2c=None, action=None):
        """Per step: the pose (the ground truth, or tracked without
        use_gt_poses), a mapping event every `map_every` frames, a keyframe
        every `keyframe_every` frames.  The first call initializes the map
        instead."""
        if not self.initialized:
            self.init(color, depth, gt_w2c)
            return
        color, depth = self._prep_inputs(color, depth)
        time_idx = self.frame_idx + 1
        if self.use_gt_poses and gt_w2c is not None:
            w2c = np.asarray(gt_w2c, np.float32)
        else:
            w2c = self._track_pose(color, depth)
        self.poses_w2c.append(w2c)

        cfgc = self.cfg
        if (time_idx + 1) % int(cfgc.map_every) == 0:
            self._mapping_event(color, depth, w2c, time_idx)
        if ((time_idx + 1) % int(cfgc.keyframe_every) == 0
                or time_idx == int(cfgc.num_frames) - 2):
            self.keyframes.append(color, depth, w2c, time_idx)
            self.keyframe_time_indices.append(time_idx)
        self.frame_idx = time_idx

    def _track_pose(self, color, depth) -> np.ndarray:
        """The frame's w2c by optimized tracking: from the constant-velocity
        guess (with forward_prop and two poses; else the last pose), one
        tracking phase, and when its last depth loss is at
        depth_loss_thres or above (with use_depth_loss_thres) a second one
        from its best pose with twice the steps, whose best is kept."""
        dev = self.device
        prev = torch.as_tensor(self.poses_w2c[-1], dtype=torch.float32,
                               device=dev)
        q0 = rotmat_to_quat(prev[:3, :3])
        t0 = prev[:3, 3]
        if self.forward_prop and len(self.poses_w2c) >= 2:
            prev2 = torch.as_tensor(self.poses_w2c[-2], dtype=torch.float32,
                                    device=dev)
            q_prev2 = rotmat_to_quat(prev2[:3, :3])
            conj = q_prev2 * torch.tensor([1.0, -1.0, -1.0, -1.0],
                                          device=dev)
            q0 = quat_mult(q0, quat_mult(conj, q0))
            t0 = t0 + (t0 - prev2[:3, 3])
        best_q, best_t, _loss, depth_l, _losses = _tracking_phase(
            self.state, q0, t0, color, depth, self.camera, self.settings,
            self.tc)
        if (self.tc.use_depth_loss_thres
                and float(depth_l) >= self.tc.depth_loss_thres):
            best_q, best_t, _loss, _dl, _losses = _tracking_phase(
                self.state, best_q, best_t, color, depth, self.camera,
                self.settings,
                self.tc._replace(num_iters=2 * self.tc.num_iters))
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = quat_to_rotmat(best_q).cpu().numpy()
        w2c[:3, 3] = best_t.cpu().numpy()
        return w2c

    def densify_draw(self, time_idx: int, n_children: int,
                     shape: tuple) -> torch.Tensor:
        """The (n_children, *shape) standard normal draws of gs_densify's
        children at frame time_idx, from a torch generator seeded by
        time_idx on the SLAM's device.  (The JAX package draws from
        jax.random.PRNGKey(time_idx), which torch cannot reproduce; tests
        replace this method to feed its draws.)"""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(time_idx))
        return torch.randn((n_children,) + tuple(shape), generator=gen,
                           device=self.device)

    def _gs_densify(self, ga, dn, time_idx: int):
        """Gradient clone/split after a mapping event's Adam phase, from
        its statistics ga / dn.  The clones and children are counted first
        and the capacity grown to hold them all."""
        dd = self.cfg.mapping.densify_dict
        n_children = int(dd.num_to_split_into)
        grad_thresh, split_scale = float(dd.grad_thresh), 0.05
        st = self.state
        with torch.no_grad():
            mean_g = torch.where(dn > 0, ga / torch.clamp(dn, min=1),
                                 torch.zeros_like(ga))
            max_scale = torch.exp(st.log_scales).amax(dim=1)
            high = st.active & (mean_g >= grad_thresh)
            incoming = (int((high & (max_scale <= split_scale)).sum())
                        + n_children * int((high & (max_scale > split_scale))
                                           .sum()))
        self._ensure_capacity(incoming)
        pad = self.state.capacity - ga.shape[0]
        if pad:
            # grown: the new slots are empty and carry no gradient
            ga, dn = (torch.cat([x, x.new_zeros(pad)]) for x in (ga, dn))
        self.state = gs_densify(
            self.state, ga, dn,
            self.densify_draw(time_idx, n_children,
                              tuple(self.state.means3D.shape)),
            grad_thresh=grad_thresh, split_scale=split_scale,
            num_to_split_into=n_children,
            removal_opacity_threshold=float(dd.removal_opacity_threshold),
            time_idx=float(time_idx))

    def _drain_densify_guard(self):
        """Read the previous densify's dropped and overflow counts (kept
        as device scalars so that no event waits for its own densify) and
        grow the capacity or the per-tile K accordingly."""
        prev = getattr(self, "_densify_guard", None)
        if prev is None:
            return
        self._densify_guard = None
        p_dropped, p_overflow = (int(x) for x in prev)
        if p_dropped > 0:
            self._ensure_capacity(p_dropped + 1024)
        if p_overflow > 0:
            self._maybe_bump_tile_capacity(p_overflow, 2)

    def _flush_pending_bump(self):
        """Apply the previous mapping event's deferred binning-overflow
        check."""
        if getattr(self, "_pending_bump", None) is None:
            return
        overflow, n_renders = self._pending_bump
        self._pending_bump = None
        self._maybe_bump_tile_capacity(int(overflow), n_renders)

    def _mapping_event(self, color, depth, w2c, time_idx):
        """Densify, select the keyframe window, run the Adam phase, and
        with use_gaussian_splatting_densification clone and split: the
        span map.event (with its device time) and its children, and the
        counters map.capacity, map.steps and map.n_active of the event's
        start (the 0-d device tensor unless the count is cached: no
        host read)."""
        cfgc = self.cfg
        n_steps = max(self.mc.num_iters // self.mc.frames_per_iter, 1)
        with span("map.event", device=self.device):
            cached = getattr(self, "_n_active_cache", None)
            count("map.n_active", cached[1] if cached is not None
                  and cached[0] == self._state_epoch else self.state.n_active)
            count("map.capacity", self.state.capacity)
            count("map.steps", n_steps)
            with span("map.densify"):
                self._flush_pending_bump()
                if bool(cfgc.mapping.add_new_gaussians) and time_idx > 0:
                    # the previous event's guard, checked before this
                    # densify
                    self._drain_densify_guard()
                    ds = self.mc.downsample_pcd
                    self._ensure_capacity(
                        (self.camera.height // ds) * (self.camera.width // ds))
                    self.state, dropped, _added, overflow = _densify(
                        self.state, color, depth, self._w2c(w2c),
                        float(time_idx), self.camera, self.settings, self.mc)
                    self._densify_guard = (dropped, overflow)

            with span("map.window"):
                # overlapping keyframes, the latest keyframe, this frame
                num_kf = int(cfgc.mapping_window_size) - 2
                host_depth = depth.detach().cpu().numpy()
                selected = select_keyframes_overlap(
                    host_depth[None], w2c, self.intrinsics, self.keyframes,
                    num_kf, rng=self.rng)
                if len(self.keyframes) > 0:
                    selected.append(len(self.keyframes) - 1)
                dev = self.device
                win_colors = [self.keyframes.color_dev(i, dev)
                              for i in selected] + [color]
                win_depths = [self.keyframes.depth_dev(i, dev)
                              for i in selected] + [depth]
                win_w2cs = [self.keyframes.w2cs[i] for i in selected] + [w2c]
                b = len(win_colors)
                # padded to a fixed size with the current frame, as the JAX
                # package does (the draws below depend on b and b_max)
                b_max = int(cfgc.mapping_window_size)
                while len(win_colors) < b_max:
                    win_colors.append(win_colors[-1])
                    win_depths.append(win_depths[-1])
                    win_w2cs.append(win_w2cs[-1])
                choices = self.rng.integers(
                    0, min(b, b_max), size=(n_steps, self.mc.frames_per_iter))
                if self.mesh is not None:
                    from ..parallel.sharding import sharded_mapping_phase
                    phase = sharded_mapping_phase(self.mesh, self.camera,
                                                  self.settings, self.mc)
                    self.sharded_calls["mapping"] += 1
                else:
                    phase = functools.partial(
                        _mapping_phase_impl, camera=self.camera,
                        settings=self.settings, mc=self.mc)
                window = (torch.stack(win_colors[:b_max]),
                          torch.stack(win_depths[:b_max]),
                          self._w2c(np.stack(win_w2cs[:b_max])))
            state, losses, ga, dn, overflow = phase(self.state, *window,
                                                    choices)
            self.state = state
            self.last_losses = losses
            if bool(cfgc.mapping.use_gaussian_splatting_densification):
                with span("map.gs_densify"):
                    self._gs_densify(ga, dn, time_idx)
            # binning truncation over the window's frames, read at the next
            # event so that this one is not waited for
            self._pending_bump = (overflow, b_max)
            self._param_version += 1

    def render_at_pose(self, c2w, white_bg: bool = False, mask=None):
        w2c = np.linalg.inv(np.asarray(c2w, np.float32))
        full_mask = None
        if mask is not None:
            full_mask = torch.zeros(self.state.capacity, dtype=torch.bool,
                                    device=self.device)
            full_mask[:len(mask)] = torch.as_tensor(mask, device=self.device)
        out = _render_pose(self.state, self._w2c(w2c), self.camera,
                           self.settings, bool(white_bg), full_mask)
        return {"render": out["im"], "depth": out["med_depth"],
                "depth_acc": out["depth"], "sil": out["sil"]}

    def render_at_poses(self, c2ws, white_bg: bool = False):
        """Render at (P, 4, 4) c2w poses; outputs carry a leading P."""
        w2cs = np.linalg.inv(np.asarray(c2ws, np.float32))
        out = _render_pose_batch(self.state, self._w2c(w2cs), self.camera,
                                 self.settings, bool(white_bg))
        return {"render": out["im"], "depth": out["med_depth"],
                "depth_acc": out["depth"], "sil": out["sil"]}

    def compute_Hessian(self, rel_w2c, return_points: bool = False,
                        random_gaussian_params=None, return_pose: bool = False):
        """Fisher H at one pose; (capacity, 4), rows past n_active zero.
        `random_gaussian_params` is accepted and ignored, as in the
        reference; the pose Hessian is its identity placeholder."""
        out = _fisher_batch(self.state, self._w2c(rel_w2c)[None],
                            self.fisher_camera, self.fisher_settings,
                            self.fisher_full_chain, self.fisher_grad_value)
        h = out["H"][0]
        if not return_points:
            h = h.reshape(-1)
        if return_pose:
            return h, torch.eye(6, device=self.device)
        return h

    def _h_train_key(self):
        """H_train changes only when the keyframe set or the Gaussian
        parameters change."""
        return (len(self.keyframes), self._param_version, self.n_active,
                self.state.capacity)

    def compute_H_train(self, random_gaussian_params=None):
        """Σ over keyframes of compute_Hessian, cached per parameter and
        keyframe version.  When keyframes were only appended since the
        cached sum, the new keyframes' Hessians are added to it.  With
        more keyframes than tpu.h_train_window, the sum runs over keyframe
        ids evenly strided across the whole history (first and latest
        always in), scaled by K/|ids|."""
        key = self._h_train_key()
        n_kf = len(self.keyframes)
        w = self.h_train_window
        cached = getattr(self, "_h_train_cache", None)
        if w and n_kf > w:
            ids = sorted(set(np.round(
                np.linspace(0, n_kf - 1, w)).astype(int).tolist()))
            key = key + ("win", tuple(ids))
            if cached is not None and cached[0] == key:
                return cached[1]
            h = self._h_train_over(
                self.keyframes.stacked_w2cs()[ids]) * (n_kf / len(ids))
            self._h_train_cache = (key, h)
            return h
        if cached is not None and cached[0] == key:
            return cached[1]
        if cached is not None and len(cached[0]) == len(key) \
                and cached[0][1:] == key[1:] and cached[0][0] < key[0]:
            h = cached[1] + self._h_train_over(
                self.keyframes.stacked_w2cs()[cached[0][0]:])
        else:
            h = self._h_train_over(self.keyframes.stacked_w2cs())
        self._h_train_cache = (key, h)
        return h

    def _h_train_over(self, w2cs: np.ndarray):
        h_train = torch.zeros(self.state.capacity, 4, device=self.device)
        if len(w2cs) == 0:
            return h_train
        ck = min(self.pose_chunk, len(w2cs))
        hsum_fn = None
        if self.mesh is not None:
            # the data axis splits the chunk; the padding weighs 0
            ck = self.mesh_data * -(-ck // self.mesh_data)
            from ..parallel.sharding import sharded_fisher_hsum
            hsum_fn = sharded_fisher_hsum(
                self.mesh, self.fisher_camera, self.fisher_settings,
                self.fisher_full_chain, self.fisher_grad_value)
        for i in range(0, len(w2cs), ck):
            chunk = w2cs[i:i + ck]
            n_real = len(chunk)
            if hsum_fn is not None:
                weights = torch.zeros(ck, device=self.device)
                weights[:n_real] = 1.0
                h_train = h_train + hsum_fn(
                    self.state, self._w2c(_pad_poses(chunk, ck)), weights)
                self.sharded_calls["h_train"] += 1
                continue
            out = _fisher_batch(self.state, self._w2c(_pad_poses(chunk, ck)),
                                self.fisher_camera, self.fisher_settings,
                                self.fisher_full_chain,
                                self.fisher_grad_value)
            h_train = h_train + out["H"][:n_real].sum(dim=0)
        return h_train

    def prewarm_H_train(self):
        """Launch H_train ahead of a planning event (the result is cached;
        the same keyframes and parameters give the same sum)."""
        self.compute_H_train()

    def pose_eval_async(self, poses, random_gaussian_params=None):
        """Launch EIG scoring for all candidate c2w poses and return a
        `resolve()` closure giving (scores (P,), poses (P, 4, 4))."""
        poses = np.asarray(poses, np.float32)
        h_train_inv = 1.0 / (self.compute_H_train() + 0.1)
        w2cs = np.linalg.inv(poses)
        ck = self.pose_chunk
        scores_fn = None
        if self.mesh is not None:
            from ..parallel.sharding import sharded_pose_scores
            scores_fn = sharded_pose_scores(
                self.mesh, self.fisher_camera, self.fisher_settings,
                self.fisher_full_chain, self.fisher_grad_value)
        chunks = []
        for i in range(0, len(w2cs), ck):
            chunk = w2cs[i:i + ck]
            padded = self._w2c(_pad_poses(chunk, ck))
            if scores_fn is not None:
                # the gather is waited on in resolve(), so that pipelined
                # planning keeps its overlap
                s = scores_fn(self.state, padded, h_train_inv, async_op=True)
                self.sharded_calls["pose"] += 1
            else:
                s = _pose_scores(self.state, padded, h_train_inv,
                                 self.fisher_camera, self.fisher_settings,
                                 self.fisher_full_chain,
                                 self.fisher_grad_value)
            chunks.append((s, len(chunk)))

        def resolve():
            got = [(s.wait() if scores_fn is not None else s)[:n]
                   for s, n in chunks]
            return torch.cat(got), torch.as_tensor(poses, device=self.device)
        return resolve

    def pose_eval(self, poses, random_gaussian_params=None):
        """EIG score per candidate c2w pose: sum(H_pose / (H_train + 0.1))."""
        return self.pose_eval_async(poses, random_gaussian_params)()

    def delete_gaussians_by_index(self, gaussian_index):
        """Remove the Gaussians at the given slots (and compact)."""
        keep = torch.ones(self.state.capacity, dtype=torch.bool,
                          device=self.device)
        keep[torch.as_tensor(np.asarray(gaussian_index, np.int64),
                             device=self.device)] = False
        self.state, _order = prune_compact(self.state, keep)
        self._param_version += 1

    def _seen_mask(self, w2cs: np.ndarray) -> torch.Tensor:
        """(capacity,) bool: seen from any of the (P, 4, 4) w2c poses, a
        pose_chunk of them at a time (the last chunk padded)."""
        ck = self.pose_chunk
        n_real = len(w2cs)
        w2cs = _pad_poses(w2cs, -(-n_real // ck) * ck)
        seen = torch.zeros(self.state.capacity, dtype=torch.bool,
                           device=self.device)
        for i in range(0, len(w2cs), ck):
            seen |= _seen_from_poses(self.state, self._w2c(w2cs[i:i + ck]),
                                     n_real - i, self.camera)
        return seen

    def prune_invisible(self, w2cs=None) -> int:
        """Drop the Gaussians seen (radius > 0) from none of the given w2c
        poses, the keyframes' by default; returns how many went.  The
        poses are padded to a multiple of pose_chunk and scored a chunk at
        a time.  When none goes, the state is left as it is, so the
        caches keyed on it survive; when some go, the cached H_train is
        permuted by the compaction's order (each row rides with its
        Gaussian) rather than recomputed."""
        w2cs = self.keyframes.stacked_w2cs() if w2cs is None else \
            np.asarray(w2cs, np.float32)
        if len(w2cs) == 0:
            return 0
        seen = self._seen_mask(w2cs)
        removed = self.n_active - int(seen[:self.n_active].sum())
        if removed == 0:
            return 0
        old_key = self._h_train_key()
        cached = getattr(self, "_h_train_cache", None)
        self.state, order = prune_compact(self.state, seen)
        self._param_version += 1
        if cached is not None and cached[0] == old_key:
            self._h_train_cache = (self._h_train_key(), cached[1][order])
        return removed

    def gs_pts_cnt(self, random_gaussian_params=None):
        return max(self.n_active, 1)

    def get_latest_frame(self):
        """(4, 4) c2w of the latest tracked frame."""
        return np.linalg.inv(self.poses_w2c[self.frame_idx])

    # -- the legacy in-SLAM planning API (the reference's own planning,
    # superseded by AstarPlanner; nothing in the driver calls it) ----------
    def get_top_down_map(self, cell_size: float | None = None,
                         grid_dim: int = 256) -> np.ndarray:
        """A (3, grid_dim, grid_dim) vote map of the Gaussian means around
        their xz mean: channel 0 unknown (1 everywhere), 1 a vote per mean
        in the 0.1-1.3 m band, 2 0.01 per other mean."""
        cell = cell_size or float(self.cfg.explore.cell_size)
        pts = self.gaussian_points
        occ = np.zeros((3, grid_dim, grid_dim), np.float32)
        occ[0] = 1.0
        if len(pts) == 0:
            return occ
        center = pts[:, [0, 2]].mean(axis=0)
        gx = np.clip(np.floor((pts[:, 0] - center[0]) / cell)
                     + grid_dim // 2, 0, grid_dim - 1).astype(np.int64)
        gz = np.clip(np.floor((pts[:, 2] - center[1]) / cell)
                     + grid_dim // 2, 0, grid_dim - 1).astype(np.int64)
        occ_band = (pts[:, 1] >= 0.1) & (pts[:, 1] <= 1.3)
        np.add.at(occ[1], (gz[occ_band], gx[occ_band]), 1.0)
        np.add.at(occ[2], (gz[~occ_band], gx[~occ_band]), 0.01)
        return occ

    @property
    def cam_height(self) -> float:
        """The first tracked frame's camera height (world y of its c2w)."""
        if self.poses_w2c:
            return float(np.linalg.inv(self.poses_w2c[0])[1, 3])
        return 1.25

    def uncertainty_scores(self) -> np.ndarray:
        """Per-Gaussian uncertainty, the sum of 1 / (H_train + 0.1) over
        its Fisher row, (capacity,) numpy."""
        return _sum_rows4(1.0 / (self.compute_H_train() + 0.1)).cpu().numpy()

    def global_planning(self, is_navigable, agent_pose=None, frontier=None,
                        find_path=None):
        """The reference's in-SLAM planning event: (scores (P,), c2ws
        (P, 4, 4)) tensors of the navigable candidates, or (None, None).

        Ring centres: `frontier` (M, 2) world xz points while fewer than
        two rounds have run (`selection` < 2), else the Gaussians of
        highest uncertainty (above the 0.8 quantile of
        uncertainty_scores in the camera's height band) clustered by
        DBSCAN (eps 0.1, 5 samples), the cluster holding the most
        uncertain point winning; centres and candidates are drawn from
        the shared `self.rng`.  The ring radius grows with the rounds
        (sample_range x (selection + 1), at most 5 m).  Candidates must
        pass `is_navigable(position)` and, if given, `find_path(position)`
        without raising.  Each pose chunk is scored by one Fisher call
        that also gives every Gaussian's largest score; with
        explore.prune_invisible the winning cluster's Gaussians whose
        largest score stays under twice their uncertainty are deleted.
        With an eval_dir the DBSCAN labels go to
        global_planning_iter<frame>.npz."""
        from ..parallel.distributed import is_writer
        from ..planning.candidates import generate_candidates
        ex = self.cfg.explore
        k = int(ex.sample_view_num)
        rng = self.rng
        h_train_inv = 1.0 / (self.compute_H_train() + 0.1)
        score_points = _sum_rows4(h_train_inv).cpu().numpy()
        pts = self.gaussian_points
        cam_h = self.cam_height
        selected_points_index = None

        use_frontier = (frontier is not None and len(frontier) > 0
                        and self.selection < 2)
        if use_frontier:
            f = np.asarray(frontier, np.float32).reshape(-1, 2)
            centers_xz = f[rng.integers(0, len(f), k)]
        else:
            band = ((pts[:, 1] >= cam_h - float(ex.height_range))
                    & (pts[:, 1] <= cam_h + float(ex.height_range)))
            if not band.any():
                self.selection += 1
                return None, None
            sel_xyz = pts[band]
            sel_scores = score_points[:self.n_active][band]
            idx_range = np.where(band)[0]
            thresh = np.quantile(sel_scores, 0.8)
            over = sel_scores > thresh
            centers_xz = None
            if over.sum() > 0:
                from ..utils.clustering import dbscan
                labels = dbscan(sel_xyz[over], eps=0.1, min_samples=5)
                over_scores = sel_scores[over]
                best_label, best = -1, -np.inf
                for lab in np.unique(labels):
                    if lab < 0:
                        continue
                    s = over_scores[labels == lab].max()
                    if s > best:
                        best_label, best = int(lab), s
                if self.eval_dir and is_writer():
                    seg = np.full((len(score_points),), -1, np.int64)
                    seg[idx_range[over]] = labels
                    os.makedirs(self.eval_dir, exist_ok=True)
                    atomic_savez(os.path.join(
                        self.eval_dir,
                        f"global_planning_iter{self.frame_idx}.npz"),
                        segmentated_labels=seg[idx_range],
                        max_label=best_label, points_index_range=idx_range)
                if best_label >= 0:
                    in_cluster = labels == best_label
                    selected_points_index = idx_range[over][in_cluster]
                    cluster_pts = sel_xyz[over][in_cluster]
                    centers_xz = cluster_pts[
                        rng.integers(0, len(cluster_pts), k)][:, [0, 2]]
            if centers_xz is None:
                centers_xz = sel_xyz[np.argmax(sel_scores)][None, [0, 2]]

        radius = min(float(ex.sample_range) * (self.selection + 1), 5.0)
        c2ws = generate_candidates(centers_xz, k, radius,
                                   float(ex.min_range), cam_h, rng)

        agent_y = (float(np.asarray(agent_pose)[1, 3])
                   if agent_pose is not None else cam_h)
        nav = []
        for i, c2w in enumerate(c2ws):
            p = c2w[:3, 3].copy()
            p[1] = agent_y
            if not bool(is_navigable(p)):
                continue
            if find_path is not None:
                try:
                    find_path(p)
                except Exception:
                    continue
            nav.append(i)
        self.selection += 1
        if not nav:
            return None, None
        nav_c2ws = c2ws[np.asarray(nav)]
        w2cs = np.linalg.inv(nav_c2ws)

        ck = self.pose_chunk
        scores, max_points = [], None
        for i in range(0, len(w2cs), ck):
            chunk = w2cs[i:i + ck]
            vs, pm = _pose_point_scores(
                self.state, self._w2c(_pad_poses(chunk, ck)), len(chunk),
                h_train_inv, self.fisher_camera, self.fisher_settings,
                self.fisher_full_chain, self.fisher_grad_value)
            scores.append(vs[:len(chunk)])
            max_points = pm if max_points is None else torch.maximum(
                max_points, pm)
        scores = torch.cat(scores)

        if bool(ex.prune_invisible) and selected_points_index is not None:
            sel_max = max_points.cpu().numpy()[selected_points_index]
            low = sel_max < score_points[selected_points_index] * 2.0
            if low.any():
                self.delete_gaussians_by_index(selected_points_index[low])
        return scores, torch.as_tensor(nav_c2ws, device=self.device)

    def DFS_acq_score_planning(self, train_poses, is_navigable,
                               max_depth: int = 6,
                               forward_step: float = 0.065,
                               turn_angle: float = 10.0) -> list[int]:
        """The reference's 3-action lookahead: a depth-first search over
        max_depth actions from the last of `train_poses` (c2w), each pose
        scored by sum(H_pose / (H_acc + 0.1)) with H_acc = H_train plus
        the Hessians of the poses before it on the branch; a left right
        after a right (or the reverse) scores -1, and so does a pose that
        fails `is_navigable(position)`.  Returns the best branch's actions
        in the order they run."""
        from ..utils.geometry import compute_next_campos
        h_train = self.compute_H_train()

        def dfs(train_h, pose, action_id, depth):
            if depth > 0:
                if not is_navigable(pose[:3, 3]):
                    return -1.0, []
                cur = self.compute_Hessian(np.linalg.inv(pose),
                                           return_points=True)
                acq = float((cur / (train_h + 0.1)).sum())
                train_h = train_h + cur
            else:
                acq = 0.0
            if depth == max_depth:
                return acq, []
            scores, actions = [], []
            for a in (1, 2, 3):
                if (a == 2 and action_id == 3) or (a == 3 and action_id == 2):
                    scores.append(-1.0)
                    actions.append([])
                    continue
                nxt = compute_next_campos(pose, a, forward_step, turn_angle)
                s, acts = dfs(train_h, nxt, a, depth + 1)
                scores.append(s)
                actions.append(acts)
            best = int(np.argmax(scores))
            return acq + scores[best], actions[best] + [best + 1]

        start = np.asarray(train_poses[-1], np.float64)
        _score, action_list = dfs(h_train, start, 1, 0)
        return action_list[::-1]

    # MonoGS-compatible no-ops
    def pause(self):
        pass

    def resume(self):
        pass

    def stop(self):
        pass

    def color_refinement(self):
        pass

    # checkpointing ---------------------------------------------------------
    def save(self, time_idx: int):
        """Write params{time_idx}.npz, keyframe_time_indices{time_idx}.npy
        and keyframes.npz in the JAX package's format; keyframes.npz also
        carries `ckpt_t` = time_idx, the checkpoint it belongs to."""
        os.makedirs(self.eval_dir, exist_ok=True)
        path = os.path.join(self.eval_dir, f"params{time_idx}.npz")
        arrs = state_to_numpy(self.state)
        atomic_savez(
            path, n_active=self.n_active, timestep=arrs["timestep"],
            poses_w2c=np.stack(self.poses_w2c),
            keyframe_time_indices=np.asarray(self.keyframe_time_indices),
            **{k: arrs[k] for k in PARAM_KEYS})
        atomic_save_npy(os.path.join(
            self.eval_dir, f"keyframe_time_indices{time_idx}.npy"),
            np.asarray(self.keyframe_time_indices))
        if len(self.keyframes):
            kf = self.keyframes.state_dict()
            atomic_savez(
                os.path.join(self.eval_dir, "keyframes.npz"),
                colors=np.stack(kf["colors"]).astype(np.float16),
                depths=np.stack(kf["depths"]).astype(np.float16),
                w2cs=np.stack(kf["w2cs"]), ids=np.asarray(kf["ids"]),
                ckpt_t=int(time_idx))
        return path

    def run_state(self) -> dict:
        """What an episode's run has set beside the parameters, as arrays:
        the per-tile K after its adaptive bumps, and the deferred
        binning-overflow and densify checks not yet applied (empty when
        none is pending).  Restored by load_run_state, a resumed run bins
        as the uninterrupted run does."""
        def ints(pair):
            return np.asarray([] if pair is None else [int(x) for x in pair],
                              np.int64)
        return dict(max_per_tile=int(self.settings.max_per_tile),
                    pending_bump=ints(getattr(self, "_pending_bump", None)),
                    densify_guard=ints(getattr(self, "_densify_guard",
                                               None)))

    def load_run_state(self, d):
        self.settings = self.settings._replace(
            max_per_tile=int(d["max_per_tile"]))
        pb, dg = np.asarray(d["pending_bump"]), np.asarray(d["densify_guard"])
        self._pending_bump = tuple(int(x) for x in pb) if len(pb) else None
        self._densify_guard = tuple(int(x) for x in dg) if len(dg) else None

    def load(self, path: str):
        """Read a params npz (and the keyframes.npz beside it) written by
        this class's or the JAX package's GaussianSLAM.save."""
        with np.load(path) as data:
            n = int(data["n_active"])
            self._ensure_capacity(n)
            self.state = state_from_numpy(
                {k: data[k] for k in PARAM_KEYS + ("timestep", "n_active")},
                self.state.capacity, device=self.device)
            self.poses_w2c = [p for p in data["poses_w2c"]]
            self.keyframe_time_indices = [
                int(i) for i in data["keyframe_time_indices"]]
        self._param_version += 1
        self.frame_idx = len(self.poses_w2c) - 1
        kf_path = os.path.join(os.path.dirname(path), "keyframes.npz")
        if os.path.exists(kf_path):
            with np.load(kf_path) as kf:
                self.keyframes.load_state_dict(dict(
                    colors=list(kf["colors"]), depths=list(kf["depths"]),
                    w2cs=list(kf["w2cs"]),
                    ids=[int(i) for i in kf["ids"]]))
        self.initialized = True
