"""Plain PyTorch reference of the camera tracking of one frame: the pose
(a wxyz quaternion q and a translation t, world to camera) fitted to an
RGB-D frame by Adam against a fixed map of 3D Gaussians.

Built on gaussians.py's render (its blend, binning and `final_t`); it
imports nothing of the port.  Every function follows the dtype of its
inputs: the float32 call is the reference, the bfloat16 call the control.
Matrix products run without TF32.

Where this departs from the reference repository's tracking
(FisherRF models/SLAM/gaussian.py:607-670, SplaTAM's form):
  * one render of [r, g, b, z] gives colour, depth and the silhouette,
    1 - final T; the repository renders twice and takes the silhouette
    from a blended channel of ones, which telescopes to the same number;
  * each tile blends only its K nearest Gaussians (gaussians.py's
    binning, as the port renders), where the repository's rasterizer has
    no cut;
  * Adam has eps 1e-8 and float32 bias corrections (the JAX package's
    form, which the port follows), where the repository's optimizer is
    torch.optim.Adam as SplaTAM builds it (eps 1e-15);
  * a phase keeps the post-step pose of the lowest pre-step loss, as the
    repository does; the doubled phase (twice the steps when the depth
    loss stays at the threshold) starts afresh from the best pose with a
    new optimizer, where the repository continues its optimizer from the
    last pose.  Only one phase is worked out here: its start pose and
    step count are the caller's;
  * the start pose (forward propagation) is the caller's: the port
    multiplies quaternions, the repository extrapolates them linearly.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import torch

from . import gaussians as ref


class Tracking(NamedTuple):
    """The tracking block of a configuration, as this file reads it."""
    sil_thres: float
    depth_weight: float
    im_weight: float
    use_sil_for_loss: bool
    ignore_outlier_depth_loss: bool
    lr_rot: float
    lr_trans: float


@contextmanager
def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def quat_to_rotmat(q):
    """(4,) wxyz quaternion, divided by (its norm + 1e-12) first ->
    (3, 3) rotation."""
    q = q / (torch.sqrt((q * q).sum()) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)])])


def w2c_of(q, t):
    """The (4, 4) world-to-camera matrix of (q, t), differentiable."""
    top = torch.cat([quat_to_rotmat(q), t[:, None]], dim=1)
    bottom = torch.zeros(1, 4, dtype=top.dtype, device=top.device)
    bottom[0, 3] = 1.0
    return torch.cat([top, bottom], dim=0)


def median(x):
    """The median of all elements, the two middle ones averaged when the
    count is even."""
    v = torch.sort(x.reshape(-1)).values
    m = v.numel()
    return v[m // 2] if m % 2 else 0.5 * (v[m // 2 - 1] + v[m // 2])


def loss(q, t, params, n_active, gt_color, gt_depth, cam, tr: Tracking,
         k: int, ts: int = 16, chunk: int = 64):
    """(loss, depth loss, mask (H, W), silhouette (H, W)) of the render at
    (q, t): the SUMs
    of |depth error| and 0.5 x |colour error| (the configuration's
    weights) over the pixels with gt depth > 0 and a finite render depth,
    and with the options an error under 10 x its median and a silhouette
    (1 - final T) above sil_thres; the map is held fixed."""
    p = {key: v.detach() for key, v in params.items()}
    out = ref.render(p, n_active, w2c_of(q, t), cam, k, ts=ts, chunk=chunk)
    depth, im = out["depth"], out["im"]
    with torch.no_grad():
        mask = (gt_depth > 0) & torch.isfinite(depth)
        if tr.ignore_outlier_depth_loss:
            err = torch.abs(gt_depth - depth) * (gt_depth > 0)
            mask = mask & (err < 10.0 * median(err))
        if tr.use_sil_for_loss:
            mask = mask & (1.0 - out["final_t"] > tr.sil_thres)
    depth_l = torch.sum(torch.abs(gt_depth - depth) * mask)
    im_l = torch.sum(torch.abs(im - gt_color) * mask[..., None])
    return (tr.depth_weight * depth_l + tr.im_weight * im_l, depth_l, mask,
            1.0 - out["final_t"].detach())


def pose_grad(q, t, params, n_active, gt_color, gt_depth, cam,
              tr: Tracking, k: int, ts: int = 16, chunk: int = 64):
    """dict(loss, depth_l, gq, gt (the gradient of the loss by autograd),
    mask, sil) at (q, t), as `loss` gives them."""
    with _no_tf32():
        q = q.detach().clone().requires_grad_()
        t = t.detach().clone().requires_grad_()
        total, depth_l, mask, sil = loss(q, t, params, n_active, gt_color,
                                         gt_depth, cam, tr, k, ts, chunk)
        gq, gt_ = torch.autograd.grad(total, [q, t])
    return dict(loss=total.detach(), depth_l=depth_l.detach(), gq=gq, gt=gt_,
                mask=mask, sil=sil)


class Adam(NamedTuple):
    """Adam's moments of q and t."""
    mq: torch.Tensor
    vq: torch.Tensor
    mt: torch.Tensor
    vt: torch.Tensor


def adam_init(q, t) -> Adam:
    return Adam(torch.zeros_like(q), torch.zeros_like(q), torch.zeros_like(t),
                torch.zeros_like(t))


def adam_step(q, t, gq, gt_, opt: Adam, step: int, tr: Tracking):
    """(q, t, moments) after Adam's step number `step` (from 1): b1 0.9,
    b2 0.999, eps 1e-8, the bias corrections 1 - b^step in float32, the
    learning rates lr_rot on q and lr_trans on t; in the dtype of q."""
    b = torch.tensor([0.9, 0.999], dtype=torch.float32) ** float(step)
    bc1, bc2 = float(1.0 - b[0]), float(1.0 - b[1])
    mq = 0.9 * opt.mq + 0.1 * gq
    vq = 0.999 * opt.vq + 0.001 * gq * gq
    mt = 0.9 * opt.mt + 0.1 * gt_
    vt = 0.999 * opt.vt + 0.001 * gt_ * gt_
    q = q - tr.lr_rot * (mq / bc1) / (torch.sqrt(vq / bc2) + 1e-8)
    t = t - tr.lr_trans * (mt / bc1) / (torch.sqrt(vt / bc2) + 1e-8)
    return q, t, Adam(mq, vq, mt, vt)


def phase(q0, t0, params, n_active, gt_color, gt_depth, cam, tr: Tracking,
          n_iters: int, k: int, ts: int = 16, chunk: int = 64):
    """One tracking phase of `n_iters` Adam steps from (q0, t0): (best q,
    best t, best loss, the last step's depth loss, the losses).  The loss
    is taken at the pose before each step; the pose after the step of the
    lowest loss is kept (the start pose if no loss is finite)."""
    q, t = q0.detach(), t0.detach()
    opt = adam_init(q, t)
    best = (q, t, float("inf"))
    losses, depth_l = [], None
    for step in range(1, n_iters + 1):
        g = pose_grad(q, t, params, n_active, gt_color, gt_depth, cam, tr,
                      k, ts, chunk)
        depth_l = g["depth_l"]
        with torch.no_grad():
            q, t, opt = adam_step(q, t, g["gq"], g["gt"], opt, step, tr)
        value = float(g["loss"])
        if value < best[2]:
            best = (q, t, value)
        losses.append(value)
    return best[0], best[1], best[2], depth_l, losses
