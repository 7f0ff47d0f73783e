"""Batched path-EIG evaluation.

Counterpart of the JAX package's engine/path_eval.py.  For each candidate
path the camera rolls through its action sequence; at the steps whose
Hessians count (acc_step_indices) the Fisher diagonal at the path's pose
gives

    point_EIG_s = log( sum cur_H_s / (H_train_path + lambda) )
    score += w_point * point_EIG_s,   H_train_path += cur_H_s

and the final score is score / len + path_end_weight * final_EIG (or
(score + final_EIG) / len when path_end_weight is 0).  The pose term is
the log-determinant of the reference's identity placeholder Hessian,
zero, and is left out.

The JAX package scans over the acc steps with the Fisher render vmapped
over all paths.  Here the scan is a Python loop over the acc steps, each
one `fisher_diag_batch(..., full_chain=True)` call over the padded path
poses: one launch of K3's 20-wide kernel per step on the card.  Path EIG
uses the full chain (the JAX package's default there), while H_train
and pose_eval use the reduced one (ROADMAP.md, queue 3 item b).  The
running per-path H (P, capacity, 4) stays on the device.
"""
from __future__ import annotations

import torch

from ..models.gaussian_state import GaussianState
from ..ops.camera import Camera
from ..ops.fisher import fisher_diag_batch
from ..ops.rasterize import RenderSettings


def acc_step_indices(n_actions: int, acc_every: int) -> list[int]:
    """The action indices whose Hessians affect the score: the reference
    computes a Hessian per action but accumulates (and scores) only when
    (len(actions) + 1) % acc_every == 0, i.e. at 0-based steps s with
    (s + 2) % acc_every == 0."""
    return [s for s in range(n_actions) if (s + 2) % acc_every == 0]


def path_point_eig_totals(state: GaussianState, h_train, acc_w2cs, acc_valid,
                          camera: Camera, settings: RenderSettings,
                          h_reg_lambda: float, path_point_weight: float,
                          vol_weighted: bool, gs_pts_cnt: float,
                          grad_value: float = 1e-3):
    """The point-EIG sums (P,) of P padded paths: the loop over the acc
    steps, one K3 20-wide launch per step.  Arguments as path_eig_scores'
    (acc_w2cs (P, A', 4, 4), acc_valid (P, A'))."""
    params = state.params()
    means_w = params["means3D"]
    scales = torch.exp(params["log_scales"])
    quats = params["unnorm_rotations"]
    opac = torch.sigmoid(params["logit_opacities"][:, 0])
    colors = params["rgb_colors"]
    active = torch.arange(means_w.shape[0],
                          device=means_w.device) < state.n_active
    n_paths = acc_w2cs.shape[0]

    h_paths = h_train[None].expand(n_paths, -1, -1)
    totals = torch.zeros(n_paths, device=means_w.device)
    for s in range(acc_w2cs.shape[1]):
        ok_s = acc_valid[:, s]
        cur_h = fisher_diag_batch(camera, acc_w2cs[:, s], means_w, scales,
                                  quats, opac, colors, grad_value=grad_value,
                                  active=active, settings=settings,
                                  full_chain=True)["H"]       # (P, N, 4)
        raw = torch.sum(cur_h * (1.0 / (h_paths + h_reg_lambda)), dim=(1, 2))
        if vol_weighted:
            raw = raw / gs_pts_cnt
        point_eig = torch.log(torch.clamp(raw, min=1e-30))
        totals = totals + torch.where(ok_s, path_point_weight * point_eig,
                                      torch.zeros_like(point_eig))
        h_paths = h_paths + ok_s.to(cur_h.dtype)[:, None, None] * cur_h
    return totals


def combine_path_scores(totals, lengths, final_eigs, path_end_weight: float):
    """A path's score from its point-EIG sum, action count and final EIG:
    totals / len + w_end final (or (totals + final) / len when w_end is
    0)."""
    length = torch.clamp(lengths.to(torch.float32), min=1.0)
    if path_end_weight > 0:
        return totals / length + path_end_weight * final_eigs
    return (totals + final_eigs) / length


def path_eig_scores(state: GaussianState, h_train, acc_w2cs, acc_valid,
                    lengths, final_eigs, camera: Camera,
                    settings: RenderSettings, h_reg_lambda: float,
                    path_pose_weight: float, path_point_weight: float,
                    path_end_weight: float, vol_weighted: bool,
                    gs_pts_cnt: float, grad_value: float = 1e-3):
    """Scores (P,) for P padded paths.

    h_train (capacity, 4); acc_w2cs (P, A', 4, 4) world->camera at the acc
    steps only (see acc_step_indices); acc_valid (P, A') bool; lengths
    (P,) whole action counts (the score's normalizer); final_eigs (P,).
    All tensors on the state's device.  path_pose_weight weighs the
    (zero) pose term and is kept for the JAX package's signature."""
    totals = path_point_eig_totals(state, h_train, acc_w2cs, acc_valid,
                                   camera, settings, h_reg_lambda,
                                   path_point_weight, vol_weighted,
                                   gs_pts_cnt, grad_value)
    return combine_path_scores(totals, lengths, final_eigs, path_end_weight)
