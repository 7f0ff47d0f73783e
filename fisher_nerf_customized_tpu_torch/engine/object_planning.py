"""Object-observing path planning with P-optimality path scores.

Counterpart of the JAX package's engine/object_planning.py (the
reference's plan_best_object_path, path_object_evaluation and
path_evaluation_popgs): candidate poses around the tracked object are
scored by the object SLAM (criterion `fisher`, `topt` or `dopt`), the
best goals are compiled to action sequences, and each sequence is rolled
out and scored by the object information it gathers every
acc_H_train_every actions, mixed with its goal's score by
object_path_end_weight.  All paths are scored together
(models/object_slam.object_path_scores).
"""
from __future__ import annotations

import numpy as np
import torch

from ..planning.planner import LocalizationError
from .actions import action_planning, rollout_path_poses
from .path_eval import acc_step_indices


def path_evaluation_batched(obj_slam, h_train11, path_actions, current_pose,
                            cam_height, forward_step, turn_angle, final_eigs,
                            cfg, criterion: str = "fisher", probes: int = 2,
                            p_max: int = 8):
    """Scores of the object paths (at most p_max, the path axis padded to
    it): only the acc-step poses contribute.  The probes of acc step s and
    path p are pose s p_max + p of one draw of the object SLAM's
    stream."""
    from ..models.object_slam import object_path_scores
    lam = float(cfg.H_reg_lambda) if criterion == "fisher" else 1e-6
    n_paths = len(path_actions)
    a_max = max(len(a) for a in path_actions)
    acc_idx = acc_step_indices(a_max, int(cfg.acc_H_train_every)) or [0]
    w2cs = np.tile(np.eye(4, dtype=np.float32), (p_max, len(acc_idx), 1, 1))
    valid = np.zeros((p_max, len(acc_idx)), bool)
    lengths = np.ones((p_max,), np.int32)
    for i, acts in enumerate(path_actions[:p_max]):
        poses = rollout_path_poses(current_pose, acts, cam_height,
                                   forward_step, turn_angle)
        for j, s in enumerate(acc_idx):
            if s < len(acts):
                w2cs[i, j] = np.linalg.inv(poses[s])
                valid[i, j] = True
        lengths[i] = len(acts)
    fe = np.full((p_max,), -np.inf, np.float32)
    fe[:n_paths] = np.asarray(final_eigs, np.float32)[:p_max]
    draw = obj_slam._pose_probes(int(probes))
    dev = obj_slam.device
    scores = object_path_scores(
        obj_slam.state.params(), obj_slam.state.n_active, h_train11,
        torch.as_tensor(w2cs, device=dev), torch.as_tensor(valid, device=dev),
        torch.as_tensor(lengths, device=dev), torch.as_tensor(fe, device=dev),
        lambda s: draw(range(s * p_max, (s + 1) * p_max)), lam,
        float(cfg.path_point_weight), float(cfg.object_path_end_weight),
        obj_slam.camera, obj_slam.settings, criterion)
    return scores.cpu().numpy()[:n_paths]


def plan_best_object_path(obj_slam, slam, planner, current_agent_pose,
                          expansion, t, cfg, forward_step, turn_angle,
                          queue_size, criterion: str = "fisher"):
    """Returns (actions, path, scores) of the best object-observing path,
    or (None, None, None)."""
    obj_pts = obj_slam.gaussian_points
    if len(obj_pts) == 0:
        return None, None, None
    if criterion in ("topt", "dopt"):
        def pose_fn(poses, criterion=criterion):
            return obj_slam.pose_eval_popgs(poses, criterion=criterion, K=2)
    else:
        pose_fn = obj_slam.pose_eval
    global_points, eigs, _ = planner.global_object_planning(
        pose_fn, obj_pts, slam.gaussian_points, expansion=expansion,
        agent_pose=current_agent_pose[:3, 3], criterion=criterion)
    if global_points is None:
        return None, None, None
    try:
        _goals, path_actions, paths_arr, goal_idx = action_planning(
            global_points, current_agent_pose, planner,
            slam.gaussian_points, t, forward_step, turn_angle, queue_size)
    except LocalizationError:
        # an enclosed start: the scene planner takes over
        return None, None, None
    if not path_actions:
        return None, None, None
    path_actions, paths_arr, goal_idx = (path_actions[:8], paths_arr[:8],
                                         goal_idx[:8])
    # fisher scores are summed ratios (their log mixes); the P-opt scores
    # are utilities already
    final_eigs = [np.log(max(float(eigs[i]), 1e-30)) if criterion == "fisher"
                  else float(eigs[i]) for i in goal_idx]
    probes = 2 if criterion in ("topt", "dopt") else obj_slam.hutch_probes
    if len(obj_slam.keyframes):
        h_train11 = obj_slam.compute_H_train_obj(n_probes=probes)
    else:
        h_train11 = torch.zeros(obj_slam.state.capacity, 11,
                                device=obj_slam.device)
    scores = path_evaluation_batched(
        obj_slam, h_train11, path_actions, current_agent_pose,
        planner.cam_height, forward_step, turn_angle, final_eigs, cfg,
        criterion=criterion if criterion in ("topt", "dopt") else "fisher",
        probes=probes)
    best = int(np.argmax(scores))
    return path_actions[best], paths_arr[best], scores


def object_center_error(mask: np.ndarray, width: int | None = None) -> float:
    """Horizontal offset of the mask centroid from the image center, in
    [-1, 1] (the reference's object_center_error)."""
    mask = np.asarray(mask, bool)
    if not mask.any():
        return 0.0
    w = width or mask.shape[1]
    cx = np.nonzero(mask)[1].mean()
    return float((cx - w / 2.0) / (w / 2.0))


def init_object_policy(mask, turn_angle: float, width: int,
                       max_actions: int = 12) -> list[int]:
    """Turns that bring the object mask's centroid within one turn angle
    of the image center (the reference's init_object_policy)."""
    err = object_center_error(mask, width)
    # horizontal pixel offset -> approximate yaw (90 degree hfov camera)
    yaw_err_deg = err * 45.0
    n = int(abs(yaw_err_deg) // turn_angle)
    action = 3 if yaw_err_deg > 0 else 2       # object right -> turn right
    return [action] * min(n, max_actions)
