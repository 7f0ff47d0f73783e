"""Path -> discrete-action compiler (host-side numpy).

Counterpart of the JAX package's engine/actions.py (the reference's
action_planning): for each goal pose, follow the planned waypoints by
turn-angle quantization (turn toward the next waypoint until it lies
within one turn angle, else step forward), then align the heading with
the goal pose; at most `queue_size` actions.
"""
from __future__ import annotations

import math

import numpy as np

from ..utils.geometry import compute_next_campos


def compile_actions(paths: np.ndarray, goal_pose: np.ndarray,
                    current_agent_pose: np.ndarray, cam_height: float,
                    convert_to_world, forward_step: float, turn_angle: float,
                    queue_size: int) -> list[int]:
    """Action list (1 fwd / 2 left / 3 right) following `paths` (K, 2)
    grid cells in [x, z] order toward `goal_pose` (4, 4)."""
    future = np.asarray(current_agent_pose, np.float64).copy()
    future[1, 3] = cam_height
    actions: list[int] = []

    if len(paths) == 1:
        paths = np.concatenate([paths, paths], axis=0)
    stage_idx = 1
    stage = paths[stage_idx]
    stage_w = convert_to_world(stage + 0.5)
    stage_w = np.array([stage_w[0], future[1, 3], stage_w[1], 1.0])

    while len(actions) < queue_size:
        rel = np.linalg.inv(future) @ stage_w
        xz = rel[[0, 2]]
        if np.linalg.norm(xz) < forward_step:
            stage_idx += 1
            if stage_idx == len(paths):
                # final heading alignment with the goal pose
                angle = (math.degrees(math.atan2(goal_pose[0, 2], goal_pose[2, 2]))
                         - math.degrees(math.atan2(future[0, 2], future[2, 2])))
                if abs(angle) > 180:
                    angle = angle - 360 if angle > 0 else angle + 360
                for _ in range(int(abs(angle) // turn_angle)):
                    if len(actions) >= queue_size:
                        break
                    a = 2 if angle > 0 else 3
                    future = compute_next_campos(future, a, forward_step,
                                                 turn_angle)
                    actions.append(a)
                break
            stage = paths[stage_idx]
            stage_w = convert_to_world(stage + 0.5)
            stage_w = np.array([stage_w[0], future[1, 3], stage_w[1], 1.0])
            rel = np.linalg.inv(future) @ stage_w
            xz = rel[[0, 2]]

        angle = math.atan2(xz[0], xz[1])
        if angle > math.radians(turn_angle):
            a = 3
        elif angle < -math.radians(turn_angle):
            a = 2
        else:
            a = 1
        future = compute_next_campos(future, a, forward_step, turn_angle)
        actions.append(a)
    return actions


def action_planning(global_points, current_agent_pose, planner,
                    gaussian_points, t, forward_step: float,
                    turn_angle: float, queue_size: int):
    """Plan paths and action sequences for each goal pose.  Returns
    (valid_goals, path_actions, paths_arr, goal_indices); goal_indices[i]
    is the row of `global_points` that produced valid_goals[i], so callers
    can look up per-goal scores without re-matching poses."""
    valid_goals, path_actions, paths_arr, goal_indices = [], [], [], []
    current_agent_pos = current_agent_pose[:3, 3]
    start = planner.convert_to_map(current_agent_pos[[0, 2]])[[1, 0]]
    planner.setup_start(start, gaussian_points, t)

    for gi, pose_np in enumerate(np.asarray(global_points)):
        pos = pose_np[:3, 3].copy()
        pos[1] = current_agent_pos[1]
        finish = planner.convert_to_map(pos[[0, 2]])[[1, 0]]
        paths = planner.planning(finish)
        if len(paths) == 0:
            continue
        actions = compile_actions(paths, pose_np, current_agent_pose,
                                  planner.cam_height, planner.convert_to_world,
                                  forward_step, turn_angle, queue_size)
        if len(actions) == 0 or actions in path_actions:
            continue
        path_actions.append(actions)
        valid_goals.append(pose_np)
        paths_arr.append(paths)
        goal_indices.append(gi)
    return valid_goals, path_actions, paths_arr, goal_indices


def rollout_path_poses(current_agent_pose: np.ndarray, actions: list[int],
                       cam_height: float, forward_step: float,
                       turn_angle: float) -> np.ndarray:
    """c2w pose after each action of a rollout."""
    future = np.asarray(current_agent_pose, np.float64).copy()
    future[1, 3] = cam_height
    out = []
    for a in actions:
        future = compute_next_campos(future, a, forward_step, turn_angle)
        out.append(future.copy())
    return np.asarray(out, np.float32)
