"""FrontierNavigator: the frontier-only exploration driver.

Counterpart of the JAX package's engine/navigator.py (the reference
Navigator.frontier_test_navigation): no Gaussian map, a 360-degree
spin to start, an occupancy update per step, the frontier-based goal
(AstarPlanner.global_planning_frontier: the closest frontier cell at
least 0.5 m away), the planner's path to it and the action compiler,
and a global point cloud keeping 5 % of every frame's pixels.  More
than 10 consecutive blocked forwards end the episode ("stuck"); an
exhausted, unreachable or enclosed frontier ends it as "no_frontier".
With a ground-truth cloud, the reconstruction metric of the whole cloud
runs every 25 steps and at the end (engine/eval.py: on the card its
nearest neighbours come from the 1-NN kernel, the ground truth uploaded
once).
"""
from __future__ import annotations

import os
from collections import deque

import numpy as np
import torch

from ..planning.planner import (AstarPlanner, LocalizationError,
                                NoFrontierError)
from ..utils.pointcloud import GlobalPointCloud
from .actions import compile_actions
from .eval import MetricsRecorder, accuracy_comp_ratio_from_pcl


class FrontierNavigator:
    def __init__(self, cfg, sim, scene=None, eval_dir: str | None = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.sim = sim
        self.scene = scene
        self.device = device
        self.eval_dir = eval_dir or os.path.join(cfg.workdir, cfg.run_name)
        os.makedirs(self.eval_dir, exist_ok=True)
        self.scene_id = os.path.basename(self.eval_dir) or "fake_scene"
        self.planner = AstarPlanner(cfg, seed=seed, device=device)
        agent_r = getattr(scene, "agent_radius", 0.0)
        if agent_r:
            self.planner.set_clearance(float(agent_r))
        self.queue: deque[int] = deque()
        self.global_pcl = GlobalPointCloud(keep_ratio=0.05, seed=seed)
        self.metrics = MetricsRecorder("frontier", self.scene_id)
        self.forward_step = float(cfg.forward_step_size)
        self.turn_angle = float(cfg.turn_angle)
        self.queue_size = int(cfg.policy.planning_queue_size)
        self.max_steps = int(cfg.num_frames)
        self.stuck_count = 0
        self._gt_dev = None       # the ground-truth cloud on the card

    def _replan(self, c2w, t):
        goal, _free = self.planner.global_planning_frontier(
            agent_pose=c2w[:3, 3])
        if goal is None:
            raise NoFrontierError("frontier exploration exhausted")
        agent_pos = c2w[:3, 3]
        start = self.planner.convert_to_map(agent_pos[[0, 2]])[[1, 0]]
        self.planner.setup_start(start, None, t)
        finish = self.planner.convert_to_map(goal[0])[[1, 0]]
        paths = self.planner.planning(finish)
        if len(paths) == 0:
            raise NoFrontierError("frontier goal unreachable")
        # the goal "pose" keeps the agent's heading: no view to align to
        goal_pose = np.asarray(c2w, np.float64).copy()
        actions = compile_actions(paths, goal_pose, c2w,
                                  self.planner.cam_height,
                                  self.planner.convert_to_world,
                                  self.forward_step, self.turn_angle,
                                  self.queue_size)
        if not actions:
            raise NoFrontierError("no actions compiled")
        self.queue.extend(actions)

    def _recon(self, recon_gt_points) -> dict:
        if self._gt_dev is None and torch.device(self.device).type == "cuda":
            self._gt_dev = torch.as_tensor(
                np.asarray(recon_gt_points, np.float32), device=self.device)
        return accuracy_comp_ratio_from_pcl(
            self.global_pcl.get(), recon_gt_points, 0.05,
            surface_dist_fn=getattr(self.scene, "surface_distance", None),
            device=self.device, gt_dev=self._gt_dev)

    def frontier_test_navigation(self, recon_gt_points=None,
                                 on_step=None) -> dict:
        """Run the episode to max_steps (cfg.num_frames), an exhausted
        frontier or a stuck agent.  on_step(obs, t), if given, sees each
        step's observation first.  Returns dict(scene, policy, steps,
        done_reason) and, with a ground-truth cloud, `recon` and `auc`."""
        obs = self.sim.get_observations()
        c2w = obs["c2w"]
        self.planner.init(c2w, self.sim.intrinsics,
                          img_size=tuple(obs["depth"].shape))
        # the 360-degree spin
        for _ in range(max(int(360.0 // self.turn_angle), 1)):
            self.queue.append(2)

        t = 0
        done_reason = "max_steps"
        while t < self.max_steps:
            c2w = obs["c2w"]
            if on_step is not None:
                on_step(obs, t)
            self.planner.update_occ_map(obs["depth"], c2w, t)
            self.global_pcl.add_frame(obs["depth"], self.sim.intrinsics, c2w,
                                      color=obs["rgb"])
            try:
                while not self.queue:
                    self._replan(c2w, t)
            except (NoFrontierError, LocalizationError):
                done_reason = "no_frontier"
                break
            action = self.queue.popleft()
            prev = c2w[:3, 3].copy()
            obs = self.sim.step(action)
            if action == 1:
                if np.linalg.norm(obs["c2w"][:3, 3] - prev) < 1e-3:
                    self.stuck_count += 1
                    self.queue.clear()
                    if self.stuck_count > 10:
                        done_reason = "stuck"
                        break
                else:
                    self.stuck_count = 0
            if recon_gt_points is not None and t % 25 == 0:
                self.metrics.record(t, **self._recon(recon_gt_points))
            t += 1

        result = dict(scene=self.scene_id, policy="frontier", steps=t,
                      done_reason=done_reason)
        if recon_gt_points is not None:
            result["recon"] = self._recon(recon_gt_points)
            result["auc"] = self.metrics.auc()
        return result
