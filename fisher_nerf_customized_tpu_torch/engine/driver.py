"""ActiveMapper: the active-mapping episode driver.

Counterpart of the JAX package's engine/driver.py (the reference's
NavTester.test_navigation): a host loop that feeds the simulator's
RGB-D into GaussianSLAM.track_rgbd and the occupancy update, and plans
whenever the action queue drains: frontier candidate poses scored by
Fisher EIG (K3, 11-wide), one sweep field for their paths, the action
compiler, then path EIG over at most 20 paths (K3, 20-wide), and the
best path's actions are queued.

Policies: 'gaussians_based' (FisherRF), 'frontier' (the same planning
with uniform scores, first valid path) and 'random_walk'; with
`traj_actions` the episode replays them (the 'traj_reader' fixture).  As
in the JAX package, any other name plans as FisherRF does, without the
H_train prewarm.  Not ported yet (ROADMAP.md): the object
branch, UPEN, the DINO gate, the held-out eval curve, reconstruction
metrics, the global point cloud, checkpoint/resume (the port writes no
checkpoint), the cluster manager, pipelined planning and
`explore.prune_invisible`; a config that turns one of them on raises
NotImplementedError.
"""
from __future__ import annotations

import os
from collections import deque

import numpy as np
import torch

from ..models.slam import GaussianSLAM
from ..planning.planner import (AstarPlanner, LocalizationError,
                                NoFrontierError)
from ..utils.logging_utils import StepTimer
from .actions import action_planning, rollout_path_poses
from .path_eval import acc_step_indices, path_eig_scores

_NOT_PORTED = ("{} is not ported to the PyTorch package yet (ROADMAP.md, "
               "queue 1)")


def _check_ported(cfg, policy_name: str):
    """Raise NotImplementedError for a setting whose code path is not
    ported."""
    if policy_name.lower().startswith("upen"):
        raise NotImplementedError(_NOT_PORTED.format(
            f"The UPEN policy {policy_name!r}"))
    unported = [
        (bool(cfg.tpu.get("pipeline_planning", False)),
         "Pipelined planning (tpu.pipeline_planning)"),
        (bool(cfg.explore.prune_invisible),
         "explore.prune_invisible"),
        (int(cfg.eval_every) > 0, "The held-out eval curve (eval_every)"),
        (bool(cfg.policy.save_nav_images),
         "The navigation images (policy.save_nav_images)"),
    ]
    for on, what in unported:
        if on:
            raise NotImplementedError(_NOT_PORTED.format(what))


class ActiveMapper:
    def __init__(self, cfg, sim, scene=None, policy_name: str | None = None,
                 eval_dir: str | None = None, seed: int = 0,
                 traj_actions=None, scene_id: str | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.sim = sim
        self.scene = scene                    # BoxScene (GT access) or None
        self.scene_id = scene_id or os.path.basename(eval_dir or "") \
            or "fake_scene"
        self.policy_name = policy_name or str(cfg.policy.name)
        _check_ported(cfg, self.policy_name)
        self.eval_dir = eval_dir or os.path.join(cfg.workdir, cfg.run_name)
        os.makedirs(self.eval_dir, exist_ok=True)

        self.slam = GaussianSLAM(cfg, eval_dir=self.eval_dir, device=device)
        self.planner = AstarPlanner(cfg, seed=seed, device=device)
        # C-space clearance from the embodied agent radius
        agent_r = getattr(scene, "agent_radius",
                          getattr(sim, "agent_radius", 0.0))
        if agent_r:
            self.planner.set_clearance(float(agent_r))
        self.queue: deque[int] = deque()
        self.rng = np.random.default_rng(seed)
        self.traj_actions = list(traj_actions) if traj_actions else None

        self.forward_step = float(cfg.forward_step_size)
        self.turn_angle = float(cfg.turn_angle)
        self.queue_size = int(cfg.policy.planning_queue_size)
        self.max_steps = int(cfg.num_frames)
        self.stuck_count = 0      # consecutive blocked forwards
        self.stuck_total = 0      # lifetime blocked forwards (recorded)
        self.plan_watermark = int(cfg.tpu.get("plan_watermark", 2))
        self.timer = StepTimer()
        self.habvis = None
        # one entry per planning event that chose a path: its step, the
        # path scores (path EIG, or None for 'frontier') and the choice
        self.plan_log: list[dict] = []

    # -- setup --------------------------------------------------------------
    def _init_episode(self):
        obs = self.sim.get_observations()
        c2w = obs["c2w"]
        self.slam.init(obs["rgb"], obs["depth"], np.linalg.inv(c2w))
        img_size = (self.slam.camera.height, self.slam.camera.width)
        self.planner.init(c2w, self.sim.intrinsics, img_size=img_size)
        self.planner.update_occ_map(obs["depth"], c2w, 0)
        self._make_habvis()
        # init scan: 90 degrees of turn-left steps
        for _ in range(max(int(90.0 // self.turn_angle), 1)):
            self.queue.append(2)
        return obs

    def _make_habvis(self):
        """Top-down fog-of-war map, whose revealed share is the 2D
        coverage."""
        self.habvis = None
        if self.scene is not None:
            from .visualization import MapVisualizer
            vis_dim = (192, 192)
            gt_free = self.scene.gt_free_map(self.planner.cell_size * 2,
                                             vis_dim,
                                             self.planner.map_center)
            self.habvis = MapVisualizer(gt_free, self.planner.cell_size * 2,
                                        self.planner.map_center)

    # -- planning -----------------------------------------------------------
    def plan_best_path(self, current_agent_pose: np.ndarray, expansion: int,
                       t: int):
        """Global candidates -> sweep paths and actions -> batched path EIG
        -> the best action sequence.  Returns (actions, path) or
        (None, None)."""
        slam, planner = self.slam, self.planner
        snap = getattr(self, "_points_snapshot", None)
        points = snap[1] if snap is not None and snap[0] == t else None
        with self.timer.phase("plan.global"):
            pose_fn = None if self.policy_name == "frontier" \
                else slam.pose_eval_async
            gaussian_points = (points if points is not None
                               else slam.gaussian_points)
            finish = planner.global_planning(
                pose_fn, gaussian_points, None, expansion=expansion,
                agent_pose=current_agent_pose[:3, 3], defer_scores=True)
            if finish is None or isinstance(finish, tuple):
                return None, None
        # the candidate Fisher batch is in flight: launch the sweep field
        # for this frame's map behind it (action_planning's own setup_start
        # call is then a no-op)
        with self.timer.phase("plan.sweep"):
            start = planner.convert_to_map(
                current_agent_pose[[0, 2], 3])[[1, 0]]
            try:
                planner.setup_start(start, gaussian_points, t)
            except LocalizationError:
                return None, None
        # the pull of the candidate scores (waits on the device)
        with self.timer.phase("plan.global.wait"):
            global_points, eigs, _rgp = finish()
            if global_points is None:
                return None, None

        try:
            with self.timer.phase("plan.actions"):
                _goals, path_actions, paths_arr, goal_idx = action_planning(
                    global_points, current_agent_pose, planner,
                    gaussian_points, t, self.forward_step, self.turn_angle,
                    self.queue_size)
        except LocalizationError:
            return None, None
        if not path_actions:
            return None, None
        path_actions, paths_arr, goal_idx = (
            path_actions[:20], paths_arr[:20], goal_idx[:20])

        scores = None
        if self.policy_name == "frontier":
            best = 0       # the first (closest-frontier) valid path
        else:
            with self.timer.phase("plan.h_train"):
                h_train = slam.compute_H_train()
            acc_idx = acc_step_indices(self.queue_size,
                                       int(self.cfg.acc_H_train_every))
            # the path axis padded to 20 (padding rows score -inf)
            p_max = 20
            w2cs = np.tile(np.eye(4, dtype=np.float32),
                           (p_max, len(acc_idx), 1, 1))
            valid = np.zeros((p_max, len(acc_idx)), bool)
            lengths = np.ones((p_max,), np.int32)
            with self.timer.phase("plan.rollout"):
                for i, acts in enumerate(path_actions):
                    poses = rollout_path_poses(current_agent_pose, acts,
                                               planner.cam_height,
                                               self.forward_step,
                                               self.turn_angle)
                    for j, s in enumerate(acc_idx):
                        if s < len(acts):
                            w2cs[i, j] = np.linalg.inv(poses[s])
                            valid[i, j] = True
                    lengths[i] = len(acts)
                final_eigs = np.full((p_max,), -np.inf, np.float32)
                for i, gi in enumerate(goal_idx):
                    # log of the endpoint EIG
                    final_eigs[i] = np.log(max(float(eigs[gi]), 1e-30))
            with self.timer.phase("plan.path_eig"):
                dev = slam.device
                scores = path_eig_scores(
                    slam.state, h_train, torch.as_tensor(w2cs, device=dev),
                    torch.as_tensor(valid, device=dev),
                    torch.as_tensor(lengths, device=dev),
                    torch.as_tensor(final_eigs, device=dev),
                    slam.fisher_camera, slam.fisher_settings,
                    float(self.cfg.H_reg_lambda),
                    float(self.cfg.path_pose_weight),
                    float(self.cfg.path_point_weight),
                    float(self.cfg.path_end_weight),
                    bool(self.cfg.vol_weighted_H),
                    float(slam.gs_pts_cnt()), slam.fisher_grad_value)
                scores = scores.cpu().numpy()[:len(path_actions)]
                best = int(np.argmax(scores))
        self.plan_log.append(dict(t=t, scores=scores, best=best,
                                  actions=list(path_actions[best])))
        return path_actions[best], paths_arr[best]

    def _replan(self, c2w: np.ndarray, t: int):
        expansion = 1
        for _attempt in range(10):
            if self.policy_name == "random_walk":
                self.queue.extend(self._random_walk_actions())
                return
            actions, _path = self.plan_best_path(c2w, expansion, t)
            if actions:
                self.queue.extend(actions)
                return
            expansion += 1
        raise NoFrontierError("no plan found after 10 expansions")

    def _random_walk_actions(self):
        return [int(self.rng.choice([1, 1, 1, 2, 3]))
                for _ in range(self.queue_size)]

    # -- main loop ----------------------------------------------------------
    def test_navigation(self, on_step=None) -> dict:
        """Run the episode to max_steps (cfg.num_frames), the end of
        traj_actions, an exhausted frontier or a stuck agent.  Returns the
        result dict: steps, done_reason, the per-phase timer and, with a
        scene, coverage_2d_pct."""
        obs = self._init_episode()
        t = 0
        done_reason = "max_steps"
        while t < self.max_steps:
            c2w = obs["c2w"]
            # planning runs this step iff the queue is empty: take the
            # Gaussian means before this step's mapping event
            if (not self.queue and self.traj_actions is None
                    and self.policy_name not in ("random_walk", "frontier")):
                self._points_snapshot = (t, self.slam.gaussian_points)
            with self.timer.phase("tracking_mapping"):
                self.slam.track_rgbd(obs["rgb"], obs["depth"],
                                     gt_w2c=np.linalg.inv(c2w))
            with self.timer.phase("occupancy"):
                self.planner.update_occ_map(obs["depth"], c2w, t)

            if self.traj_actions is not None:
                if t >= len(self.traj_actions):
                    done_reason = "traj_end"
                    break
                action = int(self.traj_actions[t])
            else:
                if (self.policy_name == "gaussians_based"
                        and len(self.queue) <= max(self.plan_watermark + 2,
                                                   int(self.cfg.map_every)
                                                   + 2)):
                    # H_train ahead of the planning event (cached)
                    with self.timer.phase("prewarm"):
                        self.slam.prewarm_H_train()
                try:
                    while not self.queue:
                        with self.timer.phase("planning"):
                            self._replan(c2w, t)
                except NoFrontierError:
                    done_reason = "no_frontier"
                    break
                action = self.queue.popleft()

            prev_pos = self.sim.c2w[:3, 3].copy() if hasattr(self.sim, "c2w") \
                else c2w[:3, 3].copy()
            with self.timer.phase("sim_step"):
                obs = self.sim.step(action)
            # stuck detection: a blocked forward makes the cell ahead an
            # obstacle, so that the replan routes around it; more than 10
            # consecutive blocked forwards end the episode
            if action == 1:
                moved = np.linalg.norm(obs["c2w"][:3, 3] - prev_pos)
                if moved < 1e-3:
                    self.stuck_count += 1
                    self.stuck_total += 1
                    fwd = obs["c2w"][:3, :3] @ np.array([0.0, 0.0, 1.0])
                    ahead = (obs["c2w"][:3, 3]
                             + fwd * max(self.forward_step,
                                         self.planner.cell_size * 1.5))
                    self.planner.add_obstacle((ahead[0], ahead[2]))
                    self.queue.clear()
                    if self.stuck_count > 10:
                        done_reason = "stuck"
                        break
                else:
                    self.stuck_count = 0
            if self.habvis is not None:
                with self.timer.phase("habvis"):
                    self.habvis.update_fow_sim(obs["c2w"])
            if on_step is not None:
                on_step(t, obs)
            t += 1

        result = dict(scene=self.scene_id, policy=self.policy_name,
                      max_steps=self.max_steps, steps=t,
                      done_reason=done_reason, stuck_total=self.stuck_total,
                      n_gaussians=self.slam.n_active,
                      n_keyframes=len(self.slam.keyframes),
                      planning_events=len(self.plan_log),
                      timing=self.timer.summary())
        if self.habvis is not None:
            result["coverage_2d_pct"] = self.habvis.coverage_2d()
        return result
