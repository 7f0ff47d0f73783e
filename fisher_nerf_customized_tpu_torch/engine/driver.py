"""ActiveMapper: the active-mapping episode driver.

Counterpart of the JAX package's engine/driver.py (the reference's
NavTester.test_navigation): a host loop that feeds the simulator's
RGB-D into GaussianSLAM.track_rgbd, the occupancy update and the global
point cloud, and plans whenever the action queue drains: frontier
candidate poses scored by Fisher EIG (K3, 11-wide), one sweep field for
their paths, the action compiler, then path EIG over at most 20 paths
(K3, 20-wide), and the best path's actions are queued.  Every 25 steps
the running reconstruction metric takes the cloud's new points; with
cfg.eval_every the held-out PSNR curve is recorded; every
checkpoint_interval steps (offset to the middle of the mapping window)
the episode is checkpointed.  After the loop the map is evaluated over
held-out poses (eval_navigation) and the curves are written.

Checkpoints (save_checkpoint / resume) hold the JAX package's files:
params{t}.npz, keyframes.npz, astar.npz, global_pcl.npz,
metrics_curve.yaml, episode_rng.pkl (the four numpy generator states) and
episode_state.npz, written last as the commit record.  Unlike the JAX
package's, each of the others carries the step t it belongs to, and
resume refuses a group whose files name another step than the record;
the record also holds the curve, the PLY-export latch, the SLAM run
state (per-tile K, deferred checks) and the running metric's distances
in float64.  resume reads a JAX checkpoint too (no steps: taken as is;
its `last_goal`, which the JAX planner never reads, is not kept).

Policies: 'gaussians_based' (FisherRF), 'frontier' (the same planning
with uniform scores, first valid path) and 'random_walk'; with
`traj_actions` the episode replays them (the 'traj_reader' fixture).  As
in the JAX package, any other name plans as FisherRF does, without the
H_train prewarm.

The simulator is a FakeSim or an envs/habitat_adapter.py HabitatSim;
what only FakeSim has (render_at_batch, prefetch, the scene's boxes) is
taken where the sim has it, as in the JAX package.

The object branch (`object_scene`, on a FakeSim with a SimObject or a
HabitatSim with a spawned object, whose ground-truth cloud may be
missing: the object curve is then not recorded): each
step the object mask comes from the semantic channel; while it covers
more than 20 pixels, the masked depth is accumulated in the object's
canonical frame (`global_obj_pcl`) and a GaussianObjectSLAM tracks and
maps the object (models/object_slam.py), and while an object is tracked,
planning goes through engine/object_planning.py (criterion cfg.criterion:
`fisher`, `topt` or `dopt`), the scene planner taking over where it
finds no path.  With `dynamic_scene` the object random-walks each step.
Every 25 steps the object reconstruction curve (completeness of the
canonical cloud against the object's surface, 1 cm) is recorded.
Checkpoints carry the object cloud, the object's cells of the map view
and object_metrics_curve.yaml, as the JAX package's do (not the object
SLAM, which, as there, starts anew at the next detection).

Known-environment mode (`known_env_points`, a ground-truth cloud of the
scene without the object): the planner's map is seeded from the cloud
(AstarPlanner.init_known_env), each step marks the camera's field of view
as covered, and the frontier is the free space not yet covered.  On the
object branch the object mask is then the novelty mask: the pixels more
than 5 cm from the cloud (ops/knn.py::novelty_mask_from_pcd_nn, the 1-NN
kernel on the card, the cloud uploaded once).  As in the JAX package the
coverage is not checkpointed: a resumed known-env episode plans from the
unknown cells of its restored map.

The reconstruction metrics find their nearest neighbours on the mapper's
device (engine/eval.py::_nn_dists: the 1-NN kernel on the card from 1e8
pairs up, cKDTree below that and on the CPU).

Preemption, as in the JAX package: while test_navigation runs, SIGTERM
and SIGUSR1 set the cluster manager's exit flag (utils/cluster.py), and
so does its time budget.  The loop polls it at the top of every step,
before any work of step t: it checkpoints step t - 1 with the sim's pose
and resume_t = t, and requeues.  Resuming that checkpoint takes the
uninterrupted run's actions.

With `explore.prune_invisible`, each planning event first drops the
Gaussians seen from no keyframe (GaussianSLAM.prune_invisible).

UPEN (a policy name starting with "upen", models/upen.py): every step
registers its depth into UPEN's geocentric grid (cells of twice
explore.cell_size), and each replan asks UPEN for a goal cell (FBE on
the fused map, or with policy.with_rrt_planning or "rrt" in the name,
RRT* paths scored by the ensemble's disagreement), which the planner's
path and the action compiler reach; where UPEN's goal has no path, five
random-walk actions.  The Gaussian map is still built (mapping events)
but never scored.  As in the JAX package, UPEN's grid is not
checkpointed: a resumed UPEN episode starts a new grid at its first step
(the JAX package's fails there, ROADMAP.md fault t).

The DINO gate (`dino_gate` or `dino_weights` on the object branch,
engine/dino_gate.py): the object's first frame enters the descriptor
bank; each later object frame maps the object only if its masked patch
descriptors are distinct from the bank's (then they join it).  The
descriptors are the DINOv2 ViT's patch tokens with `dino_weights` (a
checkpoint, models/perceptual.py, run on the mapper's device), else
colour and gradient histograms.  `dino_log` lists (step,
accepted).  As in the JAX package the bank is not checkpointed.

With policy.save_nav_images, each planning event writes
planning_vis/plan_<frame>.png and every 20th step
nav_images/topdown_<step>.png (engine/visualization.py).

Pipelined planning (tpu.pipeline_planning), as in the JAX package: when
0 < len(queue) <= tpu.plan_watermark at the top of a step (not under
UPEN, the frontier policy or a scripted trajectory), `prepare_planning`
generates the candidates from this step's map and occupancy and launches
their Fisher scoring, before this step's mapping event; the planning
event that drains the queue takes that preparation when it plans its
first round (expansion 1) at most plan_watermark + 2 steps after it,
and plans anew otherwise.  Each step also prefetches the next frame
(FakeSim.prefetch) for the queue's head or the scripted action, before
its mapping event.  `plan_preps` counts the preparations made, consumed
and dropped as stale.  A preparation is not checkpointed (nor in the
JAX package), so a run resumed between a preparation and its planning
event plans that event anew.
"""
from __future__ import annotations

import json
import os
import pickle
from collections import deque

import numpy as np
import torch

from ..models.slam import GaussianSLAM
from ..planning.planner import (AstarPlanner, LocalizationError,
                                NoFrontierError, _host)
from ..utils.cluster import ClusterStateManager, get_cluster_manager
from ..utils.io import atomic_pickle, atomic_savez, valid_npz
from ..utils.logging_utils import MetricsLogger, StepTimer
from ..utils.pointcloud import GlobalPointCloud, backproject_depth
from .actions import action_planning, compile_actions, rollout_path_poses
from .eval import (IncrementalReconMetric, MetricsRecorder,
                   accuracy_comp_ratio_from_pcl, eval_navigation)
from .path_eval import acc_step_indices, path_eig_scores

class TornCheckpointError(RuntimeError):
    """A checkpoint file belongs to another step than the commit
    record."""


def _stamp(path: str):
    """The step an npz checkpoint file names (`ckpt_t`), or None."""
    with np.load(path) as d:
        return int(d["ckpt_t"]) if "ckpt_t" in d.files else None


class ActiveMapper:
    def __init__(self, cfg, sim, scene=None, policy_name: str | None = None,
                 eval_dir: str | None = None, seed: int = 0,
                 traj_actions=None, scene_id: str | None = None,
                 object_scene: bool = False, dynamic_scene: bool = False,
                 known_env_points=None, device="cuda",
                 cluster_manager: ClusterStateManager | None = None,
                 dino_gate: bool = False, dino_weights: str | None = None):
        self.cfg = cfg
        self.sim = sim
        self.scene = scene                    # BoxScene (GT access) or None
        self.scene_id = scene_id or os.path.basename(eval_dir or "") \
            or "fake_scene"
        self.policy_name = policy_name or str(cfg.policy.name)
        self.eval_dir = eval_dir or os.path.join(cfg.workdir, cfg.run_name)
        os.makedirs(self.eval_dir, exist_ok=True)

        self.device = device
        self.object_scene = bool(object_scene)
        self.dynamic_scene = bool(dynamic_scene)
        self.known_env_points = known_env_points  # the known scene's cloud
        self._known_env_dev = None                # its device copy, once
        self.obj_slam = None
        self.object_tracking = False
        self.criterion = str(cfg.criterion)
        self.object_metrics = MetricsRecorder(f"{cfg.criterion}_OA",
                                              self.scene_id)
        self._obj_pcl_parts: list[np.ndarray] = []
        # the DINO gate of object mapping: the ViT of a checkpoint
        # (dino_weights), else the histogram extractor
        self.dino_bank = None
        self._dino_extractor = None
        self._dino_on_device = bool(dino_weights)
        self.dino_log: list[tuple[int, bool]] = []
        if self.object_scene and (dino_gate or dino_weights):
            from .dino_gate import DinoBank, PatchDescriptorExtractor
            self.dino_bank = DinoBank()
            if dino_weights:
                from ..models.perceptual import ViTPatchExtractor
                self._dino_extractor = ViTPatchExtractor.from_checkpoint(
                    dino_weights, device=device)
            else:
                self._dino_extractor = PatchDescriptorExtractor()

        self.slam = GaussianSLAM(cfg, eval_dir=self.eval_dir, device=device)
        self.planner = AstarPlanner(cfg, seed=seed, device=device,
                                    eval_dir=self.eval_dir)
        # C-space clearance from the embodied agent radius
        agent_r = getattr(scene, "agent_radius",
                          getattr(sim, "agent_radius", 0.0))
        if agent_r:
            self.planner.set_clearance(float(agent_r))
        self.queue: deque[int] = deque()
        self.rng = np.random.default_rng(seed)
        self.global_pcl = GlobalPointCloud(keep_ratio=0.05, seed=seed)
        self.metrics = MetricsRecorder(self.policy_name, self.scene_id)
        self.traj_actions = list(traj_actions) if traj_actions else None

        self.forward_step = float(cfg.forward_step_size)
        self.turn_angle = float(cfg.turn_angle)
        self.queue_size = int(cfg.policy.planning_queue_size)
        self.max_steps = int(cfg.num_frames)
        self.checkpoint_interval = int(cfg.checkpoint_interval)
        self.stuck_count = 0      # consecutive blocked forwards
        self.stuck_total = 0      # lifetime blocked forwards (recorded)
        self.plan_watermark = int(cfg.tpu.get("plan_watermark", 2))
        self.pipeline_planning = bool(cfg.tpu.get("pipeline_planning",
                                                  False))
        self._plan_prep = None         # (step, finish) of a pending stage 1
        self.plan_preps = dict(made=0, consumed=0, dropped=0)
        self._inc_recon = None
        self._inc_recon_saved = None   # the running metric of a checkpoint
        self._pcl_skip = 0             # its points already in the cloud
        self._pcl_cursor = 0
        self._pcl_1000_saved = False   # the step-1000 PLY export latch
        self._eval_curve = None
        self._resume_t = None
        # preemption: polled at the top of every step (the process's
        # manager unless one is given)
        self.cm = (cluster_manager if cluster_manager is not None
                   else get_cluster_manager())
        self.timer = StepTimer()
        self.mlog = MetricsLogger(self.eval_dir, cfg.run_name,
                                  use_wandb=bool(cfg.use_wandb))
        self.habvis = None
        # one entry per planning event that chose a path: its step, the
        # path scores (path EIG, or None for 'frontier' and UPEN) and the
        # choice
        self.plan_log: list[dict] = []
        self.upen = None
        if self.policy_name.lower().startswith("upen"):
            from ..models.upen import UPEN
            self.upen = UPEN(options=None, cfg=cfg, seed=seed,
                             cell_size=float(cfg.explore.cell_size) * 2,
                             use_rrt=bool(cfg.policy.with_rrt_planning)
                             or "rrt" in self.policy_name.lower(),
                             ensemble_dir=str(cfg.policy.get(
                                 "ensemble_dir", "")) or None,
                             device=device)

    # -- setup --------------------------------------------------------------
    def _init_episode(self):
        obs = self.sim.get_observations()
        c2w = obs["c2w"]
        self.slam.init(obs["rgb"], obs["depth"], np.linalg.inv(c2w))
        img_size = (self.slam.camera.height, self.slam.camera.width)
        if self.known_env_points is not None:
            self.planner.init_known_env(c2w, self.known_env_points,
                                        intrinsic=self.sim.intrinsics,
                                        img_size=img_size)
        else:
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

    # -- object branch ------------------------------------------------------
    def _object_mask(self, obs):
        """The object's pixels, (H, W) bool numpy: in known-environment
        mode the novelty mask against the known cloud; else the spawned
        object's semantic id (a real semantic sensor labels every pixel
        with an instance id), else any nonzero label; None off the object
        branch or without a semantic channel."""
        if not self.object_scene:
            return None
        if self.known_env_points is not None:
            from ..ops.knn import novelty_mask_from_pcd_nn
            dev = self.device
            if self._known_env_dev is None:
                self._known_env_dev = torch.as_tensor(
                    np.asarray(self.known_env_points, np.float32),
                    device=dev)
            inv_k = np.linalg.inv(self.sim.intrinsics).astype(np.float32)
            depth = torch.as_tensor(obs["depth"], device=dev)
            mask, _n = novelty_mask_from_pcd_nn(
                self._known_env_dev, depth.reshape(depth.shape[-2:]),
                torch.as_tensor(inv_k, device=dev),
                torch.as_tensor(np.asarray(obs["c2w"], np.float32),
                                device=dev))
            return mask.cpu().numpy()
        if "semantic" not in obs:
            return None
        sem = np.asarray(obs["semantic"])
        obj = getattr(self.sim, "dynamic_object", None)
        if obj is not None and getattr(obj, "semantic_id", None) is not None:
            return sem == int(obj.semantic_id)
        return sem > 0

    def _accumulate_object_pcl(self, obs, mask):
        """Back-project the masked depth and keep it in the object's
        canonical frame (through inv(object_pose)), so that a moving
        object's observations stay registered.  At most 4096 points per
        frame; past 400 000 in all, the cloud is deduplicated on a 0.5 cm
        voxel grid (half the 1 cm metric scale, so coverage is kept),
        and randomly cut to 300 000 only if still above."""
        obj = getattr(self.sim, "dynamic_object", None)
        if obj is None:
            return
        depth = _host(obs["depth"])
        d_masked = np.where(mask, depth, 0.0).astype(np.float32)
        pts_w = backproject_depth(d_masked, self.sim.intrinsics, obs["c2w"])
        if len(pts_w) == 0:
            return
        T_wo = obj.object_pose()
        pts_obj = (pts_w - T_wo[:3, 3]) @ T_wo[:3, :3]
        if len(pts_obj) > 4096:
            idx = self.rng.choice(len(pts_obj), 4096, replace=False)
            pts_obj = pts_obj[idx]
        self._obj_pcl_parts.append(pts_obj.astype(np.float32))
        if sum(len(p) for p in self._obj_pcl_parts) > 400_000:
            merged = np.concatenate(self._obj_pcl_parts)
            q = np.round(merged / 0.005).astype(np.int64)
            _, first = np.unique(q, axis=0, return_index=True)
            merged = merged[first]
            if len(merged) > 400_000:
                keep = self.rng.choice(len(merged), 300_000, replace=False)
                merged = merged[keep]
            self._obj_pcl_parts = [merged]

    @property
    def global_obj_pcl(self) -> np.ndarray:
        """The accumulated object cloud (M, 3) in the canonical frame."""
        if not self._obj_pcl_parts:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(self._obj_pcl_parts)

    def _object_step(self, obs, mask, t):
        """Accumulate the object cloud; start the object SLAM at the first
        detection (then queue the turns that center the object) or track
        and map the object."""
        from ..models.object_slam import GaussianObjectSLAM
        from .object_planning import init_object_policy
        w2c = np.linalg.inv(obs["c2w"])
        self._accumulate_object_pcl(obs, mask)
        if self.obj_slam is None:
            self.obj_slam = GaussianObjectSLAM(
                self.cfg, eval_dir=self.eval_dir, start_frame_idx=t,
                device=self.device)
            self.obj_slam.init(obs["rgb"], obs["depth"], w2c, mask)
            self.queue.clear()
            self.queue.extend(init_object_policy(mask, self.turn_angle,
                                                 mask.shape[1]))
            self.object_tracking = True
            if self.dino_bank is not None:
                self._dino_decide(obs, mask, t, force=True)
            return
        allow_map = True
        if self.dino_bank is not None:
            allow_map = self._dino_decide(obs, mask, t)
        self.obj_slam.track_rgbd(obs["rgb"], obs["depth"], gt_w2c=w2c,
                                 obj_mask_2d=mask, step=t,
                                 allow_map=allow_map)
        self.object_tracking = True

    def _dino_decide(self, obs, mask, t, force: bool = False) -> bool:
        """The DINO gate on one object frame: whether the frame joins the
        bank, and so may map the object; `force` admits the object's
        first frame.  The ViT takes the RGB where it lies; the histogram
        extractor takes it on the host."""
        rgb = obs["rgb"] if self._dino_on_device else _host(obs["rgb"])
        with self.timer.phase("dino_gate"):
            descs = self._dino_extractor(rgb, mask)
            accepted = self.dino_bank.add_if_distinct(descs, force=force)
        self.dino_log.append((int(t), bool(accepted)))
        return accepted

    def record_object_metrics(self, t, gt_object_points,
                              dist_thresh: float = 0.01):
        """Record the object reconstruction at step t: the canonical-frame
        cloud against the object's surface points in its canonical frame
        (or, before any cloud, the object Gaussians' means); None before
        the object is seen."""
        est = self.global_obj_pcl
        if len(est) == 0:
            if self.obj_slam is None or self.obj_slam.n_active == 0:
                return None
            est = self.obj_slam.gaussian_points
        m = accuracy_comp_ratio_from_pcl(est, gt_object_points, dist_thresh,
                                         device=self.device)
        self.object_metrics.record(t, **m)
        return m

    # -- planning -----------------------------------------------------------
    def prepare_planning(self, current_agent_pose: np.ndarray, t: int):
        """Pipelined planning's stage 1: the candidates of this step's map
        and occupancy, their Fisher scoring launched (pose_eval_async);
        plan_best_path takes the finish closure when the queue drains.
        Nothing under the frontier policy or while a preparation is
        pending."""
        if self.policy_name == "frontier" or self._plan_prep is not None:
            return
        slam, planner = self.slam, self.planner
        if bool(self.cfg.explore.prune_invisible):
            slam.prune_invisible()
        try:
            finish = planner.global_planning(
                slam.pose_eval_async, slam.gaussian_points, None,
                expansion=1, agent_pose=current_agent_pose[:3, 3],
                defer_scores=True)
        except (LocalizationError, NoFrontierError):
            return
        if finish is not None:
            self._plan_prep = (t, finish)
            self.plan_preps["made"] += 1

    def plan_best_path(self, current_agent_pose: np.ndarray, expansion: int,
                       t: int):
        """Global candidates (or a pending stage 1's) -> sweep paths and
        actions -> batched path EIG -> the best action sequence.  Returns
        (actions, path) or (None, None)."""
        slam, planner = self.slam, self.planner
        prep, self._plan_prep = self._plan_prep, None
        snap = getattr(self, "_points_snapshot", None)
        points = snap[1] if snap is not None and snap[0] == t else None
        with self.timer.phase("plan.global"):
            if (prep is not None and expansion == 1
                    and t - prep[0] <= self.plan_watermark + 2):
                finish = prep[1]
                self.plan_preps["consumed"] += 1
            else:
                if prep is not None:
                    self.plan_preps["dropped"] += 1
                if bool(self.cfg.explore.prune_invisible):
                    slam.prune_invisible()
                pose_fn = None if self.policy_name == "frontier" \
                    else slam.pose_eval_async
                finish = planner.global_planning(
                    pose_fn,
                    points if points is not None else slam.gaussian_points,
                    None, expansion=expansion,
                    agent_pose=current_agent_pose[:3, 3], defer_scores=True,
                    visualize=bool(self.cfg.policy.save_nav_images))
            gaussian_points = (points if points is not None
                               else slam.gaussian_points)
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

    @staticmethod
    def _pose_xzyaw(c2w):
        fwd = c2w[:3, :3] @ np.array([0.0, 0.0, 1.0])
        return (float(c2w[0, 3]), float(c2w[2, 3]),
                float(np.arctan2(fwd[0], fwd[2])))

    def _replan_upen(self, c2w, t) -> bool:
        """UPEN's goal cell -> world xz -> the planner's path -> actions
        queued; False where UPEN gives no goal or it has no path."""
        goal_cell, _info = self.upen.predict_action(self._pose_xzyaw(c2w))
        if goal_cell is None:
            return False
        gh, gw = self.upen.sgrid.grid_dim
        origin = self.upen.sgrid.origin_pose
        wx = (float(goal_cell[0]) - gw / 2) * self.upen.cell_size + origin[0]
        wz = (float(goal_cell[1]) - gh / 2) * self.upen.cell_size + origin[1]
        start = self.planner.convert_to_map(c2w[[0, 2], 3])[[1, 0]]
        try:
            self.planner.setup_start(start, self.slam.gaussian_points, t)
        except LocalizationError:
            return False
        finish = self.planner.convert_to_map((wx, wz))[[1, 0]]
        paths = self.planner.planning(finish)
        if len(paths) == 0:
            return False
        actions = compile_actions(paths, c2w, c2w, self.planner.cam_height,
                                  self.planner.convert_to_world,
                                  self.forward_step, self.turn_angle,
                                  self.queue_size)
        if not actions:
            return False
        self.queue.extend(actions)
        self.plan_log.append(dict(t=t, scores=None, best=0,
                                  actions=list(actions)))
        return True

    def _replan(self, c2w: np.ndarray, t: int):
        expansion = 1
        for _attempt in range(10):
            if self.policy_name == "random_walk":
                self.queue.extend(self._random_walk_actions())
                return
            if self.upen is not None:
                if self._replan_upen(c2w, t):
                    return
                self.queue.extend(self._random_walk_actions()[:5])
                return
            if self.object_tracking and self.obj_slam is not None:
                # the object-observing path takes over while an object is
                # tracked
                from .object_planning import plan_best_object_path
                with self.timer.phase("plan.object"):
                    actions, _p, scores = plan_best_object_path(
                        self.obj_slam, self.slam, self.planner, c2w,
                        expansion, t, self.cfg, self.forward_step,
                        self.turn_angle, self.queue_size,
                        criterion=self.criterion)
                if actions:
                    self.plan_log.append(dict(
                        t=t, scores=scores, best=int(np.argmax(scores)),
                        actions=list(actions), object=True))
                    self.queue.extend(actions)
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
    def test_navigation(self, n_eval_poses: int | None = None,
                        recon_gt_points=None, on_step=None) -> dict:
        """Run the episode to max_steps (cfg.num_frames), the end of
        traj_actions, an exhausted frontier or a stuck agent; after
        resume(), from the checkpoint's step.  With `recon_gt_points`, the
        reconstruction metric runs every 25 steps and at the end.  Unless
        n_eval_poses is 0, the map is evaluated over n_eval_poses held-out
        poses (2000 for None) at the end.  Returns the result dict: steps,
        done_reason, the per-phase timer, planning_events and, with a
        scene, coverage_2d_pct, `eval`; with a ground-truth cloud, `recon`
        and `auc`.  SIGTERM and SIGUSR1 set the cluster manager's exit
        flag while it runs (see the module docstring)."""
        with self.cm.armed():
            return self._test_navigation(n_eval_poses, recon_gt_points,
                                         on_step)

    def _test_navigation(self, n_eval_poses, recon_gt_points, on_step):
        if self._resume_t is not None:
            obs = self.sim.get_observations()
            t, self._resume_t = self._resume_t, None
        else:
            obs = self._init_episode()
            t = 0
        c2w = obs["c2w"]
        done_reason = "max_steps"
        while t < self.max_steps:
            if self.cm.should_exit():
                # preempted: step t has not run, and the sim is at its
                # pose, so the resume starts at t from there
                self.save_checkpoint(max(t - 1, 0), sim_c2w=obs["c2w"],
                                     resume_t=t)
                self.cm.requeue()
            c2w = obs["c2w"]
            obj = getattr(self.sim, "dynamic_object", None)
            if self.dynamic_scene and obj is not None:
                obj.moving_randomly()
                obs = self.sim.get_observations()
            obj_mask = self._object_mask(obs)
            # the next action is known while the queue holds one (or the
            # trajectory scripts it): launch the next frame's raycast
            # before this step's mapping event
            with self.timer.phase("prefetch"):
                if hasattr(self.sim, "prefetch"):
                    if self.traj_actions is None and self.queue:
                        self.sim.prefetch(self.queue[0])
                    elif (self.traj_actions is not None
                            and t < len(self.traj_actions)):
                        self.sim.prefetch(int(self.traj_actions[t]))
            # pipelined planning's stage 1, before this step's mapping
            # event: the candidates' scoring is launched ahead of it
            if (self.pipeline_planning and self.upen is None
                    and self.traj_actions is None
                    and 0 < len(self.queue) <= self.plan_watermark):
                with self.timer.phase("planning"):
                    self.prepare_planning(c2w, t)
            # planning runs this step iff the queue is empty: take the
            # Gaussian means before this step's mapping event (not under
            # prune_invisible, which changes them before planning)
            if (not self.queue and self.traj_actions is None
                    and self.upen is None
                    and self.policy_name not in ("random_walk", "frontier")
                    and not bool(self.cfg.explore.prune_invisible)):
                self._points_snapshot = (t, self.slam.gaussian_points)
            with self.timer.phase("tracking_mapping"):
                self.slam.track_rgbd(obs["rgb"], obs["depth"],
                                     gt_w2c=np.linalg.inv(c2w))
            if obj_mask is not None and obj_mask.sum() > 20:
                with self.timer.phase("object_tracking"):
                    self._object_step(obs, obj_mask, t)
            with self.timer.phase("occupancy"):
                self.planner.update_occ_map(obs["depth"], c2w, t)
                if self.planner.covered is not None:
                    self.planner.cover_fov_2d(c2w)
            if self.upen is not None:
                with self.timer.phase("upen_observe"):
                    pose = self._pose_xzyaw(c2w)
                    # the grid is not checkpointed: a resumed episode
                    # starts a new one at its first step (ROADMAP fault t)
                    if t == 0 or self.upen.sgrid.origin_pose is None:
                        self.upen.init(pose)
                    self.upen.observe(obs["depth"], self.sim.intrinsics, pose,
                                      cam_height=float(c2w[1, 3]))
            with self.timer.phase("pcl"):
                self.global_pcl.add_frame(obs["depth"], self.sim.intrinsics,
                                          c2w, color=obs["rgb"])

            if self.traj_actions is not None:
                if t >= len(self.traj_actions):
                    done_reason = "traj_end"
                    break
                action = int(self.traj_actions[t])
            else:
                if (self.policy_name == "gaussians_based" and self.upen is None
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

            # held-out PSNR / depth-MAE curve on a fixed pose set
            ev_every = int(self.cfg.eval_every)
            if (ev_every > 0 and t > 0 and t % ev_every == 0
                    and self.scene is not None
                    and hasattr(self.sim, "render_at")):
                with self.timer.phase("eval_curve"):
                    if self._eval_curve is None:
                        from .eval import EvalPoseCurve
                        self._eval_curve = EvalPoseCurve(
                            self.scene, self.sim,
                            cam_height=float(c2w[1, 3]))
                    em = self._eval_curve.update(self.slam)
                    self.metrics.record(t, **em)
                    self.mlog.log(t, **em)
            if recon_gt_points is not None and t % 25 == 0:
                with self.timer.phase("recon_metric"):
                    m = self._recon_update(recon_gt_points)
                    self.metrics.record(t, **m)
                    self.mlog.log(t, **m, n_gaussians=self.slam.n_active)
            if self.obj_slam is not None and t % 25 == 0 and obj is not None:
                # the object curve, against 20 000 surface samples (at the
                # 1 cm protocol a sparser cloud is sampling-limited)
                with self.timer.phase("obj_recon_metric"):
                    gt_obj = obj.sample_surface_points(20000, frame="object")
                    if gt_obj is not None:   # an object without a cloud
                        self.record_object_metrics(t, gt_obj)
            if self.habvis is not None:
                with self.timer.phase("habvis"):
                    self.habvis.update_fow_sim(obs["c2w"])
                if self.dynamic_scene and obj is not None:
                    self.habvis.update_object(obj.translation)
                if bool(self.cfg.policy.save_nav_images) and t % 20 == 0:
                    self.habvis.save_vis_seen(
                        os.path.join(self.eval_dir, "nav_images"), t)
            # the checkpoint cadence is offset to the middle of the mapping
            # window, where the device is idle and the state pull is a copy
            ck_off = (int(self.cfg.map_every) // 2) % self.checkpoint_interval
            if t > ck_off and t % self.checkpoint_interval == ck_off:
                # the sim has already moved to step t+1's pose
                self.save_checkpoint(t, sim_c2w=obs["c2w"], resume_t=t + 1)
            if t >= 1000 and not self._pcl_1000_saved:
                # the cloud at step 1000 (and at the end, by the CLI)
                self._pcl_1000_saved = True
                with self.timer.phase("pcl_export"):
                    self.global_pcl.save_ply(os.path.join(
                        self.eval_dir, "pointcloud", "global_pcl_1000.ply"))
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
        if n_eval_poses != 0 and self.scene is not None and \
                hasattr(self.sim, "render_at"):
            seen_fn = None
            if self.habvis is not None:
                hv = self.habvis

                def seen_fn(x, z, _hv=hv):
                    cx, cz = _hv._to_cell(x, z)
                    gz, gx = _hv.fow_mask.shape
                    return bool(0 <= cz < gz and 0 <= cx < gx
                                and _hv.fow_mask[cz, cx])
            with self.timer.phase("eval"):
                nav_eval = eval_navigation(self.slam, self.sim, self.scene,
                                           n_poses=n_eval_poses or 2000,
                                           cam_height=float(c2w[1, 3]),
                                           out_dir=self.eval_dir,
                                           seen_fn=seen_fn)
            result["eval"] = {k: v for k, v in nav_eval.items()
                              if k != "per_pose"}
            result["timing"]["eval"] = self.timer.summary()["eval"]
            with open(os.path.join(self.eval_dir, "eval.json"), "w") as f:
                json.dump(nav_eval["per_pose"], f)
            with open(os.path.join(self.eval_dir,
                                   f"{self.policy_name}_results.txt"),
                      "w") as f:
                for k, v in result["eval"].items():
                    f.write(f"{k}: {v}\n")
        if recon_gt_points is not None:
            if self._inc_recon is not None or \
                    self._inc_recon_saved is not None:
                # the running state is the one-shot metric on the whole
                # cloud (an exact decomposition)
                result["recon"] = self._recon_update(recon_gt_points)
            else:
                result["recon"] = accuracy_comp_ratio_from_pcl(
                    self.global_pcl.get(), recon_gt_points, 0.05,
                    surface_dist_fn=getattr(self.scene, "surface_distance",
                                            None), device=self.device)
            result["auc"] = self.metrics.auc()
        if self.metrics.steps:
            self.metrics.dump(os.path.join(self.eval_dir,
                                           "metrics_curve.yaml"))
        if self.object_metrics.steps:
            self.object_metrics.dump(self._path("object_metrics_curve.yaml"))
        return result

    def _recon_update(self, recon_gt_points) -> dict:
        """Feed the running reconstruction metric the cloud's new points.
        After a resume the restored running state stands for the loaded
        cloud's first points (append-only, same order: the skip is
        exact).  The timer splits it under recon_metric: .new_points and
        IncrementalReconMetric.update's sub-phases."""
        if self._inc_recon is None:
            self._inc_recon = IncrementalReconMetric(
                recon_gt_points, 0.05,
                surface_dist_fn=getattr(self.scene, "surface_distance",
                                        None), device=self.device)
            if self._inc_recon_saved is not None:
                if self._inc_recon.load_state_dict(self._inc_recon_saved):
                    self._pcl_skip = self._inc_recon.n_est
                self._inc_recon_saved = None
        with self.timer.phase("recon_metric.new_points"):
            new_pts, self._pcl_cursor = self.global_pcl.get_new(
                self._pcl_cursor)
            if self._pcl_skip:
                k = min(self._pcl_skip, len(new_pts))
                new_pts = new_pts[k:]
                self._pcl_skip -= k
        return self._inc_recon.update(new_pts, timer=self.timer)

    # -- checkpoint / resume ------------------------------------------------
    def _path(self, name: str) -> str:
        return os.path.join(self.eval_dir, name)

    def save_checkpoint(self, t: int, sim_c2w=None,
                        resume_t: int | None = None):
        """Checkpoint the episode as step t.  sim_c2w: the simulator's
        current pose (the in-loop checkpoint comes after the sim stepped
        past the last tracked frame); resume_t: the step the resumed loop
        starts at (default t + 1: step t is done)."""
        self.slam.save(t)
        self.planner.save(self._path("astar.npz"), ckpt_t=int(t))
        self.global_pcl.save(self._path("global_pcl.npz"), ckpt_t=int(t))
        self.metrics.dump(self._path("metrics_curve.yaml"))
        if self.object_metrics.steps:
            self.object_metrics.dump(self._path("object_metrics_curve.yaml"))
        record = dict(
            t=int(t), stuck_count=int(self.stuck_count),
            stuck_total=int(self.stuck_total),
            resume_t=int(t + 1 if resume_t is None else resume_t),
            sim_c2w=(np.zeros((0, 4, 4), np.float32) if sim_c2w is None
                     else np.asarray(sim_c2w, np.float32)[None]),
            queue=np.asarray(list(self.queue), np.int64),
            pcl_1000_saved=bool(self._pcl_1000_saved),
            obj_pcl=self.global_obj_pcl,
            metrics_curve=json.dumps(dict(header=self.metrics.header,
                                          steps=self.metrics.steps)),
            **{f"slam_{k}": v for k, v in self.slam.run_state().items()})
        inc = (self._inc_recon.state_dict() if self._inc_recon is not None
               else self._inc_recon_saved)
        if inc is not None:
            record.update(inc_recon_d_gt_min=np.asarray(inc["d_gt_min"],
                                                        np.float64),
                          inc_recon_acc=np.asarray(inc["acc"], np.float64))
        if self.habvis is not None:
            hv = self.habvis.state_dict()
            record.update(habvis_fow=hv["fow_mask"],
                          habvis_traj=np.asarray(hv["traj"]).reshape(-1, 2),
                          habvis_obj=np.asarray(hv["obj_traj"]).reshape(-1,
                                                                        2))
        # without the generator states a resumed episode's draws part
        # from the uninterrupted run's
        atomic_pickle(self._path("episode_rng.pkl"), dict(
            t=int(t), driver=self.rng.bit_generator.state,
            planner=self.planner.rng.bit_generator.state,
            slam=self.slam.rng.bit_generator.state,
            pcl=self.global_pcl.rng.bit_generator.state))
        # the commit record, last: a kill before it leaves the previous
        # group in force
        atomic_savez(self._path("episode_state.npz"), **record)

    def resume(self, slam_ckpt: str):
        """Restore the episode from a checkpoint, and the simulator's
        pose; the next test_navigation() continues at the checkpoint's
        step.  When episode_state.npz (the commit record) names a step t
        whose params{t}.npz loads, that file is used, whatever
        `slam_ckpt` says.  A file of the group stamped with another step
        than the record's raises TornCheckpointError."""
        ep_path = self._path("episode_state.npz")
        ep = None
        if os.path.exists(ep_path) and valid_npz(ep_path):
            with np.load(ep_path) as d:
                ep = {k: d[k] for k in d.files}
            committed = self._path(f"params{int(ep['t'])}.npz")
            if os.path.exists(committed) and valid_npz(committed):
                slam_ckpt = committed
        t_rec = None if ep is None else int(ep["t"])
        rng_path = self._path("episode_rng.pkl")
        states = None
        if os.path.exists(rng_path):
            with open(rng_path, "rb") as f:
                states = pickle.load(f)
        if t_rec is not None:
            stamps = {name: _stamp(self._path(name))
                      for name in ("keyframes.npz", "astar.npz",
                                   "global_pcl.npz")
                      if os.path.exists(self._path(name))}
            if states is not None:
                stamps["episode_rng.pkl"] = states.get("t")
            torn = {k: v for k, v in stamps.items()
                    if v is not None and v != t_rec}
            if torn:
                raise TornCheckpointError(
                    f"checkpoint files of other steps than the commit "
                    f"record's t={t_rec}: {torn}")

        self.slam.load(slam_ckpt)
        if os.path.exists(self._path("astar.npz")):
            self.planner.load(self._path("astar.npz"))
            self.planner.camera = self.slam.camera
        if os.path.exists(self._path("global_pcl.npz")):
            self.global_pcl.load(self._path("global_pcl.npz"))
        if ep is not None and "metrics_curve" in ep:
            curve = json.loads(str(ep["metrics_curve"]))
            self.metrics.header = dict(curve["header"])
            self.metrics.steps = [dict(s) for s in curve["steps"]]
        elif os.path.exists(self._path("metrics_curve.yaml")):
            self.metrics.load(self._path("metrics_curve.yaml"))
        if os.path.exists(self._path("object_metrics_curve.yaml")):
            self.object_metrics.load(self._path("object_metrics_curve.yaml"))
        if ep is not None:
            self.stuck_count = int(ep["stuck_count"])
            self.stuck_total = int(ep["stuck_total"]) \
                if "stuck_total" in ep else self.stuck_count
            if "inc_recon_d_gt_min" in ep:
                self._inc_recon_saved = dict(d_gt_min=ep["inc_recon_d_gt_min"],
                                             acc=ep["inc_recon_acc"])
            self.queue = deque(int(a) for a in ep["queue"])
            if "obj_pcl" in ep and len(ep["obj_pcl"]):
                self._obj_pcl_parts = [np.asarray(ep["obj_pcl"], np.float32)]
            self._pcl_1000_saved = bool(ep.get("pcl_1000_saved", False))
            if "slam_max_per_tile" in ep:
                self.slam.load_run_state({
                    k[len("slam_"):]: v for k, v in ep.items()
                    if k.startswith("slam_")})
            self._make_habvis()
            if self.habvis is not None and "habvis_fow" in ep:
                self.habvis.load_state_dict(dict(
                    fow_mask=ep["habvis_fow"], traj=ep["habvis_traj"],
                    obj_traj=ep["habvis_obj"]))
            self._resume_t = int(ep["resume_t"]) if "resume_t" in ep \
                else int(ep["t"]) + 1
            if "sim_c2w" in ep and len(ep["sim_c2w"]):
                self.sim.set_pose(ep["sim_c2w"][0])
            else:
                self.sim.set_pose(self.slam.get_latest_frame())
        else:
            self.sim.set_pose(self.slam.get_latest_frame())
        if states is not None:
            self.rng.bit_generator.state = states["driver"]
            self.planner.rng.bit_generator.state = states["planner"]
            self.slam.rng.bit_generator.state = states["slam"]
            self.global_pcl.rng.bit_generator.state = states["pcl"]
