"""Recorded episodes for training UPEN's occupancy ensemble.

Counterpart of the JAX package's envs/offline_dataset.py (the
reference's HabitatDataOffline, which replays stored shortest-path
episodes into ego grids): FakeSim episodes, each sample the partial ego
grid of one frame (NHWC probabilities, models/upen.py's
ego_grid_from_depth, in float32 as the JAX package's dataset computes
it) and its complete ground-truth ego grid (class ids:
2 navigable, 1 not), so that the predictor learns to complete maps.  The
recording policy is the frontier-only navigator (engine/navigator.py),
goal-directed coverage as the reference's episodes are, or a random
walk.  The ego grids are computed on the navigator's device; the labels
on the host, vectorized over the grid with the JAX package's float64
arithmetic and BoxScene.is_navigable's float32 positions.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..models.upen import ego_grid_from_depth
from .fake_sim import BoxScene, FakeSim


def generate_offline_dataset(camera, n_scenes: int = 4,
                             steps_per_scene: int = 30, grid_dim: int = 64,
                             cell_size: float = 0.1, seed: int = 0,
                             traj_policy: str = "frontier", device="cuda"):
    """Returns (inputs (N, g, g, 3) float32 partial ego grids, NHWC,
    labels (N, g, g) int64 ground-truth class ids), as numpy arrays.

    Scene s is BoxScene.default(seed * 100 + s), recorded for
    steps_per_scene steps by the frontier navigator (sim and navigator
    seed s, its run directories in a temporary directory) or, with
    traj_policy "random", by random actions."""
    rng = np.random.default_rng(seed)
    inputs, labels = [], []
    with tempfile.TemporaryDirectory() as work_dir:
        for s in range(n_scenes):
            scene = BoxScene.default(seed=seed * 100 + s)
            sim = FakeSim(scene, camera, forward_step=0.15, turn_angle=30.0,
                          seed=s, device=device)

            def on_frame(obs, _t=None, scene=scene, sim=sim):
                ego = ego_grid_from_depth(obs["depth"], sim.intrinsics,
                                          grid_dim=grid_dim,
                                          cell_size=cell_size,
                                          dtype=torch.float32)
                inputs.append(np.moveaxis(ego.cpu().numpy(), 0, -1))
                labels.append(_gt_ego_grid(scene, obs["c2w"], grid_dim,
                                           cell_size))

            if traj_policy == "frontier":
                from ..config import get_cfg_defaults
                from ..engine.navigator import FrontierNavigator
                cfg = get_cfg_defaults()
                cfg.workdir = work_dir
                cfg.run_name = f"rec_{s}"
                cfg.policy.name = "frontier"
                cfg.policy.planning_queue_size = 10
                cfg.num_frames = steps_per_scene
                cfg.forward_step_size = 0.15
                cfg.turn_angle = 30.0
                cfg.explore.cell_size = cell_size
                nav = FrontierNavigator(cfg, sim, scene=scene, seed=s,
                                        device=device)
                nav.frontier_test_navigation(on_step=on_frame)
            else:
                sim.reset()
                for _t in range(steps_per_scene):
                    a = int(rng.choice([1, 1, 1, 2, 3]))
                    on_frame(sim.step(a))
    return np.stack(inputs).astype(np.float32), np.stack(labels)


def _navigable(scene: BoxScene, x, z) -> np.ndarray:
    """BoxScene.is_navigable at each (x, z), vectorized: positions taken
    as float32, as is_navigable takes them."""
    x = np.asarray(x).astype(np.float32).astype(np.float64)
    z = np.asarray(z).astype(np.float32).astype(np.float64)
    r = scene.agent_radius
    lo, hi = scene.room_lo, scene.room_hi
    ok = (lo[0] + r <= x) & (x <= hi[0] - r) & (lo[2] + r <= z) \
        & (z <= hi[2] - r)
    for blo, bhi in scene.obstacles:
        ok &= ~((blo[0] - r <= x) & (x <= bhi[0] + r)
                & (blo[2] - r <= z) & (z <= bhi[2] + r))
    return ok


def _gt_ego_grid(scene: BoxScene, c2w: np.ndarray, grid_dim: int,
                 cell_size: float) -> np.ndarray:
    """Ground-truth ego labels, (g, g) int64: the agent at the bottom
    centre looking +z; 2 where the cell's world position is navigable,
    else 1."""
    c2w = np.asarray(c2w)
    R, t = c2w[:3, :3], c2w[:3, 3]
    fwd = R @ np.array([0.0, 0.0, 1.0])
    yaw = np.arctan2(fwd[0], fwd[2])
    c, s = np.cos(yaw), np.sin(yaw)
    gz, gx = np.meshgrid(np.arange(grid_dim), np.arange(grid_dim),
                         indexing="ij")
    ex = (gx - grid_dim / 2) * cell_size
    ez = gz * cell_size
    wx = t[0] + c * ex + s * ez
    wz = t[2] - s * ex + c * ez
    return np.where(_navigable(scene, wx, wz), 2, 1).astype(np.int64)


def save_dataset(path: str, inputs, labels):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, inputs=inputs, labels=labels)


def load_dataset(path: str):
    with np.load(path) as d:
        return d["inputs"], d["labels"]
