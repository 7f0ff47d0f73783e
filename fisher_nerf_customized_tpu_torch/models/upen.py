"""UPEN: the uncertainty-driven exploration baseline policy.

Counterpart of the JAX package's models/upen.py (the reference's
models/UPEN.py): each step the depth-derived ego grid is registered into
a geocentric SemanticGrid on the card; at each replan the occupancy
ensemble predicts the map around the agent, and either (FBE) the nearest
frontier of the fused map is the goal, or (RRT) a goal is drawn with
probability proportional to info² (info: the ensemble's disagreement
times the predicted unknown-class probability, cells near the agent
left out), RRT* grows exploration paths toward it, and the first
waypoint of the path with the largest summed disagreement is the goal.
As in the JAX package the ensemble's prediction is computed in FBE mode
too, and not read there.  The goal's path is planned by the episode's
planner (engine/driver.py), in place of the reference's DD-PPO policy.

The ego grid is computed on the depth's device (float64 geometry,
float32 counts accumulated with index_put_: small integers, exact);
the planning draws come from a numpy generator seeded as in the JAX
package, so the same inputs give its goals.
"""
from __future__ import annotations

import numpy as np
import torch

from ..planning.frontier_search import FrontierSearch
from ..planning.rrt import RRTStar
from .predictors import PredictorEnsemble
from .semantic_grid import SemanticGrid


def ego_grid_from_depth(depth, intrinsics: np.ndarray, grid_dim: int = 64,
                        cell_size: float = 0.1, height_band=(0.1, 1.3),
                        cam_height: float = 1.25, far: float = 6.0,
                        dtype=torch.float64) -> torch.Tensor:
    """Label-pooled ego occupancy of one (H, W) depth image, numpy or a
    tensor: per cell, the counts of obstacle hits (a height within
    height_band) and of free samples along each ray (at 0.25, 0.5, 0.75
    and 0.92 of the depth) -> (3, g, g) float32 probabilities on the
    depth's device (unseen cells [1, 0, 0]), the agent at the bottom
    centre looking +z.  The points are computed in `dtype` from the
    float64 ray slopes: float64 as the JAX package's UPEN computes them
    from host frames, float32 as its offline dataset does (its frames are
    JAX arrays there, and JAX computes them in float32)."""
    depth = torch.as_tensor(depth)
    dev, f64 = depth.device, torch.float64
    h, w = depth.shape[-2:]
    intr = np.asarray(intrinsics)
    fx, fy = float(intr[0, 0]), float(intr[1, 1])
    cx, cy = float(intr[0, 2]), float(intr[1, 2])
    ys, xs = torch.meshgrid(torch.arange(h, dtype=f64, device=dev),
                            torch.arange(w, dtype=f64, device=dev),
                            indexing="ij")
    z32 = depth.reshape(-1).float()
    valid = (z32 > 0) & (z32 < far)
    z = z32.to(dtype)
    px = ((xs.reshape(-1) - cx) / fx).to(dtype) * z
    py = ((ys.reshape(-1) - cy) / fy).to(dtype) * z   # camera y (down)
    pts = torch.stack([px, py, z], -1)[valid]

    counts = torch.zeros((3, grid_dim, grid_dim), dtype=torch.float32,
                         device=dev)
    flat = counts.view(-1)

    def splat(p_x, p_z, ch):
        gx = (p_x / cell_size + grid_dim / 2).to(torch.int64)
        gz = (p_z / cell_size).to(torch.int64)
        ok = (gx >= 0) & (gx < grid_dim) & (gz >= 0) & (gz < grid_dim)
        at = ch * grid_dim * grid_dim + gz[ok] * grid_dim + gx[ok]
        flat.index_put_((at,), torch.ones_like(at, dtype=torch.float32),
                        accumulate=True)

    # world height = cam_height - camera y
    hgt = cam_height - pts[:, 1]
    obstacle = (hgt >= height_band[0]) & (hgt <= height_band[1])
    splat(pts[obstacle][:, 0], pts[obstacle][:, 2], 1)
    for f in (0.25, 0.5, 0.75, 0.92):
        free_pts = pts * f
        splat(free_pts[:, 0], free_pts[:, 2], 2)
    total = counts[0] + counts[1] + counts[2]
    unseen = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32,
                          device=dev).reshape(3, 1, 1)
    return torch.where(total > 0, counts / torch.clamp(total, min=1e-6),
                       unseen)


class UPEN:
    def __init__(self, options, cfg=None, n_members: int = 4, seed: int = 0,
                 grid_dim: tuple = (192, 192), crop: int = 64,
                 cell_size: float = 0.1, use_rrt: bool = True,
                 ensemble_dir: str | None = None, device="cuda"):
        self.options = options
        self.cfg = cfg
        self.device = torch.device(device)
        self.ensemble = PredictorEnsemble(n_members=n_members, seed=seed,
                                          device=device)
        if ensemble_dir:
            # members saved by tools/train_predictors.py or by the JAX
            # package's scripts/train_predictors.py
            self.ensemble.load(ensemble_dir)
        self.sgrid = SemanticGrid(grid_dim=grid_dim, cell_size=cell_size,
                                  device=device)
        self.crop = crop
        self.cell_size = cell_size
        self.use_rrt = use_rrt
        self.rng = np.random.default_rng(seed)
        self.step_count = 0

    def init(self, pose_xzyaw):
        self.sgrid.set_origin(pose_xzyaw)
        self.step_count = 0

    def observe(self, depth, intrinsics, pose_xzyaw, cam_height=1.25):
        """Register the ego grid of one depth frame taken at pose (x, z,
        yaw); returns the ego grid."""
        ego = ego_grid_from_depth(torch.as_tensor(depth, device=self.device),
                                  intrinsics, grid_dim=self.crop,
                                  cell_size=self.cell_size,
                                  cam_height=cam_height)
        self.sgrid.register_ego(ego, pose_xzyaw)
        self.step_count += 1
        return ego

    def _predict(self, pose_xzyaw):
        """The ensemble on the map's crop at the pose: the mean prediction
        (3, c, c) and the disagreement (c, c), the variance averaged over
        the classes, as numpy arrays."""
        crop = self.sgrid.crop_at(pose_xzyaw, self.crop)      # (3, c, c)
        mean, var, _all = self.ensemble.predict(crop.permute(1, 2, 0)[None])
        return (np.moveaxis(mean[0].cpu().numpy(), -1, 0),
                var[0].cpu().numpy().mean(axis=-1))

    def predict_action(self, pose_xzyaw):
        """The next goal in cells (x, z) of the geocentric grid and an info
        dict (mode "rrt" with n_paths, or "fbe")."""
        mean_pred, uncertainty = self._predict(pose_xzyaw)
        rel = np.asarray(pose_xzyaw, np.float64) - self.sgrid.origin_pose
        gh, gw = self.sgrid.grid_dim
        agent = np.array([gw / 2 + rel[0] / self.cell_size,
                          gh / 2 + rel[1] / self.cell_size])

        geo = self.sgrid.proj_grid.cpu().numpy()
        occ_binary = (geo.argmax(axis=0) == 1).astype(np.uint8)

        if self.use_rrt:
            # the goal is drawn (not the argmax: a fixed max-info goal
            # fixates on one, often unreachable, cell across replans);
            # cells near the agent are left out so that the goal moves it
            ch, cw = uncertainty.shape
            yy, xx = np.mgrid[0:ch, 0:cw]
            dist = np.hypot(xx - cw / 2, yy - ch / 2)
            info = uncertainty * (0.25 + mean_pred[0]) \
                * (dist >= min(10.0, cw / 4))
            w = (info.reshape(-1) ** 2).astype(np.float64)
            goal = agent + self.rng.uniform(-20, 20, 2)
            if np.isfinite(w).all() and w.sum() > 0:
                cell = int(self.rng.choice(len(w), p=w / w.sum()))
                iy, ix = np.unravel_index(cell, info.shape)
                goal = agent + np.array([ix - cw / 2, iy - ch / 2],
                                        np.float64)
            rrt = RRTStar(start=tuple(agent), goal=tuple(goal),
                          occupancy_map=occ_binary,
                          rand_area=(0, min(gh, gw) - 1),
                          expand_dis=6.0, max_iter=300,
                          search_until_max_iter=True, rng=self.rng)
            paths = rrt.planning(exploration=True, horizon=5)
            if paths:
                # each path's summed disagreement at its cells (crop-local)
                scores = []
                for p in paths:
                    s = 0.0
                    for x, y in p:
                        ux = int(np.clip(x - agent[0] + cw / 2, 0, cw - 1))
                        uy = int(np.clip(y - agent[1] + ch / 2, 0, ch - 1))
                        s += float(uncertainty[uy, ux])
                    scores.append(s)
                best = paths[int(np.argmax(scores))]
                return np.asarray(best[0]), dict(mode="rrt",
                                                 n_paths=len(paths))
        # FBE on the fused map
        fs = FrontierSearch(self.step_count, geo, min_frontier_size=4)
        goal = fs.nextGoal(np.array([[agent]]), np.zeros((1, 3)))
        return goal.reshape(-1), dict(mode="fbe")
