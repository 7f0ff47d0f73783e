"""AstarPlanner: occupancy mapping, frontier exploration, path planning.

Counterpart of the JAX package's planning/planner.py (the reference
AstarPlanner's API): init / init_known_env / update_occ_map /
cover_fov_2d / build_frontier_cells / build_frontiers / setup_start /
planning / global_planning / global_planning_frontier /
global_object_planning / add_obstacle / convert_to_map /
convert_to_world / occ_coord_to_3d / get_map / pose_eval (a uniform
stub) / render_bev / save / load.  The
(3, Gz, Gx) occupancy map stays on the planner's device and takes one
vote update per frame (planning/occupancy.py); a planning event pulls its
uint8 label map once and runs the morphology, connected components and
distance transform on the host (utils/raster.py, cv2's cells without
cv2), then one device sweep field serves every goal (planning/sweep.py),
or, with `explore.planner_backend: astar`, the host A* search
(planning/astar.py::AstarSearch) does.

Known-environment mode (init_known_env): the map is seeded from a
ground-truth cloud, each frame marks the free cells of the camera's
field of view as covered (cover_fov_2d), and the frontier is the free
space not yet covered.  As in the JAX package, the coverage mask is not
checkpointed: a planner restored by load() has none, and plans from
the unknown cells of its map.

With `visualize` and an eval_dir, global_planning writes each event's
occupancy map with its candidates' scores to
<eval_dir>/planning_vis/plan_<frame>.png (engine/visualization.py).
render_bev renders the Gaussian map from above (K1 on the card), the
Gaussians above the camera's height left out.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.camera import Camera, camera_from_intrinsics
from ..utils import raster
from .candidates import (generate_candidates, generate_candidates_object,
                         generate_random_gaussians, sample_random_candidates)
from .astar import AstarSearch, check_collision_free
from .occupancy import occ_update
from .sweep import SweepSearch


class LocalizationError(RuntimeError):
    """The start cell is enclosed by obstacles."""


class NoFrontierError(RuntimeError):
    """Exploration is exhausted."""


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class AstarPlanner:
    def __init__(self, slam_config, eval_dir: str | None = None,
                 seed: int = 0, device="cuda"):
        self.cfg = slam_config
        self.eval_dir = eval_dir
        ex = slam_config["explore"]
        pol = slam_config["policy"]
        self.device = torch.device(device)
        self.cell_size = float(ex["cell_size"])
        self.height_upper = float(pol["height_upper"])
        self.height_lower = float(pol["height_lower"])
        self.add_random_gaussians = bool(ex["add_random_gaussians"])
        self.K = int(ex["sample_view_num"])
        self.radius = float(ex["sample_range"])
        self.min_range = float(ex["min_range"])
        ob = slam_config["explore_object"]
        self.K_object = int(ob["sample_view_num"])
        self.radius_object = float(ob["sample_range"])
        self.min_range_object = float(ob["min_range"])
        self.centering = bool(ex["centering"])
        self.frontier_select_method = str(ex["frontier_select_method"])
        self.shortcut_path = bool(ex["shortcut_path"])
        self.planner_backend = str(ex.get("planner_backend", "sweep"))
        # C-space clearance: inflate observed obstacles by the agent radius
        # (clearance_m < 0 = auto from the simulator's agent radius through
        # set_clearance; 0 = off)
        self.clearance_m = float(ex.get("clearance_m", -1.0))
        self.clearance_cells = (int(round(self.clearance_m / self.cell_size))
                                if self.clearance_m > 0 else 0)
        self.pcd_far_distance = float(pol["pcd_far_distance"])
        self.rng = np.random.default_rng(seed)

        self.occ_map = None          # (3, Gz, Gx) f32 tensor on the device
        self.occ_map_np = None       # dilated binary obstacle map (host)
        self.free_space_np = None
        self.frontier = None
        self.target_frontier = None
        self.cam_pos = None          # [z, x] grid cell
        self.map_center = None       # np (2,) world xz
        self.grid_dim = None         # np (2,) [gx, gz]
        self.cam_height = None
        self.frame_idx = 0
        self._search = None
        self._search_key = None
        self._occ_idx_cache = None
        self.covered = None          # known-env coverage (init_known_env)
        self._known_free = None
        self.camera: Camera | None = None

    # -- lifecycle ----------------------------------------------------------
    def init(self, pose, intrinsic, scene_bounds=None,
             img_size: tuple[int, int] = (256, 256)):
        """768² grid centered at the start pose, or sized by the scene
        bounds when they are known."""
        pose = np.asarray(pose, np.float64)
        self.cam_height = float(pose[1, 3])
        self.camera = camera_from_intrinsics(np.asarray(intrinsic),
                                             img_size[1], img_size[0])
        self.grid_dim = np.array([768, 768])
        if scene_bounds is not None:
            lo, hi = np.asarray(scene_bounds[0]), np.asarray(scene_bounds[1])
            map_center = (hi[[0, 2]] + lo[[0, 2]]) / 2
            self.grid_dim = np.array([
                int((hi[0] - lo[0]) / self.cell_size + 1),
                int((hi[2] - lo[2]) / self.cell_size + 1)])
        else:
            map_center = pose[[0, 2], 3]
        self.map_center = np.asarray(map_center, np.float32)
        self._map_center_dev = torch.as_tensor(self.map_center,
                                               device=self.device)

        occ = np.zeros((3, self.grid_dim[1], self.grid_dim[0]), np.float32)
        occ[0] = 1.0
        cx = int((pose[0, 3] - map_center[0]) / self.cell_size
                 + self.grid_dim[0] // 2)
        cz = int((pose[2, 3] - map_center[1]) / self.cell_size
                 + self.grid_dim[1] // 2)
        occ[2, cz - 1:cz + 2, cx - 1:cx + 2] = 2.0
        self.cam_pos = np.array([cz, cx])
        self.occ_map = torch.as_tensor(occ, device=self.device)
        self._occ_idx_cache = None
        self._search_key = None
        self.covered = None
        self.frame_idx = 0

    def init_known_env(self, pose, env_pcd_world, intrinsic=None,
                       img_size: tuple[int, int] = (256, 256),
                       max_lines: int = 20000, seed: int = 0):
        """Known-environment init: the occupancy map seeded from a
        ground-truth cloud instead of exploration, and an empty coverage
        mask for cover_fov_2d.  Occupied votes: the cloud's points in the
        height band, counted per cell; free votes: the cells of lines from
        (at most max_lines, drawn by seed) occupied cells to the robot's
        cell."""
        pose = np.asarray(pose, np.float64)
        self.cam_height = float(pose[1, 3])
        if intrinsic is not None:
            self.camera = camera_from_intrinsics(np.asarray(intrinsic),
                                                 img_size[1], img_size[0])
        self.grid_dim = np.array([768, 768])
        self.map_center = np.asarray(pose[[0, 2], 3], np.float32)
        self._map_center_dev = torch.as_tensor(self.map_center,
                                               device=self.device)
        h, w = int(self.grid_dim[1]), int(self.grid_dim[0])

        occ = np.zeros((3, h, w), np.float32)
        occ[0] = 1.0
        cx = int((pose[0, 3] - self.map_center[0]) / self.cell_size + w // 2)
        cz = int((pose[2, 3] - self.map_center[1]) / self.cell_size + h // 2)
        self.cam_pos = np.array([cz, cx])
        occ[2, cz - 1:cz + 2, cx - 1:cx + 2] = 2.0

        pc = np.asarray(env_pcd_world, np.float32)
        sel = (pc[:, 1] >= self.height_lower) & \
            (pc[:, 1] <= self.height_upper)
        pts = pc[sel]
        vote = np.zeros((3, h, w), np.float32)
        if len(pts):
            gx, gz = self._discretize(pts[:, 0], pts[:, 2])
            flat = gz * w + gx
            uniq, counts = np.unique(flat, return_counts=True)
            grid = np.zeros((h * w,), np.float32)
            grid[uniq] = counts + 1e-5
            vote[1] = 0.01 * grid.reshape(h, w)
            occ_z, occ_x = uniq // w, uniq % w
            if len(occ_z) > max_lines:
                idx = np.random.default_rng(seed).choice(
                    len(occ_z), size=max_lines, replace=False)
                occ_z, occ_x = occ_z[idx], occ_x[idx]
            canvas = raster.draw_lines((h, w), np.stack([occ_x, occ_z], 1),
                                       (cx, cz))
            vote[2][canvas > 0] += 1.0
            vote[2][occ_z, occ_x] = 0.0        # the end stays occupied
            denom = vote.sum(axis=0, keepdims=True) + 1e-5
            occ += vote / denom
        self.occ_map = torch.as_tensor(occ, device=self.device)
        self._occ_idx_cache = None
        self._search_key = None
        self.covered = np.zeros((h, w), bool)
        # the known map does not change: its free cells stay on the host
        # for the per-step coverage probes
        self._known_free = occ.argmax(axis=0) == 2
        self.frame_idx = 0

    def cover_fov_2d(self, c2w, fov_deg: float = 90.0,
                     max_range: float = 4.0, ang_step_deg: float = 2.0):
        """Mark the free cells visible in the camera's field-of-view wedge
        as covered: per angle, walk the ray until a cell that is not free
        stops it."""
        assert self.covered is not None, "call init_known_env first"
        free = self._known_free
        h, w = free.shape
        c2w = np.asarray(c2w, np.float64)
        x, z = float(c2w[0, 3]), float(c2w[2, 3])
        gx = int((x - self.map_center[0]) / self.cell_size + w // 2)
        gz = int((z - self.map_center[1]) / self.cell_size + h // 2)
        if not (0 <= gx < w and 0 <= gz < h):
            return
        fwd = c2w[:3, :3] @ np.array([0.0, 0.0, 1.0])
        yaw = np.arctan2(fwd[2], fwd[0])       # the angle in the xz plane
        half = np.deg2rad(fov_deg) / 2
        n_cells = int(max_range / self.cell_size)
        for a in np.arange(-half, half + 1e-6, np.deg2rad(ang_step_deg)):
            ca, sa = np.cos(yaw + a), np.sin(yaw + a)
            for r in range(n_cells):
                # round half to even, as Python's round of a float64
                i = int(round(gx + r * ca))
                j = int(round(gz + r * sa))
                if not (0 <= i < w and 0 <= j < h):
                    break
                if free[j, i]:
                    self.covered[j, i] = True
                else:
                    break

    def build_frontier_cells(self) -> np.ndarray:
        """The coverage frontier: free, not covered, and 4-adjacent to a
        covered cell.  Returns (M, 2) [j, i] cells."""
        assert self.covered is not None, "call init_known_env first"
        free = self._known_free
        cov = self.covered
        adj = np.zeros_like(cov)
        adj[:-1] |= cov[1:]
        adj[1:] |= cov[:-1]
        adj[:, :-1] |= cov[:, 1:]
        adj[:, 1:] |= cov[:, :-1]
        fr = (~cov) & free & adj
        return np.stack(np.where(fr), axis=1)

    def update_occ_map(self, depth, c2w, t: int, downsample: int = 1):
        """`downsample` is accepted and ignored, as in the JAX package."""
        self.frame_idx = int(t)
        depth = torch.as_tensor(depth, device=self.device).float()
        if depth.dim() == 3:
            depth = depth.reshape(depth.shape[-2], depth.shape[-1])
        c2w = np.asarray(c2w, np.float32)
        # the camera cell on the host: the device update needs no pull
        cx = int(np.floor((c2w[0, 3] - self.map_center[0]) / self.cell_size)
                 + (self.grid_dim[0] - 1) // 2)
        cz = int(np.floor((c2w[2, 3] - self.map_center[1]) / self.cell_size)
                 + (self.grid_dim[1] - 1) // 2)
        self.cam_pos = np.array([cz, cx])
        self.occ_map, _ = occ_update(
            self.occ_map, depth, torch.as_tensor(c2w, device=self.device),
            self.camera, self.cell_size, self._map_center_dev,
            self.height_lower, self.height_upper, self.pcd_far_distance)

    # -- conversions --------------------------------------------------------
    def convert_to_map(self, coord):
        cx = int((coord[0] - self.map_center[0]) / self.cell_size
                 + self.grid_dim[0] // 2)
        cz = int((coord[1] - self.map_center[1]) / self.cell_size
                 + self.grid_dim[1] // 2)
        return np.array([cx, cz])

    def convert_to_world(self, coord):
        return (np.asarray(coord) - self.grid_dim / 2) * self.cell_size + \
            self.map_center

    # -- free space / frontiers --------------------------------------------
    def _occ_index_np(self):
        """Host copy of the occupancy LABEL map (argmax over the channels,
        the first maximum on ties, as uint8), pulled once per frame: a
        planning event reads it several times."""
        cached = self._occ_idx_cache
        if cached is not None and cached[0] == self.frame_idx:
            return cached[1]
        idx = torch.argmax(self.occ_map, dim=0).to(torch.uint8).cpu().numpy()
        self._occ_idx_cache = (self.frame_idx, idx)
        return idx

    def build_connected_freespace(self, gaussian_points=None) -> np.ndarray:
        """The free region connected to the robot (the largest component
        after a 3x3 opening); columns of Gaussians block cells."""
        index = self._occ_index_np()
        free = (index == 2)

        if free.sum() > 18 and gaussian_points is not None:
            pts = np.asarray(gaussian_points)
            sel = (pts[:, 1] >= self.height_lower) & \
                (pts[:, 1] <= self.height_upper)
            pts = pts[sel]
            if len(pts):
                gx, gz = self._discretize(pts[:, 0], pts[:, 2])
                flat = gz.astype(np.int64) * self.grid_dim[0] + gx
                uniq, counts = np.unique(flat, return_counts=True)
                uniq = uniq[counts > 25]
                free[uniq // self.grid_dim[0], uniq % self.grid_dim[0]] = False

        free = raster.open3(free)
        n, labels, areas = raster.label8(free)
        if n <= 1:
            return free
        order = np.argsort(areas)
        robot_label = order[-1] if order[-1] != 0 else order[-2]
        return (labels == robot_label).astype(np.uint8)

    def _discretize(self, x, z):
        gx = np.floor((x - self.map_center[0]) / self.cell_size) + \
            (self.grid_dim[0] - 1) // 2
        gz = np.floor((z - self.map_center[1]) / self.cell_size) + \
            (self.grid_dim[1] - 1) // 2
        gx = np.clip(gx, 0, self.grid_dim[0] - 1).astype(np.int64)
        gz = np.clip(gz, 0, self.grid_dim[1] - 1).astype(np.int64)
        return gx, gz

    def build_frontiers(self, gaussian_points=None):
        """Frontier cells (free boundary and unknown) in world coords.
        Returns (frontier_points, free_space); frontier_points is None
        when exploration is exhausted."""
        free_space = self.build_connected_freespace(gaussian_points)
        if self.covered is not None:
            # known-env mode: the map is complete, so the free space not
            # yet covered takes the place of the unknown cells
            cells = self.build_frontier_cells()
            frontier = np.zeros(free_space.shape, bool)
            if len(cells):
                frontier[cells[:, 0], cells[:, 1]] = True
            frontier &= free_space.astype(bool)
        else:
            unknown = (self._occ_index_np() == 0)
            boundary = raster.dilate3(free_space) - free_space
            frontier = np.bitwise_and(boundary.astype(bool), unknown)
        self.frontier = frontier.astype(np.uint8)
        if frontier.sum() == 0:
            self.target_frontier = None
            return None, free_space

        frontier = raster.dilate3(frontier)
        _n, labels, _areas = raster.label8(frontier)
        uniq, counts = np.unique(labels, return_counts=True)
        uniq, counts = uniq[1:], counts[1:]
        keep = counts > 10
        uniq, counts = uniq[keep], counts[keep]
        if len(uniq) == 0:
            return None, free_space

        target_label = -1
        if self.frontier_select_method == "largest":
            target_label = uniq[np.argmax(counts)]
        else:
            # every label's mean distance to the agent in one bincount pass
            ys, xs = np.nonzero(labels)
            labs = labels[ys, xs]
            d = np.hypot(ys - self.cam_pos[0], xs - self.cam_pos[1])
            n_all = int(labels.max()) + 1
            cnt_all = np.bincount(labs, minlength=n_all)
            mean_d = np.bincount(labs, weights=d, minlength=n_all) \
                / np.maximum(cnt_all, 1)
            eligible = np.zeros(n_all, bool)
            eligible[uniq] = True
            eligible &= cnt_all >= 4
            if eligible.any():
                if self.frontier_select_method == "combined":
                    score = np.where(eligible,
                                     cnt_all / (mean_d + 20.0), -np.inf)
                    if score.max() > 0.0:
                        target_label = int(np.argmax(score))
                else:                     # "closest"
                    dist_m = np.where(eligible, mean_d, np.inf)
                    if dist_m.min() < 1e4:
                        target_label = int(np.argmin(dist_m))
        if target_label == -1:
            return None, free_space

        self.target_frontier = (labels == target_label).astype(np.uint8)
        pix = np.stack(np.where(self.target_frontier), axis=1)[:, [1, 0]]
        world = (pix - np.array([[self.grid_dim[0] // 2,
                                  self.grid_dim[1] // 2]])) * self.cell_size \
            + self.map_center[None, :]

        if gaussian_points is None:
            # frontier-based exploration: the closest frontier cell at least
            # 0.5 m away, else a step backward
            agent = self.cam_pos[[1, 0]]          # to x, z cell coords
            agent_w = self.convert_to_world(agent)
            dist = np.linalg.norm(world - agent_w[None, :], axis=1)
            valid = np.where(dist >= 0.5)[0]
            if len(valid) > 0:
                best_i = valid[np.argmin(dist[valid])]
                return world[best_i:best_i + 1], free_space
            ang = np.pi * 5 / 4
            return (agent_w[None, :]
                    + np.array([[-np.cos(ang), -np.sin(ang)]]) * 0.5,
                    free_space)
        return world, free_space

    # -- start / paths ------------------------------------------------------
    def setup_start(self, start, gaussian_points=None, frame_idx: int = 0):
        """Binarize the map with Gaussian columns as obstacles, dilate,
        inflate by the clearance, check that the start cell is free, and
        launch the sweep field from it.  Idempotent per (frame, start): the
        driver calls it early in a planning event and action planning's
        own call is then a no-op."""
        key = (self.frame_idx, int(start[0]), int(start[1]))
        if self._search is not None and self._search_key == key:
            return
        # invalidate BEFORE building: if the build raises (enclosed start)
        # a retry must not reuse a stale search
        self._search_key = None
        self._search = None
        occupied = (self._occ_index_np() == 1)
        self.start = np.asarray(start, np.int64)

        if gaussian_points is not None:
            pts = np.asarray(gaussian_points)
            lower_y, upper_y = self.cam_height - 1.0, self.cam_height
            sel = (pts[:, 1] >= lower_y) & (pts[:, 1] <= upper_y)
            pts = pts[sel]
            if len(pts):
                gx, gz = self._discretize(pts[:, 0], pts[:, 2])
                flat = gz * self.grid_dim[0] + gx
                uniq, counts = np.unique(flat, return_counts=True)
                uniq = uniq[counts > 50]
                occupied[uniq // self.grid_dim[0],
                         uniq % self.grid_dim[0]] = True

        binarymap = raster.dilate3(occupied)
        y, x = self.start
        patch = binarymap[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2].copy()
        if patch.size == 9:
            patch[1, 1] = 0
            if patch.sum() >= 8:
                raise LocalizationError("start cell is enclosed")
        free = self.build_connected_freespace(gaussian_points)
        clr = self.clearance_cells
        if clr > 0:
            # configuration-space obstacles: observed-occupied inflated by
            # the agent radius, so that every plannable cell admits the
            # agent's footprint
            k = raster.ellipse_kernel(2 * clr + 1)
            binarymap = np.maximum(binarymap, raster.dilate(occupied, k))
            # the agent occupies the start disk: traversable regardless of
            # vote noise around it
            start_disk = raster.fill_circle(binarymap.shape, (x, y), clr)
            binarymap[start_disk > 0] = 0
            nav = (((free > 0) | (start_disk > 0))
                   & (binarymap == 0)).astype(np.uint8)
            # the component connected to the start
            _n, labels, _areas = raster.label8(nav)
            lab = labels[y, x]
            if lab > 0:
                nav = (labels == lab).astype(np.uint8)
            free = nav
        binarymap[y, x] = 0
        self.occ_map_np = binarymap
        self.free_space_np = free
        if self.planner_backend == "sweep":
            self._search = SweepSearch(self.occ_map_np, self.free_space_np,
                                       self.start, device=self.device)
        else:
            self._search = AstarSearch(self.occ_map_np, self.free_space_np,
                                       self.start)
        self._search_key = key

    def add_obstacle(self, world_xy):
        """Mark one cell as hard-occupied (after a blocked forward action,
        the cell ahead of the agent, so that the next plan routes around
        it)."""
        gx, gz = self._discretize(np.asarray([world_xy[0]]),
                                  np.asarray([world_xy[1]]))
        gx, gz = int(gx[0]), int(gz[0])
        cell = self.occ_map[:, gz, gx]
        self.occ_map[:, gz, gx] = torch.stack(
            [torch.zeros_like(cell[0]), cell.max() + 100.0,
             torch.zeros_like(cell[0])])
        self._occ_idx_cache = None
        self._search_key = None

    def set_clearance(self, radius_m: float):
        """Resolve clearance_m = -1 (auto) from the embodied agent's
        radius, which the simulator reports."""
        if self.clearance_m < 0 and radius_m > 0:
            self.clearance_cells = int(round(float(radius_m)
                                             / self.cell_size))
            self._search_key = None

    def _snap_goal(self, goal):
        """The navigable cell nearest to `goal` [y, x]: with C-space
        inflation, frontier goals sit in the inflated band and are reached
        from a safe standoff."""
        gy, gx = int(goal[0]), int(goal[1])
        nav = self.free_space_np
        h, w = nav.shape
        if 0 <= gy < h and 0 <= gx < w and nav[gy, gx]:
            return goal
        r = self.clearance_cells + 6
        y0, y1 = max(gy - r, 0), min(gy + r + 1, h)
        x0, x1 = max(gx - r, 0), min(gx + r + 1, w)
        win = nav[y0:y1, x0:x1]
        ys, xs = np.nonzero(win)
        if len(ys) == 0:
            return None
        d2 = (ys + y0 - gy) ** 2 + (xs + x0 - gx) ** 2
        i = int(np.argmin(d2))
        return np.array([ys[i] + y0, xs[i] + x0], np.int64)

    def planning(self, goal) -> np.ndarray:
        if self._search is None:
            raise RuntimeError("call setup_start first")
        if self.clearance_cells > 0:
            goal = self._snap_goal(goal)
            if goal is None:
                return np.array([])
        return self._search.plan(goal, shortcut=self.shortcut_path)

    def CheckCollision(self, pt1, pt2, occ_map) -> bool:
        """True if the 7-px-wide line between two [x, z] cells stays free
        of occ_map's nonzero cells (planning/astar.py)."""
        return check_collision_free(pt1, pt2, occ_map)

    # -- global planning ----------------------------------------------------
    def pose_eval(self, poses, *args):
        """Uniform-score stub so that planning runs without a SLAM
        backend."""
        return torch.ones(poses.shape[0]), poses

    def global_planning(self, pose_evaluation_fn=None, gaussian_points=None,
                        goal_proposal_fn=None, expansion=1, visualize=False,
                        agent_pose=None, last_goal=None, slam=None,
                        defer_scores=False):
        """Frontier-driven candidate poses, scored by EIG, best 20 first.

        Returns (poses (<=20, 4, 4), scores, random_gaussian_params) as
        numpy arrays.  With `defer_scores=True`, `pose_evaluation_fn` is
        the asynchronous variant (it returns a resolve closure) and this
        returns one `finish()` closure giving that triple, so the device
        scores the candidates while the caller goes on.  `visualize`
        writes the planning image; `last_goal` and `slam` are accepted and
        ignored, as in the JAX package."""
        candidate_pos, free_space = self.build_frontiers(gaussian_points)
        use_frontier = candidate_pos is not None
        if pose_evaluation_fn is None and not use_frontier:
            return None, None, None

        random_gaussian_params = None
        if self.add_random_gaussians:
            random_gaussian_params = generate_random_gaussians(
                candidate_pos, self.cell_size, self.cam_height, self.rng)

        if candidate_pos is None and goal_proposal_fn is not None:
            candidate_pos = goal_proposal_fn(self.K, self.cam_height)

        candidate_pose = np.zeros((0, 4, 4), np.float32)
        if candidate_pos is not None:
            candidate_pos = np.asarray(candidate_pos)
            if self.centering:
                candidate_pos = candidate_pos.mean(axis=0, keepdims=True)
            exp = float(expansion)
            while len(candidate_pose) == 0:
                candidate_pose = generate_candidates(
                    candidate_pos, self.K, self.radius, self.min_range,
                    self.cam_height, self.rng, expansion=exp)
                exp *= 1.5
                candidate_pose = candidate_pose[self._free_cells(
                    candidate_pose[:, [0, 2], 3], free_space)]
                if exp > 100:
                    break

        if not use_frontier and agent_pose is not None:
            random_pose = sample_random_candidates(
                agent_pose, free_space, self.grid_dim, self.cell_size,
                self.map_center, self.rng)
            candidate_pose = (random_pose if len(candidate_pose) == 0 else
                              np.concatenate([candidate_pose, random_pose]))

        if len(candidate_pose) == 0:
            if defer_scores:
                return None
            return None, None, random_gaussian_params

        if pose_evaluation_fn is None:
            resolve = lambda: self.pose_eval(candidate_pose)  # noqa: E731
        else:
            resolve = pose_evaluation_fn(candidate_pose,
                                         random_gaussian_params)
            if not callable(resolve):     # a synchronous evaluator's scores
                _r = resolve
                resolve = lambda: _r      # noqa: E731

        def finish():
            scores, poses = resolve()
            scores, poses = _host(scores), _host(poses)
            if visualize and self.eval_dir:
                self._save_planning_vis(poses, scores)
            order = np.argsort(-scores, kind="stable")[:20]
            poses, scores = poses[order], scores[order]
            return poses, scores, random_gaussian_params

        if defer_scores:
            return finish
        return finish()

    def _save_planning_vis(self, candidate_poses, scores):
        """The occupancy map with the candidates' scores and the target
        frontier, as planning_vis/plan_<frame>.png."""
        from ..engine.visualization import save_occ_map_png
        xz = np.asarray(candidate_poses)[:, [0, 2], 3]
        gx = np.clip(((xz[:, 0] - self.map_center[0]) / self.cell_size
                      + self.grid_dim[0] // 2).astype(np.int64),
                     0, self.grid_dim[0] - 1)
        gz = np.clip(((xz[:, 1] - self.map_center[1]) / self.cell_size
                      + self.grid_dim[1] // 2).astype(np.int64),
                     0, self.grid_dim[1] - 1)
        save_occ_map_png(_host(self.occ_map),
                         os.path.join(self.eval_dir, "planning_vis",
                                      f"plan_{self.frame_idx:05d}.png"),
                         candidates=np.stack([gx, gz], axis=1),
                         scores=scores,
                         agent_cell=(self.cam_pos[1], self.cam_pos[0]),
                         frontier=self.target_frontier)

    def render_bev(self, slam):
        """Render the SLAM map from 7 m above the map centre, looking down,
        on a white background, the Gaussians at or above the camera's
        height left out (GaussianSLAM.render_at_pose's outputs)."""
        bev_c2w = np.array([[1.0, 0, 0, 0], [0, 0, -1, 0],
                            [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
        bev_c2w[:3, 3] = [self.map_center[0], 7.0, self.map_center[1]]
        xyz = slam.gaussian_points
        mask = xyz[:, 1] < self.cam_height
        return slam.render_at_pose(bev_c2w, white_bg=True, mask=mask)

    def global_planning_frontier(self, expansion=1, visualize=False,
                                 agent_pose=None):
        """The frontier-only (FBE) goal, no scoring: (goal (1, 2) world xz,
        free space), or (None, None) when exploration is exhausted.
        `visualize` is accepted and ignored, as in the JAX package."""
        candidate_pos, free_space = self.build_frontiers(None)
        if candidate_pos is None:
            return None, None
        return np.asarray(candidate_pos), free_space

    def _free_cells(self, xz, free_space) -> np.ndarray:
        """Which world xz points (M, 2) fall on a cell of the eroded free
        space; all of them when it has 40 cells or fewer."""
        eroded = raster.erode_square(free_space, 10)
        if eroded.sum() <= 40:
            return np.ones(len(xz), bool)
        gx = np.clip(((xz[:, 0] - self.map_center[0]) / self.cell_size
                      + self.grid_dim[0] // 2).astype(np.int64),
                     0, self.grid_dim[0] - 1)
        gz = np.clip(((xz[:, 1] - self.map_center[1]) / self.cell_size
                      + self.grid_dim[1] // 2).astype(np.int64),
                     0, self.grid_dim[1] - 1)
        return eroded[gz, gx] > 0

    def build_object_frontiers(self, gaussian_points):
        """The object's footprint cells as world xz (M, 2): the cells hit
        by more than 3 of the object's Gaussians; None if there is none.
        Candidate rings anchor on them, so viewpoints spread around the
        object's whole extent."""
        if gaussian_points is None:
            return None
        pts = np.asarray(gaussian_points)
        if len(pts) == 0:
            return None
        gx, gz = self._discretize(pts[:, 0], pts[:, 2])
        flat = gz * self.grid_dim[0] + gx
        uniq, counts = np.unique(flat, return_counts=True)
        uniq = uniq[counts > 3]
        if len(uniq) == 0:
            return None
        cells = np.stack([uniq % self.grid_dim[0],
                          uniq // self.grid_dim[0]], axis=1)   # [x, z]
        return (cells - np.array([[self.grid_dim[0] // 2,
                                   self.grid_dim[1] // 2]])) \
            * self.cell_size + self.map_center[None, :]

    def global_object_planning(self, pose_evaluation_fn=None,
                               gaussian_points=None,
                               gaussian_points_scene=None, expansion=1,
                               visualize=False, agent_pose=None,
                               criterion: str | None = None):
        """Candidate poses on the sorted angle and radius grid around the
        object's footprint cells (its Gaussians' centroid with
        `explore.centering`), kept on the eroded free space, scored by the
        object SLAM's pose_eval (criterion 'fisher') or pose_eval_popgs
        ('topt', 'dopt'), best 20 first.  gaussian_points: the object's
        Gaussians; gaussian_points_scene: the scene's, which block cells
        of the free space.  Returns (poses, scores, None) as numpy
        arrays, or (None, None, None).  `visualize` is accepted and
        ignored, as in the JAX package."""
        if gaussian_points is None or len(np.asarray(gaussian_points)) == 0:
            return None, None, None
        obj_pts = np.asarray(gaussian_points)
        free_space = self.build_connected_freespace(gaussian_points_scene)
        anchors = self.build_object_frontiers(obj_pts)
        if anchors is None:
            anchors = obj_pts[:, [0, 2]]
        if self.centering:
            anchors = anchors.mean(axis=0, keepdims=True)
        exp = float(expansion)
        candidate_pose = np.zeros((0, 4, 4), np.float32)
        while len(candidate_pose) == 0 and exp < 100:
            candidate_pose = generate_candidates_object(
                anchors, self.K_object, self.radius_object,
                self.min_range_object, self.cam_height, self.rng,
                expansion=exp)
            exp *= 1.5
            candidate_pose = candidate_pose[self._free_cells(
                candidate_pose[:, [0, 2], 3], free_space)]
        if len(candidate_pose) == 0:
            return None, None, None
        if pose_evaluation_fn is None:
            scores, poses = self.pose_eval(candidate_pose)
        elif criterion in ("topt", "dopt"):
            scores, poses = pose_evaluation_fn(candidate_pose,
                                               criterion=criterion)
        else:
            scores, poses = pose_evaluation_fn(candidate_pose)
        scores, poses = _host(scores), _host(poses)
        order = np.argsort(-scores, kind="stable")[:20]
        return poses[order], scores[order], None

    def occ_coord_to_3d(self, occ_coord) -> np.ndarray:
        """(M, 2) map cells (row z, column x) -> (M, 3) world points at
        the camera's height."""
        pts = np.asarray(occ_coord)[:, [1, 0]]
        world = (pts - np.array([[self.grid_dim[0] // 2,
                                  self.grid_dim[1] // 2]])) * self.cell_size \
            + self.map_center[None, :]
        out = np.zeros((len(world), 3))
        out[:, [0, 2]] = world
        out[:, 1] = self.cam_height
        return out

    def get_map(self) -> torch.Tensor:
        """The (3, Gz, Gx) occupancy map, on the planner's device."""
        return self.occ_map

    # -- persistence --------------------------------------------------------
    def save(self, path: str, **extra):
        """The map and its frame as a compressed npz, with the JAX
        package's keys; `extra` arrays ride along (the driver's step
        stamp)."""
        from ..utils.io import atomic_savez
        atomic_savez(path, compressed=True, occ_map=_host(self.occ_map),
                     map_center=self.map_center, grid_dim=self.grid_dim,
                     frame_idx=self.frame_idx, cam_pos=self.cam_pos,
                     cam_height=self.cam_height, **extra)

    def load(self, path: str):
        """Restore a map saved by this class or the JAX package's, onto
        the planner's device; every cache of the old map is dropped."""
        with np.load(path) as d:
            self.occ_map = torch.as_tensor(np.asarray(d["occ_map"],
                                                      np.float32),
                                           device=self.device)
            self.map_center = np.asarray(d["map_center"], np.float32)
            self.grid_dim = np.asarray(d["grid_dim"])
            self.frame_idx = int(d["frame_idx"])
            self.cam_pos = np.asarray(d["cam_pos"])
            self.cam_height = float(d["cam_height"])
        self._map_center_dev = torch.as_tensor(self.map_center,
                                               device=self.device)
        self._occ_idx_cache = None
        self._search_key = None
        self._search = None
