"""Hermetic simulator: procedural box-room scenes with analytic raycasting.

`BoxScene` describes a room (or a grid of rooms) with box obstacles;
`FakeSim` renders ground-truth RGB-D by per-pixel AABB raycasting on the
device and steps the discrete action space (1 fwd / 2 left / 3 right)
with collision checks, so the SLAM object can be driven with no scene
data.  Observations stay on the device as torch tensors.  A `SimObject`
(a box that can random-walk or oscillate, the object branch's dynamic
object) adds its box to the raycast and a `semantic` channel to the
observations.  `FakeSim.prefetch(action)` launches the next frame's
raycast ahead of `step(action)`, which then takes it.  `ReplaySim` plays
back recorded frames and poses (what `engine/eval.py::eval_nvs` reads).

Conventions: world y is up; cameras are +z forward / +y down (CV frame);
depth images are z-depth along the camera axis.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..ops.camera import Camera
from ..utils.geometry import compute_next_campos


class _Boxes(NamedTuple):
    lo: np.ndarray          # (B, 3)
    hi: np.ndarray          # (B, 3)
    inward: np.ndarray      # (B,) bool: True = room shell (hit from inside)
    color_seed: np.ndarray  # (B,) float


@dataclass
class BoxScene:
    """Room shell + box obstacles.  Sizes in meters."""
    room_lo: tuple = (-4.0, 0.0, -4.0)
    room_hi: tuple = (4.0, 2.5, 4.0)
    obstacles: list = field(default_factory=list)   # list of (lo, hi) tuples
    agent_radius: float = 0.18

    @staticmethod
    def default(seed: int = 0, n_obstacles: int = 6,
                room: float = 4.0) -> "BoxScene":
        rng = np.random.default_rng(seed)
        obstacles = []
        for _ in range(n_obstacles):
            cx, cz = rng.uniform(-room + 1.2, room - 1.2, 2)
            sx, sz = rng.uniform(0.25, 0.7, 2)
            sy = rng.uniform(0.8, 2.2)
            if abs(cx) < 1.2 and abs(cz) < 1.2:
                continue   # keep the spawn area clear
            obstacles.append(((cx - sx, 0.0, cz - sz), (cx + sx, sy, cz + sz)))
        return BoxScene(room_lo=(-room, 0.0, -room), room_hi=(room, 2.5, room),
                        obstacles=obstacles)

    @staticmethod
    def multi_room(seed: int = 0, rooms_x: int = 3, rooms_z: int = 3,
                   room: float = 4.0, door: float = 1.0,
                   wall_t: float = 0.12, height: float = 2.5,
                   clutter_per_room: int = 2) -> "BoxScene":
        """A rooms_x x rooms_z grid of `room`-sized rooms separated by
        interior walls with one doorway per shared edge, plus per-room
        clutter boxes.  The agent spawns at the origin, the center of the
        middle room."""
        rng = np.random.default_rng(seed)
        wx = rooms_x * room / 2.0
        wz = rooms_z * room / 2.0
        # shift so that one room's center is the origin (spawn point)
        ox = (room / 2.0) if rooms_x % 2 == 0 else 0.0
        oz = (room / 2.0) if rooms_z % 2 == 0 else 0.0
        obstacles = []

        # interior walls normal to x: one door per room cell they border
        for i in range(1, rooms_x):
            x = -wx + i * room + ox
            for j in range(rooms_z):
                z0, z1 = -wz + j * room + oz, -wz + (j + 1) * room + oz
                dz = rng.uniform(z0 + 0.6, z1 - 0.6 - door)
                if dz - z0 > 0.05:
                    obstacles.append(((x - wall_t / 2, 0.0, z0),
                                      (x + wall_t / 2, height, dz)))
                if z1 - (dz + door) > 0.05:
                    obstacles.append(((x - wall_t / 2, 0.0, dz + door),
                                      (x + wall_t / 2, height, z1)))
        # interior walls normal to z
        for j in range(1, rooms_z):
            z = -wz + j * room + oz
            for i in range(rooms_x):
                x0, x1 = -wx + i * room + ox, -wx + (i + 1) * room + ox
                dx = rng.uniform(x0 + 0.6, x1 - 0.6 - door)
                if dx - x0 > 0.05:
                    obstacles.append(((x0, 0.0, z - wall_t / 2),
                                      (dx, height, z + wall_t / 2)))
                if x1 - (dx + door) > 0.05:
                    obstacles.append(((dx + door, 0.0, z - wall_t / 2),
                                      (x1, height, z + wall_t / 2)))
        # per-room clutter (tall boxes + half-height occluders), kept off
        # walls/doorways by a margin and out of the spawn room's center
        for i in range(rooms_x):
            for j in range(rooms_z):
                cx0 = -wx + i * room + ox + 1.0
                cz0 = -wz + j * room + oz + 1.0
                for _ in range(clutter_per_room):
                    cx = rng.uniform(cx0, cx0 + room - 2.0)
                    cz = rng.uniform(cz0, cz0 + room - 2.0)
                    if abs(cx) < 1.0 and abs(cz) < 1.0:
                        continue                    # spawn area clear
                    sx, sz = rng.uniform(0.2, 0.55, 2)
                    sy = rng.uniform(0.5, 1.1) if rng.uniform() < 0.5 \
                        else rng.uniform(1.4, 2.2)
                    obstacles.append(((cx - sx, 0.0, cz - sz),
                                      (cx + sx, sy, cz + sz)))
        return BoxScene(room_lo=(-wx + ox, 0.0, -wz + oz),
                        room_hi=(wx + ox, height, wz + oz),
                        obstacles=obstacles)

    def boxes(self) -> _Boxes:
        los = [np.asarray(self.room_lo, np.float32)]
        his = [np.asarray(self.room_hi, np.float32)]
        inward = [True]
        for lo, hi in self.obstacles:
            los.append(np.asarray(lo, np.float32))
            his.append(np.asarray(hi, np.float32))
            inward.append(False)
        seeds = np.arange(len(los), dtype=np.float32)
        return _Boxes(lo=np.stack(los), hi=np.stack(his),
                      inward=np.asarray(inward), color_seed=seeds)

    def is_navigable(self, pos) -> bool:
        """xz position reachable by the agent (inside room, off obstacles)."""
        p = np.asarray(pos, np.float32).reshape(-1)
        x, z = float(p[0]), float(p[-1])
        r = self.agent_radius
        lo, hi = self.room_lo, self.room_hi
        if not (lo[0] + r <= x <= hi[0] - r and lo[2] + r <= z <= hi[2] - r):
            return False
        for blo, bhi in self.obstacles:
            if blo[0] - r <= x <= bhi[0] + r and blo[2] - r <= z <= bhi[2] + r:
                return False
        return True

    def sample_navigable(self, rng: np.random.Generator,
                         n: int) -> np.ndarray:
        """n navigable (x, z) positions, (n, 2) float32, by rejection from
        the room's bounds (two uniform draws per try)."""
        out = []
        lo, hi = self.room_lo, self.room_hi
        while len(out) < n:
            x = rng.uniform(lo[0], hi[0])
            z = rng.uniform(lo[2], hi[2])
            if self.is_navigable((x, 0.0, z)):
                out.append((x, z))
        return np.asarray(out, np.float32)

    # -- ground truth for evaluation ---------------------------------------
    def sample_surface_points(self, n: int, rng=None,
                              interior_only: bool = True) -> np.ndarray:
        """n area-weighted uniform samples of every box face, (n, 3)
        float32: the ground-truth cloud of the reconstruction metrics."""
        rng = rng or np.random.default_rng(0)
        faces = []   # (origin, edge_u, edge_v)

        def add_box(lo, hi):
            lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
            d = hi - lo
            faces.extend([
                (np.array([lo[0], lo[1], lo[2]]), np.array([0, d[1], 0]),
                 np.array([0, 0, d[2]])),                           # x-
                (np.array([hi[0], lo[1], lo[2]]), np.array([0, d[1], 0]),
                 np.array([0, 0, d[2]])),                           # x+
                (np.array([lo[0], lo[1], lo[2]]), np.array([d[0], 0, 0]),
                 np.array([0, 0, d[2]])),                           # y-
                (np.array([lo[0], hi[1], lo[2]]), np.array([d[0], 0, 0]),
                 np.array([0, 0, d[2]])),                           # y+
                (np.array([lo[0], lo[1], lo[2]]), np.array([d[0], 0, 0]),
                 np.array([0, d[1], 0])),                           # z-
                (np.array([lo[0], lo[1], hi[2]]), np.array([d[0], 0, 0]),
                 np.array([0, d[1], 0])),                           # z+
            ])
        add_box(self.room_lo, self.room_hi)
        for lo, hi in self.obstacles:
            add_box(lo, hi)
        origins = np.stack([f[0] for f in faces])
        e_u = np.stack([f[1] for f in faces])
        e_v = np.stack([f[2] for f in faces])
        areas = np.linalg.norm(np.cross(e_u, e_v), axis=1)
        probs = areas / areas.sum()
        idx = rng.choice(len(faces), size=n, p=probs)
        us, vs = rng.uniform(size=(2, n, 1))
        pts = origins[idx] + us * e_u[idx] + vs * e_v[idx]
        return pts.astype(np.float32)

    def surface_area(self) -> float:
        """Total area (m²) of every box face; it sizes the ground-truth
        cloud (cli._sample_gt)."""
        def box_area(lo, hi):
            d = np.asarray(hi, np.float64) - np.asarray(lo, np.float64)
            return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2])
        area = box_area(self.room_lo, self.room_hi)
        for lo, hi in self.obstacles:
            area += box_area(lo, hi)
        return float(area)

    def surface_distance(self, pts: np.ndarray) -> np.ndarray:
        """Exact distance (float64) from each point to the nearest box
        surface: |SDF| of each axis-aligned box, the minimum over boxes.
        Accuracy and FPR use it in place of the sampled ground-truth cloud,
        which has no sampling floor; faces buried in walls count as
        surface."""
        p = np.asarray(pts, np.float64).reshape(-1, 3)
        best = np.full(len(p), np.inf)
        boxes = [(self.room_lo, self.room_hi)] + list(self.obstacles)
        for lo, hi in boxes:
            lo = np.asarray(lo, np.float64)
            hi = np.asarray(hi, np.float64)
            q = np.abs(p - (lo + hi) / 2.0) - (hi - lo) / 2.0
            outside = np.linalg.norm(np.maximum(q, 0.0), axis=1)
            inside = np.minimum(np.max(q, axis=1), 0.0)
            np.minimum(best, np.abs(outside + inside), out=best)
        return best.astype(np.float64)

    def gt_free_map(self, cell_size: float, grid_dim, map_center) -> np.ndarray:
        """Top-down (Gz, Gx) bool grid of navigable cell centres, the
        denominator of 2D coverage."""
        gx, gz = int(grid_dim[0]), int(grid_dim[1])
        xs = (np.arange(gx) + 0.5 - gx // 2) * cell_size + map_center[0]
        zs = (np.arange(gz) + 0.5 - gz // 2) * cell_size + map_center[1]
        free = np.zeros((gz, gx), bool)
        for iz, z in enumerate(zs):
            for ix, x in enumerate(xs):
                free[iz, ix] = self.is_navigable((x, 0.0, z))
        return free


class SimObject:
    """A kinematic dynamic object: an extra box with a random-walk motion
    drawn from its own numpy generator (the reference's SimObject:
    semantic id, translation, moving_forward_and_back: an oscillation
    along the heading; moving_randomly: a random yaw jitter and a new
    random yaw off non-navigable positions)."""

    def __init__(self, scene: BoxScene, semantic_id: int = 100,
                 size=(0.3, 0.6, 0.3), start_xz=(0.8, -0.8),
                 speed: float = 0.04, seed: int = 0):
        self.scene = scene
        self.semantic_id = int(semantic_id)
        self.size = np.asarray(size, np.float32)
        self.pos = np.array([start_xz[0], 0.0, start_xz[1]], np.float32)
        self.yaw = 0.0
        self.speed = float(speed)
        self.rng = np.random.default_rng(seed)
        self._dir = 1.0

    @property
    def translation(self) -> np.ndarray:
        return self.pos.copy()

    def set_translation(self, pos):
        self.pos = np.asarray(pos, np.float32)

    def aabb(self):
        half = self.size / 2
        lo = self.pos + np.array([-half[0], 0.0, -half[2]])
        hi = self.pos + np.array([half[0], self.size[1], half[2]])
        return tuple(lo), tuple(hi)

    def object_pose(self) -> np.ndarray:
        """4x4 world-from-object transform.  The box is axis-aligned (the
        yaw only steers the walk), so the canonical object frame is a
        translation: observations registered through its inverse stay put
        while the object moves."""
        T = np.eye(4, dtype=np.float64)
        T[:3, 3] = self.pos
        return T

    def sample_surface_points(self, n: int, rng=None,
                              frame: str = "world") -> np.ndarray:
        """n area-weighted uniform points on the box's faces, in the world
        frame or (frame='object') the canonical object frame: the object
        reconstruction metric's ground truth."""
        rng = rng or np.random.default_rng(0)
        lo, hi = self.aabb()
        if frame == "object":
            lo, hi = np.asarray(lo) - self.pos, np.asarray(hi) - self.pos
        lo, hi = np.asarray(lo), np.asarray(hi)
        ext = hi - lo
        # face areas: two each normal to x, y, z
        areas = np.array([ext[1] * ext[2], ext[1] * ext[2],
                          ext[0] * ext[2], ext[0] * ext[2],
                          ext[0] * ext[1], ext[0] * ext[1]])
        face = rng.choice(6, size=n, p=areas / areas.sum())
        u, v = rng.uniform(size=(2, n))
        pts = np.empty((n, 3), np.float32)
        axis = face // 2            # 0 = x, 1 = y, 2 = z
        side = face % 2             # 0 = the lo face, 1 = the hi face
        for a in range(3):
            b, c = [i for i in range(3) if i != a]
            m = axis == a
            pts[m, a] = np.where(side[m] == 1, hi[a], lo[a])
            pts[m, b] = lo[b] + u[m] * ext[b]
            pts[m, c] = lo[c] + v[m] * ext[c]
        return pts

    def _try_move(self, delta) -> bool:
        nxt = self.pos + delta
        if self.scene.is_navigable((nxt[0], 0.0, nxt[2])):
            self.pos = nxt
            return True
        return False

    def moving_forward_and_back(self):
        """A step of `speed` along the heading, the direction reversed
        where that step is not navigable."""
        d = np.array([np.sin(self.yaw), 0.0, np.cos(self.yaw)]) \
            * self.speed * self._dir
        if not self._try_move(d):
            self._dir *= -1.0

    def moving_randomly(self):
        """A random yaw jitter, and a new random yaw where the step is not
        navigable."""
        self.yaw += self.rng.uniform(-0.4, 0.4)
        d = np.array([np.sin(self.yaw), 0.0, np.cos(self.yaw)]) * self.speed
        if not self._try_move(d):
            self.yaw = self.rng.uniform(0, 2 * np.pi)


def _raycast_device(lo, hi, inward, seeds, c2w, camera: Camera):
    """Per-pixel nearest-hit AABB raycast in plain torch on the tensors'
    device.  lo, hi (B, 3), inward (B,) bool, seeds (B,), c2w (4, 4) or
    (P, 4, 4).  Returns rgb (H, W, 3), z-depth (H, W) and the hit box id
    (H, W), each with a leading P for a stack of poses.  Every pixel's
    arithmetic is the same elementwise chain at any P, so a pose of a
    stack gets the frame it gets alone.

    The checker color flips across faces that lie on the 0.5 m grid (the
    room shell), where it is decided by the last bit of the hit point.  So
    that the frames agree with the JAX package's, the arithmetic follows
    its compiled form: pixel offsets times the f32 reciprocal of the focal
    length, the ray direction as a left-to-right sum, and the hit point as
    one fused multiply-add (emulated in f64, exact but for a rare double
    rounding)."""
    single = c2w.dim() == 2
    c2w = c2w.reshape(-1, 4, 4)
    dev = lo.device
    h, w = camera.height, camera.width
    f32 = torch.float32
    ys = (torch.arange(h, dtype=f32, device=dev) - camera.cy) \
        * torch.tensor(1.0 / camera.fy, dtype=f32)
    xs = (torch.arange(w, dtype=f32, device=dev) - camera.cx) \
        * torch.tensor(1.0 / camera.fx, dtype=f32)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    R = c2w[:, None, None, :3, :3]                           # (P, 1, 1, 3, 3)
    dirs_w = (gx[..., None] * R[..., 0] + gy[..., None] * R[..., 1]) \
        + R[..., 2]                                          # (P, H, W, 3)
    origin = c2w[:, None, None, :3, 3]                       # (P, 1, 1, 3)

    safe = torch.where(torch.abs(dirs_w) < 1e-9,
                       torch.full_like(dirs_w, 1e-9), dirs_w)
    inv_d = 1.0 / safe
    box = (slice(None), None, None, None)
    t0 = (lo[box] - origin) * inv_d[None]                    # (B, P, H, W, 3)
    t1 = (hi[box] - origin) * inv_d[None]
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    t_hit = torch.where(inward[box], tmax, tmin)
    hit_ok = (tmax >= torch.clamp(tmin, min=0.0)) & (t_hit > 1e-4)
    t_hit = torch.where(hit_ok, t_hit, torch.full_like(t_hit, float("inf")))
    best = torch.argmin(t_hit, dim=0)                        # first minimum
    t_best = t_hit.amin(dim=0)
    t_best = torch.where(torch.isfinite(t_best), t_best,
                         torch.zeros_like(t_best))

    hit_pt = (origin.double() + dirs_w.double()
              * t_best[..., None].double()).float()
    # rays are scaled so dirs_cam.z == 1, hence t IS the camera z-depth
    seed = seeds[best]
    checker = torch.remainder(torch.floor(hit_pt[..., 0] / 0.5)
                              + torch.floor(hit_pt[..., 1] / 0.5)
                              + torch.floor(hit_pt[..., 2] / 0.5), 2.0)
    base_r = 0.25 + 0.5 * torch.abs(torch.sin(seed * 2.1 + 1.0))
    base_g = 0.25 + 0.5 * torch.abs(torch.sin(seed * 3.7 + 2.0))
    base_b = 0.25 + 0.5 * torch.abs(torch.sin(seed * 5.3 + 3.0))
    shade = 0.75 + 0.25 * checker
    stripes = 0.85 + 0.15 * torch.sin(hit_pt[..., 0] * 7.0) * torch.sin(
        hit_pt[..., 2] * 7.0)
    rgb = torch.stack([base_r * shade * stripes, base_g * shade,
                       base_b * (1.25 - 0.25 * checker)], dim=-1)
    rgb = torch.clamp(rgb, 0.0, 1.0)
    if single:
        return rgb[0], t_best[0], best[0]
    return rgb, t_best, best


class FakeSim:
    """Embodied sim over a BoxScene: reset / step / get_observations /
    set_pose / render_at / intrinsics, with actions 1 = fwd, 2 = left,
    3 = right.
    Observations are dict(rgb (H, W, 3), depth (H, W)) tensors on
    `device` plus the host c2w; render_at_batch renders a stack of poses
    in one raycast (the evaluation's ground truth).  With a
    `dynamic_object`, its box is part of every raycast, at its position
    at the time of the call (no frame is cached, so a moved object shows
    where it is), and the observations carry `semantic`, an (H, W) int32
    numpy array: the object's semantic id where it is hit, else 0.

    `prefetch(action)` launches the raycast of the frame that
    `step(action)` would render, without changing the sim; the next
    `step` takes that frame when its action is the prefetched one (and
    counts it in `prefetch_hits`), and renders anew otherwise.  With
    `object_dynamic` (the episode moves the object between steps),
    prefetch does nothing: the object may still move before the step."""

    def __init__(self, scene: BoxScene, camera: Camera,
                 forward_step: float = 0.065, turn_angle: float = 10.0,
                 cam_height: float = 1.25, seed: int = 0,
                 dynamic_object: SimObject | None = None, device="cuda",
                 object_dynamic: bool = False):
        self.scene = scene
        self.camera = camera
        self.forward_step = float(forward_step)
        self.turn_angle = float(turn_angle)
        self.cam_height = float(cam_height)
        self.device = torch.device(device)
        self.dynamic_object = dynamic_object
        self.object_dynamic = bool(object_dynamic)
        self._prefetched = None
        self.prefetch_hits = 0
        b = scene.boxes()
        self._boxes = (torch.as_tensor(b.lo, device=self.device),
                       torch.as_tensor(b.hi, device=self.device),
                       torch.as_tensor(b.inward, device=self.device),
                       torch.as_tensor(b.color_seed, device=self.device))
        self.rng = np.random.default_rng(seed)
        self.c2w = np.eye(4, dtype=np.float32)
        self.collided_last = False
        self.reset()

    def _boxes_now(self):
        """The scene's boxes plus the dynamic object's box where it is
        now, and the object's box index (-1 without an object)."""
        if self.dynamic_object is None:
            return self._boxes, -1
        lo, hi = self.dynamic_object.aabb()
        dev = self.device
        extra = (torch.tensor([lo], dtype=torch.float32, device=dev),
                 torch.tensor([hi], dtype=torch.float32, device=dev),
                 torch.zeros(1, dtype=torch.bool, device=dev),
                 torch.full((1,), 17.0, device=dev))
        return (tuple(torch.cat([a, b]) for a, b in zip(self._boxes, extra)),
                self._boxes[0].shape[0])

    def _raycast(self, c2w):
        c2w_t = torch.as_tensor(np.asarray(c2w, np.float32),
                                device=self.device)
        boxes, obj_idx = self._boxes_now()
        rgb, depth, hit = _raycast_device(*boxes, c2w_t, self.camera)
        return rgb, depth, hit, obj_idx

    def reset(self, start_xz=(0.0, 0.0), yaw: float = 0.0):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        # CV camera: x right, y down, z forward: flip x and y of the y-up frame
        R = R @ np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
        self.c2w = np.eye(4, dtype=np.float32)
        self.c2w[:3, :3] = R
        self.c2w[:3, 3] = [start_xz[0], self.cam_height, start_xz[1]]
        self.collided_last = False
        self._prefetched = None
        return self.get_observations()

    def _frame(self, c2w):
        """The observation tensors at c2w: rgb, depth and, with an object,
        the semantic mask (still on the device)."""
        rgb, depth, hit, obj_idx = self._raycast(c2w)
        sem = None
        if self.dynamic_object is not None:
            sem = torch.where(hit == obj_idx, self.dynamic_object.semantic_id,
                              0).to(torch.int32)
        return rgb, depth, sem

    def _obs(self, frame):
        rgb, depth, sem = frame
        obs = dict(rgb=rgb, depth=depth, c2w=self.c2w.copy())
        if sem is not None:
            obs["semantic"] = sem.cpu().numpy()
        return obs

    def get_observations(self):
        return self._obs(self._frame(self.c2w))

    def _next_pose(self, action_id: int):
        """The pose after action_id and whether a forward was blocked."""
        next_c2w = compute_next_campos(self.c2w, int(action_id),
                                       self.forward_step, self.turn_angle)
        collided = False
        if action_id == 1:
            nxt = next_c2w[:3, 3]
            if not self.scene.is_navigable((nxt[0], 0.0, nxt[2])):
                collided = True
                next_c2w = self.c2w      # blocked: stay (habitat-style stop)
        return np.asarray(next_c2w, np.float32), collided

    def prefetch(self, action_id: int):
        """Launch the raycast of the frame after action_id; nothing of the
        sim's state changes until step takes it."""
        if self.dynamic_object is not None and self.object_dynamic:
            return
        next_c2w, collided = self._next_pose(int(action_id))
        self._prefetched = (int(action_id), next_c2w, collided,
                            self._frame(next_c2w))

    def step(self, action_id: int):
        pf, self._prefetched = self._prefetched, None
        if pf is not None and pf[0] == int(action_id):
            _a, self.c2w, self.collided_last, frame = pf
            self.prefetch_hits += 1
            return self._obs(frame)
        self.c2w, self.collided_last = self._next_pose(int(action_id))
        return self.get_observations()

    def set_pose(self, c2w):
        self.c2w = np.asarray(c2w, np.float32)
        self._prefetched = None

    def render_at(self, c2w):
        """Ground-truth (rgb, depth) tensors at a c2w pose."""
        rgb, depth, _hit, _obj = self._raycast(c2w)
        return rgb, depth

    def render_at_batch(self, c2ws):
        """Ground-truth rgb (P, H, W, 3) and depth (P, H, W) tensors at
        (P, 4, 4) c2w poses, in one raycast; pose i equals render_at at
        pose i to the bit."""
        rgb, depth, _hit, _obj = self._raycast(c2ws)
        return rgb, depth

    def is_navigable(self, pos) -> bool:
        return self.scene.is_navigable(pos)

    @property
    def intrinsics(self) -> np.ndarray:
        return self.camera.intrinsics


class ReplaySim:
    """Plays back a recorded trajectory: frames (rgb (H, W, 3), depth
    (H, W)) and c2w poses, as arrays or tensors.  They are uploaded once,
    at construction, to `colors` (F, H, W, 3) and `depths` (F, H, W)
    float32 tensors on `device`; `c2ws` (F, 4, 4) stays a float32 host
    array, as the poses are consumed on the host.  Observations follow
    FakeSim's: rgb and depth tensors, c2w a numpy copy.  Each step moves
    to the next frame, whatever the action, and the index clamps at the
    last frame."""

    def __init__(self, colors, depths, c2ws, device="cuda"):
        self.device = torch.device(device)

        def stack(frames):
            return torch.stack([torch.as_tensor(f, dtype=torch.float32)
                                .to(self.device) for f in frames])

        self.colors = stack(colors)
        self.depths = stack(depths)
        self.c2ws = np.stack([np.asarray(p, np.float32) for p in c2ws])
        self.t = 0

    def __len__(self):
        return len(self.colors)

    def reset(self):
        self.t = 0
        return self.get_observations()

    def get_observations(self):
        i = min(self.t, len(self.colors) - 1)
        return dict(rgb=self.colors[i], depth=self.depths[i],
                    c2w=self.c2ws[i].copy())

    def step(self, action_id: int = 0):
        self.t += 1
        return self.get_observations()
