"""The habitat-sim adapter and its data layer.  The JAX package's
envs/habitat_adapter.py, with the observations on a torch device.

As in the reference's HabitatDataScene: the per-dataset scene and
pointnav episode paths, the episodes' json.gz, the sensor resolution and
turn / forward overrides of habitat's Hydra config, the intrinsics from
the 90 degree hfov, the Neural-SLAM actuation noise, and the sensor
state's c2w (habitat's y-up, -z-forward sensor frame flipped into the CV
frame).  These helpers are numpy and need no habitat.  `HabitatSim`
wraps a `habitat.Env` behind FakeSim's interface: `rgb` (H, W, 3)
float32 in [0, 1] and `depth` (H, W) in metres as tensors on the sim's
device, `c2w` a host (4, 4) float32 array and, where the sensors give
it, `semantic` a host (H, W) int32 array, so the episode drivers take
either sim.  habitat is imported when a HabitatSim is made without an
`env_factory` (or without a `config`); it is not installed here, and
`env_factory` / `config` let a mock environment stand in for it.
"""
from __future__ import annotations

import copy
import gzip
import json
import os

import numpy as np
import torch


def _habitat():
    """The habitat module, or ImportError with what to do instead."""
    try:
        import habitat  # type: ignore
    except ImportError as e:
        raise ImportError(
            "habitat-sim is not installed; use `--sim fake` (FakeSim) or "
            "install habitat-lab and habitat-sim to run MP3D, HM3D or "
            "Gibson scenes") from e
    return habitat


# -- pure helpers (no habitat) -----------------------------------------------

def scene_asset_path(dataset_type: str, root_path: str, scene_id: str,
                     split: str = "val", scenes_dir: str = "") -> dict:
    """The scene asset and scene_dataset paths of a dataset family:
    {"scene": ..., "scene_dataset": ... or None}."""
    ds = dataset_type
    scene_name = scene_id.split("-")[1] if "-" in scene_id else scene_id
    if ds == "MP3D":
        return dict(
            scene=os.path.join(root_path, ds, scene_id, scene_id + ".glb"),
            scene_dataset=os.path.join(
                root_path, ds, "mp3d_annotated_basis.scene_dataset_config"
                ".json"))
    if ds == "gibson":
        return dict(scene=os.path.join(root_path, ds, scene_id,
                                       scene_id + ".glb"),
                    scene_dataset=None)
    if ds == "replica":
        return dict(scene=os.path.join(root_path, "data/scene_datasets/",
                                       scenes_dir, scene_id,
                                       "habitat/mesh_semantic.ply"),
                    scene_dataset=None)
    if ds == "hm3d":
        return dict(
            scene=os.path.join(root_path, "hm3d-0.2/hm3d/", split, scene_id,
                               f"{scene_name}.basis.glb"),
            scene_dataset=os.path.join(
                root_path,
                "hm3d-0.2/hm3d/hm3d_annotated_basis.scene_dataset_config"
                ".json"))
    if ds == "habitat_test_scenes":
        return dict(scene=os.path.join(root_path, ds, f"{scene_id}.glb"),
                    scene_dataset=None)
    raise ValueError(f"unknown dataset_type {dataset_type!r}")


def episode_file_path(dataset_type: str, root_path: str, split: str,
                      scene_id: str) -> str:
    """The pointnav episode file of a dataset family."""
    ds = dataset_type
    if ds == "MP3D":
        return os.path.join(root_path, ds, "pointnav_mp3d_v1", split,
                            "content", scene_id + ".json.gz")
    if ds == "gibson":
        return os.path.join(root_path, ds, "pointnav_gibson_v2", split,
                            "content", scene_id + ".json.gz")
    if ds == "hm3d":
        return os.path.join("../data/datasets/pointnav/hm3d/v1", split,
                            split + ".json.gz")
    if ds == "habitat_test_scenes":
        return os.path.join("../data/datasets/pointnav/habitat_test_scenes"
                            "/v1", split, split + ".json.gz")
    if ds == "replica":
        return os.path.join(root_path, "data/scene_datasets/Replica",
                            scene_id, "habitat/replica_stage.stage_config"
                            ".json")
    raise ValueError(f"unknown dataset_type {dataset_type!r}")


def load_pointnav_episodes(path: str, scene_id: str) -> dict:
    """This scene's episodes of a pointnav json(.gz) file; a missing file
    gives no episodes (the active-mapping drivers need no goals)."""
    if not os.path.exists(path):
        return {"episodes": []}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fp:
        data = json.load(fp)
    out = {"episodes": []}
    for ep in data.get("episodes", []):
        sc = ep.get("scene_id", "").split("/")[-1].split(".")[0]
        if sc == scene_id:
            out["episodes"].append(ep)
    return out


def add_difficulty(episodes: list[dict]) -> None:
    """Difficulty from the geodesic distance: over 13 m hard, over 7 m
    medium, else easy."""
    for ep in episodes:
        geo = ep["info"]["geodesic_distance"]
        ep["info"]["difficulty"] = ("hard" if geo > 13.0 else
                                    "medium" if geo > 7.0 else "easy")


def intrinsics_from_hfov(width: int, height: int,
                         hfov_deg: float = 90.0) -> np.ndarray:
    """Pinhole K from habitat's horizontal field of view."""
    hfov = np.deg2rad(hfov_deg)
    fx = (width / 2.0) / np.tan(hfov / 2.0)
    fy = (height / 2.0) / np.tan(hfov / 2.0)
    return np.array([[fx, 0.0, width / 2.0],
                     [0.0, fy, height / 2.0],
                     [0.0, 0.0, 1.0]], np.float32)


def unnormalize_depth(depth: np.ndarray, min_depth: float,
                      max_depth: float) -> np.ndarray:
    """A normalize_depth sensor's [0, 1] back to metres."""
    return depth * (max_depth - min_depth) + min_depth


def apply_sensor_overrides(cfg, turn_angle: float, forward_step: float,
                           max_steps: int, img_width: int, img_height: int,
                           scene: str | None = None,
                           scene_dataset: str | None = None,
                           split: str = "val"):
    """Set a habitat Hydra config (any attribute tree) as the reference
    does: the motion steps, the episode cap, the RGB / depth / semantic
    sensors' resolution, the scene paths, no pointnav dataset preload."""
    sim = cfg.habitat.simulator
    sim.turn_angle = int(turn_angle)
    sim.forward_step_size = float(forward_step)
    cfg.habitat.environment.max_episode_steps = int(max_steps)
    cfg.habitat.dataset.type = ""
    cfg.habitat.dataset.split = split
    sensors = sim.agents.main_agent.sim_sensors
    for name in ("rgb_sensor", "depth_sensor", "semantic_sensor"):
        s = getattr(sensors, name, None)
        if s is not None:
            s.width = int(img_width)
            s.height = int(img_height)
    if scene is not None:
        sim.scene = scene
    if scene_dataset is not None:
        sim.scene_dataset = scene_dataset
    return cfg


class PoseNoiseModel:
    """Neural-SLAM actuation noise: per action an (x m, y m, yaw deg)
    error, from the pickled GMMs in `noise_dir` where they exist, else a
    Gaussian with Neural-SLAM's magnitudes (LoCoBot: 1-2 cm and 1-2
    degrees), scaled by noise_level."""

    _FALLBACK = {  # action_id -> (mean, sigma) of (x m, y m, o deg)
        1: ((0.008, 0.004, -0.3), (0.012, 0.009, 1.4)),   # forward
        2: ((0.002, 0.002, 0.8), (0.005, 0.004, 1.5)),    # left
        3: ((0.002, -0.002, -0.8), (0.005, 0.004, 1.5)),  # right
    }

    def __init__(self, noise_dir: str = "noise_models", noise_level=1.0,
                 seed: int = 0):
        self.noise_level = float(noise_level)
        self.rng = np.random.default_rng(seed)
        self._gmms = {}
        names = {1: "sensor_noise_fwd.pkl", 2: "sensor_noise_left.pkl",
                 3: "sensor_noise_right.pkl"}
        for aid, fn in names.items():
            path = os.path.join(noise_dir, fn)
            if os.path.exists(path):
                import pickle
                try:
                    with open(path, "rb") as f:
                        self._gmms[aid] = pickle.load(f)
                except Exception:
                    pass

    def sample(self, action_id: int):
        """(x_err m, y_err m, o_err deg) of one executed action."""
        aid = int(action_id)
        if aid in self._gmms:
            return tuple(float(v) for v in self._gmms[aid].sample()[0][0])
        if aid not in self._FALLBACK:
            return (0.0, 0.0, 0.0)
        mean, sigma = self._FALLBACK[aid]
        return tuple(float(self.rng.normal(m, s))
                     for m, s in zip(mean, sigma))

    def add_pose_noise(self, rel_pose, action_id: int):
        """A (3,) [x, y, yaw rad] relative pose with one action's noise."""
        x_err, y_err, o_err = self.sample(action_id)
        rel = np.asarray(rel_pose, np.float64).copy()
        rel[0] += x_err * self.noise_level
        rel[1] += y_err * self.noise_level
        rel[2] += np.deg2rad(o_err * self.noise_level)
        return rel


def quat_wxyz_to_rotmat(w: float, x: float, y: float, z: float):
    n = max(np.sqrt(w * w + x * x + y * y + z * z), 1e-12)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def sensor_c2w(position, rotation_wxyz) -> np.ndarray:
    """A sensor state's CV-frame c2w: habitat's y-up / -z-forward sensor
    frame flipped into x-right / y-down / z-forward."""
    rot = quat_wxyz_to_rotmat(*rotation_wxyz)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = rot @ np.diag([1.0, -1.0, -1.0])
    c2w[:3, 3] = np.asarray(position, np.float32)
    return c2w


def _state_c2w(agent_state) -> np.ndarray:
    s = agent_state.sensor_states["rgb"]
    q = s.rotation
    return sensor_c2w(s.position, (q.w, q.x, q.y, q.z))


def rotmat_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z) quaternion (Shepperd's method)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2.0
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def set_agent_state(sim, c2w: np.ndarray) -> None:
    """Teleport the agent and its sensors to a CV-frame c2w (a (4, 4)
    matrix or (x, y, z, qw, qx, qy, qz)), as the reference's
    set_agent_state: only x and z move (y keeps the agent's height), the
    rotation is reduced to its yaw (the quaternion's y and w), the CV
    frame's y and z axes flipped back into habitat's sensor frame."""
    c2w = np.asarray(c2w, np.float64)
    state = sim.get_agent_state()
    if c2w.size == 16:
        x, z = float(c2w[0, 3]), float(c2w[2, 3])
        rot = c2w[:3, :3].copy()
        rot[:, 1] *= -1.0
        rot[:, 2] *= -1.0
        qw, _qx, qy, _qz = rotmat_to_quat_wxyz(rot)
    elif c2w.size == 7:
        x, z = float(c2w[0]), float(c2w[2])
        qw, qy = float(c2w[3]), float(c2w[5])
    else:
        raise ValueError(f"set_agent_state: got size-{c2w.size} pose")
    for tgt in [state] + list(state.sensor_states.values()):
        tgt.position[0] = x
        tgt.position[2] = z
        tgt.rotation.y = qy
        tgt.rotation.w = qw
    sim.agents[0].set_state(state)


class HabitatSimObject:
    """A spawned rigid object with SimObject's motion interface: its
    semantic id, translation and pose, `moving_randomly` and
    `moving_forward_and_back` (a random walk that bounces off what the
    pathfinder calls not navigable), integrated here kinematically
    rather than by habitat's physics (the same for a KINEMATIC object)."""

    def __init__(self, obj, navigable_fn, semantic_id: int = 100,
                 speed: float = 0.04, gt_points: np.ndarray | None = None,
                 seed: int = 0):
        self.obj = obj                       # habitat's rigid object
        self._navigable = navigable_fn
        self.semantic_id = int(semantic_id)
        self.speed = float(speed)
        self.rng = np.random.default_rng(seed)
        self.yaw = 0.0
        self._dir = 1.0
        # the object's cloud in its own frame, when one is given (the
        # reference samples its glb)
        self._gt_points = (np.asarray(gt_points, np.float32)
                           if gt_points is not None else None)

    @property
    def translation(self) -> np.ndarray:
        return np.asarray(self.obj.translation, np.float64).copy()

    def set_translation(self, pos):
        self.obj.translation = np.asarray(pos, np.float64)

    def object_pose(self) -> np.ndarray:
        """(4, 4) world-from-object: a translation (the walk keeps the
        object's frame)."""
        T = np.eye(4, dtype=np.float64)
        T[:3, 3] = self.translation
        return T

    def sample_surface_points(self, n: int, rng=None,
                              frame: str = "world") -> np.ndarray | None:
        """n points of the object's cloud, or None for an object spawned
        without one (the episode then skips the object curve)."""
        if self._gt_points is None:
            return None
        rng = rng or np.random.default_rng(0)
        idx = rng.choice(len(self._gt_points), size=n,
                         replace=n > len(self._gt_points))
        pts = self._gt_points[idx]
        if frame == "object":
            return pts
        return pts + self.translation.astype(np.float32)

    def _try_move(self, delta) -> bool:
        nxt = self.translation + delta
        if self._navigable((nxt[0], nxt[1], nxt[2])):
            self.set_translation(nxt)
            return True
        return False

    def moving_forward_and_back(self):
        """Along the heading, turning back where blocked."""
        d = np.array([np.sin(self.yaw), 0.0, np.cos(self.yaw)]) \
            * self.speed * self._dir
        if not self._try_move(d):
            self._dir *= -1.0

    def moving_randomly(self):
        """A random yaw jitter; a new random heading where blocked."""
        self.yaw += self.rng.uniform(-0.4, 0.4)
        d = np.array([np.sin(self.yaw), 0.0, np.cos(self.yaw)]) * self.speed
        if not self._try_move(d):
            self.yaw = self.rng.uniform(0, 2 * np.pi)


class HabitatScene:
    """The scene interface of a habitat episode (BoxScene's
    sample_navigable, gt_free_map and is_navigable) from the pathfinder,
    so the evaluation's poses, its PSNR map and the fog-of-war coverage
    run as on FakeSim."""

    def __init__(self, hsim: "HabitatSim"):
        self._hsim = hsim

    def is_navigable(self, pos) -> bool:
        return self._hsim.is_navigable(pos)

    def sample_navigable(self, rng: np.random.Generator, n: int):
        return self._hsim.sample_navigable(rng, n)

    def gt_free_map(self, cell_size: float, grid_dim, map_center):
        return self._hsim.gt_free_map(cell_size, grid_dim, map_center)

    def sample_surface_points(self, n: int, rng=None,
                              interior_only: bool = True):
        """None: without a mesh loader there is no ground-truth cloud,
        and the reconstruction metric is skipped."""
        return None


# -- the habitat-backed simulator ---------------------------------------------

class HabitatSim:
    """A habitat.Env behind FakeSim's interface (see the module
    docstring), with the reference's data layer: the scene's pointnav
    episodes, the sensor and step overrides, the noise model and the
    hfov intrinsics.  `env_factory(config) -> env` and `config` replace
    habitat.Env and habitat.get_config (a mock environment in tests);
    the observations' tensors go to `device`."""

    ACTION_MAP = {0: "stop", 1: "move_forward", 2: "turn_left",
                  3: "turn_right"}

    def __init__(self, args, cfg, scene_id: str, env_factory=None,
                 config=None, seed: int = 0, device="cuda"):
        if env_factory is None:
            habitat = _habitat()
            env_factory = lambda c: habitat.Env(config=c)  # noqa: E731
        self.device = torch.device(device)
        self.scene_id = scene_id
        dataset_type = str(getattr(args, "dataset_type",
                                   getattr(args, "dataset", "MP3D")))
        root_path = str(getattr(args, "root_path", "data"))
        split = str(getattr(args, "dataset_split", "val"))

        h = int(cfg.SLAM.Dataset.Calibration.height)
        w = int(cfg.SLAM.Dataset.Calibration.width)
        if config is None:
            config = _habitat().get_config(os.path.join(
                "configs", f"my_pointnav_{dataset_type.lower()}_val.yaml"))
            try:
                from omegaconf import OmegaConf
                OmegaConf.set_readonly(config, False)
            except Exception:
                pass
        assets = scene_asset_path(dataset_type, root_path, scene_id,
                                  split=split,
                                  scenes_dir=str(getattr(args, "scenes_dir",
                                                         "")))
        apply_sensor_overrides(
            config, turn_angle=float(cfg.turn_angle),
            forward_step=float(cfg.forward_step_size),
            max_steps=int(cfg.num_frames), img_width=w, img_height=h,
            scene=assets["scene"], scene_dataset=assets["scene_dataset"],
            split=split)

        self._env = env_factory(config)
        if hasattr(self._env, "seed"):
            self._env.seed(seed)
        self.turn_angle = float(cfg.turn_angle)
        self.forward_step = float(cfg.forward_step_size)
        self._K = intrinsics_from_hfov(w, h, 90.0)
        self.min_depth = float(getattr(args, "min_depth", 0.0))
        self.max_depth = float(getattr(args, "max_depth", 10.0))
        self.normalized_depth = bool(getattr(args, "normalized_depth",
                                             False))

        ep_path = episode_file_path(dataset_type, root_path, split, scene_id)
        self.scene_data = load_pointnav_episodes(ep_path, scene_id)
        self.number_of_episodes = len(self.scene_data["episodes"])

        # actuation noise (opt-in, the reference's noisy_pose)
        self.noise_model = None
        if bool(getattr(args, "noisy_pose", False)):
            self.noise_model = PoseNoiseModel(
                noise_level=float(getattr(args, "noise_level", 1.0)),
                seed=seed)

        self.dynamic_object: HabitatSimObject | None = None
        self._rng = np.random.default_rng(seed)
        self._env.reset()

    # -- data layer -----------------------------------------------------
    def __len__(self):
        return self.number_of_episodes

    def get_episode_info(self, idx: int) -> dict:
        """Episode idx's start_position, start_rotation and goals."""
        return self.scene_data["episodes"][idx]

    @property
    def intrinsics(self):
        return self._K

    # -- sim interface --------------------------------------------------
    def _upload(self, rgb, depth):
        """habitat's uint8 rgb and float32 depth -> (rgb (H, W, 3) in
        [0, 1], depth (H, W) in metres) on the sim's device."""
        depth = np.asarray(depth, np.float32)
        depth = depth.reshape(depth.shape[0], depth.shape[1])
        if self.normalized_depth:
            depth = unnormalize_depth(depth, self.min_depth, self.max_depth)
        rgb = np.asarray(rgb, np.float32)[..., :3] / 255.0
        return (torch.as_tensor(rgb, device=self.device),
                torch.as_tensor(depth, device=self.device))

    def _obs_dict(self, obs):
        c2w = _state_c2w(self._env.sim.get_agent_state())
        rgb, depth = self._upload(obs["rgb"], obs["depth"])
        out = dict(rgb=rgb, depth=depth, c2w=c2w)
        if "semantic" in obs:
            out["semantic"] = np.asarray(obs["semantic"], np.int32)
        return out

    def get_observations(self):
        return self._obs_dict(self._env.sim.get_sensor_observations())

    def reset(self):
        return self._obs_dict(self._env.reset())

    def step(self, action_id: int):
        # the dynamic object is moved by the episode driver each step, as
        # FakeSim's is
        return self._obs_dict(self._env.step(self.ACTION_MAP[int(action_id)]))

    def is_navigable(self, pos) -> bool:
        p = np.asarray(pos, np.float32).reshape(-1)
        point = [float(p[0]), 0.0, float(p[-1])] if len(p) == 2 else \
            [float(p[0]), float(p[1]), float(p[2])]
        return bool(self._env.sim.pathfinder.is_navigable(point))

    @property
    def c2w(self):
        return _state_c2w(self._env.sim.get_agent_state())

    # -- evaluation, resume and objects -----------------------------------
    def set_pose(self, c2w):
        """Teleport by set_agent_state (the resume's pose replay)."""
        set_agent_state(self._env.sim, c2w)

    def render_at(self, c2w):
        """(rgb, depth) tensors at a c2w pose.  The whole agent state is
        snapshotted before the teleport and restored after the render,
        so the episode goes on from where it was."""
        sim = self._env.sim
        snapshot = copy.deepcopy(sim.get_agent_state())
        try:
            set_agent_state(sim, c2w)
            obs = sim.get_sensor_observations()
        finally:
            sim.agents[0].set_state(snapshot)
        return self._upload(obs["rgb"], obs["depth"])

    def sample_navigable(self, rng: np.random.Generator,
                         n: int) -> np.ndarray:
        """(n, 2) navigable xz points from the pathfinder's random
        navigable points (`rng` is not drawn from: the pathfinder keeps
        its own stream)."""
        pf = self._env.sim.pathfinder
        out = []
        tries = 0
        while len(out) < n:
            p = pf.get_random_navigable_point()
            tries += 1
            if p is not None and np.all(np.isfinite(p)):
                out.append((float(p[0]), float(p[2])))
            elif tries > 100 * max(n, 1):
                raise RuntimeError("pathfinder returned no navigable "
                                   f"points after {tries} tries")
        return np.asarray(out, np.float32)

    def gt_free_map(self, cell_size: float, grid_dim,
                    map_center) -> np.ndarray:
        """(gz, gx) bool navigability at the agent's height, cell centres
        on the visualizer's grid."""
        y = float(self._env.sim.get_agent_state().position[1])
        gx, gz = int(grid_dim[0]), int(grid_dim[1])
        xs = (np.arange(gx) + 0.5 - gx // 2) * cell_size + map_center[0]
        zs = (np.arange(gz) + 0.5 - gz // 2) * cell_size + map_center[1]
        pf = self._env.sim.pathfinder
        free = np.zeros((gz, gx), bool)
        for iz, z in enumerate(zs):
            for ix, x in enumerate(xs):
                free[iz, ix] = bool(pf.is_navigable(
                    [float(x), y, float(z)]))
        return free

    def spawn_object(self, template_path: str, scale: float = 1.0,
                     semantic_id: int = 100, speed: float = 0.04,
                     gt_points: np.ndarray | None = None,
                     max_tries: int = 100) -> HabitatSimObject:
        """A kinematic rigid object at a random navigable point: the
        template loaded, scaled and registered, added by its id, then
        placed (the reference's initialize_dynamic_object)."""
        sim = self._env.sim
        tmpl_mgr = sim.get_object_template_manager()
        rigid_mgr = sim.get_rigid_object_manager()
        template_id = tmpl_mgr.load_configs(str(template_path))[0]
        template = tmpl_mgr.get_template_by_id(template_id)
        template.scale = [scale, scale, scale]
        tmpl_mgr.register_template(template)
        obj = rigid_mgr.add_object_by_template_id(template_id)
        try:
            import habitat_sim  # type: ignore
            obj.motion_type = habitat_sim.physics.MotionType.KINEMATIC
        except Exception:
            pass
        pf = sim.pathfinder
        pos = None
        for _ in range(max_tries):
            p = pf.get_random_navigable_point()
            if p is not None and np.all(np.isfinite(p)):
                pos = p
                break
        if pos is None:
            raise RuntimeError("no navigable point found for the object "
                               f"after {max_tries} tries")
        obj.translation = np.asarray(pos, np.float64)
        if hasattr(obj, "semantic_id"):
            obj.semantic_id = int(semantic_id)
        self.dynamic_object = HabitatSimObject(
            obj, navigable_fn=lambda p3: self.is_navigable(p3),
            semantic_id=semantic_id, speed=speed, gt_points=gt_points,
            seed=int(self._rng.integers(2 ** 31)))
        return self.dynamic_object
