"""Gaussian-SLAM runtime: the map-query slice.

The module functions mirror the JAX package's models/slam.py: a map is
built without an optimiser (`_init_first_frame` back-projects the first
frame, `_densify` adds Gaussians where the map is missing), rendered at
poses (`_render_rgbd`, `_render_pose`), and scored by Fisher information
(`_fisher_batch`, `_pose_scores`).  `GaussianSLAM` keeps the reference's
host API for these queries: init / render_at_pose(s) / compute_Hessian /
compute_H_train / pose_eval(_async) / save / load.  The mapping phase
(Adam over the map, tracking) is not part of this slice.

Every tensor of a GaussianSLAM lives on its `device` ("cuda" by
default); the ops pick the CUDA kernels for CUDA tensors and their plain
twins for CPU tensors.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..config import ConfigNode
from ..ops.camera import Camera
from ..ops.fisher import fisher_diag_batch
from ..ops.rasterize import RenderSettings, render, render_prebinned
from ..utils.geometry import invert_se3
from .gaussian_state import (GaussianState, PARAM_KEYS, add_gaussians,
                             empty_state, grow_state, state_from_numpy,
                             state_to_numpy)
from .keyframes import KeyframeBuffer


class MappingConfig(NamedTuple):
    """The mapping hyperparameters this slice reads, from the YAML."""
    sil_thres: float
    depth_error_ratio: float
    downsample_pcd: int


def _gaussian_rendervars(params: dict, w2c):
    means_cam = params["means3D"] @ w2c[:3, :3].T + w2c[:3, 3]
    scales = torch.exp(params["log_scales"])
    opac = torch.sigmoid(params["logit_opacities"][:, 0])
    return means_cam, scales, params["unnorm_rotations"], opac


def _render_rgbd(camera, settings, params, n_active, w2c, bg_white=False,
                 bins=None, with_depth_sq=False):
    """One pass over [r, g, b, z] (+ z² when `with_depth_sq`).  The
    silhouette is 1 - final_t: the blended constant-ones channel would
    telescope to exactly that, so it is not blended."""
    means_cam, scales, quats, opac = _gaussian_rendervars(params, w2c)
    z = means_cam[:, 2:3]
    cols = [params["rgb_colors"], z]
    if with_depth_sq:
        cols.append(z * z)
    colors = torch.cat(cols, dim=-1)
    cch = colors.shape[-1]
    bg = torch.zeros(cch, device=colors.device)
    if bg_white:
        bg[:3] = 1.0
    if bins is not None:
        out = render_prebinned(camera, means_cam, scales, quats, opac,
                               colors, bins, bg=bg, settings=settings)
    else:
        active = torch.arange(means_cam.shape[0],
                              device=means_cam.device) < n_active
        out = render(camera, means_cam, scales, quats, opac, colors, bg=bg,
                     active=active, settings=settings)
    res = dict(im=out["color"][..., :3], depth=out["color"][..., 3],
               sil=1.0 - out["final_t"], med_depth=out["depth"],
               final_t=out["final_t"], radii=out["radii"],
               overflow=out["overflow"])
    if with_depth_sq:
        res["depth_sq"] = out["color"][..., 4]
    return res


def _median(x):
    """Median of all elements, averaging the two middle values of an even
    count as jnp.median does (torch.median returns the lower one)."""
    v = torch.sort(x.reshape(-1)).values
    m = v.numel()
    if m % 2:
        return v[m // 2]
    return 0.5 * (v[m // 2 - 1] + v[m // 2])


def _backproject(depth, color, w2c, camera: Camera, ds: int):
    """World points, colors and projective scales of the ds-strided grid."""
    h, w = depth.shape
    dev = depth.device
    ys = torch.arange(0, h, ds, dtype=torch.float32, device=dev)
    xs = torch.arange(0, w, ds, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    zs = depth[::ds, ::ds]
    px = (gx - camera.cx) / camera.fx
    py = (gy - camera.cy) / camera.fy
    pts_cam = torch.stack([px * zs, py * zs, zs], dim=-1).reshape(-1, 3)
    c2w = invert_se3(w2c)
    pts_w = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    cols = color[::ds, ::ds].reshape(-1, 3)
    z = zs.reshape(-1)
    scale = ds * z / ((camera.fx + camera.fy) / 2.0)
    m = pts_w.shape[0]
    rot = torch.zeros(m, 4, device=dev)
    rot[:, 0] = 1.0
    params = dict(
        means3D=pts_w,
        rgb_colors=cols,
        unnorm_rotations=rot,
        logit_opacities=torch.zeros(m, 1, device=dev),
        log_scales=torch.log(torch.clamp(scale, min=1e-6))[:, None].repeat(1, 3),
    )
    return params, z


def _init_first_frame(state: GaussianState, color, depth, w2c,
                      min_depth: float, camera: Camera, ds: int = 1):
    """Back-project the first frame on the ds-strided pixel grid where
    depth > min_depth.  Returns (state, dropped, n_added)."""
    params, z = _backproject(depth, color, w2c, camera, ds)
    mask = z > min_depth
    new_state, dropped = add_gaussians(state, params, mask, 0.0)
    return new_state, dropped, mask.sum(dtype=torch.int32)


def _densify(state: GaussianState, color, depth, w2c, time_idx,
             camera: Camera, settings: RenderSettings, mc: MappingConfig):
    """Back-project pixels where the map is missing: silhouette below
    threshold, or the render is behind the ground truth with a large
    error.  Returns (state, dropped, n_candidates, overflow)."""
    out = _render_rgbd(camera, settings, state.params(), state.n_active, w2c)
    sil, rdepth = out["sil"], out["depth"]

    non_presence_sil = sil < mc.sil_thres
    depth_error = torch.abs(depth - rdepth) * (depth > 0)
    err_med = _median(depth_error)
    non_presence_depth = (rdepth > depth) & (
        depth_error > mc.depth_error_ratio * err_med)
    non_presence = (non_presence_sil | non_presence_depth) & (depth > 0.01)

    ds = mc.downsample_pcd
    h, w = camera.height, camera.width
    # any-in-block downsample of the mask, candidates on the strided grid
    blocks = non_presence[:(h // ds) * ds, :(w // ds) * ds]
    blocks = blocks.reshape(h // ds, ds, w // ds, ds)
    cand_mask = blocks.any(dim=3).any(dim=1).reshape(-1)

    params, z = _backproject(depth, color, w2c, camera, ds)
    cand_mask = cand_mask & (z > 0.01)
    new_state, dropped = add_gaussians(state, params, cand_mask, time_idx)
    return (new_state, dropped, cand_mask.sum(dtype=torch.int32),
            out["overflow"])


def _render_pose(state: GaussianState, w2c, camera: Camera,
                 settings: RenderSettings, white_bg: bool, mask=None):
    """Render [rgb, z, z²] at a pose; `mask` (capacity,) bool hides
    Gaussians (opacity 0)."""
    params = state.params()
    if mask is not None:
        params = dict(params)
        params["logit_opacities"] = torch.where(
            mask[:, None], params["logit_opacities"],
            torch.full_like(params["logit_opacities"], float("-inf")))
    return _render_rgbd(camera, settings, params, state.n_active, w2c,
                        bg_white=white_bg, with_depth_sq=True)


def _render_pose_batch(state: GaussianState, w2cs, camera: Camera,
                       settings: RenderSettings, white_bg: bool):
    """Render P poses; outputs stacked on a leading pose dimension."""
    outs = [_render_pose(state, w2c, camera, settings, white_bg)
            for w2c in w2cs]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _fisher_batch(state: GaussianState, w2cs, camera: Camera,
                  settings: RenderSettings, full_chain: bool = False,
                  grad_value: float = 1e-3):
    params = state.params()
    active = torch.arange(state.capacity,
                          device=w2cs.device) < state.n_active
    return fisher_diag_batch(camera, w2cs, params["means3D"],
                             torch.exp(params["log_scales"]),
                             params["unnorm_rotations"],
                             torch.sigmoid(params["logit_opacities"][:, 0]),
                             params["rgb_colors"], active=active,
                             settings=settings, full_chain=full_chain,
                             grad_value=grad_value)


def _pose_scores(state: GaussianState, w2cs, h_train_inv, camera: Camera,
                 settings: RenderSettings, full_chain: bool = False,
                 grad_value: float = 1e-3):
    out = _fisher_batch(state, w2cs, camera, settings, full_chain,
                        grad_value)
    return torch.sum(out["H"] * h_train_inv[None], dim=(1, 2))


def _atomic_savez(path: str, **arrays) -> None:
    """np.savez with write-to-tmp + rename, so a reader never sees a torn
    file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _pad_poses(w2cs: np.ndarray, ck: int) -> np.ndarray:
    """Pad a pose chunk to ck poses with identities."""
    pad = ck - len(w2cs)
    if pad <= 0:
        return w2cs
    return np.concatenate([w2cs, np.tile(np.eye(4, dtype=np.float32),
                                         (pad, 1, 1))])


class GaussianSLAM:
    """Host-side orchestrator with the reference GaussianSLAM query API."""

    def __init__(self, cfg: ConfigNode, eval_dir: str | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.eval_dir = eval_dir or os.path.join(cfg.workdir, cfg.run_name)
        calib = cfg.SLAM.Dataset.Calibration
        self.camera = Camera(fx=float(calib.fx), fy=float(calib.fy),
                             cx=float(calib.cx), cy=float(calib.cy),
                             width=int(calib.width), height=int(calib.height))
        tpu = cfg.tpu
        self.settings = RenderSettings(
            tile_size=int(tpu.tile_size),
            max_per_tile=int(tpu.max_per_tile),
            chunk=min(int(tpu.get("blend_chunk", 256)),
                      int(tpu.max_per_tile)),
            max_depth=float(tpu.max_depth))
        # Fisher/EIG renders use bigger tiles
        fisher_k = int(tpu.get("fisher_max_per_tile", tpu.max_per_tile))
        self.fisher_settings = RenderSettings(
            tile_size=int(tpu.get("fisher_tile_size", tpu.tile_size)),
            max_per_tile=fisher_k, chunk=min(64, fisher_k),
            max_depth=float(tpu.max_depth))
        # EIG renders at reduced resolution; grad_value scales by the
        # factor so H keeps its full-resolution magnitude
        # (H ~ grad_value² * n_pixels), and the camera's dilation by 1/s²
        fs = max(int(tpu.get("fisher_downsample", 1)), 1)
        self.fisher_downsample = fs
        self.fisher_camera = self.camera.downsampled(fs)
        self.fisher_grad_value = 1e-3 * fs
        # reduced projection chain for H_train and pose_eval, as in the
        # JAX package (its path-EIG scoring uses the full chain)
        self.fisher_full_chain = bool(tpu.get("fisher_full_chain", False))
        mp = cfg.mapping
        self.mc = MappingConfig(
            sil_thres=float(mp.sil_thres),
            depth_error_ratio=float(mp.densify_dict.depth_error_ratio),
            downsample_pcd=int(cfg.downsample_pcd))
        self.state = empty_state(int(tpu.capacity), device=self.device)
        self.pose_chunk = int(tpu.pose_chunk)
        # H_train keyframe budget per planning event (0 = exact full sum)
        self.h_train_window = int(tpu.get("h_train_window", 96))

        self.keyframes = KeyframeBuffer(self.camera.height, self.camera.width)
        self.keyframe_time_indices: list[int] = []
        self.poses_w2c: list[np.ndarray] = []
        self.frame_idx = -1
        self.initialized = False
        self._param_version = 0   # bumped on any Gaussian-param mutation

    # -- helpers ------------------------------------------------------------
    @property
    def state(self) -> GaussianState:
        return self._state

    @state.setter
    def state(self, s: GaussianState):
        self._state = s
        self._state_epoch = getattr(self, "_state_epoch", 0) + 1

    @property
    def n_active(self) -> int:
        c = getattr(self, "_n_active_cache", None)
        if c is not None and c[0] == self._state_epoch:
            return c[1]
        n = int(self.state.n_active)
        self._n_active_cache = (self._state_epoch, n)
        return n

    def _maybe_bump_tile_capacity(self, overflow: int, n_renders: int):
        """Adaptive per-tile capacity: double `max_per_tile` (up to
        tpu.max_per_tile_limit) when the truncated fraction of splat-tile
        entries exceeds tpu.overflow_bump_ratio."""
        st = self.settings
        limit = int(self.cfg.tpu.get("max_per_tile_limit", 1024))
        if st.max_per_tile >= limit or n_renders <= 0:
            return
        n_tiles = (-(-self.camera.width // st.tile_size)
                   * -(-self.camera.height // st.tile_size))
        frac = overflow / float(n_renders * n_tiles * st.max_per_tile)
        if frac > float(self.cfg.tpu.get("overflow_bump_ratio", 1e-3)):
            self.settings = st._replace(
                max_per_tile=min(2 * st.max_per_tile, limit))

    def _ensure_capacity(self, incoming: int):
        cap = self.state.capacity
        need = self.n_active + incoming
        if need > cap:
            growth = int(self.cfg.tpu.capacity_growth)
            new_cap = cap
            while new_cap < need:
                new_cap *= growth
            self.state = grow_state(self.state, new_cap)

    def _prep_inputs(self, color, depth):
        """(H, W, 3) float color in [0, 1] and (H, W) depth, as float32
        tensors on the SLAM device."""
        color = torch.as_tensor(color, device=self.device)
        if color.dtype == torch.uint8:
            color = color.float() / 255.0
        color = color.float()
        if color.dim() == 3 and color.shape[0] == 3:     # (3,H,W) -> (H,W,3)
            color = color.movedim(0, -1)
        depth = torch.as_tensor(depth, device=self.device).float()
        if depth.dim() == 3:
            depth = depth.reshape(depth.shape[-2], depth.shape[-1])
        return color, depth

    def _w2c(self, w2c) -> torch.Tensor:
        return torch.as_tensor(np.asarray(w2c, np.float32), device=self.device)

    # -- reference API ------------------------------------------------------
    def init(self, color, depth, w2c=None):
        """First-frame initialization: back-project the downsample_pcd-
        strided pixel grid where depth > 10*cell_size into Gaussians."""
        color, depth = self._prep_inputs(color, depth)
        w2c = np.eye(4, dtype=np.float32) if w2c is None \
            else np.asarray(w2c, np.float32)
        self.frame_idx = 0
        self.poses_w2c = [w2c]
        cell = float(self.cfg.explore.cell_size)
        h, w = depth.shape
        ds = self.mc.downsample_pcd
        self._ensure_capacity((h // ds) * (w // ds))
        state, _dropped, n_added = _init_first_frame(
            self.state, color, depth, self._w2c(w2c), 10.0 * cell,
            self.camera, ds)
        self.state = state
        self._param_version += 1
        self.keyframes.append(color, depth, w2c, 0)
        self.keyframe_time_indices.append(0)
        self.initialized = True
        return int(n_added)

    def render_at_pose(self, c2w, white_bg: bool = False, mask=None):
        w2c = np.linalg.inv(np.asarray(c2w, np.float32))
        full_mask = None
        if mask is not None:
            full_mask = torch.zeros(self.state.capacity, dtype=torch.bool,
                                    device=self.device)
            full_mask[:len(mask)] = torch.as_tensor(mask, device=self.device)
        out = _render_pose(self.state, self._w2c(w2c), self.camera,
                           self.settings, bool(white_bg), full_mask)
        return {"render": out["im"], "depth": out["med_depth"],
                "depth_acc": out["depth"], "sil": out["sil"]}

    def render_at_poses(self, c2ws, white_bg: bool = False):
        """Render at (P, 4, 4) c2w poses; outputs carry a leading P."""
        w2cs = np.linalg.inv(np.asarray(c2ws, np.float32))
        out = _render_pose_batch(self.state, self._w2c(w2cs), self.camera,
                                 self.settings, bool(white_bg))
        return {"render": out["im"], "depth": out["med_depth"],
                "depth_acc": out["depth"], "sil": out["sil"]}

    def compute_Hessian(self, rel_w2c, return_points: bool = False,
                        random_gaussian_params=None, return_pose: bool = False):
        """Fisher H at one pose; (capacity, 4), rows past n_active zero.
        `random_gaussian_params` is accepted and ignored, as in the
        reference; the pose Hessian is its identity placeholder."""
        out = _fisher_batch(self.state, self._w2c(rel_w2c)[None],
                            self.fisher_camera, self.fisher_settings,
                            self.fisher_full_chain, self.fisher_grad_value)
        h = out["H"][0]
        if not return_points:
            h = h.reshape(-1)
        if return_pose:
            return h, torch.eye(6, device=self.device)
        return h

    def _h_train_key(self):
        """H_train changes only when the keyframe set or the Gaussian
        parameters change."""
        return (len(self.keyframes), self._param_version, self.n_active,
                self.state.capacity)

    def compute_H_train(self, random_gaussian_params=None):
        """Σ over keyframes of compute_Hessian, cached per parameter and
        keyframe version.  When keyframes were only appended since the
        cached sum, the new keyframes' Hessians are added to it.  With
        more keyframes than tpu.h_train_window, the sum runs over keyframe
        ids evenly strided across the whole history (first and latest
        always in), scaled by K/|ids|."""
        key = self._h_train_key()
        n_kf = len(self.keyframes)
        w = self.h_train_window
        cached = getattr(self, "_h_train_cache", None)
        if w and n_kf > w:
            ids = sorted(set(np.round(
                np.linspace(0, n_kf - 1, w)).astype(int).tolist()))
            key = key + ("win", tuple(ids))
            if cached is not None and cached[0] == key:
                return cached[1]
            h = self._h_train_over(
                self.keyframes.stacked_w2cs()[ids]) * (n_kf / len(ids))
            self._h_train_cache = (key, h)
            return h
        if cached is not None and cached[0] == key:
            return cached[1]
        if cached is not None and len(cached[0]) == len(key) \
                and cached[0][1:] == key[1:] and cached[0][0] < key[0]:
            h = cached[1] + self._h_train_over(
                self.keyframes.stacked_w2cs()[cached[0][0]:])
        else:
            h = self._h_train_over(self.keyframes.stacked_w2cs())
        self._h_train_cache = (key, h)
        return h

    def _h_train_over(self, w2cs: np.ndarray):
        h_train = torch.zeros(self.state.capacity, 4, device=self.device)
        if len(w2cs) == 0:
            return h_train
        ck = min(self.pose_chunk, len(w2cs))
        for i in range(0, len(w2cs), ck):
            chunk = w2cs[i:i + ck]
            n_real = len(chunk)
            out = _fisher_batch(self.state, self._w2c(_pad_poses(chunk, ck)),
                                self.fisher_camera, self.fisher_settings,
                                self.fisher_full_chain,
                                self.fisher_grad_value)
            h_train = h_train + out["H"][:n_real].sum(dim=0)
        return h_train

    def pose_eval_async(self, poses, random_gaussian_params=None):
        """Launch EIG scoring for all candidate c2w poses and return a
        `resolve()` closure giving (scores (P,), poses (P, 4, 4))."""
        poses = np.asarray(poses, np.float32)
        h_train_inv = 1.0 / (self.compute_H_train() + 0.1)
        w2cs = np.linalg.inv(poses)
        ck = self.pose_chunk
        chunks = []
        for i in range(0, len(w2cs), ck):
            chunk = w2cs[i:i + ck]
            s = _pose_scores(self.state, self._w2c(_pad_poses(chunk, ck)),
                             h_train_inv, self.fisher_camera,
                             self.fisher_settings, self.fisher_full_chain,
                             self.fisher_grad_value)
            chunks.append(s[:len(chunk)])

        def resolve():
            return torch.cat(chunks), torch.as_tensor(poses,
                                                      device=self.device)
        return resolve

    def pose_eval(self, poses, random_gaussian_params=None):
        """EIG score per candidate c2w pose: sum(H_pose / (H_train + 0.1))."""
        return self.pose_eval_async(poses, random_gaussian_params)()

    # checkpointing ---------------------------------------------------------
    def save(self, time_idx: int):
        """Write params{time_idx}.npz and keyframes.npz in the JAX
        package's format."""
        os.makedirs(self.eval_dir, exist_ok=True)
        path = os.path.join(self.eval_dir, f"params{time_idx}.npz")
        arrs = state_to_numpy(self.state)
        _atomic_savez(
            path, n_active=self.n_active, timestep=arrs["timestep"],
            poses_w2c=np.stack(self.poses_w2c),
            keyframe_time_indices=np.asarray(self.keyframe_time_indices),
            **{k: arrs[k] for k in PARAM_KEYS})
        if len(self.keyframes):
            kf = self.keyframes.state_dict()
            _atomic_savez(
                os.path.join(self.eval_dir, "keyframes.npz"),
                colors=np.stack(kf["colors"]).astype(np.float16),
                depths=np.stack(kf["depths"]).astype(np.float16),
                w2cs=np.stack(kf["w2cs"]), ids=np.asarray(kf["ids"]))
        return path

    def load(self, path: str):
        """Read a params npz (and the keyframes.npz beside it) written by
        this class's or the JAX package's GaussianSLAM.save."""
        with np.load(path) as data:
            n = int(data["n_active"])
            self._ensure_capacity(n)
            self.state = state_from_numpy(
                {k: data[k] for k in PARAM_KEYS + ("timestep", "n_active")},
                self.state.capacity, device=self.device)
            self.poses_w2c = [p for p in data["poses_w2c"]]
            self.keyframe_time_indices = [
                int(i) for i in data["keyframe_time_indices"]]
        self._param_version += 1
        self.frame_idx = len(self.poses_w2c) - 1
        kf_path = os.path.join(os.path.dirname(path), "keyframes.npz")
        if os.path.exists(kf_path):
            with np.load(kf_path) as kf:
                self.keyframes.load_state_dict(dict(
                    colors=list(kf["colors"]), depths=list(kf["depths"]),
                    w2cs=list(kf["w2cs"]),
                    ids=[int(i) for i in kf["ids"]]))
        self.initialized = True
