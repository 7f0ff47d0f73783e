"""GaussianObjectSLAM: mask-aware reconstruction of one object.

Counterpart of the JAX package's models/object_slam.py (the reference's
GaussianObjectSLAM): a second Gaussian SLAM for a dynamic or novel
object, whose
  * init and densify seed only pixels of the object mask;
  * mapping loss is restricted to the mask (`_masked_mapping_loss`), over
    tile bins frozen once per window frame, as the scene's mapping phase;
  * mapping events prune the active Gaussians that project outside the
    current mask (`_project_outside_mask`) or fell below the opacity
    threshold;
  * keyframes carry the object mask, and the overlap selection sees the
    masked depth;
  * Hessian covers means, opacity, scales and rotations (N, 11) from
    Hutchinson estimates of diag(JᵀJ) (ops/fisher.py: K1 once per pose
    chunk, the probe-batched K2 once for all probes), and candidate poses
    and paths are scored under the `fisher`, `topt` (T-optimality) or
    `dopt` (D-optimality) criterion.
The object state holds capacity `tpu.object_capacity` (8192) slots and
renders with `tpu.object_max_per_tile` (64) slots per tile; the scene's
overflow guard doubles K when binning truncates.

Probes.  The JAX package draws its probes from jax.random keys: one
stream from PRNGKey(start_frame_idx) for candidate poses and one-off
estimates, and fold_in(PRNGKey(start_frame_idx + 7919), kf_id) per
keyframe, so that H_train topped up with new keyframes equals a full
recompute.  Torch cannot reproduce jax.random, so each draw here is named
by a seed tuple, ("kf", kf_id), ("key", c) or ("pose", c, i) with c the
count of draws from the stream, and `probe_draw(seed, n_probes)` makes it
from a torch generator seeded with those numbers and start_frame_idx.
The keyframe draws depend on the keyframe alone, so the top-up property
holds; tests replace `probe_draw` to feed the JAX package's draws.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.camera import Camera
from ..ops.fisher import (block_jtj, dopt_score_blocks, hutchinson_batch,
                          hutchinson_diag, topt_score_blocks)
from ..ops.image import calc_ssim
from .gaussian_state import (PARAM_KEYS, adam_init, adam_step, empty_state,
                             prune_compact, state_from_numpy)
from .keyframes import select_keyframes_overlap
from .slam import (GaussianSLAM, MappingConfig, _bin_frame, _densify,
                   _init_first_frame, _render_rgbd)


def _masked_mapping_loss(params, n_active, w2c, gt_color, gt_depth, obj_mask,
                         camera, settings, mc: MappingConfig, bins=None):
    """Depth L1 and 0.8 L1 + 0.2 (1 - SSIM) on the color, restricted to
    the object mask (the reference's calc_loss_mask, mapping branch)."""
    out = _render_rgbd(camera, settings, params, n_active, w2c, bins=bins)
    depth = out["depth"]
    m = (obj_mask & (gt_depth > 0) & torch.isfinite(depth)).detach()
    denom = torch.clamp(m.sum(), min=1)
    depth_l1 = torch.sum(torch.abs(gt_depth - depth) * m) / denom
    mf = m[..., None].to(torch.float32)
    im_l1 = torch.sum(torch.abs(out["im"] - gt_color) * mf) / (3 * denom)
    ssim = calc_ssim(out["im"] * mf, gt_color * mf)
    im_loss = 0.8 * im_l1 + 0.2 * (1.0 - ssim)
    return mc.depth_weight * depth_l1 + mc.im_weight * im_loss


def _object_mapping_phase(state, kf_colors, kf_depths, kf_w2cs, kf_masks,
                          frame_choices, camera: Camera, settings,
                          mc: MappingConfig):
    """The masked mapping event: `num_iters // frames_per_iter` Adam steps,
    each on the mean masked loss of the window frames `frame_choices[it]`,
    over tile bins made once per window pose from the phase's starting
    parameters; no pruning inside (the caller prunes by mask after).
    Returns (state, losses (n_steps,), bin_overflow)."""
    lrs = dict(means3D=mc.lr_means3D, rgb_colors=mc.lr_rgb,
               unnorm_rotations=mc.lr_rots, logit_opacities=mc.lr_logit_op,
               log_scales=mc.lr_log_scales)
    params = {k: v.detach() for k, v in state.params().items()}
    opt = adam_init(params)
    active = state.active
    by_pose: dict[bytes, object] = {}
    frame_bins = []
    for w2c_host, w2c in zip(kf_w2cs.cpu().numpy(), kf_w2cs):
        key = w2c_host.tobytes()
        if key not in by_pose:
            by_pose[key] = _bin_frame(params, active, w2c, camera, settings)
        frame_bins.append(by_pose[key])
    bin_overflow = torch.stack([b.overflow for b in frame_bins]).sum()
    losses = []
    for frames in np.asarray(frame_choices):
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        loss = torch.stack([
            _masked_mapping_loss(leaves, state.n_active, kf_w2cs[i],
                                 kf_colors[i], kf_depths[i], kf_masks[i],
                                 camera, settings, mc, bins=frame_bins[i])
            for i in frames.tolist()]).mean()
        grads = dict(zip(PARAM_KEYS, torch.autograd.grad(
            loss, [leaves[k] for k in PARAM_KEYS])))
        params, opt = adam_step(opt, {k: v.detach() for k, v in
                                      leaves.items()}, grads, lrs, eps=1e-15)
        losses.append(loss.detach())
    return state.replace_params(params), torch.stack(losses), bin_overflow


@torch.no_grad()
def _project_outside_mask(means3D, n_active, w2c, obj_mask, opacities,
                          camera: Camera, alpha_thresh: float):
    """(outside_active, inside_active): the active Gaussians whose center
    projects outside the object mask with opacity >= alpha_thresh, and
    those that project inside it (the reference's
    get_gaussians_outside_mask)."""
    mc = means3D @ w2c[:3, :3].T + w2c[:3, 3]
    z = torch.clamp(mc[:, 2], min=1e-6)
    u = camera.fx * mc[:, 0] / z + camera.cx
    v = camera.fy * mc[:, 1] / z + camera.cy
    h, w = obj_mask.shape
    in_img = (mc[:, 2] > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    iu = torch.clamp(torch.round(u), 0, w - 1).long()
    iv = torch.clamp(torch.round(v), 0, h - 1).long()
    inside = in_img & obj_mask[iv, iu]
    active = torch.arange(means3D.shape[0], device=means3D.device) < n_active
    outside_active = (~inside) & active & (opacities >= alpha_thresh)
    return outside_active, inside & active


def _obj_h11_batch(params, n_active, w2cs, zs, camera: Camera, settings):
    """Hutchinson (B, N, 11) Hessian diagonals [means (3), opacity (1),
    scales (3), rotations (4)] at B poses w2cs (B, 4, 4), from the probes
    zs (B, K, H, W, 3): one K1 launch and one probe-batched K2 launch."""
    active = torch.arange(params["means3D"].shape[0],
                          device=w2cs.device) < n_active
    means_cam = params["means3D"] @ w2cs[:, :3, :3].transpose(1, 2) \
        + w2cs[:, None, :3, 3]
    g = hutchinson_batch(camera, means_cam, torch.exp(params["log_scales"]),
                         params["unnorm_rotations"],
                         torch.sigmoid(params["logit_opacities"][:, 0]),
                         params["rgb_colors"], zs, active=active,
                         settings=settings)
    return torch.cat([(g["means"] ** 2).mean(dim=0),
                      (g["opacity"] ** 2).mean(dim=0)[..., None],
                      (g["scales"] ** 2).mean(dim=0),
                      (g["rotations"] ** 2).mean(dim=0)], dim=-1)


def _active_rows(n: int, n_active, device):
    return (torch.arange(n, device=device) < n_active)[None, :, None]


def _popgs_point(h_prior, cur, lam: float, active, criterion: str):
    """T-opt or D-opt gain per pose of the (B, N, 11) diagonals `cur`
    over the prior h_prior ((N, 11) or (B, N, 11)), summed over ACTIVE
    rows only: an inactive row would add -1/lam to T-opt, which in f32
    swamps the differences between poses."""
    zero = torch.zeros((), device=cur.device)
    if criterion == "topt":
        inv = 1.0 / torch.clamp(h_prior + cur + lam, min=1e-12)
        return -torch.sum(torch.where(active, inv, zero), dim=(1, 2))
    hm = torch.clamp(h_prior + lam, min=1e-12)
    gain = torch.log(torch.clamp(hm + cur, min=1e-12)) - torch.log(hm)
    return torch.sum(torch.where(active, gain, zero), dim=(1, 2))


def _obj_fisher_scores(params, n_active, w2cs, zs, h_inv, camera, settings):
    """Fisher EIG per pose: Σ H_pose / (H_train + 0.1) over the 11-wide
    Hessian (the reference's object pose_eval)."""
    h = _obj_h11_batch(params, n_active, w2cs, zs, camera, settings)
    return torch.einsum("bnd,nd->b", h, h_inv)


def _obj_popgs_scores(params, n_active, w2cs, zs, h_train11, lam: float,
                      camera, settings, criterion: str):
    """T-opt or D-opt score per pose from the Hutchinson diagonals."""
    h = _obj_h11_batch(params, n_active, w2cs, zs, camera, settings)
    active = _active_rows(h.shape[1], n_active, h.device)
    return _popgs_point(h_train11[None], h, lam, active, criterion)


def object_path_scores(params, n_active, h_train11, acc_w2cs, acc_valid,
                       lengths, final_eigs, probes, lam: float,
                       w_point: float, w_end: float, camera: Camera,
                       settings, criterion: str):
    """All candidate paths scored together (the reference's
    path_object_evaluation and path_evaluation_popgs): per path and acc
    step, the pose is scored against the path's running prior, and its
    information is folded in.

    acc_w2cs (P, A, 4, 4) poses at the acc steps, acc_valid (P, A),
    lengths (P,) action counts, final_eigs (P,); probes(s) gives the acc
    step s's probes (P, K, H, W, 3).  criterion: 'fisher', 'topt' or
    'dopt'.  Returns (P,) scores."""
    n_paths, n_acc = acc_valid.shape
    active = _active_rows(h_train11.shape[0], n_active, acc_w2cs.device)
    h_paths = h_train11[None].expand(n_paths, -1, -1)
    totals = torch.zeros(n_paths, device=acc_w2cs.device)
    for s in range(n_acc):
        cur = _obj_h11_batch(params, n_active, acc_w2cs[:, s], probes(s),
                             camera, settings)
        if criterion == "fisher":
            raw = torch.sum(cur / (h_paths + lam), dim=(1, 2))
            point = torch.log(torch.clamp(raw, min=1e-30))
        else:
            point = _popgs_point(h_paths, cur, lam, active, criterion)
        ok = acc_valid[:, s]
        totals = totals + torch.where(ok, w_point * point,
                                      torch.zeros_like(point))
        h_paths = h_paths + ok.to(cur.dtype)[:, None, None] * cur
    length = torch.clamp(lengths.to(torch.float32), min=1.0)
    if w_end > 0:
        return totals / length + w_end * final_eigs
    return (totals + final_eigs) / length


def _seed_int(numbers) -> int:
    """A 63-bit generator seed from a tuple of non-negative ints."""
    state = np.random.SeedSequence([int(x) for x in numbers]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


class GaussianObjectSLAM(GaussianSLAM):
    """Object-centric SLAM with the reference GaussianObjectSLAM API."""

    def __init__(self, cfg, eval_dir: str | None = None,
                 start_frame_idx: int = 0, device="cuda"):
        super().__init__(cfg, eval_dir=eval_dir, device=device)
        tpu = cfg.tpu
        # one object's splats, not the scene's: a small capacity (grown
        # on demand) and a small per-tile K (an object covers few tiles at
        # shallow depth; the overflow guard doubles K when a close view
        # truncates)
        self.state = empty_state(int(tpu.get("object_capacity", 8192)),
                                 device=self.device)
        k_obj = int(tpu.get("object_max_per_tile", 64))
        self.settings = self.settings._replace(max_per_tile=k_obj,
                                               chunk=min(64, k_obj))
        self.start_frame_idx = int(start_frame_idx)
        self.map_obj_every = int(cfg.map_obj_every)
        self.keyframe_obj_every = int(cfg.keyframe_obj_every)
        self.hutch_probes = int(tpu.hutchinson_probes)
        self.outside_alpha_thresh = 0.01
        self.keyframe_masks: list = []       # (H, W) bool tensors
        self.obj_pose_chunk = int(tpu.get("object_pose_chunk", 8))
        # H_train keyframe budget per planning event (0 = the exact sum):
        # past it, ids evenly strided over the whole history, scaled
        self.h_train_window = int(tpu.get("object_h_train_window", 64))
        self._draws = 0                      # draws taken from the stream

    # -- probes -------------------------------------------------------------
    def probe_draw(self, seed: tuple, n_probes: int) -> torch.Tensor:
        """The (n_probes, H, W, 3) standard normal probes named by `seed`
        (see the module docstring)."""
        tag, *ids = seed
        base = (self.start_frame_idx + 7919 if tag == "kf"
                else self.start_frame_idx)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_seed_int((base,) + tuple(ids)))
        cam = self.camera
        return torch.randn((n_probes, cam.height, cam.width, 3),
                           generator=gen, device=self.device)

    def _next_seed(self) -> int:
        self._draws += 1
        return self._draws - 1

    def _kf_probes(self, kf_ids, n_probes: int) -> torch.Tensor:
        return torch.stack([self.probe_draw(("kf", int(i)), n_probes)
                            for i in kf_ids])

    def _pose_probes(self, n_probes: int):
        """A function of pose ids giving their probes (len, K, H, W, 3),
        all from one draw of the stream."""
        c = self._next_seed()
        return lambda ids: torch.stack([
            self.probe_draw(("pose", c, int(i)), n_probes) for i in ids])

    def _next_probes(self, n_probes: int) -> torch.Tensor:
        return self.probe_draw(("key", self._next_seed()), n_probes)

    # -- lifecycle ----------------------------------------------------------
    def init(self, color, depth, w2c=None, mask=None):
        """Seed Gaussians from the masked pixels of the first frame."""
        color, depth = self._prep_inputs(color, depth)
        mask = self._mask(mask, depth)
        w2c = np.eye(4, dtype=np.float32) if w2c is None \
            else np.asarray(w2c, np.float32)
        self.frame_idx = 0
        self.poses_w2c = [w2c]
        self._ensure_capacity(int(mask.sum()) + 16)
        state, _dropped, n_added = _init_first_frame(
            self.state, color, torch.where(mask, depth, torch.zeros_like(depth)),
            self._w2c(w2c), 0.01, self.camera)
        self.state = state
        self.keyframes.append(color, depth, w2c, 0)
        self.keyframe_masks.append(mask)
        self.keyframe_time_indices.append(0)
        self.initialized = True
        return int(n_added)

    def _mask(self, mask, depth) -> torch.Tensor:
        """The object mask as an (H, W) bool tensor (all True for None)."""
        if mask is None:
            return torch.ones(depth.shape, dtype=torch.bool,
                              device=self.device)
        return torch.as_tensor(mask, device=self.device).reshape(
            depth.shape).bool()

    def track_rgbd(self, color, depth, gt_w2c=None, action=None,
                   obj_mask_2d=None, step: int | None = None,
                   allow_map: bool = True):
        """Per step: the pose (ground truth), a masked mapping event every
        `map_obj_every` frames and a keyframe every `keyframe_obj_every`
        frames while the mask is not empty.  allow_map=False vetoes both
        for this frame.  The first call initializes the map instead."""
        if not self.initialized:
            self.init(color, depth, gt_w2c, obj_mask_2d)
            return
        color, depth = self._prep_inputs(color, depth)
        mask = self._mask(obj_mask_2d, depth)
        time_idx = self.frame_idx + 1
        w2c = (np.asarray(gt_w2c, np.float32) if gt_w2c is not None
               else self.poses_w2c[-1])
        self.poses_w2c.append(w2c)
        seen = allow_map and bool(mask.any())
        if seen and (time_idx + 1) % self.map_obj_every == 0:
            self._object_mapping_event(color, depth, w2c, mask, time_idx)
        if seen and (time_idx + 1) % self.keyframe_obj_every == 0:
            self.keyframes.append(color, depth, w2c, time_idx)
            self.keyframe_masks.append(mask)
            self.keyframe_time_indices.append(time_idx)
        self.frame_idx = time_idx

    def _object_mapping_event(self, color, depth, w2c, mask, time_idx):
        """Densify the masked pixels, select the mask-aware keyframe
        window, run the masked Adam phase, prune outside the mask."""
        masked_depth = torch.where(mask, depth, torch.zeros_like(depth))
        ds = self.mc.downsample_pcd
        self._ensure_capacity(
            (self.camera.height // ds) * (self.camera.width // ds))
        self.state, _dropped, _added, _overflow = _densify(
            self.state, color, masked_depth, self._w2c(w2c), float(time_idx),
            self.camera, self.settings, self.mc)

        num_kf = int(self.cfg.mapping_window_size) - 2
        selected = select_keyframes_overlap(
            masked_depth.cpu().numpy()[None], w2c, self.intrinsics,
            self.keyframes, num_kf, rng=self.rng)
        if len(self.keyframes) > 0:
            selected.append(len(self.keyframes) - 1)
        dev = self.device
        win_c = [self.keyframes.color_dev(i, dev) for i in selected] + [color]
        win_d = [self.keyframes.depth_dev(i, dev) for i in selected] + [depth]
        win_w = [self.keyframes.w2cs[i] for i in selected] + [w2c]
        win_m = [self.keyframe_masks[i] for i in selected] + [mask]
        b = len(win_c)
        # padded to a fixed size with the current frame, as the JAX
        # package does (the draws below depend on b and b_max)
        b_max = int(self.cfg.mapping_window_size)
        while len(win_c) < b_max:
            win_c.append(win_c[-1])
            win_d.append(win_d[-1])
            win_w.append(win_w[-1])
            win_m.append(win_m[-1])
        win_c, win_d = win_c[:b_max], win_d[:b_max]
        win_w, win_m = win_w[:b_max], win_m[:b_max]
        n_steps = max(self.mc.num_iters // self.mc.frames_per_iter, 1)
        choices = self.rng.integers(0, min(b, b_max),
                                    size=(n_steps, self.mc.frames_per_iter))
        # the previous event's binning-overflow check
        self._flush_pending_bump()
        self.state, losses, bin_overflow = _object_mapping_phase(
            self.state, torch.stack(win_c), torch.stack(win_d),
            self._w2c(np.stack(win_w)), torch.stack(win_m), choices,
            self.camera, self.settings, self.mc)
        self.last_losses = losses
        self._pending_bump = (bin_overflow, b_max)

        # drop the active Gaussians outside the mask, and those of low
        # opacity
        opac = torch.sigmoid(self.state.logit_opacities[:, 0])
        outside, _inside = _project_outside_mask(
            self.state.means3D, self.state.n_active, self._w2c(w2c), mask,
            opac, self.camera, self.outside_alpha_thresh)
        keep = ~(outside | (opac < self.mc.prune_thresh))
        self.state, _order = prune_compact(self.state, keep)
        self._param_version += 1

    def count_gaussians_vs_mask(self, w2c, obj_mask_2d,
                                alpha_thresh: float = 0.01):
        """(in_count, out_count) of active Gaussians (opacity >= thresh)
        against the mask."""
        opac = torch.sigmoid(self.state.logit_opacities[:, 0])
        mask = torch.as_tensor(np.asarray(obj_mask_2d, bool),
                               device=self.device)
        outside, inside = _project_outside_mask(
            self.state.means3D, self.state.n_active, self._w2c(w2c), mask,
            opac, self.camera, alpha_thresh)
        return int(inside.sum()), int(outside.sum())

    def set_from_numpy(self, state: dict, keyframes: dict | None = None,
                       masks=None, poses_w2c=None):
        """Carry an object map across: the Gaussians from numpy arrays
        (PARAM_KEYS, timestep, n_active: a JAX GaussianState's fields) at
        this map's capacity, and optionally the keyframes (colors, depths,
        w2cs, ids), their masks and the tracked poses."""
        n = int(np.asarray(state["n_active"]))
        self._ensure_capacity(n)
        self.state = state_from_numpy(state, self.state.capacity,
                                      device=self.device)
        if keyframes is not None:
            self.keyframes.load_state_dict(keyframes)
            self.keyframe_time_indices = [int(i) for i in keyframes["ids"]]
            self.keyframe_masks = [
                torch.as_tensor(np.asarray(m, bool), device=self.device)
                for m in masks]
        if poses_w2c is not None:
            self.poses_w2c = [np.asarray(p, np.float32) for p in poses_w2c]
            self.frame_idx = len(self.poses_w2c) - 1
        self._param_version += 1
        self.initialized = True

    # -- Hessians and scores --------------------------------------------------
    def _active(self):
        return torch.arange(self.state.capacity,
                            device=self.device) < self.state.n_active

    def _h11(self, w2cs: np.ndarray, zs):
        return _obj_h11_batch(self.state.params(), self.state.n_active,
                              self._w2c(w2cs), zs, self.camera,
                              self.settings)

    def _at_pose(self, w2c):
        """The render inputs of the object map at one pose: (means_cam,
        scales, quats, opacities, colors)."""
        params = self.state.params()
        w2c_t = self._w2c(w2c)
        return (params["means3D"] @ w2c_t[:3, :3].T + w2c_t[:3, 3],
                torch.exp(params["log_scales"]), params["unnorm_rotations"],
                torch.sigmoid(params["logit_opacities"][:, 0]),
                params["rgb_colors"])

    def _hutch(self, w2c, n_probes=None):
        """hutchinson_diag at one pose, one draw of the stream."""
        k = int(n_probes or self.hutch_probes)
        return hutchinson_diag(self.camera, *self._at_pose(w2c),
                               self._next_probes(k), active=self._active(),
                               settings=self.settings)

    def compute_Hessian(self, rel_w2c, return_points: bool = False,
                        random_gaussian_params=None, return_pose: bool = False):
        """The object's (N, 11) Hessian at a pose: means, opacity, scales,
        rotations."""
        out = self._hutch(rel_w2c)
        h = torch.cat([out["means"], out["opacity"], out["scales"],
                       out["rotations"]], dim=-1)
        if not return_points:
            h = h.reshape(-1)
        if return_pose:
            return h, torch.eye(6, device=self.device)
        return h

    def estimate_diag_JtJ_simple(self, w2c, K: int = 4):
        """Flat group-major diag(JᵀJ) [means | opacity | rotations |
        scales] and the count of visible Gaussians."""
        out = self._hutch(w2c, n_probes=K)
        diag = torch.cat([out[k].reshape(-1) for k in
                          ("means", "opacity", "rotations", "scales")])
        return diag, int(out["visible"].sum())

    def _blocks_full(self, w2c, K: int):
        """(N, 11, 11) Hutchinson JᵀJ blocks at one pose and the visible
        mask, one draw of the stream."""
        out = block_jtj(self.camera, *self._at_pose(w2c),
                        self._next_probes(K), active=self._active(),
                        settings=self.settings)
        return out["blocks"], out["visible"]

    def estimate_block_JtJ(self, w2c, K: int = 2, use_rot=True,
                           use_scale=True, use_opacity=True):
        """The visible Gaussians' 11 x 11 blocks and their indices."""
        blocks, vis = self._blocks_full(w2c, K)
        vis_idx = torch.nonzero(vis).flatten()
        return blocks[vis_idx], vis_idx.cpu().numpy()

    def _h11_key(self, n_probes: int):
        return (len(self.keyframes), self._param_version, self.n_active,
                self.state.capacity, int(n_probes))

    def _h11_over(self, w2cs, kf_ids, n_probes: int):
        """Σ of the keyframes' (N, 11) Hessians, in pose chunks; each
        keyframe's probes depend on its id alone, so partial sums
        compose."""
        h = torch.zeros(self.state.capacity, 11, device=self.device)
        ck = self.obj_pose_chunk
        for i in range(0, len(w2cs), ck):
            ids = list(kf_ids[i:i + ck])
            h = h + self._h11(np.asarray(w2cs[i:i + ck], np.float32),
                              self._kf_probes(ids, n_probes)).sum(dim=0)
        return h

    def _h_train_kf_ids(self) -> list[int]:
        """Every keyframe id, or past `h_train_window` keyframes that many
        ids evenly strided over the whole history (first and latest
        in)."""
        n_kf = len(self.keyframes)
        w = self.h_train_window
        if not w or n_kf <= w:
            return list(range(n_kf))
        return sorted(set(np.round(
            np.linspace(0, n_kf - 1, w)).astype(int).tolist()))

    def compute_H_train_obj(self, n_probes: int | None = None):
        """Σ over keyframes of the (N, 11) Hutchinson Hessian, cached per
        keyframe set and parameter version.  When keyframes were only
        appended since the cached sum, their terms are added to it, which
        equals a full recompute.  Past the window, the strided subsample's
        sum scaled by K/|ids|."""
        n_probes = int(n_probes or self.hutch_probes)
        ids = self._h_train_kf_ids()
        n_kf = len(self.keyframes)
        key = self._h11_key(n_probes)
        cached = getattr(self, "_h11_cache", None)
        if len(ids) < n_kf:
            key = key + ("win", tuple(ids))
            if cached is not None and cached[0] == key:
                return cached[1]
            h = self._h11_over([self.keyframes.w2cs[i] for i in ids], ids,
                               n_probes) * (n_kf / len(ids))
        elif cached is not None and cached[0] == key:
            return cached[1]
        elif (cached is not None and len(cached[0]) == len(key)
              and cached[0][1:] == key[1:] and cached[0][0] < key[0]):
            new = list(range(cached[0][0], n_kf))
            h = cached[1] + self._h11_over(
                [self.keyframes.w2cs[i] for i in new], new, n_probes)
        else:
            h = self._h11_over(self.keyframes.w2cs, list(range(n_kf)),
                               n_probes)
        self._h11_cache = (key, h)
        return h

    def compute_H_train_popgs(self, K: int = 4):
        """Flat group-major diag prior [means | opacity | rotations |
        scales] (estimate_diag_JtJ_simple's layout)."""
        if len(self.keyframes) == 0:
            raise RuntimeError("No keyframes available for POP-GS prior.")
        h = self.compute_H_train_obj(n_probes=K)
        return torch.cat([h[:, :3].reshape(-1), h[:, 3],
                          h[:, 7:11].reshape(-1), h[:, 4:7].reshape(-1)])

    def _chunked_scores(self, w2cs: np.ndarray, n_probes: int, score_fn):
        """Scores of every pose, in pose chunks, from one draw of the
        stream; one pull at the end."""
        probes = self._pose_probes(n_probes)
        ck = self.obj_pose_chunk
        out = [score_fn(self._w2c(w2cs[i:i + ck]),
                        probes(range(i, min(i + ck, len(w2cs)))))
               for i in range(0, len(w2cs), ck)]
        return torch.cat(out)

    def pose_eval(self, poses, random_gaussian_params=None, criterion=None):
        """Fisher EIG over the 11-wide Hessian per candidate c2w pose:
        Σ H_pose / (H_train + 0.1).  Returns (scores, poses) tensors."""
        poses = np.asarray(poses, np.float32)
        h_train = (self.compute_H_train_obj() if len(self.keyframes) else
                   torch.zeros(self.state.capacity, 11, device=self.device))
        h_inv = 1.0 / (h_train + 0.1)
        params, n_active = self.state.params(), self.state.n_active
        scores = self._chunked_scores(
            np.linalg.inv(poses), self.hutch_probes,
            lambda w, z: _obj_fisher_scores(params, n_active, w, z, h_inv,
                                            self.camera, self.settings))
        return scores, torch.as_tensor(poses, device=self.device)

    def pose_eval_popgs(self, poses, random_gaussian_params=None,
                        criterion: str = "topt", K: int = 4,
                        lam: float = 1e-6):
        """T-opt or D-opt score per candidate c2w pose over the Hutchinson
        diagonals."""
        criterion = criterion.lower()
        if criterion not in ("topt", "dopt"):
            raise ValueError("criterion must be 'topt' or 'dopt'")
        poses = np.asarray(poses, np.float32)
        h_train = self.compute_H_train_obj(n_probes=K)
        params, n_active = self.state.params(), self.state.n_active
        scores = self._chunked_scores(
            np.linalg.inv(poses), int(K),
            lambda w, z: _obj_popgs_scores(params, n_active, w, z, h_train,
                                           lam, self.camera, self.settings,
                                           criterion))
        return scores, torch.as_tensor(poses, device=self.device)

    def pose_eval_popgs_blocks(self, poses, random_gaussian_params=None,
                               criterion: str = "topt", K: int = 6,
                               lam: float = 1e-6, use_rot=True,
                               use_scale=True, use_opacity=True):
        """Block T-opt or D-opt score per candidate c2w pose, against the
        keyframes' summed blocks (cached like H_train)."""
        poses = np.asarray(poses, np.float32)
        ids = self._h_train_kf_ids()
        key = self._h11_key(K) + ("blocks", tuple(ids))
        cached = getattr(self, "_blocks_cache", None)
        if cached is not None and cached[0] == key:
            h_blocks, train_vis = cached[1]
        else:
            h_blocks, train_vis = None, None
            for i in ids:
                b, vis = self._blocks_full(self.keyframes.w2cs[i], K)
                h_blocks = b if h_blocks is None else h_blocks + b
                train_vis = vis if train_vis is None else (train_vis | vis)
            if h_blocks is None:
                raise RuntimeError("No keyframes available for POP-GS blocks.")
            if len(ids) < len(self.keyframes):
                h_blocks = h_blocks * (len(self.keyframes) / len(ids))
            self._blocks_cache = (key, (h_blocks, train_vis))
        criterion = criterion.lower()
        if criterion not in ("topt", "dopt"):
            raise ValueError("criterion must be 'topt' or 'dopt'")
        score_fn = topt_score_blocks if criterion == "topt" \
            else dopt_score_blocks
        scores = []
        for c2w in poses:
            jb, cur_vis = self._blocks_full(np.linalg.inv(c2w), K)
            scores.append(score_fn(h_blocks, jb, train_vis & cur_vis, lam))
        return torch.stack(scores), torch.as_tensor(poses, device=self.device)
