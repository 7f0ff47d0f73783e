"""Evaluation of an episode: render quality, 3D reconstruction, coverage
and AUC curves.  The JAX package's engine/eval.py.

  render quality   PSNR, SSIM, lpips_proxy and depth MAE over held-out
                   poses (eval_navigation: 2000 uniform navigable poses,
                   rendered 32 at a time with K1, the ground truth by one
                   batched raycast per chunk); EvalPoseCurve, the same on a
                   fixed set of 16 poses during the episode; eval_nvs over
                   a recorded trajectory;
  reconstruction   accuracy, completion, completeness ratio and FPR of the
                   estimated cloud against a ground-truth cloud at 5 cm
                   (accuracy_comp_ratio_from_pcl, and its exact running
                   form IncrementalReconMetric); the nearest neighbours
                   of a query of 1e8 pairs or more on a CUDA device come
                   from the 1-NN kernel (ops/knn.py), the others from
                   scipy's cKDTree;
  curves           MetricsRecorder (the metric YAML) and trapezoid_auc.

lpips_proxy is a perceptual distance from three seeded random conv layers
(the structure of LPIPS without pretrained weights), as in the JAX
package.  Its convolutions run in full f32: on the card cuDNN would run
them in TF32 by default.  With set_lpips_weights(path) (the CLI's
--lpips_weights) the real LPIPS(alex) of models/perceptual.py is reported
beside it as `lpips`: by render_metrics, per pose by eval_navigation
(each chunk's pairs in one batch) and per frame by eval_nvs.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import os

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..ops.image import calc_psnr, calc_ssim, ssim_map
from ..utils.precision import no_tf32

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# render-quality metrics
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=2)
def _lpips_kernels_np(seed: int = 7):
    """The three conv kernels (3, 3, cin, cout), cin 3 -> 16 -> 32 -> 64,
    normal draws scaled by 1/sqrt(9 cin)."""
    rng = np.random.default_rng(seed)
    ks = []
    cin = 3
    for cout in (16, 32, 64):
        k = rng.normal(size=(3, 3, cin, cout)).astype(np.float32)
        k /= np.sqrt(9 * cin)
        ks.append(k)
        cin = cout
    return ks


def _lpips_weights(device):
    """The kernels as conv2d weights (cout, cin, 3, 3) on `device`."""
    return [torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(device)
            for k in _lpips_kernels_np()]


def _lpips_feats(x):
    """x (P, H, W, 3) in [0, 1] -> the unit-normalized ReLU features of the
    three layers, each (P, C, h, w); a 2x2 max pool (floor) between
    layers."""
    x = ((x - 0.5) * 2.0).permute(0, 3, 1, 2)
    outs = []
    with no_tf32():
        for k in _lpips_weights(x.device):
            x = torch.relu(torch.nn.functional.conv2d(x, k, padding=1))
            n = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-8)
            outs.append(n)
            x = torch.nn.functional.max_pool2d(x, 2)
    return outs


def lpips_proxy_batch(img1, img2):
    """lpips_proxy of each pair of (P, H, W, 3) stacks: (P,)."""
    f1, f2 = _lpips_feats(img1.float()), _lpips_feats(img2.float())
    return sum(((a - b) ** 2).mean(dim=(1, 2, 3)) for a, b in zip(f1, f2))


def lpips_proxy(img1, img2):
    """Perceptual distance of two (H, W, 3) images in [0, 1]: the mean
    squared difference of their features, summed over the three layers."""
    return lpips_proxy_batch(img1[None], img2[None])[0]


_LPIPS_NET = None        # set by set_lpips_weights


def set_lpips_weights(path: str | None):
    """Report the real LPIPS(alex) from a torch checkpoint
    (models/perceptual.py::load_torch_lpips) beside lpips_proxy; None
    turns it off.  The network moves to the images' device at use."""
    global _LPIPS_NET
    _LPIPS_NET = None
    if path:
        from ..models.perceptual import LPIPSAlex, load_torch_lpips
        _LPIPS_NET = LPIPSAlex.from_flat(load_torch_lpips(path))


def lpips_alex_batch(img1, img2):
    """LPIPS(alex) of each pair of (P, H, W, 3) stacks in [0, 1]: (P,) on
    their device.  Needs set_lpips_weights."""
    return _LPIPS_NET.to(img1.device)(img1, img2)


def _as_tensor(x, device=None):
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def render_metrics(render, gt_rgb, render_depth=None, gt_depth=None):
    """PSNR / SSIM / lpips_proxy / depth MAE (over valid depth) of one
    view; images (H, W, 3), depths (H, W), tensors or arrays."""
    render = torch.clamp(_as_tensor(render).float(), 0.0, 1.0)
    # SSIM's <= 1 bound holds only for nonnegative inputs
    gt_rgb = torch.clamp(_as_tensor(gt_rgb, render.device).float(), 0.0, 1.0)
    out = dict(psnr=float(calc_psnr(render, gt_rgb)),
               ssim=float(calc_ssim(render, gt_rgb)),
               lpips_proxy=float(lpips_proxy(render, gt_rgb)))
    if _LPIPS_NET is not None:
        out["lpips"] = float(lpips_alex_batch(render[None], gt_rgb[None])[0])
    if render_depth is not None and gt_depth is not None:
        gt_depth = _as_tensor(gt_depth).detach().cpu().numpy()
        rd = _as_tensor(render_depth).detach().cpu().numpy()
        valid = gt_depth > 0
        out["depth_mae"] = float(np.abs(rd - gt_depth)[valid].mean()) \
            if valid.any() else float("nan")
    return out


def uniform_eval_poses(scene, n_poses: int, cam_height: float,
                       seed: int = 42) -> np.ndarray:
    """n_poses (n, 4, 4) float32 c2w poses at navigable positions with a
    uniform yaw, from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    xz = scene.sample_navigable(rng, n_poses)
    yaw = rng.uniform(0, 2 * np.pi, n_poses)
    poses = np.zeros((n_poses, 4, 4), np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0] = c
    poses[:, 0, 2] = s
    poses[:, 1, 1] = 1.0
    poses[:, 2, 0] = -s
    poses[:, 2, 2] = c
    # CV camera (x right / y down / z fwd)
    poses[:, :3, 0] *= -1
    poses[:, :3, 1:2] = poses[:, :3, 1:2] * -1
    poses[:, 0, 3] = xz[:, 0]
    poses[:, 1, 3] = cam_height
    poses[:, 2, 3] = xz[:, 1]
    poses[:, 3, 3] = 1.0
    return poses


def _batch_render_metrics(render, gt_rgb, depth, gt_depth):
    """(psnr, ssim, lpips_proxy, depth_mae), each (P,), of a pose stack:
    render, gt_rgb (P, H, W, 3); depth, gt_depth (P, H, W).  Depth MAE is
    over the pixels with gt_depth > 0, divided by max(their count, 1).
    With LPIPS weights set, lpips (P,) is a fifth."""
    r = torch.clamp(render.float(), 0.0, 1.0)
    g = torch.clamp(gt_rgb.float(), 0.0, 1.0)
    mse = torch.mean((r - g) ** 2, dim=(1, 2, 3))
    psnr = 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))
    # SSIM with the poses side by side in the channel axis: the filter
    # runs over H and W only, so each pose's map is its own
    p, h, w, c = r.shape
    side = lambda x: x.permute(1, 2, 0, 3).reshape(h, w, p * c)
    ssim = ssim_map(side(r), side(g)).reshape(h, w, p, c).mean(dim=(0, 1, 3))
    lp = lpips_proxy_batch(r, g)
    valid = gt_depth > 0
    mae = (torch.where(valid, torch.abs(depth - gt_depth),
                       torch.zeros_like(depth)).sum(dim=(1, 2))
           / torch.clamp(valid.sum(dim=(1, 2)), min=1))
    if _LPIPS_NET is not None:
        return psnr, ssim, lp, mae, lpips_alex_batch(r, g)
    return psnr, ssim, lp, mae


def eval_navigation(slam, sim, scene, n_poses: int = 2000,
                    cam_height: float = 1.25, seed: int = 42,
                    out_dir: str | None = None, chunk: int = 32,
                    seen_fn=None) -> dict:
    """Render quality over n_poses uniform navigable poses (seed 42).

    Each chunk of poses is rendered by slam.render_at_poses (one K1
    launch per pose), its ground truth by sim.render_at_batch (one
    raycast; per pose through sim.render_at for a sim without it), and
    its metrics in one batch, LPIPS(alex) too when its weights are set
    (the JAX package then renders and scores pose by pose: the values
    are the same); one (4, P) pull per chunk, (5, P) with LPIPS.  A pose
    whose SSIM falls outside [-1, 1.001] is logged and, with `out_dir`, its
    inputs are dumped to ssim_anomaly_<i>.npz.  `seen_fn(x, z) -> bool`
    marks the poses inside the explored region: rows then carry `seen`
    and the summary the `*_seen` means and `n_seen`.  With `out_dir`,
    also writes eval_psnr_map.png, the per-pose PSNR on the top-down
    map."""
    poses = uniform_eval_poses(scene, n_poses, cam_height, seed)
    per_pose = []
    for i in range(0, n_poses, chunk):
        batch = poses[i:i + chunk]
        out = slam.render_at_poses(batch)
        dev = out["render"].device
        if hasattr(sim, "render_at_batch"):
            gt_rgb, gt_depth = sim.render_at_batch(batch)
        else:
            gts = [sim.render_at(c2w) for c2w in batch]
            gt_rgb = torch.stack([_as_tensor(g[0], dev) for g in gts])
            gt_depth = torch.stack([_as_tensor(g[1], dev) for g in gts])
        gt_rgb, gt_depth = gt_rgb.to(dev), gt_depth.to(dev)
        mets = torch.stack(_batch_render_metrics(
            out["render"], gt_rgb, out["depth"], gt_depth)).cpu().numpy()
        rows = []
        for col in mets.T:                # the JAX package's key order
            m = dict(psnr=float(col[0]), ssim=float(col[1]),
                     lpips_proxy=float(col[2]))
            if len(col) == 5:
                m["lpips"] = float(col[4])
            m["depth_mae"] = float(col[3])
            rows.append(m)
        for j, m in enumerate(rows):
            if not -1.0 <= m["ssim"] <= 1.001:
                # SSIM outside its range means a degenerate input pair:
                # keep it rather than let it blur the mean
                if out_dir is not None:
                    np.savez(os.path.join(out_dir, f"ssim_anomaly_{i + j}.npz"),
                             render=out["render"][j].cpu().numpy(),
                             gt=gt_rgb[j].cpu().numpy(), c2w=batch[j],
                             ssim=m["ssim"])
                logger.warning("per-pose SSIM %.3f outside [-1, 1]; "
                               "inputs dumped", m["ssim"])
        per_pose.extend(rows)
    if seen_fn is not None:
        for m, c2w in zip(per_pose, poses):
            m["seen"] = bool(seen_fn(float(c2w[0, 3]), float(c2w[2, 3])))
    agg = {k: float(np.mean([m[k] for m in per_pose]))
           for k in per_pose[0] if k != "seen"}
    if seen_fn is not None:
        seen_rows = [m for m in per_pose if m["seen"]]
        agg["n_seen"] = len(seen_rows)
        for k in ("psnr", "ssim", "depth_mae"):
            agg[f"{k}_seen"] = (float(np.mean([m[k] for m in seen_rows]))
                                if seen_rows else float("nan"))
    agg["n_poses"] = n_poses
    agg["per_pose"] = per_pose
    if out_dir is not None:
        save_psnr_scatter(
            os.path.join(out_dir, "eval_psnr_map.png"), scene, poses,
            np.asarray([m["psnr"] for m in per_pose]))
    return agg


class EvalPoseCurve:
    """Held-out PSNR and depth MAE against the episode's step on a fixed
    set of n_poses poses (uniform_eval_poses, seed 42), their ground truth
    rendered once and kept on the device; each update renders the poses
    and pulls three scalars."""

    def __init__(self, scene, sim, n_poses: int = 16,
                 cam_height: float = 1.25, seed: int = 42):
        self.poses = uniform_eval_poses(scene, n_poses, cam_height, seed)
        gts = [sim.render_at(c2w) for c2w in self.poses]
        self.gt_rgb = torch.stack([_as_tensor(g[0]) for g in gts])
        self.gt_depth = torch.stack([_as_tensor(g[1]) for g in gts])

    def update(self, slam) -> dict:
        handles = [slam.render_at_pose(c2w) for c2w in self.poses]
        rs = torch.stack([h["render"] for h in handles])
        ds = torch.stack([h["depth"] for h in handles])
        gt_rgb = self.gt_rgb.to(rs.device)
        gt_depth = self.gt_depth.to(rs.device)
        mse = torch.mean((rs - gt_rgb) ** 2, dim=(1, 2, 3))
        psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
        valid = gt_depth > 0
        mae = (torch.sum(torch.abs(ds - gt_depth) * valid, dim=(1, 2))
               / torch.clamp(torch.sum(valid, dim=(1, 2)), min=1))
        psnr_h, mae_h = torch.stack([psnr, mae]).cpu().numpy()
        return dict(eval_psnr=float(np.mean(psnr_h)),
                    eval_psnr_min=float(np.min(psnr_h)),
                    eval_depth_mae=float(np.mean(mae_h)))


# cv2.COLORMAP_PLASMA as 256 RGB rows (cv2.applyColorMap of 0..255)
_PLASMA_RGB = np.frombuffer(bytes.fromhex(
    "0d088710078813078916078a19068c1b068d1d068e20068f220690240691260591280592"
    "2a05932c05942e05952f059631059733059735049837049938049a3a049a3c049b3e049c"
    "3f049c41049d43039e44039e46039f48039f4903a04b03a14c02a14e02a25002a25102a3"
    "5302a35502a45601a45801a45901a55b01a55c01a65e01a66001a66100a76300a76400a7"
    "6600a76700a86900a86a00a86c00a86e00a86f00a87100a87201a87401a87501a87701a8"
    "7801a87a02a87b02a87d03a87e03a88004a88104a78305a78405a78606a68707a68808a6"
    "8a09a58b0aa58d0ba58e0ca48f0da4910ea3920fa39410a29511a19613a19814a099159f"
    "9a169f9c179e9d189d9e199da01a9ca11b9ba21d9aa31e9aa51f99a62098a72197a82296"
    "aa2395ab2494ac2694ad2793ae2892b02991b12a90b22b8fb32c8eb42e8db52f8cb6308b"
    "b7318ab83289ba3388bb3488bc3587bd3786be3885bf3984c03a83c13b82c23c81c33d80"
    "c43e7fc5407ec6417dc7427cc8437bc9447aca457acb4679cc4778cc4977cd4a76ce4b75"
    "cf4c74d04d73d14e72d24f71d35171d45270d5536fd5546ed6556dd7566cd8576bd9586a"
    "da5a6ada5b69db5c68dc5d67dd5e66de5f65de6164df6263e06363e16462e26561e26660"
    "e3685fe4695ee56a5de56b5de66c5ce76e5be76f5ae87059e97158e97257ea7457eb7556"
    "eb7655ec7754ed7953ed7a52ee7b51ef7c51ef7e50f07f4ff0804ef1814df1834cf2844b"
    "f3854bf3874af48849f48948f58b47f58c46f68d45f68f44f79044f79143f79342f89441"
    "f89540f9973ff9983ef99a3efa9b3dfa9c3cfa9e3bfb9f3afba139fba238fca338fca537"
    "fca636fca835fca934fdab33fdac33fdae32fdaf31fdb130fdb22ffdb42ffdb52efeb72d"
    "feb82cfeba2cfebb2bfebd2afebe2afec029fdc229fdc328fdc527fdc627fdc827fdca26"
    "fdcb26fccd25fcce25fcd025fcd225fbd324fbd524fbd724fad824fada24f9dc24f9dd25"
    "f8df25f8e125f7e225f7e425f6e626f6e826f5e926f5eb27f4ed27f3ee27f3f027f2f227"
    "f1f426f1f525f0f724f0f921"), np.uint8).reshape(256, 3)


def save_psnr_scatter(path: str, scene, poses: np.ndarray,
                      psnrs: np.ndarray, cell: float = 0.05):
    """Per-pose PSNR as plasma-colored discs of radius 2 on the scene's
    256x256 top-down free map (cell `cell` m), written as a PNG."""
    from ..utils.raster import fill_circle, write_png
    dim = (256, 256)
    center = getattr(scene, "center_xz", None)
    if center is None:
        center = np.zeros(2)
    free = scene.gt_free_map(cell, dim, center)
    img = np.full(dim + (3,), 30, np.uint8)
    img[np.asarray(free, bool)] = (200, 200, 200)
    lo, hi = float(np.min(psnrs)), float(np.max(psnrs))
    span = max(hi - lo, 1e-6)
    for c2w, v in zip(poses, psnrs):
        cx = int((c2w[0, 3] - center[0]) / cell + dim[1] // 2)
        cz = int((c2w[2, 3] - center[1]) / cell + dim[0] // 2)
        if 0 <= cx < dim[1] and 0 <= cz < dim[0]:
            disc = fill_circle(dim, (cx, cz), 2) > 0
            img[disc] = _PLASMA_RGB[int((v - lo) / span * 255)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, img)


def eval_nvs(slam, frames, eval_every: int = 1, sil_thres: float = 0.5,
             out_dir: str | None = None, hole_pct_thres: float = 0.1) -> dict:
    """Novel-view synthesis over a recorded trajectory: `frames` is an
    iterable of (rgb [0, 1] (H, W, 3), depth (H, W), c2w), or an object
    with `colors`, `depths` and `c2ws`.  Frame 0 (the training init) is
    skipped; of the rest every `eval_every`-th is rendered at its pose.
    A frame whose silhouette leaves more than `hole_pct_thres` % of the
    valid-depth pixels uncovered is invalid; the means are over valid
    frames, the per-frame rows cover all.  PSNR, SSIM, lpips_proxy (and
    lpips with its weights set) on the valid-depth pixels; depth_rmse is
    a true RMSE, depth_l1 the reference's "rmse"."""
    if hasattr(frames, "colors"):
        frames = list(zip(frames.colors, frames.depths, frames.c2ws))
    else:
        frames = list(frames)
    per_frame, valid_flags = [], []
    for time_idx, (rgb, depth, c2w) in enumerate(frames):
        if time_idx == 0:
            continue
        test_idx = time_idx - 1
        if test_idx != 0 and (test_idx + 1) % eval_every != 0:
            continue
        out = slam.render_at_pose(c2w)
        dev = out["render"].device
        im = torch.clamp(out["render"].float(), 0.0, 1.0)
        rdepth = out["depth"].detach().cpu().numpy()
        sil = out["sil"].detach().cpu().numpy()
        gt_rgb = torch.clamp(_as_tensor(rgb, dev).float(), 0.0, 1.0)
        gt_depth = _as_tensor(depth).detach().cpu().numpy().astype(np.float32)

        valid_depth = gt_depth > 0
        presence = sil > sil_thres
        holes_pct = float(np.mean(~(presence | ~valid_depth))) * 100.0
        valid_flags.append(holes_pct <= hole_pct_thres)

        m3 = torch.as_tensor(valid_depth[..., None].astype(np.float32),
                             device=dev)
        psnr = float(calc_psnr(im * m3, gt_rgb * m3))
        ssim = float(calc_ssim(im * m3, gt_rgb * m3))
        lp = float(lpips_proxy(im * m3, gt_rgb * m3))
        nv = max(int(valid_depth.sum()), 1)
        diff = (rdepth - gt_depth) * valid_depth
        row = dict(
            frame=test_idx, psnr=psnr, ssim=ssim, lpips_proxy=lp,
            depth_rmse=float(np.sqrt((diff ** 2).sum() / nv)),
            depth_l1=float(np.abs(diff).sum() / nv),
            holes_pct=holes_pct)
        if _LPIPS_NET is not None:
            row["lpips"] = float(lpips_alex_batch((im * m3)[None],
                                                  (gt_rgb * m3)[None])[0])
        per_frame.append(row)
    valid = np.asarray(valid_flags, bool)
    keys = ("psnr", "ssim", "lpips_proxy", "depth_rmse", "depth_l1")
    if per_frame and "lpips" in per_frame[0]:
        keys = keys + ("lpips",)
    if valid.any():
        avg = {k: float(np.mean([f[k] for f, v in zip(per_frame, valid)
                                 if v])) for k in keys}
    else:
        avg = {k: float("nan") for k in keys}
    result = dict(n_eval_frames=len(per_frame),
                  n_valid_frames=int(valid.sum()),
                  valid_nvs_frames=valid.tolist(), per_frame=per_frame,
                  **avg)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        for k in keys:
            np.savetxt(os.path.join(out_dir, f"{k}.txt"),
                       np.asarray([f[k] for f in per_frame]))
        np.save(os.path.join(out_dir, "valid_nvs_frames.npy"), valid)
    return result


# ---------------------------------------------------------------------------
# trajectory metrics
# ---------------------------------------------------------------------------

def align_trajectories(model: np.ndarray, data: np.ndarray):
    """Horn's SE(3) alignment of two (3, N) trajectories: (R, t, the
    per-point translation errors after alignment)."""
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    mz = model - model_mean
    dz = data - data_mean
    W = mz @ dz.T
    U, _d, Vt = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = data_mean - R @ model_mean
    aligned = R @ model + t
    err = np.linalg.norm(aligned - data, axis=0)
    return R, t, err


def evaluate_ate(gt_poses: np.ndarray, est_poses: np.ndarray) -> float:
    """Absolute trajectory error, RMSE after alignment; (N, 4, 4) c2w."""
    gt = np.asarray(gt_poses)[:, :3, 3].T
    est = np.asarray(est_poses)[:, :3, 3].T
    _R, _t, err = align_trajectories(est, gt)
    return float(np.sqrt(np.mean(err ** 2)))


# ---------------------------------------------------------------------------
# 3D reconstruction metrics
# ---------------------------------------------------------------------------

NN_DEVICE_PAIRS = 1e8     # queries x refs from which the card takes the NN


def _phase(timer, name: str):
    """timer.phase("recon_metric." + name), or nothing without a timer
    (a utils/logging_utils.py::StepTimer)."""
    return (contextlib.nullcontext() if timer is None
            else timer.phase(f"recon_metric.{name}"))


def _nn_dists(queries: np.ndarray, refs: np.ndarray, device=None,
              queries_dev=None, refs_dev=None, timer=None) -> np.ndarray:
    """Distance from each query to its nearest reference point (float64).

    On a CUDA `device`, with queries x refs >= NN_DEVICE_PAIRS, the 1-NN
    kernel (ops/knn.py) finds each query's nearest reference in float32,
    and its distance is then recomputed in float64 from the inputs as
    given, as cKDTree computes it: where the two agree on the nearest
    point, the distance is cKDTree's to the bit.  queries_dev / refs_dev
    are float32 copies of the inputs already on that device (a fixed
    ground-truth cloud is uploaded once).  Otherwise scipy's cKDTree on
    every core (the answers do not depend on the worker count).  With a
    `timer`, the sub-phases recon_metric.ckdtree, or .upload, .nn1 (the
    kernel call, synchronized), .download (the rows) and .recompute."""
    dev = None if device is None else torch.device(device)
    if dev is None or dev.type != "cuda" or \
            len(queries) * len(refs) < NN_DEVICE_PAIRS:
        with _phase(timer, "ckdtree"):
            d, _ = cKDTree(refs).query(queries, k=1, workers=-1)
        return d
    from ..ops.knn import knn
    with _phase(timer, "upload"):
        if queries_dev is None:
            queries_dev = torch.as_tensor(np.asarray(queries, np.float32),
                                          device=dev)
        if refs_dev is None:
            refs_dev = torch.as_tensor(np.asarray(refs, np.float32),
                                       device=dev)
    with _phase(timer, "nn1"):
        _d, idx = knn(queries_dev, refs_dev, k=1)
        if timer is not None:
            torch.cuda.synchronize(dev)
    with _phase(timer, "download"):
        idx = idx[:, 0].cpu().numpy()
    with _phase(timer, "recompute"):
        return _dists_to(queries, refs, idx)


def _dists_to(queries, refs, idx) -> np.ndarray:
    """|queries - refs[idx]| in float64, summed as cKDTree sums it:
    (dx*dx + dy*dy) + dz*dz."""
    diff = np.asarray(queries, np.float64) - np.asarray(refs,
                                                        np.float64)[idx]
    return np.sqrt((diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1])
                   + diff[:, 2] * diff[:, 2])


def _chunked_surface_dists(fn, pts, chunk: int = 200_000) -> np.ndarray:
    """fn(pts) over chunks of `chunk` points (bounded memory)."""
    outs = [np.asarray(fn(pts[i:i + chunk]))
            for i in range(0, len(pts), chunk)]
    return (np.concatenate(outs) if outs
            else np.zeros((0,), np.float64))


def accuracy_comp_ratio_from_pcl(est_pts: np.ndarray, gt_pts: np.ndarray,
                                 dist_thresh: float = 0.05,
                                 surface_dist_fn=None, device=None,
                                 gt_dev=None) -> dict:
    """accuracy = mean est->gt distance, completion = mean gt->est
    distance, completeness ratio = % of gt within dist_thresh of est,
    FPR = % of est beyond dist_thresh of gt.  With
    `surface_dist_fn(pts) -> (N,)` exact surface distances replace the
    est->gt nearest neighbours (accuracy and FPR).  `device` and `gt_dev`
    (a float32 copy of gt on it): see _nn_dists."""
    est = np.asarray(est_pts, np.float64)
    gt = np.asarray(gt_pts, np.float64)
    if len(est) == 0 or len(gt) == 0:
        return dict(acc_distance=float("inf"), comp_distance=float("inf"),
                    completeness_ratio=0.0, fpr=1.0)
    d_e2g = (_chunked_surface_dists(surface_dist_fn, est)
             if surface_dist_fn is not None
             else _nn_dists(est, gt, device, refs_dev=gt_dev))
    d_g2e = _nn_dists(gt, est, device, queries_dev=gt_dev)
    return dict(
        acc_distance=float(d_e2g.mean()),
        comp_distance=float(d_g2e.mean()),
        completeness_ratio=float((d_g2e < dist_thresh).mean() * 100.0),
        fpr=float((1.0 - (d_e2g < dist_thresh).mean()) * 100.0),
    )


class IncrementalReconMetric:
    """accuracy_comp_ratio_from_pcl of an append-only estimated cloud
    against a fixed ground-truth cloud, kept as running terms: accuracy
    and FPR are sums over the estimated points of their own (fixed)
    distances, and the gt->est distances are a running minimum.  An
    update costs new points x gt, and the result is the one-shot
    metric's on the whole cloud.  On a CUDA `device` the ground-truth
    cloud is uploaded once and the nearest neighbours go through
    _nn_dists' kernel path."""

    def __init__(self, gt_pts, dist_thresh: float = 0.05,
                 surface_dist_fn=None, device=None):
        self.gt = np.asarray(gt_pts, np.float32)
        self.thresh = float(dist_thresh)
        self.surface_dist_fn = surface_dist_fn
        self.device = device
        self.gt_dev = None
        if device is not None and torch.device(device).type == "cuda":
            self.gt_dev = torch.as_tensor(self.gt, device=device)
        self.d_gt_min = np.full(len(self.gt), np.inf)
        self.acc_sum = 0.0
        self.acc_in = 0
        self.n_est = 0

    def state_dict(self) -> dict:
        """The running state.  d_gt_min stays float64: a float32 copy
        (the JAX package's) rounds distances near the threshold across
        it."""
        return dict(d_gt_min=np.asarray(self.d_gt_min, np.float64),
                    acc=np.asarray([self.acc_sum, float(self.acc_in),
                                    float(self.n_est)], np.float64))

    def load_state_dict(self, d) -> bool:
        """Restore a state_dict (also the JAX package's float32 one);
        False, and nothing restored, for another ground-truth cloud."""
        d_gt_min = np.asarray(d["d_gt_min"], np.float64)
        if d_gt_min.shape != (len(self.gt),):
            return False
        self.d_gt_min = d_gt_min
        acc = np.asarray(d["acc"], np.float64)
        self.acc_sum = float(acc[0])
        self.acc_in = int(acc[1])
        self.n_est = int(acc[2])
        return True

    def update(self, new_est, timer=None) -> dict:
        """Add the cloud's new points and return the metric on the whole
        cloud.  With a `timer` (a StepTimer), its sub-phases under
        recon_metric: .surface (the exact surface distances, on the host),
        those of _nn_dists, and .running_min (the gt -> est minimum and
        the returned means)."""
        new_est = np.asarray(new_est, np.float32)
        if len(new_est):
            if self.surface_dist_fn is not None:
                with _phase(timer, "surface"):
                    d_e2g = _chunked_surface_dists(self.surface_dist_fn,
                                                   new_est)
            else:
                d_e2g = _nn_dists(new_est, self.gt, self.device,
                                  refs_dev=self.gt_dev, timer=timer)
            self.acc_sum += float(d_e2g.sum())
            self.acc_in += int((d_e2g < self.thresh).sum())
            self.n_est += len(new_est)
            d_new = _nn_dists(self.gt, new_est, self.device,
                              queries_dev=self.gt_dev, timer=timer)
            with _phase(timer, "running_min"):
                self.d_gt_min = np.minimum(self.d_gt_min, d_new)
        if self.n_est == 0:
            return dict(acc_distance=float("inf"),
                        comp_distance=float("inf"),
                        completeness_ratio=0.0, fpr=1.0)
        with _phase(timer, "running_min"):
            d = self.d_gt_min
            return dict(
                acc_distance=self.acc_sum / self.n_est,
                comp_distance=float(d.mean()),
                completeness_ratio=float((d < self.thresh).mean() * 100.0),
                fpr=float((1.0 - self.acc_in / self.n_est) * 100.0),
            )


def coverage_percentage(gt_pts: np.ndarray, est_pts: np.ndarray,
                        thresh: float = 0.05) -> float:
    """% of the ground-truth points within `thresh` of the estimate."""
    if len(est_pts) == 0:
        return 0.0
    d = _nn_dists(np.asarray(gt_pts), np.asarray(est_pts))
    return float((d < thresh).mean() * 100.0)


def trapezoid_auc(values, max_steps: int | None = None) -> float:
    """Mean of a curve by the trapezoid rule over its points, the curve
    padded with its last value to max_steps points."""
    v = np.asarray(values, np.float64)
    if max_steps is not None and len(v) < max_steps:
        v = np.concatenate([v, np.full(max_steps - len(v),
                                       v[-1] if len(v) else 0.0)])
    if len(v) < 2:
        return float(v[0]) if len(v) else 0.0
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(trapezoid(v) / (len(v) - 1))


class MetricsRecorder:
    """Per-step metric curves and their YAML: policy, scene, steps (one
    dict per record) and the completeness AUC."""

    def __init__(self, policy: str, scene_id: str):
        self.header = dict(policy=policy, scene=scene_id)
        self.steps: list[dict] = []

    def record(self, step: int, **metrics):
        self.steps.append(dict(step=int(step), **{
            k: float(v) for k, v in metrics.items()}))

    def auc(self, key: str = "completeness_ratio", max_steps=None) -> float:
        return trapezoid_auc([s[key] for s in self.steps if key in s],
                             max_steps)

    def dump(self, path: str):
        import yaml
        with open(path, "w") as f:
            yaml.safe_dump(dict(**self.header, steps=self.steps,
                                auc=self.auc() if self.steps else 0.0),
                           f, sort_keys=False)

    def load(self, path: str):
        import yaml
        with open(path) as f:
            d = yaml.safe_load(f)
        self.header = dict(policy=d.get("policy", self.header["policy"]),
                           scene=d.get("scene", self.header["scene"]))
        self.steps = [dict(s) for s in d.get("steps", [])]
