"""The capacity probe: a synthetic map of n Gaussians (131072 by
default, the late-episode regime of the reference's MP3D maps; FakeSim's
scenes stop near 30k) drives the three hot programs at each per-tile
capacity tier (the JAX package's scripts/capacity_probe.py, the same
JSON line):

  render_ms               a render (K1), with the per-tile overflow;
  loss_grad_ms            the mapping loss and its gradient (K1, then K2
                          in the backward);
  pose_eval_ms_per_pose   a chunk of 8 poses scored by Fisher EIG (K3,
                          11-wide), per pose.

Synchronized wall clock, `reps` calls after a warm one.

    python -m fisher_nerf_customized_tpu_torch.tools.capacity_probe \\
        [--n 131072] [--tiers 256,512] [--reps 4] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ._timing import timed


def synth_state(n: int, capacity: int, seed: int = 0, device="cuda"):
    """n Gaussians on an 8 x 3 x 8 m box shell and inside it (the JAX
    script's draws), 2 cm, opacity logit 2, in a state of `capacity`."""
    from ..models.gaussian_state import add_gaussians, empty_state
    rng = np.random.default_rng(seed)
    pts = rng.uniform((-4, 0, -4), (4, 3, 4), (n, 3)).astype(np.float32)
    shell = rng.integers(0, 6, n)
    for ax, lo, hi in ((0, -4, 4), (1, 0, 3), (2, -4, 4)):
        pts[shell == 2 * ax, ax] = lo
        pts[shell == 2 * ax + 1, ax] = hi
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    new = dict(
        means3D=t(pts),
        rgb_colors=t(rng.uniform(0, 1, (n, 3))),
        unnorm_rotations=t(np.tile([1.0, 0, 0, 0], (n, 1))),
        logit_opacities=t(np.full((n, 1), 2.0)),
        log_scales=t(np.full((n, 3), np.log(0.02))))
    state, dropped = add_gaussians(empty_state(capacity, device=device), new,
                                   torch.ones(n, dtype=torch.bool,
                                              device=device), 0)
    assert int(dropped) == 0
    return state


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--tiers", default="256,512")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..models.slam import MappingConfig, _mapping_loss, _pose_scores
    from ..ops.camera import Camera
    from ..ops.rasterize import RenderSettings, render

    dev = torch.device(args.device)
    img = 256
    cam = Camera(fx=img / 2.0, fy=img / 2.0, cx=img / 2.0, cy=img / 2.0,
                 width=img, height=img)
    cap = 1
    while cap < args.n:
        cap *= 2
    state = synth_state(args.n, cap, device=dev)
    mc = MappingConfig(
        num_iters=120, sil_thres=0.5, depth_weight=1.0, im_weight=0.5,
        prune_enabled=False, prune_every=40, prune_start=0, prune_stop=20,
        prune_thresh=0.005, prune_big_after=0, lr_means3D=1e-4,
        lr_rgb=2.5e-3, lr_rots=1e-3, lr_logit_op=0.05,
        lr_log_scales=1e-3, depth_error_ratio=10.0, downsample_pcd=4)
    rng = np.random.default_rng(1)
    f32 = dict(dtype=torch.float32, device=dev)
    gt_c = torch.as_tensor(rng.uniform(0, 1, (img, img, 3)), **f32)
    gt_d = torch.as_tensor(rng.uniform(1, 6, (img, img)), **f32)
    w2c = torch.eye(4, device=dev)
    h_inv = torch.ones(cap, 4, device=dev)
    p = state.params()

    def loss_grad(st):
        params = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = _mapping_loss(params, state.n_active, w2c, gt_c, gt_d, cam,
                             st, mc)
        return torch.autograd.grad(loss, list(params.values()))

    def render_once(st):
        with torch.no_grad():
            return render(cam, p["means3D"], torch.exp(p["log_scales"]),
                          p["unnorm_rotations"],
                          torch.sigmoid(p["logit_opacities"][:, 0]),
                          p["rgb_colors"], active=state.active, settings=st)

    out = dict(n_gaussians=args.n, capacity=cap, platform=dev.type, tiers=[])
    ck = 8
    w2cs = torch.eye(4, device=dev).repeat(ck, 1, 1)
    for k in (int(t) for t in args.tiers.split(",")):
        st = RenderSettings(tile_size=16, max_per_tile=k, chunk=64)
        fst = RenderSettings(tile_size=32, max_per_tile=k, chunk=64)
        row = dict(max_per_tile=k)
        t_render, r = timed(lambda: render_once(st), dev, args.reps)
        n_tiles = (img // 16) ** 2
        row["overflow_frac"] = round(float(r["overflow"]) / (n_tiles * k), 5)
        row["render_ms"] = round(t_render, 2)
        t_grad, _g = timed(lambda: loss_grad(st), dev, args.reps)
        row["loss_grad_ms"] = round(t_grad, 2)
        with torch.no_grad():
            t_pose, _s = timed(lambda: _pose_scores(state, w2cs, h_inv, cam,
                                                    fst, False, 1e-3),
                               dev, args.reps)
        row["pose_eval_ms_per_pose"] = round(t_pose / ck, 3)
        out["tiers"].append(row)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
