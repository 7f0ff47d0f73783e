"""Per-stage render profile at 23k and 131k Gaussians: each stage of one
render timed on its own (synchronized wall clock, `reps` calls after a
warm one), to find the stage a render spends its time in (the JAX
package's scripts/render_profile.py, the port's stages):

  preprocess_ms   ops/projection.py::preprocess (EWA projection, culling)
  tile_bin_ms     ops/binning.py::tile_bin (two-level top-K per tile)
  pack_ms         ops/rasterize.py::blend_kernel_inputs (the row gather)
  blend_ms        K1, ops/cuda_blend.py::cuda_blend (its plain twin on
                  the CPU)
  full_render_ms  ops/rasterize.py::render (the four stages and the
                  image assembly)
  full_render_plain_ms  the same with K1's plain PyTorch twin

The scene is the JAX script's: n Gaussians uniform in a camera-frame box
(z in [2, 9] m), scale 3 cm, seed 0.  One JSON line.

    python -m fisher_nerf_customized_tpu_torch.tools.render_profile \\
        [--n 23000 131072] [--img 256] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ._timing import timed


def scene_params(n, seed=0, device="cuda"):
    """(means (camera frame), scales, quats, opacities, colors) tensors."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(2.0, 9.0, n)
    scales = np.full((n, 3), 0.03, np.float32)
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    opac = rng.uniform(0.3, 0.9, (n,)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (pts, scales, quats, opac, cols))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[23000, 131072])
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..ops import cuda_blend
    from ..ops.binning import tile_bin
    from ..ops.camera import Camera
    from ..ops.projection import preprocess
    from ..ops.rasterize import RenderSettings, blend_kernel_inputs, render

    dev = torch.device(args.device)
    img = args.img
    cam = Camera(fx=img / 2.0, fy=img / 2.0, cx=img / 2.0, cy=img / 2.0,
                 width=img, height=img)
    st = RenderSettings(tile_size=args.tile, max_per_tile=args.k,
                        chunk=args.chunk)

    def plain_render(means, scales, quats, opac, cols):
        prep = preprocess(means, scales, quats, cam)
        bins = tile_bin(prep.mean2d, prep.radius, prep.depth, prep.valid,
                        cam.width, cam.height, st.tile_size, st.max_per_tile)
        packed, pix_xy, nvalid = blend_kernel_inputs(st, prep, bins, opac,
                                                     cols)
        return cuda_blend.blend_plain(packed, pix_xy, nvalid, st.chunk,
                                      st.max_depth)

    report = {}
    with torch.no_grad():
        for n in args.n:
            means, scales, quats, opac, cols = scene_params(n, device=dev)
            t_prep, prep = timed(lambda: preprocess(means, scales, quats,
                                                    cam), dev, args.reps)
            t_bin, bins = timed(lambda: tile_bin(
                prep.mean2d, prep.radius, prep.depth, prep.valid, cam.width,
                cam.height, st.tile_size, st.max_per_tile), dev, args.reps)
            t_pack, (packed, pix_xy, nvalid) = timed(
                lambda: blend_kernel_inputs(st, prep, bins, opac, cols), dev,
                args.reps)
            t_blend, _ = timed(lambda: cuda_blend.cuda_blend(
                packed, pix_xy, nvalid, st.chunk, st.max_depth), dev,
                args.reps)
            t_full, _ = timed(lambda: render(cam, means, scales, quats, opac,
                                             cols, settings=st), dev,
                              args.reps)
            t_plain, _ = timed(lambda: plain_render(means, scales, quats,
                                                    opac, cols), dev,
                               args.reps)
            report[n] = dict(
                preprocess_ms=round(t_prep, 3), tile_bin_ms=round(t_bin, 3),
                pack_ms=round(t_pack, 3), blend_ms=round(t_blend, 3),
                full_render_ms=round(t_full, 3),
                full_render_plain_ms=round(t_plain, 3),
                sum_stages_ms=round(t_prep + t_bin + t_pack + t_blend, 3),
                overflow=int(bins.overflow),
                mean_count=float(bins.counts.float().mean()))
    out = dict(img=img, tile=args.tile, k=args.k, chunk=args.chunk,
               platform=dev.type, stages=report)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
