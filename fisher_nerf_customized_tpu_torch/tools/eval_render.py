"""Render quality over saved image pairs: the mean PSNR and SSIM of each
render PNG against the ground-truth PNG of the same name (the JAX
package's scripts/eval_render.py, the same JSON line).

    python -m fisher_nerf_customized_tpu_torch.tools.eval_render \\
        RENDER_DIR GT_DIR [--device cpu]

PNGs are read as cv2.imread reads them in color (utils/raster.py::
read_png: gray replicated to three channels, alpha dropped); the metrics
are ops/image.py's, on `--device` (the card by default).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from ..ops.image import calc_psnr, calc_ssim
from ..utils.raster import read_png


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) float32 RGB in [0, 1] of an 8-bit PNG."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    img = img[..., :1] if img.shape[-1] == 2 else img[..., :3]
    return np.broadcast_to(img, img.shape[:2] + (3,)).astype(
        np.float32) / 255.0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("render_dir")
    p.add_argument("gt_dir")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    psnrs, ssims = [], []
    for rf in sorted(glob.glob(os.path.join(args.render_dir, "*.png"))):
        gf = os.path.join(args.gt_dir, os.path.basename(rf))
        if not os.path.exists(gf):
            continue
        r = torch.from_numpy(read_rgb(rf)).to(args.device)
        g = torch.from_numpy(read_rgb(gf)).to(args.device)
        psnrs.append(float(calc_psnr(r, g)))
        ssims.append(float(calc_ssim(r, g)))
    out = dict(n=len(psnrs), psnr=float(np.mean(psnrs)) if psnrs else None,
               ssim=float(np.mean(ssims)) if ssims else None)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
