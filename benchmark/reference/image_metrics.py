"""The held-out evaluation's metrics of one pose, worked out again:
PSNR, SSIM, depth MAE over the pixels with ground-truth depth, and
LPIPS(alex) from given weights, in plain PyTorch."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .gaussians import ssim

ALEX = ((11, 4, 2), (5, 1, 2), (3, 1, 1), (3, 1, 1), (3, 1, 1))
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def psnr(img, gt):
    mse = torch.mean((img - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def depth_mae(depth, gt_depth):
    valid = gt_depth > 0
    return (torch.where(valid, torch.abs(depth - gt_depth),
                        torch.zeros_like(depth)).sum()
            / torch.clamp(valid.sum(), min=1))


def lpips_alex(img, gt, weights: dict):
    """LPIPS v0.1 with AlexNet features: [0, 1] -> 2x - 1 -> (x - shift) /
    scale -> the five conv + ReLU taps (3/2 max pools before the 2nd and
    3rd conv) -> unit norm over channels -> squared difference -> each
    tap's 1x1 linear layer -> spatial mean -> summed over the taps.
    img, gt (H, W, 3); weights: features.{0,3,6,8,10}.weight / .bias and
    lin{0..4}.model.1.weight.  Convolutions without TF32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        shift = img.new_tensor(SHIFT)[None, :, None, None]
        scale = img.new_tensor(SCALE)[None, :, None, None]
        xs = [(x.permute(2, 0, 1)[None] * 2.0 - 1.0 - shift) / scale
              for x in (img, gt)]
        total = img.new_zeros(())
        for i, (idx, (_k, s, pad)) in enumerate(zip((0, 3, 6, 8, 10), ALEX)):
            w = weights[f"features.{idx}.weight"].to(img.dtype)
            b = weights[f"features.{idx}.bias"].to(img.dtype)
            feats = []
            for j, x in enumerate(xs):
                if idx in (3, 6):
                    x = F.max_pool2d(x, 3, 2)
                x = torch.relu(F.conv2d(x, w, b, s, pad))
                xs[j] = x
                feats.append(x / torch.sqrt(torch.sum(x * x, dim=1,
                                                      keepdim=True) + 1e-10))
            d = (feats[0] - feats[1]) ** 2
            lin = weights[f"lin{i}.model.1.weight"].to(img.dtype)
            total = total + torch.mean(F.conv2d(d, lin))
        return total
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def pose_metrics(render, gt_rgb, depth, gt_depth, lpips_weights=None):
    """dict(psnr, ssim, depth_mae[, lpips]) of one pose, renders clamped
    to [0, 1]."""
    r = torch.clamp(render, 0.0, 1.0)
    g = torch.clamp(gt_rgb, 0.0, 1.0)
    out = dict(psnr=float(psnr(r, g)), ssim=float(ssim(r, g)),
               depth_mae=float(depth_mae(depth, gt_depth)))
    if lpips_weights is not None:
        out["lpips"] = float(lpips_alex(r, g, lpips_weights))
    return out
