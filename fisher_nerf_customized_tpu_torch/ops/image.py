"""Image metrics: SSIM (11x11 Gaussian window), PSNR, L1.

Constants match the reference (window 11, sigma 1.5, C1 = 0.01²,
C2 = 0.03²).  Layout is (H, W, C), as in the JAX package.

Everything stays in strict f32.  The SSIM variance E[x²] - mu² cancels
badly at reduced precision (a bf16 or TF32 filter gives negative
variances past the C2 stabilizer and unbounded SSIM), so the separable
filter is written as eleven shifted multiply-adds per axis instead of a
convolution, which cuDNN would run in TF32 by default on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=4)
def _gaussian_window_np(window_size: int = 11, sigma: float = 1.5):
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter_sep(img, g1d):
    """Separable Gaussian filter with zero 'SAME' padding; img (H, W, C)."""
    r = len(g1d) // 2
    h, w = img.shape[0], img.shape[1]
    x = torch.nn.functional.pad(img, (0, 0, 0, 0, r, r))
    out = sum(float(g1d[i]) * x[i:i + h] for i in range(len(g1d)))
    x = torch.nn.functional.pad(out, (0, 0, r, r))
    return sum(float(g1d[i]) * x[:, i:i + w] for i in range(len(g1d)))


def calc_ssim(img1, img2, window_size: int = 11):
    """Mean SSIM over the image; img (H, W, C) in [0, 1]."""
    return ssim_map(img1, img2, window_size).mean()


def ssim_map(img1, img2, window_size: int = 11):
    """Per-pixel, per-channel SSIM (H, W, C); each channel is filtered on
    its own, so channels may hold different images."""
    g = _gaussian_window_np(window_size)
    img1 = img1.float()
    img2 = img2.float()
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                      dim=-1)
    f = _filter_sep(stack, g)
    c = img1.shape[-1]
    mu1, mu2, m11, m22, m12 = [f[..., i * c:(i + 1) * c] for i in range(5)]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # exact in infinite precision: windowed variances are nonnegative and
    # |cov| <= sigma1*sigma2 (Cauchy-Schwarz); f32 cancellation breaks
    # both once mu² is large, which would unbound the score.  maximum, not
    # clamp: at a tie (a constant patch) its gradient is split 0.5/0.5 as
    # jnp.maximum's is, where clamp's passes all of it
    zero = m11.new_zeros(())
    sigma1_sq = torch.maximum(m11 - mu1_sq, zero)
    sigma2_sq = torch.maximum(m22 - mu2_sq, zero)
    cs_bound = torch.sqrt(sigma1_sq * sigma2_sq).detach()
    sigma12 = torch.maximum(torch.minimum(m12 - mu1_mu2, cs_bound), -cs_bound)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim


def calc_psnr(img1, img2):
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def l1_loss(x, y):
    return torch.mean(torch.abs(x - y))
