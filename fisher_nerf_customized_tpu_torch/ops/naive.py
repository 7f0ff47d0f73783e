"""The naive O(N x pixels) reference rasterizer, for tests and debugging.

Counterpart of the JAX package's ops/naive.py: the same preprocess
(ops/projection.py) and blend arithmetic as ops/rasterize.py, with no
tile binning and no per-tile capacity: every Gaussian is blended at every
pixel of the tiles its screen box touches, in global depth order.  It
never stops early, so against `render` it differs by at most the tail
past the tile stop (T < 1e-4).  Nothing on the episode's path calls it.
"""
from __future__ import annotations

import torch

from .camera import Camera
from .projection import preprocess


def render_naive(camera: Camera, means_cam, scales, quats, opacities, colors,
                 bg=None, active=None, max_depth: float = 15.0,
                 tile_size: int = 16):
    """The arguments and outputs of ops/rasterize.py::render (without
    `overflow`)."""
    prep = preprocess(means_cam, scales, quats, camera, active=active)
    inf = torch.full_like(prep.depth, float("inf"))
    order = torch.argsort(torch.where(prep.valid, prep.depth, inf),
                          stable=True)

    mu = prep.mean2d[order]
    con = prep.conic[order]
    dep = prep.depth[order]
    val = prep.valid[order]
    rad = prep.radius[order]
    opa = opacities[order]
    col = colors[order]

    h, w = camera.height, camera.width
    dev = means_cam.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)  # (P, 2)

    dx = mu[:, 0:1] - pix[None, :, 0]                            # (N, P)
    dy = mu[:, 1:2] - pix[None, :, 1]
    a, b, c = con[:, 0:1], con[:, 1:2], con[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    inside = power <= 0.0
    g = torch.exp(torch.where(inside, power, torch.zeros_like(power)))
    alpha = torch.clamp(opa[:, None] * g, max=0.99)
    # a Gaussian is evaluated only at the pixels of the tiles its screen
    # box touches, as the tiled renderer does
    ts = float(tile_size)
    px_t = torch.floor(pix[None, :, 0] / ts)
    py_t = torch.floor(pix[None, :, 1] / ts)
    x0 = torch.floor((mu[:, 0:1] - rad[:, None]) / ts)
    x1 = torch.floor((mu[:, 0:1] + rad[:, None]) / ts)
    y0 = torch.floor((mu[:, 1:2] - rad[:, None]) / ts)
    y1 = torch.floor((mu[:, 1:2] + rad[:, None]) / ts)
    in_rect = (px_t >= x0) & (px_t <= x1) & (py_t >= y0) & (py_t <= y1)
    alpha = torch.where(inside & in_rect & val[:, None]
                        & (alpha >= 1.0 / 255.0), alpha,
                        torch.zeros_like(alpha))

    cum = torch.cumprod(1.0 - alpha, dim=0)
    t_before = torch.cat([torch.ones_like(cum[:1]), cum[:-1]], dim=0)
    wgt = alpha * t_before                                       # (N, P)

    img = torch.einsum("np,nc->pc", wgt, col)
    t_final = cum[-1]

    t_after = t_before * (1.0 - alpha)
    crossing = (t_before > 0.5) & (t_after < 0.5) & (alpha > 0.0)
    dep_b = dep[:, None].expand(crossing.shape)
    dep_cross = torch.where(crossing, dep_b,
                            torch.full_like(dep_b, -float("inf"))).amax(0)
    depth = torch.where(crossing.any(dim=0), dep_cross,
                        torch.full_like(dep_cross, max_depth))

    cch = colors.shape[-1]
    if bg is None:
        bg = torch.zeros(cch, device=dev)
    img = img + t_final[:, None] * bg[None, :]

    return dict(color=img.reshape(h, w, cch), depth=depth.reshape(h, w),
                final_t=t_final.reshape(h, w), radii=prep.radius)
