"""Tile-based 3DGS rasterizer, differentiable through the blend.

preprocess (ops/projection.py) -> static-shape tile binning
(ops/binning.py) -> one packed row gather -> the blend, a
torch.autograd.Function whose forward is K1 (ops/cuda_blend.py) and whose
backward is K2 (ops/cuda_blend_bwd.py): the CUDA kernels on the card,
their plain twins on the CPU.  The blend stops a tile once every pixel's
transmittance is below 1e-4, as the JAX package's Pallas forward does;
its XLA blend never stops, so the two differ by at most that tail.  The
gradient reaches the Gaussian parameters by autograd through the row
gather, preprocess and the caller's own transforms, the chain JAX's AD
runs through the same functions around its custom VJP.

A render's stretches are spans of utils/logging_utils.py's store:
render.preprocess, render.bin (`render` only) and render.blend (the pack,
the K1 launch and the tile-to-image), under whichever span calls them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .binning import tile_bin
from .camera import Camera
from .cuda_blend import cuda_blend
from .cuda_blend_bwd import cuda_blend_bwd
from .projection import preprocess
from ..utils.logging_utils import span


class RenderSettings(NamedTuple):
    tile_size: int = 16
    max_per_tile: int = 512
    chunk: int = 64
    max_depth: float = 15.0   # median-depth fallback


def pack_blend_features(prep, opacities, colors):
    """Per-Gaussian packed feature rows for the blend:
    [mean2d (2), conic (3), opacity (1), depth (1), colors (C)]."""
    return torch.cat([prep.mean2d, prep.conic, opacities[:, None],
                      prep.depth[:, None], colors], dim=-1)


def tile_pixel_coords(ntx: int, nty: int, ts: int, device=None):
    """Pixel coordinates per tile: two (T, P) float tensors."""
    tile_ids = torch.arange(ntx * nty, device=device)
    tile_x0 = (tile_ids % ntx) * ts
    tile_y0 = torch.div(tile_ids, ntx, rounding_mode="floor") * ts
    lx = torch.arange(ts, dtype=torch.float32, device=device).repeat(ts)
    ly = torch.arange(ts, dtype=torch.float32,
                      device=device).repeat_interleave(ts)
    pix_x = tile_x0[:, None].float() + lx[None, :]
    pix_y = tile_y0[:, None].float() + ly[None, :]
    return pix_x, pix_y


def _tiles_to_image(buf, nty, ntx, ts, height, width):
    """(T, P, ...) tile-pixel buffer -> (H, W, ...) image (crops padding)."""
    trailing = buf.shape[2:]
    img = buf.reshape((nty, ntx, ts, ts) + trailing)
    img = img.movedim(2, 1).reshape((nty * ts, ntx * ts) + trailing)
    return img[:height, :width]


def blend_kernel_inputs(st: RenderSettings, prep, bins, opacities, colors):
    """Pack binned Gaussians for the K1 kernel: one row gather of the
    blend features with the slot-valid flag inserted at column 7.
    Returns (packed (T, K, 8+C), pix_xy (T, 2, P), nvalid (T,))."""
    rows = pack_blend_features(prep, opacities, colors)[bins.table]
    val = bins.slot_valid[..., None].to(rows.dtype)
    packed = torch.cat([rows[..., :7], val, rows[..., 7:]], dim=-1)
    pix_x, pix_y = tile_pixel_coords(bins.n_tiles_x, bins.n_tiles_y,
                                     st.tile_size, device=packed.device)
    pix_xy = torch.stack([pix_x, pix_y], dim=1).contiguous()
    nvalid = bins.slot_valid.sum(dim=-1, dtype=torch.int32)
    return packed, pix_xy, nvalid


def blend_lists(st: RenderSettings, packed, pix_xy):
    """K1 (K2 backward) over given per-tile lists: packed (T, K, 8+C) in
    K1's layout, each list's valid slots first (column 7 the flag);
    pix_xy (T, 2, P).  Returns (color (T, P, C), final_t, med_depth)."""
    nvalid = (packed[..., 7] > 0.5).sum(dim=-1, dtype=torch.int32)
    return BlendFunction.apply(packed.contiguous(), pix_xy.contiguous(),
                               nvalid, st.chunk, st.max_depth)


class BlendFunction(torch.autograd.Function):
    """K1 forward, K2 backward, with the JAX package's custom-VJP
    conventions (ops/rasterize.py `blend_packed_pallas_bwd`): the 0.99
    alpha clamp does not gate the gradient, slots past the tile's stop
    give 0, the median depth is a measurement (no gradient), and
    `d_packed` is 0 in the depth and valid columns and on invalid slots.

    apply(packed (T, K, 8+C), pix_xy, nvalid, chunk, max_depth) ->
    (color (T, P, C), final_t (T, P), med_depth (T, P))."""

    @staticmethod
    def forward(ctx, packed, pix_xy, nvalid, chunk: int, max_depth: float):
        (color, t_final, med), walked = cuda_blend(packed, pix_xy, nvalid,
                                                   chunk, max_depth)
        # K2 reads K1's outputs: the stop, T_final and the suffix sums
        ctx.save_for_backward(packed, pix_xy, nvalid, color, t_final, walked)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(med)
        return color, t_final, med

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_color, g_t, _g_med):
        packed, pix_xy, nvalid, color, t_final, walked = ctx.saved_tensors
        slots = cuda_blend_bwd(packed, pix_xy, g_color.contiguous(),
                               g_t.contiguous(), nvalid, ctx.chunk,
                               color=color, t_final=t_final, walked=walked)
        zeros = slots.new_zeros(slots.shape[:-1] + (2,))     # depth, valid
        d_packed = torch.cat([slots[..., :6], zeros, slots[..., 6:]], dim=-1)
        d_packed = torch.where(packed[..., 7:8] > 0.5, d_packed,
                               torch.zeros_like(d_packed))
        return d_packed, None, None, None, None


def _blend(camera: Camera, st: RenderSettings, prep, bins, opacities, colors,
           bg):
    packed, pix_xy, nvalid = blend_kernel_inputs(st, prep, bins, opacities,
                                                 colors)
    color, t_final, med = BlendFunction.apply(packed, pix_xy, nvalid,
                                              st.chunk, st.max_depth)
    if bg is None:
        bg = torch.zeros(colors.shape[-1], device=packed.device)
    out = color + t_final[:, :, None] * bg[None, None, :]
    ts, nty, ntx = st.tile_size, bins.n_tiles_y, bins.n_tiles_x
    return dict(
        color=_tiles_to_image(out, nty, ntx, ts, camera.height, camera.width),
        depth=_tiles_to_image(med, nty, ntx, ts, camera.height, camera.width),
        final_t=_tiles_to_image(t_final, nty, ntx, ts, camera.height,
                                camera.width),
        radii=prep.radius, overflow=bins.overflow)


def render_prebinned(camera: Camera, means_cam, scales, quats, opacities,
                     colors, bins, bg=None,
                     settings: RenderSettings = RenderSettings()):
    """Render against a frozen tile-binning table (differentiable in every
    input but the table)."""
    with span("render.preprocess"):
        prep = preprocess(means_cam, scales, quats, camera)
    with span("render.blend"):
        return _blend(camera, settings, prep, bins, opacities, colors, bg)


def render(camera: Camera, means_cam, scales, quats, opacities, colors,
           bg=None, active=None, settings: RenderSettings = RenderSettings()):
    """Render camera-frame Gaussians to an (H, W, C) image.

    means_cam (N, 3) camera-frame centers; scales (N, 3) stddevs; quats
    (N, 4) wxyz; opacities (N,) post-sigmoid; colors (N, C) per-Gaussian
    channels; bg (C,) background (default zeros); active (N,) slot mask.

    Returns dict with color (H, W, C) blended channels + T*bg, depth
    (H, W) median depth, final_t (H, W), radii (N,), overflow () count of
    Gaussian-tile entries truncated by the per-tile capacity."""
    st = settings
    with span("render.preprocess"):
        prep = preprocess(means_cam, scales, quats, camera, active=active)
    with span("render.bin"):
        bins = tile_bin(prep.mean2d.detach(), prep.radius.detach(),
                        prep.depth.detach(), prep.valid, camera.width,
                        camera.height, st.tile_size, st.max_per_tile)
    with span("render.blend"):
        return _blend(camera, st, prep, bins, opacities, colors, bg)


def render_sh(camera: Camera, means_world, w2c, scales, quats, opacities,
              sh, deg: int = 3, bg=None, active=None,
              settings: RenderSettings = RenderSettings()):
    """Render world-frame Gaussians with view-dependent SH colours
    (ops/sh.py, degree 0 to 3; sh (N, M, 3) with M >= (deg + 1)^2) at the
    (4, 4) world-to-camera w2c; the rest as `render`.  Differentiable in
    sh and, through the view direction and the transform, in the
    means."""
    from .sh import sh_to_rgb
    rot = w2c[:3, :3]
    campos = -(rot.T @ w2c[:3, 3])                # the camera centre
    colors = sh_to_rgb(sh, means_world, campos, deg=deg)
    means_cam = means_world @ rot.T + w2c[:3, 3]
    return render(camera, means_cam, scales, quats, opacities, colors,
                  bg=bg, active=active, settings=settings)
