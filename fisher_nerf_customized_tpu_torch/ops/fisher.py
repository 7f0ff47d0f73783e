"""Fisher-information diagonal via an analytic squared backward pass.

The reference computes diag(JᵀJ) by running its CUDA backward with
`grad_power=2`: every per-pixel gradient, chained to mean3D/opacity, is
squared before accumulation, under an incoming cotangent of 1e-3 per
pixel.  Here the squared per-pixel gradients come from the K3 kernel
(ops/cuda_fisher.py) as per-slot rows, and one scatter-add per batch
turns them into the per-Gaussian (N, 4) diagonal [mean_cam x, y, z,
opacity].  The pose batch is a leading dimension: one preprocess, one
binning and one kernel launch serve every pose of a batch.

full_chain=True adds the cov2D-through-mean term (the reference's
computeCov2DCUDA dL_dmean, summed with the projection term before the
per-pixel square) through the 20-wide packing; False keeps the reduced
projection chain through the 11-wide packing.
"""
from __future__ import annotations

import torch

from .binning import tile_bin
from .camera import Camera
from .cuda_fisher import cuda_fisher_slots, pack_fisher_features
from .projection import build_cov3d, conic_mean_jac, preprocess
from .rasterize import RenderSettings, tile_pixel_coords


def fisher_kernel_inputs(camera: Camera, w2cs, means_world, scales, quats,
                         opacities, colors, active=None,
                         settings: RenderSettings = RenderSettings(),
                         full_chain: bool = True):
    """Preprocess, bin and pack a batch of poses for the K3 kernel.
    Returns (packed (B, T, K, 11|20), pix_xy (T, 2, P), nvalid (B, T),
    bins, prep)."""
    st = settings
    means_cam = means_world @ w2cs[:, :3, :3].transpose(1, 2) \
        + w2cs[:, None, :3, 3]                               # (B, N, 3)
    prep = preprocess(means_cam, scales, quats, camera, active=active)
    bins = tile_bin(prep.mean2d, prep.radius, prep.depth, prep.valid,
                    camera.width, camera.height, st.tile_size,
                    st.max_per_tile)
    cjac = None
    if full_chain:
        cjac = conic_mean_jac(means_cam, build_cov3d(scales, quats), camera,
                              valid=prep.valid)
    packed = pack_fisher_features(prep, bins, opacities, colors, means_cam,
                                  conic_jac=cjac)
    pix_x, pix_y = tile_pixel_coords(bins.n_tiles_x, bins.n_tiles_y,
                                     st.tile_size, device=packed.device)
    pix_xy = torch.stack([pix_x, pix_y], dim=1).contiguous()
    nvalid = bins.slot_valid.sum(dim=-1, dtype=torch.int32)
    return packed, pix_xy, nvalid, bins, prep


def fisher_diag_batch(camera: Camera, w2cs, means_world, scales, quats,
                      opacities, colors, grad_value: float = 1e-3,
                      active=None, settings: RenderSettings = RenderSettings(),
                      full_chain: bool = True):
    """Fisher diagonal at a batch of world->camera poses.

    w2cs (B, 4, 4).  Returns dict(H (B, N, 4), radii (B, N),
    visible (B, N))."""
    st = settings
    nb = w2cs.shape[0]
    n = means_world.shape[0]
    packed, pix_xy, nvalid, bins, prep = fisher_kernel_inputs(
        camera, w2cs, means_world, scales, quats, opacities, colors,
        active=active, settings=st, full_chain=full_chain)
    h_slots = cuda_fisher_slots(packed, pix_xy, nvalid, st.chunk,
                                float(grad_value), float(camera.fx),
                                float(camera.fy))
    h_slots = torch.where(bins.slot_valid[..., None], h_slots,
                          torch.zeros_like(h_slots))
    # table entries are clamped into [0, N), so no index falls outside.
    # On CUDA index_add_ sums a Gaussian's rows (one per touched tile) in
    # a run-dependent order: f32 reassociation, ~1e-7 relative, far
    # inside the rtol 5e-3 the Fisher comparisons use.
    offsets = torch.arange(nb, device=packed.device)[:, None, None] * n
    h = torch.zeros(nb * n, 4, device=packed.device)
    h.index_add_(0, (bins.table + offsets).reshape(-1),
                 h_slots.reshape(-1, 4))
    return dict(H=h.reshape(nb, n, 4), radii=prep.radius,
                visible=prep.radius > 0)
