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

The object branch's estimators (`hutchinson_diag`, `block_jtj`,
`hutchinson_batch`) take diag(JᵀJ) of the rendered color over all
Gaussian parameter groups from K probes z ~ N(0, I) through one forward:
K1 once for every pose of a batch, the probe-batched K2 once for all
probes (ops/cuda_blend_bwd.py), and torch.func.vmap over the VJP of the
row packing and preprocess, which carries each probe's rows back to the
Gaussians.  The probes are an argument: the JAX package draws them from
jax.random, which torch cannot reproduce, so callers draw their own
(GaussianObjectSLAM from torch generators) and tests feed the JAX draws.
The T- and D-optimality scores (`topt_score_*`, `dopt_score_*`) are the
JAX package's.
"""
from __future__ import annotations

import torch

from .binning import tile_bin
from .camera import Camera
from .cuda_blend import cuda_blend
from .cuda_blend_bwd import cuda_blend_bwd_probes
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


def fisher_from_lists(camera: Camera, packed, pix_xy, slot_valid, table,
                      n_out: int, chunk: int, grad_value: float = 1e-3):
    """K3 on given per-(pose, tile) lists and the scatter of its slot rows
    into an (n_out, 4) Fisher diagonal.

    packed (B, T, K, 11|20) with each list's valid slots first (invalid
    slots at opacity 0), pix_xy (T, 2, P), slot_valid (B, T, K) bool and
    table (B, T, K) the row of [0, n_out) each slot adds to."""
    nvalid = slot_valid.sum(dim=-1, dtype=torch.int32)
    h_slots = cuda_fisher_slots(packed, pix_xy, nvalid, chunk,
                                float(grad_value), float(camera.fx),
                                float(camera.fy))
    h_slots = torch.where(slot_valid[..., None], h_slots,
                          torch.zeros_like(h_slots))
    # On CUDA index_add_ sums a Gaussian's rows (one per touched tile) in
    # a run-dependent order: f32 reassociation, ~1e-7 relative, far
    # inside the rtol 5e-3 the Fisher comparisons use.
    h = torch.zeros(n_out, 4, device=packed.device)
    h.index_add_(0, table.reshape(-1), h_slots.reshape(-1, 4))
    return h


def fisher_diag_batch(camera: Camera, w2cs, means_world, scales, quats,
                      opacities, colors, grad_value: float = 1e-3,
                      active=None, settings: RenderSettings = RenderSettings(),
                      full_chain: bool = True):
    """Fisher diagonal at a batch of world->camera poses.

    w2cs (B, 4, 4).  Returns dict(H (B, N, 4), radii (B, N),
    visible (B, N))."""
    nb = w2cs.shape[0]
    n = means_world.shape[0]
    packed, pix_xy, _nvalid, bins, prep = fisher_kernel_inputs(
        camera, w2cs, means_world, scales, quats, opacities, colors,
        active=active, settings=settings, full_chain=full_chain)
    # table entries are clamped into [0, N): pose b's rows go to
    # [b N, (b + 1) N)
    offsets = torch.arange(nb, device=packed.device)[:, None, None] * n
    h = fisher_from_lists(camera, packed, pix_xy, bins.slot_valid,
                          bins.table + offsets, nb * n, settings.chunk,
                          grad_value)
    return dict(H=h.reshape(nb, n, 4), radii=prep.radius,
                visible=prep.radius > 0)


def fisher_diag(camera: Camera, means_cam, scales, quats, opacities, colors,
                grad_value: float = 1e-3, active=None,
                settings: RenderSettings = RenderSettings(),
                full_chain: bool = True):
    """Fisher diagonal at one pose, the means already in its camera frame:
    dict(H (N, 4) = [d mean_cam (3), d opacity], radii (N,), visible (N,)
    = radii > 0).  fisher_diag_batch at the identity pose with a batch of
    one: K3 on the card, its plain twin on the CPU; since means_cam I + 0
    is exact, it equals that call to the bit."""
    eye = torch.eye(4, dtype=means_cam.dtype, device=means_cam.device)
    out = fisher_diag_batch(camera, eye[None], means_cam, scales, quats,
                            opacities, colors, grad_value=grad_value,
                            active=active, settings=settings,
                            full_chain=full_chain)
    return {k: v[0] for k, v in out.items()}


def _image_to_tiles(img, nty: int, ntx: int, ts: int):
    """(..., H, W, C) image -> (..., T, P, C) tile-pixel layout, zeros in
    the padding: the adjoint of rasterize._tiles_to_image."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    pad = img.new_zeros(lead + (nty * ts, ntx * ts, c))
    pad[..., :h, :w, :] = img
    pad = pad.reshape(lead + (nty, ts, ntx, ts, c)).transpose(-4, -3)
    return pad.reshape(lead + (nty * ntx, ts * ts, c))


def hutchinson_kernel_inputs(camera: Camera, means_cam, scales, quats,
                             opacities, colors, zs, active=None,
                             settings: RenderSettings = RenderSettings()):
    """The forward of `hutchinson_batch` and the probe-batched K2's
    inputs: preprocess and binning at each pose, the K1 rows of every
    (pose, tile) with the VJP of their packing, K1 once, and the probes
    in K2's layout.  Returns a dict: packed (B T, K, 8+C), pix_xy, nvalid,
    K1's color, t_final and walked, gcol (K, B T, P, C) and g_t
    (K, B T, P) (0: the render's background is 0, so no cotangent reaches
    the final T), valid (B T, K, 1) the slot-valid column, vjp_fn (of the
    packing, in the pose's means, scales, quaternions and opacities) and
    radii (B, N)."""
    st = settings
    nb, n = means_cam.shape[:2]
    n_probes = zs.shape[1]
    sc = scales.expand(nb, n, 3)
    qt = quats.expand(nb, n, 4)
    op = opacities.expand(nb, n)
    with torch.no_grad():
        prep = preprocess(means_cam, sc, qt, camera, active=active)
        bins = tile_bin(prep.mean2d, prep.radius, prep.depth, prep.valid,
                        camera.width, camera.height, st.tile_size,
                        st.max_per_tile)
    n_tiles, k = bins.table.shape[-2:]
    idx = bins.table.reshape(nb, -1, 1)
    valid = bins.slot_valid.reshape(nb * n_tiles, k, 1).to(means_cam.dtype)
    cols = colors.expand(nb, n, colors.shape[-1])

    def pack(mc, s, q, o):
        """The K1 rows of every (pose, tile): (B T, K, 8+C)."""
        pr = preprocess(mc, s, q, camera, active=active)
        feat = torch.cat([pr.mean2d, pr.conic, o[..., None],
                          pr.depth[..., None], cols], dim=-1)
        rows = torch.gather(feat, 1, idx.expand(-1, -1, feat.shape[-1]))
        rows = rows.reshape(nb * n_tiles, k, -1)
        return torch.cat([rows[..., :7], valid, rows[..., 7:]], dim=-1)

    packed, vjp_fn = torch.func.vjp(pack, means_cam, sc, qt, op)
    packed = packed.detach().contiguous()
    pix_x, pix_y = tile_pixel_coords(bins.n_tiles_x, bins.n_tiles_y,
                                     st.tile_size, device=packed.device)
    pix_xy = torch.stack([pix_x, pix_y], dim=1).repeat(nb, 1, 1)
    nvalid = bins.slot_valid.reshape(nb * n_tiles, k).sum(
        dim=-1, dtype=torch.int32)
    (color, t_final, _med), walked = cuda_blend(packed, pix_xy, nvalid,
                                                st.chunk, st.max_depth)
    gcol = _image_to_tiles(zs.transpose(0, 1), bins.n_tiles_y,
                           bins.n_tiles_x, st.tile_size)
    gcol = gcol.reshape(n_probes, nb * n_tiles, -1,
                        colors.shape[-1]).contiguous()
    return dict(packed=packed, pix_xy=pix_xy, nvalid=nvalid, color=color,
                t_final=t_final, walked=walked.to(torch.int32), gcol=gcol,
                g_t=gcol.new_zeros(gcol.shape[:-1]), valid=valid,
                vjp_fn=vjp_fn, radii=prep.radius)


def hutchinson_batch(camera: Camera, means_cam, scales, quats, opacities,
                     colors, zs, active=None,
                     settings: RenderSettings = RenderSettings()):
    """Jᵀz of the rendered color for K probes at each of B poses.

    means_cam (B, N, 3) camera-frame means at each pose; scales (N, 3),
    quats (N, 4), opacities (N,), colors (N, C) shared; zs (B, K, H, W, C)
    the probes (image cotangents).  Returns dict(means (K, B, N, 3),
    scales (K, B, N, 3), rotations (K, B, N, 4), opacity (K, B, N), radii
    (B, N)): the gradient of <z_k, render_b> with respect to the pose's
    camera-frame means, scales, quaternions and opacities, with the
    render's VJP conventions (ops/rasterize.py BlendFunction)."""
    x = hutchinson_kernel_inputs(camera, means_cam, scales, quats, opacities,
                                 colors, zs, active=active, settings=settings)
    slots = cuda_blend_bwd_probes(x["packed"], x["pix_xy"], x["gcol"],
                                  x["g_t"], x["nvalid"], settings.chunk,
                                  color=x["color"], t_final=x["t_final"],
                                  walked=x["walked"])
    # d_packed as BlendFunction.backward gives it: 0 in the depth and
    # valid columns and on invalid slots
    zeros = slots.new_zeros(slots.shape[:-1] + (2,))
    d_packed = torch.cat([slots[..., :6], zeros, slots[..., 6:]], dim=-1)
    g_means, g_scales, g_quats, g_opac = torch.func.vmap(x["vjp_fn"])(
        d_packed * x["valid"])
    return dict(means=g_means, scales=g_scales, rotations=g_quats,
                opacity=g_opac, radii=x["radii"])


def hutchinson_diag(camera: Camera, means_cam, scales, quats, opacities,
                    colors, zs, active=None,
                    settings: RenderSettings = RenderSettings()):
    """Hutchinson diag(JᵀJ) over all Gaussian parameter groups at one
    pose: (1/K) Σ_k (Jᵀz_k)², the probes zs (K, H, W, C).  Returns
    dict(means (N, 3), opacity (N, 1), rotations (N, 4), scales (N, 3),
    radii, visible), as the JAX package's hutchinson_diag."""
    g = hutchinson_batch(camera, means_cam[None], scales, quats, opacities,
                         colors, zs[None], active=active, settings=settings)
    return dict(means=(g["means"][:, 0] ** 2).mean(dim=0),
                scales=(g["scales"][:, 0] ** 2).mean(dim=0),
                rotations=(g["rotations"][:, 0] ** 2).mean(dim=0),
                opacity=(g["opacity"][:, 0] ** 2).mean(dim=0)[:, None],
                radii=g["radii"][0], visible=g["radii"][0] > 0)


def block_jtj(camera: Camera, means_cam, scales, quats, opacities, colors,
              zs, active=None, settings: RenderSettings = RenderSettings()):
    """Per-splat 11 x 11 JᵀJ blocks (means, opacity, rotations, scales)
    from Hutchinson outer products over the probes zs (K, H, W, C).
    Returns dict(blocks (N, 11, 11), radii, visible); invisible splats'
    blocks are 0."""
    g = hutchinson_batch(camera, means_cam[None], scales, quats, opacities,
                         colors, zs[None], active=active, settings=settings)
    v = torch.cat([g["means"][:, 0], g["opacity"][:, 0, :, None],
                   g["rotations"][:, 0], g["scales"][:, 0]], dim=-1)
    blocks = (v[..., :, None] * v[..., None, :]).mean(dim=0)
    return dict(blocks=blocks, radii=g["radii"][0],
                visible=g["radii"][0] > 0)


def topt_score_from_diags(h_train_diag, jtj_diag, lam: float = 1e-6):
    """T-optimality (maximize): -Σ 1/(H_train + JᵀJ + λ)."""
    hpi = h_train_diag + jtj_diag + lam
    return -torch.sum(1.0 / torch.clamp(hpi, min=1e-12))


def dopt_score_from_diags(h_train_diag, jtj_diag, lam: float = 1e-6):
    """D-optimality (maximize): Σ log(H+J+λ) − Σ log(H+λ)."""
    hm = torch.clamp(h_train_diag + lam, min=1e-12)
    hpi = torch.clamp(hm + jtj_diag, min=1e-12)
    return torch.sum(torch.log(hpi)) - torch.sum(torch.log(hm))


def topt_score_blocks(h_blocks, j_blocks, valid, lam: float = 1e-6):
    """Block T-opt: −Σ trace((H+J+λI)⁻¹) over valid splats, through the
    eigenvalues of the PSD sum (finite for rank-deficient blocks)."""
    ev = torch.linalg.eigvalsh(h_blocks + j_blocks)
    tr = torch.sum(1.0 / (torch.clamp(ev, min=0.0) + lam), dim=-1)
    return -torch.sum(torch.where(valid, tr, torch.zeros_like(tr)))


def dopt_score_blocks(h_blocks, j_blocks, valid, lam: float = 1e-6):
    """Block D-opt: Σ (logdet(H+J+λI) − logdet(H+λI)) over valid splats,
    through eigenvalues as `topt_score_blocks`."""
    ev1 = torch.linalg.eigvalsh(h_blocks + j_blocks)
    ev0 = torch.linalg.eigvalsh(h_blocks)
    l1 = torch.sum(torch.log(torch.clamp(ev1, min=0.0) + lam), dim=-1)
    l0 = torch.sum(torch.log(torch.clamp(ev0, min=0.0) + lam), dim=-1)
    d = l1 - l0
    return torch.sum(torch.where(valid, d, torch.zeros_like(d)))
