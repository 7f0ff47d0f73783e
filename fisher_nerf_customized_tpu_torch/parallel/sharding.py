"""Sharded execution of the hot paths over a process-group mesh
(parallel/mesh.py), the JAX package's parallel/sharding.py in SPMD form:
each rank runs the same call, computes its shard and a collective
restores the replicated value.

Episode-path factories (GaussianSLAM and ActiveMapper route their
dispatches through these when cfg.tpu.mesh_axes.data > 1):
  sharded_mapping_phase   the mapping event (`_mapping_phase_impl`), each
                          rank taking its columns of every row of
                          frame_choices, gradients and loss pmean'd after
                          each backward (K1, K2);
  sharded_pose_scores     EIG scores of a pose chunk, poses split over
                          'data', scores all-gathered (K3 11-wide);
  sharded_fisher_hsum     Σ of a keyframe chunk's Fisher diagonals,
                          padding weighted 0, partial sums psum'd;
  sharded_path_eig        path EIG, paths split over 'data', scores
                          all-gathered (K3 20-wide).

Library paths: `pose_eval_sharded`, `mapping_step_sharded`,
`full_train_step`; scene parallelism (`multi_scene_occ_update`,
`multi_scene_train_step`, each rank stepping its S/D scenes); and the
Gaussian-axis ('model') render and Fisher diagonal for maps too big for
one card (`render_gaussian_sharded`, `fisher_diag_gaussian_sharded`):
each rank preprocesses and bins its N/D shard, the per-tile lists are
all-gathered and the global nearest K re-selected (`_merge_shard_tiles`),
and each rank runs K1 or K3 on its T/D tiles of the merged lists.  Their
N-axis inputs and outputs are this rank's shard.
"""
from __future__ import annotations

import torch

from ..models.gaussian_state import GaussianState, adam_init, adam_step
from ..models.slam import (MappingConfig, _fisher_batch, _mapping_loss,
                           _mapping_phase_impl)
from ..ops.camera import Camera
from ..ops.fisher import fisher_from_lists, fisher_kernel_inputs
from ..ops.rasterize import (RenderSettings, _tiles_to_image,
                             blend_kernel_inputs, blend_lists)
from ..ops.binning import tile_bin
from ..ops.projection import preprocess
from ..planning.occupancy import occ_update
from .mesh import Axis, Mesh


def _lrs(mc: MappingConfig) -> dict:
    return dict(means3D=mc.lr_means3D, rgb_colors=mc.lr_rgb,
                unnorm_rotations=mc.lr_rots, logit_opacities=mc.lr_logit_op,
                log_scales=mc.lr_log_scales)


def _grad_step(axis: Axis, params: dict, opt, loss_fn, lrs: dict):
    """One Adam step on loss_fn(leaves), the gradients and the loss
    pmean'd over `axis` first.  Returns (params, opt, loss)."""
    keys = list(params)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
    *grads, loss = axis.pmean_all(list(grads) + [loss.detach().reshape(1)])
    new_params, new_opt = adam_step(
        opt, {k: v.detach() for k, v in leaves.items()},
        dict(zip(keys, grads)), lrs, eps=1e-15)
    return new_params, new_opt, loss[0]


def pose_eval_sharded(mesh: Mesh, state: GaussianState, w2cs, h_train_inv,
                      camera: Camera, settings: RenderSettings,
                      full_chain: bool = True):
    """EIG scores sum(H ⊙ h_train_inv) for (B, 4, 4) candidate w2cs, B
    split over 'data' (a multiple of its size); the scores (B,) are
    all-gathered."""
    ax = mesh.axis("data")
    lo, hi = ax.shard(w2cs.shape[0])
    out = _fisher_batch(state, w2cs[lo:hi], camera, settings, full_chain)
    return ax.all_gather(torch.sum(out["H"] * h_train_inv[None],
                                   dim=(1, 2)))


def mapping_step_sharded(mesh: Mesh, camera: Camera,
                         settings: RenderSettings, mc: MappingConfig):
    """A training step: fn(params, opt, n_active, colors (B, H, W, 3),
    depths (B, H, W), w2cs (B, 4, 4)) -> (params, opt, loss), the frame
    batch split over 'data', each rank's mean loss and gradients pmean'd
    and the Adam step replicated."""
    ax, lrs = mesh.axis("data"), _lrs(mc)

    def run(params, opt, n_active, colors, depths, w2cs):
        lo, hi = ax.shard(colors.shape[0])

        def loss_fn(p):
            return torch.stack([
                _mapping_loss(p, n_active, w2cs[i], colors[i], depths[i],
                              camera, settings, mc)
                for i in range(lo, hi)]).mean()
        return _grad_step(ax, params, opt, loss_fn, lrs)

    return run


def multi_scene_occ_update(mesh: Mesh, camera: Camera):
    """Per-scene occupancy updates: fn(occs (S, 3, Gz, Gx), depths (S, H,
    W), c2ws (S, 4, 4), cell_size, centers (S, 2), h_lo, h_hi, far) ->
    (occs, cam cells (S, 2)), S split over 'data', the results
    all-gathered."""
    ax = mesh.axis("data")

    def run(occs, depths, c2ws, cell_size, centers, h_lo, h_hi, far):
        lo, hi = ax.shard(occs.shape[0])
        outs = [occ_update(occs[i], depths[i], c2ws[i], camera, cell_size,
                           centers[i], h_lo, h_hi, far)
                for i in range(lo, hi)]
        return (ax.all_gather(torch.stack([o for o, _c in outs])),
                ax.all_gather(torch.stack([c for _o, c in outs])))

    return run


def multi_scene_train_step(mesh: Mesh, camera: Camera,
                           settings: RenderSettings, mc: MappingConfig):
    """Scene parallelism over the full mapping step: S independent
    scenes, each one Adam step on its own frame.  fn(states (S
    GaussianStates of one capacity), opts (S AdamStates, or None for
    fresh ones), colors (S, H, W, 3), depths (S, H, W), w2cs (S, 4, 4),
    gather=True) -> (states, opts, losses (S,)).  Each rank steps its S/D
    scenes; no collective crosses scenes, and with `gather` the results
    are all-gathered so that every rank holds all S."""
    ax, lrs = mesh.axis("data"), _lrs(mc)

    def run(states, opts, colors, depths, w2cs, gather: bool = True):
        lo, hi = ax.shard(len(states))
        new_states, new_opts, losses = [], [], []
        for i in range(lo, hi):
            st = states[i]
            params = st.params()
            opt = adam_init(params) if opts is None else opts[i]

            def loss_fn(p, i=i, n_active=st.n_active):
                return _mapping_loss(p, n_active, w2cs[i], colors[i],
                                     depths[i], camera, settings, mc)
            params, opt, loss = _grad_step(Axis("scene", 1, 0), params, opt,
                                           loss_fn, lrs)
            new_states.append(st.replace_params(params))
            new_opts.append(opt)
            losses.append(loss)
        losses = torch.stack(losses)
        if not gather or ax.group is None:
            return new_states, new_opts, losses
        return (_gather_states(ax, new_states), _gather_opts(ax, new_opts),
                ax.all_gather(losses))

    return run


def _gather_rows(ax: Axis, rows: list) -> list:
    """All-gather a list of equally shaped tensors (one per local
    scene) into the list over every rank's scenes."""
    return list(ax.all_gather(torch.stack(rows)).unbind(0))


def _gather_states(ax: Axis, states: list) -> list:
    fields = {k: _gather_rows(ax, [getattr(s, k) for s in states])
              for k in GaussianState._fields}
    return [GaussianState(**{k: v[i] for k, v in fields.items()})
            for i in range(len(fields["means3D"]))]


def _gather_opts(ax: Axis, opts: list) -> list:
    mu = {k: _gather_rows(ax, [o.mu[k] for o in opts]) for k in opts[0].mu}
    nu = {k: _gather_rows(ax, [o.nu[k] for o in opts]) for k in opts[0].nu}
    n = len(next(iter(mu.values())))
    return [opts[0]._replace(mu={k: v[i] for k, v in mu.items()},
                             nu={k: v[i] for k, v in nu.items()})
            for i in range(n)]


def _merge_shard_tiles(ax: Axis, score, *arrays, k: int):
    """All-gather every rank's per-tile nearest-K candidate lists and
    re-select the global nearest K per tile.

    The union of the ranks' nearest-K sets holds the global nearest K,
    so the merge is exact.  The re-selection is a stable descending sort:
    on a depth tie the lower rank, and within a rank the earlier slot,
    comes first, as lax.top_k orders ties (exact ties are common).

    score (T, K): -depth, -inf on invalid slots; arrays: payloads (T, K,
    ...) carried through.  Returns (valid (T, K), merged arrays, n_cand
    (T,) the valid candidates over all ranks)."""
    d = ax.size
    t = score.shape[0]
    score_m = ax.all_gather(score, tiled=False).movedim(0, 1).reshape(
        t, d * k)
    pos = torch.sort(score_m, dim=1, descending=True,
                     stable=True).indices[:, :k]
    valid = torch.gather(score_m, 1, pos) > -torch.inf
    n_cand = (score_m > -torch.inf).sum(dim=1)
    merged = []
    for arr in arrays:
        arr_m = ax.all_gather(arr, tiled=False).movedim(0, 1).reshape(
            (t, d * k) + arr.shape[2:])
        idx = pos.reshape(pos.shape + (1,) * (arr_m.dim() - 2)).expand(
            (t, k) + arr.shape[2:])
        merged.append(torch.gather(arr_m, 1, idx))
    return valid, merged, n_cand


def _tile_split(mesh: Mesh, camera: Camera, ts: int):
    ntx, nty = -(-camera.width // ts), -(-camera.height // ts)
    ax = mesh.axis("model")
    if (ntx * nty) % ax.size:
        raise ValueError(f"{ntx * nty} tiles do not split over 'model' axis "
                         f"of size {ax.size}")
    return ax, ntx, nty, ax.shard(ntx * nty)


def render_gaussian_sharded(mesh: Mesh, camera: Camera,
                            settings: RenderSettings = RenderSettings()):
    """Gaussian-axis sharded render: fn(means_w, scales, quats, opacities,
    colors, active, w2c, bg=None), the N-axis inputs this rank's shard
    (N / D of the map, rank r holding rows [r N/D, (r+1) N/D)) ->
    dict(color (H, W, C), depth, final_t (replicated), radii (this
    rank's N/D), overflow ()).  Collectives: one all-gather of the (T, K)
    scores and one of the (T, K, 8+C) K1 rows, and one of the tile
    buffers."""
    st = settings
    ts = st.tile_size
    ax, ntx, nty, (t0, t1) = _tile_split(mesh, camera, ts)

    def run(means_w, scales, quats, opacities, colors, active, w2c,
            bg=None):
        means_cam = means_w @ w2c[:3, :3].T + w2c[:3, 3]
        prep = preprocess(means_cam, scales, quats, camera, active=active)
        bins = tile_bin(prep.mean2d, prep.radius, prep.depth, prep.valid,
                        camera.width, camera.height, ts, st.max_per_tile)
        packed, pix_xy, _nvalid = blend_kernel_inputs(st, prep, bins,
                                                      opacities, colors)
        score = torch.where(bins.slot_valid, -packed[..., 6],
                            torch.full_like(packed[..., 6], -torch.inf))
        _valid, (merged,), n_cand = _merge_shard_tiles(
            ax, score, packed, k=st.max_per_tile)
        overflow = (ax.psum(bins.overflow.reshape(1))[0]
                    + torch.clamp(n_cand - st.max_per_tile, min=0).sum())
        color, t_final, med = blend_lists(st, merged[t0:t1], pix_xy[t0:t1])
        color, t_final, med = (ax.all_gather(x) for x in (color, t_final,
                                                           med))
        if bg is None:
            bg = torch.zeros(colors.shape[-1], device=color.device)
        out = color + t_final[:, :, None] * bg[None, None, :]
        return dict(
            color=_tiles_to_image(out, nty, ntx, ts, camera.height,
                                  camera.width),
            depth=_tiles_to_image(med, nty, ntx, ts, camera.height,
                                  camera.width),
            final_t=_tiles_to_image(t_final, nty, ntx, ts, camera.height,
                                    camera.width),
            radii=prep.radius, overflow=overflow)

    return run


def fisher_diag_gaussian_sharded(mesh: Mesh, camera: Camera,
                                 settings: RenderSettings = RenderSettings(),
                                 grad_value: float = 1e-3,
                                 full_chain: bool = True):
    """Gaussian-axis sharded Fisher diagonal: the merge of
    `render_gaussian_sharded` carrying global Gaussian indices (table +
    rank n_local); each rank runs K3 on its tiles of the merged lists and
    scatters into an (n_local D, 4) accumulator, and a reduce-scatter
    returns each rank its own rows.  fn(means_w, scales, quats,
    opacities, colors, active, w2c), the N-axis inputs this rank's shard
    -> dict(H (n_local, 4), radii, visible)."""
    st = settings
    ax, _ntx, _nty, (t0, t1) = _tile_split(mesh, camera, st.tile_size)

    def run(means_w, scales, quats, opacities, colors, active, w2c):
        n_local = means_w.shape[0]
        packed, pix_xy, _nvalid, bins, prep = fisher_kernel_inputs(
            camera, w2c[None], means_w, scales, quats, opacities, colors,
            active=active, settings=st, full_chain=full_chain)
        packed, table, slot_valid = packed[0], bins.table[0], \
            bins.slot_valid[0]
        gidx = table + ax.index * n_local
        score = torch.where(slot_valid, -packed[..., 6],
                            torch.full_like(packed[..., 6], -torch.inf))
        valid, (merged, gidx_m), _n_cand = _merge_shard_tiles(
            ax, score, packed, gidx, k=st.max_per_tile)
        h_full = fisher_from_lists(
            camera, merged[None, t0:t1].contiguous(), pix_xy[t0:t1].contiguous(),
            valid[None, t0:t1], gidx_m[None, t0:t1], n_local * ax.size,
            st.chunk, grad_value)
        radii = prep.radius[0]
        return dict(H=ax.psum_scatter(h_full), radii=radii,
                    visible=radii > 0)

    return run


# -- episode-path factories ------------------------------------------------

def sharded_mapping_phase(mesh: Mesh, camera: Camera,
                          settings: RenderSettings, mc: MappingConfig):
    """The mapping event over 'data': fn(state, kf_colors, kf_depths,
    kf_w2cs, frame_choices (n_steps, F)) -> `_mapping_phase_impl`'s
    outputs, replicated.  Rank r takes columns [r F/D, (r+1) F/D) of every
    row (PartitionSpec(None, 'data')) and every rank bins every window
    frame; the gradients and loss are pmean'd after each backward, before
    the densify statistics and the replicated Adam step, so the update is
    the single-rank F-frame step up to float reduction order."""
    ax = mesh.axis("data")

    def run(state, kf_colors, kf_depths, kf_w2cs, frame_choices):
        return _mapping_phase_impl(state, kf_colors, kf_depths, kf_w2cs,
                                   frame_choices, camera, settings, mc,
                                   axis=ax)

    return run


def sharded_pose_scores(mesh: Mesh, camera: Camera, settings: RenderSettings,
                        full_chain: bool, grad_value: float):
    """EIG scores of a (ck, 4, 4) w2c chunk (ck a multiple of 'data'):
    fn(state, w2cs, h_inv, async_op=False) -> scores (ck,), each rank
    scoring its ck/D poses with K3 and the scores all-gathered; with
    async_op a `Pending` whose wait() gives them."""
    ax = mesh.axis("data")

    def run(state, w2cs, h_inv, async_op: bool = False):
        lo, hi = ax.shard(w2cs.shape[0])
        out = _fisher_batch(state, w2cs[lo:hi], camera, settings,
                            full_chain, grad_value)
        return ax.all_gather(torch.sum(out["H"] * h_inv[None], dim=(1, 2)),
                             async_op=async_op)

    return run


def sharded_fisher_hsum(mesh: Mesh, camera: Camera, settings: RenderSettings,
                        full_chain: bool, grad_value: float):
    """Σ over a (ck, 4, 4) keyframe-pose chunk of the Fisher diagonal:
    fn(state, w2cs, weights (ck,)) -> (capacity, 4), each rank summing
    its ck/D poses weighted by `weights` (0 on padding) and the partial
    sums psum'd."""
    ax = mesh.axis("data")

    def run(state, w2cs, weights):
        lo, hi = ax.shard(w2cs.shape[0])
        out = _fisher_batch(state, w2cs[lo:hi], camera, settings,
                            full_chain, grad_value)
        return ax.psum(torch.sum(out["H"] * weights[lo:hi, None, None],
                                 dim=0))

    return run


def sharded_path_eig(mesh: Mesh, camera: Camera, settings: RenderSettings,
                     vol_weighted: bool, grad_value: float):
    """Path EIG (engine/path_eval.path_eig_scores) with the P paths split
    over 'data': fn(state, h_train, acc_w2cs, acc_valid, lengths,
    final_eigs, h_reg_lambda, ppw, ptw, pew, gs_cnt) -> scores (P,).  The
    per-path accumulators stay on their rank; only the scores are
    all-gathered."""
    from ..engine.path_eval import path_eig_scores
    ax = mesh.axis("data")

    def run(state, h_train, acc_w2cs, acc_valid, lengths, final_eigs,
            h_reg_lambda, ppw, ptw, pew, gs_cnt):
        lo, hi = ax.shard(acc_w2cs.shape[0])
        return ax.all_gather(path_eig_scores(
            state, h_train, acc_w2cs[lo:hi], acc_valid[lo:hi],
            lengths[lo:hi], final_eigs[lo:hi], camera, settings,
            h_reg_lambda, ppw, ptw, pew, vol_weighted, gs_cnt, grad_value))

    return run


def full_train_step(mesh: Mesh, camera: Camera, settings: RenderSettings,
                    mc: MappingConfig):
    """One sharded training step of the dry run: the sharded mapping
    step, then the sharded candidate EIG.  fn(state, colors, depths, w2cs,
    cand_w2cs, h_train_inv) -> (state, loss, scores)."""
    step_fn = mapping_step_sharded(mesh, camera, settings, mc)

    def run(state, colors, depths, w2cs, cand_w2cs, h_train_inv):
        params = state.params()
        params, _opt, loss = step_fn(params, adam_init(params),
                                     state.n_active, colors, depths, w2cs)
        state = state.replace_params(params)
        scores = pose_eval_sharded(mesh, state, cand_w2cs, h_train_inv,
                                   camera, settings)
        return state, loss, scores

    return run
