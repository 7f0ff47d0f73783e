"""Fixed-capacity Gaussian map state.

Slots [0, n_active) are live (compacted invariant) and the rest are
free; `add_gaussians` writes masked candidates into the free tail and
drops what does not fit (the SLAM object grows capacity when a drop is
reported).  `state_from_numpy` / `state_to_numpy` carry a map between
this port and the JAX package (whose GaussianSLAM.save writes the same
arrays).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.geometry import quat_to_rotmat

PARAM_KEYS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities",
              "log_scales")


class GaussianState(NamedTuple):
    means3D: torch.Tensor           # (C, 3) world frame
    rgb_colors: torch.Tensor        # (C, 3)
    unnorm_rotations: torch.Tensor  # (C, 4) wxyz
    logit_opacities: torch.Tensor   # (C, 1)
    log_scales: torch.Tensor        # (C, 3)
    timestep: torch.Tensor          # (C,)  frame index each slot was born
    n_active: torch.Tensor          # ()    int32, on the state's device

    @property
    def capacity(self) -> int:
        return self.means3D.shape[0]

    @property
    def active(self) -> torch.Tensor:
        return torch.arange(self.capacity,
                            device=self.means3D.device) < self.n_active

    def params(self) -> dict:
        return {k: getattr(self, k) for k in PARAM_KEYS}

    def replace_params(self, params: dict) -> "GaussianState":
        return self._replace(**params)


def empty_state(capacity: int, device="cuda") -> GaussianState:
    rot = torch.zeros(capacity, 4, device=device)
    rot[:, 0] = 1.0
    return GaussianState(
        means3D=torch.zeros(capacity, 3, device=device),
        rgb_colors=torch.zeros(capacity, 3, device=device),
        unnorm_rotations=rot,
        logit_opacities=torch.zeros(capacity, 1, device=device),
        log_scales=torch.full((capacity, 3), -10.0, device=device),
        timestep=torch.zeros(capacity, device=device),
        n_active=torch.zeros((), dtype=torch.int32, device=device),
    )


def grow_state(state: GaussianState, new_capacity: int) -> GaussianState:
    """Capacity growth: append empty slots."""
    pad = new_capacity - state.capacity
    if pad < 0:
        raise ValueError(f"cannot shrink capacity {state.capacity} -> "
                         f"{new_capacity}")
    fresh = empty_state(pad, device=state.means3D.device)
    cat = {k: torch.cat([getattr(state, k), getattr(fresh, k)])
           for k in PARAM_KEYS + ("timestep",)}
    return state._replace(**cat)


def add_gaussians(state: GaussianState, new_params: dict, mask,
                  time_idx) -> tuple[GaussianState, torch.Tensor]:
    """Write masked candidate Gaussians into the free tail.

    new_params: dict of (M, d) candidate arrays (keys = PARAM_KEYS);
    mask: (M,) bool.  Candidates past the capacity are dropped: they are
    masked out rather than sent to an out-of-range index (the JAX package
    scatters them to index `cap` with mode="drop").  Returns
    (new_state, dropped_count)."""
    cap = state.capacity
    rank = torch.cumsum(mask.to(torch.int32), dim=0) - 1
    dest = state.n_active + rank
    in_range = mask & (dest < cap)
    sel = dest[in_range].long()
    updates = {}
    for k in PARAM_KEYS:
        arr = getattr(state, k).clone()
        arr[sel] = new_params[k][in_range].to(arr.dtype)
        updates[k] = arr
    ts = state.timestep.clone()
    ts[sel] = float(time_idx)
    n_added = in_range.sum(dtype=torch.int32)
    dropped = mask.sum(dtype=torch.int32) - n_added
    new_state = state._replace(timestep=ts, n_active=state.n_active + n_added,
                               **updates)
    return new_state, dropped


def prune_compact(state: GaussianState, keep) -> tuple[GaussianState,
                                                       torch.Tensor]:
    """Remove active slots where ~keep and re-compact: a stable partition,
    kept active slots first, then everything else in order.  keep (C,)
    bool; entries past n_active are ignored.  Returns the compacted state
    and the permutation (for optimizer moments, `adam_permute`)."""
    keep = keep & state.active
    order = torch.argsort(torch.where(keep, 0, 1), stable=True)
    updates = {k: getattr(state, k)[order] for k in PARAM_KEYS}
    new_state = state._replace(timestep=state.timestep[order],
                               n_active=keep.sum(dtype=torch.int32),
                               **updates)
    return new_state, order


def gs_densify(state: GaussianState, grad_accum, denom, noise,
               grad_thresh: float = 0.0002, split_scale: float = 0.05,
               num_to_split_into: int = 2,
               removal_opacity_threshold: float = 0.005,
               time_idx: float = 0.0) -> GaussianState:
    """Gaussian-splatting gradient densification: clone the small
    high-gradient splats, split the large ones into n children, then drop
    the split sources and the low-opacity slots with one prune_compact.

    grad_accum / denom (C,): the summed |dL/d means3D| and its count of
    nonzero steps from the mapping phase; a slot's gradient is their
    ratio.  noise (n, C, 3): child i's standard normal draw, scaled by the
    parent's scales and rotated by its rotation to offset the child's
    mean; a child's log-scale is its parent's less log(0.8 n).  Clones
    and children are written into the free tail (the caller makes room:
    past the capacity they are dropped)."""
    grads = torch.where(denom > 0, grad_accum / torch.clamp(denom, min=1),
                        torch.zeros_like(grad_accum))
    max_scale = torch.exp(state.log_scales).amax(dim=1)
    high_grad = state.active & (grads >= grad_thresh)
    to_clone = high_grad & (max_scale <= split_scale)
    to_split = high_grad & (max_scale > split_scale)

    params = state.params()
    n = num_to_split_into
    state, _dropped = add_gaussians(state, params, to_clone, time_idx)
    R = quat_to_rotmat(params["unnorm_rotations"])
    stds = torch.exp(params["log_scales"])
    for i in range(n):
        # R @ (noise * stds), written out (no matmul: f32 on every device)
        offset = (R * (noise[i] * stds)[:, None, :]).sum(dim=-1)
        child = dict(params, means3D=params["means3D"] + offset,
                     log_scales=params["log_scales"] - float(
                         torch.log(torch.tensor(0.8 * n))))
        state, _dropped = add_gaussians(state, child, to_split, time_idx)

    opac = torch.sigmoid(state.logit_opacities[:, 0])
    keep = torch.ones(state.capacity, dtype=torch.bool,
                      device=to_split.device)
    keep[:to_split.shape[0]] = ~to_split
    keep = keep & (opac >= removal_opacity_threshold)
    state, _order = prune_compact(state, keep)
    return state


class AdamState(NamedTuple):
    mu: dict              # first moments, keyed like the params
    nu: dict              # second moments
    count: int            # steps taken


def adam_init(params: dict) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     count=0)


@torch.no_grad()
def adam_step(opt: AdamState, params: dict, grads: dict, lrs: dict,
              b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-15) -> tuple[dict, AdamState]:
    """One Adam update with a learning rate per parameter group (a group
    with lr 0.0 is frozen).  The arithmetic is the JAX package's,
    (mu / bc1) / (sqrt(nu / bc2) + eps), in f32 with f32 bias corrections;
    torch.optim.Adam rounds differently.  Returns new tensors."""
    count = opt.count + 1
    t = torch.tensor(float(count))
    bc1 = float(1.0 - torch.tensor(b1) ** t)
    bc2 = float(1.0 - torch.tensor(b2) ** t)
    new_params, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu = b1 * opt.mu[k] + (1 - b1) * g
        nu = b2 * opt.nu[k] + (1 - b2) * (g * g)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        new_params[k] = p - lrs[k] * update
        new_mu[k], new_nu[k] = mu, nu
    return new_params, AdamState(mu=new_mu, nu=new_nu, count=count)


def adam_permute(opt: AdamState, order) -> AdamState:
    """Permute moment slots after prune_compact."""
    return AdamState(mu={k: v[order] for k, v in opt.mu.items()},
                     nu={k: v[order] for k, v in opt.nu.items()},
                     count=opt.count)


def adam_reset_slots(opt: AdamState, dest) -> AdamState:
    """Zero the moments of freshly added slots `dest` (int indices; those
    past the capacity are dropped)."""
    def zero_at(v):
        v = v.clone()
        v[dest[(dest >= 0) & (dest < v.shape[0])].long()] = 0
        return v
    return AdamState(mu={k: zero_at(v) for k, v in opt.mu.items()},
                     nu={k: zero_at(v) for k, v in opt.nu.items()},
                     count=opt.count)


def state_from_numpy(d: dict, capacity: int, device="cuda"):
    """A GaussianState from numpy arrays (PARAM_KEYS, n_active and,
    optionally, timestep: as the JAX package's GaussianState or its
    checkpoint npz holds them).  Only the first n_active rows are read;
    the rest of the capacity is empty.  Inputs of any float type are cast
    to float32.  Stacked per-scene states (n_active of shape (S,), every
    array with a leading S, as the JAX package's multi-scene step takes
    them) give a list of S GaussianStates."""
    if np.ndim(d["n_active"]) == 1:
        return [state_from_numpy({k: v[i] for k, v in d.items()}, capacity,
                                 device=device)
                for i in range(len(d["n_active"]))]
    n = int(np.asarray(d["n_active"]))
    if n > capacity:
        raise ValueError(f"{n} active Gaussians exceed capacity {capacity}")
    state = empty_state(capacity, device=device)
    upd = {}
    for k in PARAM_KEYS + ("timestep",):
        if k not in d:
            continue
        arr = getattr(state, k).clone()
        src = np.array(d[k], np.float32)[:n]
        arr[:n] = torch.from_numpy(src.reshape(arr[:n].shape)).to(device)
        upd[k] = arr
    return state._replace(n_active=torch.tensor(n, dtype=torch.int32,
                                                device=device), **upd)


def state_to_numpy(state: GaussianState) -> dict:
    """numpy float32 arrays of every field (full capacity) + n_active."""
    out = {k: getattr(state, k).detach().cpu().numpy()
           for k in PARAM_KEYS + ("timestep",)}
    out["n_active"] = np.int32(int(state.n_active))
    return out
