"""The numbers that the checks compare, each a share of the reference's
own size, so that one limit holds at every image size and map."""
from __future__ import annotations

import numpy as np
import torch


def rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref|| over all elements, in float64."""
    got = torch.as_tensor(got).double().reshape(-1)
    ref = torch.as_tensor(ref).double().reshape(-1).to(got.device)
    return float(torch.linalg.norm(got - ref)
                 / torch.clamp(torch.linalg.norm(ref), min=1e-30))


def worst_leaf(got: dict, ref: dict) -> tuple[float, str]:
    """(largest rel_l2 over the leaves, its leaf)."""
    gaps = {k: rel_l2(got[k], ref[k]) for k in ref}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def worst_norm_gap(got: dict, ref: dict) -> tuple[float, str]:
    """(largest | ||got|| - ||ref|| | / ||ref|| over the leaves, its leaf):
    a change that never happened reads 1, one made twice reads 1."""
    gaps = {}
    for k in ref:
        n_ref = float(torch.linalg.norm(torch.as_tensor(ref[k]).double()))
        n_got = float(torch.linalg.norm(torch.as_tensor(got[k]).double()))
        gaps[k] = abs(n_got - n_ref) / max(n_ref, 1e-30)
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def rel_rms(got, ref) -> float:
    """rms(got - ref) / rms(ref) of two numpy vectors, in float64."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2))
                 / max(np.sqrt(np.mean(ref ** 2)), 1e-300))
