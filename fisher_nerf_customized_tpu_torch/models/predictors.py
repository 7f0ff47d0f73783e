"""The occupancy predictor, its ensemble, and their weights in the JAX
package's format.

Counterpart of the JAX package's models/predictors.py (the reference's
map_predictor_model OccupancyPredictor and its trainer): a ResNetUNet
trained by cross-entropy with Adam as optax computes it (lr 1e-3, b1 0.9,
b2 0.999, eps 1e-8 outside the square root, eps_root 0), and an ensemble
of independently seeded members, each trained on its own bootstrap
subset drawn by numpy; its mean prediction and disagreement (variance)
drive UPEN.  The interface is the JAX package's: inputs NHWC (B, H, W, 3),
labels (B, H, W) class ids, predictions NHWC softmax.  The convolutions
run with TF32 off.

Weights carried across: `save` writes one member_{i}.pkl per member,
holding the flax parameter tree ({"params": {"ConvBlock_0": {"Conv_0":
{"kernel", "bias"}, ...}, ..., "Conv_0": ...}}) as numpy arrays with HWIO
kernels, exactly what the JAX package's PredictorEnsemble.save pickles;
`load` reads those files (the optimizer state is not saved, as there).
params_from_jax / params_to_jax map the tree onto the torch state dict
(OIHW kernels) and back.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..utils.precision import no_tf32
from .networks import ResNetUNet

_N_BLOCKS = 7


def _flax_key(name: str) -> tuple[str, str, str | None]:
    """A state-dict key -> (block, conv, leaf) of the flax tree; block is
    None for the head (the tree's top-level Conv_0)."""
    parts = name.split(".")
    leaf = "kernel" if parts[-1] == "weight" else "bias"
    if parts[0] == "head":
        return None, "Conv_0", leaf
    return f"ConvBlock_{parts[1]}", f"Conv_{parts[3]}", leaf


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The flax parameter tree of a JAX OccupancyPredictor ({"params":
    ...}, numpy or JAX arrays) as a ResNetUNet state dict: HWIO kernels
    become OIHW."""
    p = tree["params"]
    out = {}
    for name in _state_keys():
        block, conv, leaf = _flax_key(name)
        arr = np.array((p if block is None else p[block])[conv][leaf],
                       np.float32)
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def params_to_jax(state_dict) -> dict:
    """A ResNetUNet state dict as the flax parameter tree the JAX package
    pickles: numpy float32 arrays, HWIO kernels."""
    p: dict = {}
    for name, t in state_dict.items():
        block, conv, leaf = _flax_key(name)
        arr = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "kernel":
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        node = p if block is None else p.setdefault(block, {})
        node.setdefault(conv, {})[leaf] = arr
    return {"params": p}


def _state_keys() -> list[str]:
    keys = [f"blocks.{i}.convs.{j}.{leaf}" for i in range(_N_BLOCKS)
            for j in range(2) for leaf in ("weight", "bias")]
    return keys + ["head.weight", "head.bias"]


def _check_tree(tree, path: str):
    """Plain dicts of arrays all the way down, or a clear error (a flax
    FrozenDict would need flax to unpickle, and the port has none)."""
    def walk(node, where):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{where}/{k}")
        elif not isinstance(node, np.ndarray):
            raise TypeError(
                f"{path}: {where} is a {type(node).__name__}, not a dict or "
                f"a numpy array; save the ensemble with plain dicts of "
                f"numpy arrays (flax >= 0.8 model.init returns them; "
                f"flax.core.unfreeze a FrozenDict before pickling)")
    if not isinstance(tree, dict) or "params" not in tree:
        raise TypeError(f"{path}: expected a dict with 'params', got "
                        f"{type(tree).__name__}")
    walk(tree, "")


def cross_entropy_loss(logits, labels):
    """Mean cross-entropy of NHWC logits against (B, H, W) class ids."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).mean()


class OccupancyPredictor:
    """A ResNetUNet with its Adam state.  `generator` draws the initial
    weights (flax's initializers)."""

    LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8

    def __init__(self, generator: torch.Generator, grid_channels: int = 3,
                 base: int = 16, device="cuda"):
        self.device = torch.device(device)
        self.model = ResNetUNet(n_channel_out=grid_channels, base=base,
                                n_channel_in=grid_channels,
                                generator=generator).to(self.device)
        # Adam's moments and step count
        self.mu = [torch.zeros_like(p) for p in self.model.parameters()]
        self.nu = [torch.zeros_like(p) for p in self.model.parameters()]
        self.count = 0

    def logits(self, inputs):
        """NHWC inputs -> NHWC logits."""
        x = torch.as_tensor(np.asarray(inputs, np.float32)
                            if not isinstance(inputs, torch.Tensor)
                            else inputs, device=self.device).float()
        with no_tf32():
            out = self.model(x.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1)

    def train_step(self, inputs, labels) -> float:
        """One Adam step on the batch's cross-entropy; returns the loss
        before the step."""
        y = torch.as_tensor(labels, device=self.device)
        with no_tf32():
            loss = cross_entropy_loss(self.logits(inputs), y)
            grads = torch.autograd.grad(loss, list(self.model.parameters()))
        self._adam(grads)
        return float(loss.detach())

    @torch.no_grad()
    def _adam(self, grads):
        """optax.adam's update: moments, bias corrections in float32,
        mu_hat / (sqrt(nu_hat) + eps), times -lr."""
        self.count += 1
        b1 = torch.tensor(self.B1, dtype=torch.float32)
        b2 = torch.tensor(self.B2, dtype=torch.float32)
        bc1 = float(1 - b1 ** self.count)
        bc2 = float(1 - b2 ** self.count)
        for p, g, mu, nu in zip(self.model.parameters(), grads, self.mu,
                                self.nu):
            mu.copy_((1 - self.B1) * g + self.B1 * mu)
            nu.copy_((1 - self.B2) * (g * g) + self.B2 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            p.add_(-self.LR * upd)

    @torch.no_grad()
    def predict(self, inputs):
        """NHWC class probabilities."""
        return torch.softmax(self.logits(inputs), dim=-1)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(params_to_jax(self.model.state_dict()), f)

    def load(self, path: str):
        try:
            with open(path, "rb") as f:
                tree = pickle.load(f)
        except ModuleNotFoundError as e:
            raise TypeError(f"{path} holds objects of a module the port does "
                            f"not have ({e.name}); save plain dicts of numpy "
                            f"arrays") from e
        _check_tree(tree, path)
        sd = params_from_jax(tree)
        self.model.load_state_dict({k: v.to(self.device)
                                    for k, v in sd.items()})


def member_generator(seed: int, i: int) -> torch.Generator:
    """The generator of member i's initial weights."""
    state = np.random.SeedSequence([int(seed), int(i)]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


class PredictorEnsemble:
    """n_members independently seeded predictors; predict gives the mean,
    the variance (the disagreement UPEN explores by) and all members."""

    def __init__(self, n_members: int = 4, seed: int = 0, base: int = 16,
                 device="cuda"):
        self.members = [OccupancyPredictor(member_generator(seed, i),
                                           base=base, device=device)
                        for i in range(n_members)]

    def train(self, inputs: np.ndarray, labels: np.ndarray, epochs: int = 4,
              batch_size: int = 8, dataset_percentage: float = 1.0,
              seed: int = 0) -> list[float]:
        """Each member in turn on its bootstrap subset (each sample kept
        with probability dataset_percentage), epochs of shuffled batches;
        returns each member's last loss.  The draws are the JAX package's."""
        rng = np.random.default_rng(seed)
        n = len(inputs)
        losses = []
        for member in self.members:
            keep = rng.random(n) < dataset_percentage if \
                dataset_percentage < 1.0 else np.ones(n, bool)
            idx_all = np.nonzero(keep)[0]
            if len(idx_all) == 0:
                idx_all = np.arange(n)
            last = 0.0
            for _ep in range(epochs):
                order = rng.permutation(idx_all)
                for i in range(0, len(order), batch_size):
                    b = order[i:i + batch_size]
                    last = member.train_step(inputs[b], labels[b])
            losses.append(last)
        return losses

    @torch.no_grad()
    def predict(self, inputs):
        """(mean, var, all) over the members, NHWC tensors; all has the
        member axis first."""
        preds = torch.stack([m.predict(inputs) for m in self.members])
        return (preds.mean(dim=0), preds.var(dim=0, correction=0), preds)

    def save(self, dir_path: str):
        for i, m in enumerate(self.members):
            m.save(os.path.join(dir_path, f"member_{i}.pkl"))

    def load(self, dir_path: str):
        """Read member_{i}.pkl for every member; a missing file raises
        FileNotFoundError, as in the JAX package."""
        for i, m in enumerate(self.members):
            m.load(os.path.join(dir_path, f"member_{i}.pkl"))
