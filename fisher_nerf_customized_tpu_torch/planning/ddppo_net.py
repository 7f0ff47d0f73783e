"""DD-PPO pointgoal policy network (habitat's PointNavResNetPolicy).

Counterpart of the JAX package's planning/ddppo_net.py, as an nn.Module
tree whose state_dict keys are exactly that package's flat parameter
names, which are the habitat checkpoint's own
(``net.visual_encoder.backbone.layer1.0.convs.0.weight`` ...): a
checkpoint loads by name (`load_torch_checkpoint`), and so do the JAX
package's `init_params` arrays.

  * depth (N, H, W, 1) -> avg_pool(2) -> GroupNorm ResNet50 (base planes
    32, 16 groups, Bottleneck [3, 4, 6, 3]) -> 3x3 compression conv to
    ~2048 flat features (one-group GroupNorm, ReLU) -> Linear -> ReLU
    (visual_fc);
  * pointgoal (rho, phi) -> [rho, cos(-phi), sin(-phi)] -> Linear(3, 32);
  * the previous action -> Embedding(n_actions + 1, 32), index 0 at an
    episode's start (mask 0), else action + 1;
  * [visual | goal | previous action] -> a 2-layer LSTM (gates i|f|g|o,
    the state zeroed where mask is 0) -> the categorical head's logits
    over 4 actions and the value head.

The convolutions run under cuDNN and the matmuls under cuBLAS, with TF32
off.  `act` samples from an explicit torch.Generator (the JAX package's
jax.random.categorical draws cannot be reproduced), so two packages
agree on logits, values, the hidden state and the argmax.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

# habitat resnet50: Bottleneck(expansion 4), layers [3, 4, 6, 3],
# base_planes 32, ngroups 16 (= base_planes // 2)
_LAYERS = (3, 4, 6, 3)
_BASE_PLANES = 32
_NGROUPS = 16
_EXPANSION = 4
_EMBED = 32          # the goal and previous-action embedding widths
_FLAT_TARGET = 2048  # after_compression_flat_size


@contextlib.contextmanager
def _no_tf32():
    """cuDNN and cuBLAS in full f32 inside the block."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def compression_channels(input_hw: int) -> tuple[int, int]:
    """(compression channels, final spatial size) for a square depth
    input: avg_pool(2), then the backbone's 1/32, with the channels
    chosen so the flat size is ~2048 (habitat's ResNetEncoder sizing)."""
    final_spatial = max(int((input_hw // 2) * (1.0 / 32.0)), 1)
    n_ch = int(round(_FLAT_TARGET / (final_spatial ** 2)))
    return n_ch, final_spatial


class _Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        out = planes * _EXPANSION
        self.convs = nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, bias=False),
            nn.GroupNorm(_NGROUPS, planes), nn.ReLU(True),
            nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                      bias=False),
            nn.GroupNorm(_NGROUPS, planes), nn.ReLU(True),
            nn.Conv2d(planes, out, 1, bias=False),
            nn.GroupNorm(_NGROUPS, out))
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
                nn.GroupNorm(_NGROUPS, out))

    def forward(self, x):
        sc = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.convs(x) + sc)


class _Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv2d(1, _BASE_PLANES, 7, stride=2, padding=3, bias=False),
            nn.GroupNorm(_NGROUPS, _BASE_PLANES), nn.ReLU(True))
        inplanes = _BASE_PLANES
        for li, n_blocks in enumerate(_LAYERS):
            planes = _BASE_PLANES * (2 ** li)
            blocks = []
            for bi in range(n_blocks):
                blocks.append(_Bottleneck(inplanes, planes,
                                          2 if (li > 0 and bi == 0) else 1))
                inplanes = planes * _EXPANSION
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.out_planes = inplanes

    def forward(self, x):
        # torch pads the max pool with -inf, as the JAX package's does
        x = F.max_pool2d(self.conv1(x), 3, stride=2, padding=1)
        for li in range(len(_LAYERS)):
            x = getattr(self, f"layer{li + 1}")(x)
        return x


class _VisualEncoder(nn.Module):
    def __init__(self, input_hw: int):
        super().__init__()
        self.backbone = _Backbone()
        n_comp, _ = compression_channels(input_hw)
        self.compression = nn.Sequential(
            nn.Conv2d(self.backbone.out_planes, n_comp, 3, padding=1,
                      bias=False),
            nn.GroupNorm(1, n_comp), nn.ReLU(True))

    def forward(self, depth_nchw):
        return self.compression(self.backbone(F.avg_pool2d(depth_nchw, 2)))


class _StateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.rnn = nn.LSTM(input_size, hidden_size, num_layers=2)


class _Net(nn.Module):
    def __init__(self, hidden_size: int, input_hw: int, n_actions: int):
        super().__init__()
        self.visual_encoder = _VisualEncoder(input_hw)
        n_comp, fs = compression_channels(input_hw)
        self.visual_fc = nn.Sequential(nn.Flatten(),
                                       nn.Linear(n_comp * fs * fs,
                                                 hidden_size),
                                       nn.ReLU(True))
        self.tgt_embeding = nn.Linear(3, _EMBED)
        self.prev_action_embedding = nn.Embedding(n_actions + 1, _EMBED)
        self.state_encoder = _StateEncoder(hidden_size + 2 * _EMBED,
                                           hidden_size)


class _Linear(nn.Module):
    """A head holding one Linear under the attribute name habitat's
    checkpoints use."""

    def __init__(self, attr: str, in_f: int, out_f: int):
        super().__init__()
        setattr(self, attr, nn.Linear(in_f, out_f))


class DdppoNet(nn.Module):
    """The actor-critic; `forward` is one policy step."""

    def __init__(self, hidden_size: int = 512, input_hw: int = 256,
                 n_actions: int = 4):
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.net = _Net(self.hidden_size, input_hw, n_actions)
        self.action_distribution = _Linear("linear", self.hidden_size,
                                           n_actions)
        self.critic = _Linear("fc", self.hidden_size, 1)

    @torch.no_grad()
    def forward(self, depth, pointgoal, hidden, prev_action, mask):
        """depth (N, H, W, 1) in [0, 1]; pointgoal (N, 2) (rho, phi);
        hidden (2, L, N, H) stacked (h, c); prev_action (N,) int; mask
        (N,) 0. at an episode's start, else 1.  Returns (logits (N, A),
        value (N,), new hidden)."""
        n = depth.shape[0]
        net = self.net
        with _no_tf32():
            vis = net.visual_fc(net.visual_encoder(depth.permute(0, 3, 1, 2)))
            rho, phi = pointgoal[:, 0], pointgoal[:, 1]
            tgt = net.tgt_embeding(torch.stack(
                [rho, torch.cos(-phi), torch.sin(-phi)], dim=-1))
            idx = ((prev_action.float() + 1.0) * mask).long()
            prev = net.prev_action_embedding(idx)
            x = torch.cat([vis, tgt, prev], dim=-1)
            m = mask.reshape(1, n, 1)
            out, (h, c) = net.state_encoder.rnn(
                x[None], (hidden[0] * m, hidden[1] * m))
            feats = out[0]
            logits = self.action_distribution.linear(feats)
            value = self.critic.fc(feats)[:, 0]
        return logits, value, torch.stack([h, c])


def act(net: DdppoNet, depth, pointgoal, hidden, prev_action, mask,
        generator: torch.Generator | None = None,
        deterministic: bool = False):
    """One step: (action (N,) int32, value (N,), new hidden); the action
    is the argmax, or a draw from softmax(logits) by `generator`."""
    logits, value, new_hidden = net(depth, pointgoal, hidden, prev_action,
                                    mask)
    if deterministic:
        action = torch.argmax(logits, dim=-1)
    else:
        action = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                   generator=generator)[:, 0]
    return action.to(torch.int32), value, new_hidden


def param_shapes(hidden_size: int = 512, input_hw: int = 256,
                 n_actions: int = 4) -> dict[str, tuple[int, ...]]:
    """The flat, checkpoint-named parameter spec of the actor-critic."""
    shapes: dict[str, tuple[int, ...]] = {}
    bb = "net.visual_encoder.backbone"
    shapes[f"{bb}.conv1.0.weight"] = (_BASE_PLANES, 1, 7, 7)
    shapes[f"{bb}.conv1.1.weight"] = (_BASE_PLANES,)
    shapes[f"{bb}.conv1.1.bias"] = (_BASE_PLANES,)
    inplanes = _BASE_PLANES
    for li, n_blocks in enumerate(_LAYERS):
        planes = _BASE_PLANES * (2 ** li)
        for bi in range(n_blocks):
            pre = f"{bb}.layer{li + 1}.{bi}"
            shapes[f"{pre}.convs.0.weight"] = (planes, inplanes, 1, 1)
            shapes[f"{pre}.convs.1.weight"] = (planes,)
            shapes[f"{pre}.convs.1.bias"] = (planes,)
            shapes[f"{pre}.convs.3.weight"] = (planes, planes, 3, 3)
            shapes[f"{pre}.convs.4.weight"] = (planes,)
            shapes[f"{pre}.convs.4.bias"] = (planes,)
            out_planes = planes * _EXPANSION
            shapes[f"{pre}.convs.6.weight"] = (out_planes, planes, 1, 1)
            shapes[f"{pre}.convs.7.weight"] = (out_planes,)
            shapes[f"{pre}.convs.7.bias"] = (out_planes,)
            stride = 2 if (li > 0 and bi == 0) else 1
            if stride != 1 or inplanes != out_planes:
                shapes[f"{pre}.downsample.0.weight"] = \
                    (out_planes, inplanes, 1, 1)
                shapes[f"{pre}.downsample.1.weight"] = (out_planes,)
                shapes[f"{pre}.downsample.1.bias"] = (out_planes,)
            inplanes = out_planes
    n_comp, final_spatial = compression_channels(input_hw)
    ve = "net.visual_encoder.compression"
    shapes[f"{ve}.0.weight"] = (n_comp, inplanes, 3, 3)
    shapes[f"{ve}.1.weight"] = (n_comp,)
    shapes[f"{ve}.1.bias"] = (n_comp,)
    flat = n_comp * final_spatial * final_spatial
    shapes["net.visual_fc.1.weight"] = (hidden_size, flat)
    shapes["net.visual_fc.1.bias"] = (hidden_size,)
    shapes["net.tgt_embeding.weight"] = (_EMBED, 3)
    shapes["net.tgt_embeding.bias"] = (_EMBED,)
    shapes["net.prev_action_embedding.weight"] = (n_actions + 1, _EMBED)
    rnn_in = hidden_size + 2 * _EMBED
    for layer in range(2):
        in_sz = rnn_in if layer == 0 else hidden_size
        shapes[f"net.state_encoder.rnn.weight_ih_l{layer}"] = \
            (4 * hidden_size, in_sz)
        shapes[f"net.state_encoder.rnn.weight_hh_l{layer}"] = \
            (4 * hidden_size, hidden_size)
        shapes[f"net.state_encoder.rnn.bias_ih_l{layer}"] = (4 * hidden_size,)
        shapes[f"net.state_encoder.rnn.bias_hh_l{layer}"] = (4 * hidden_size,)
    shapes["action_distribution.linear.weight"] = (n_actions, hidden_size)
    shapes["action_distribution.linear.bias"] = (n_actions,)
    shapes["critic.fc.weight"] = (1, hidden_size)
    shapes["critic.fc.bias"] = (1,)
    return shapes


def init_params(rng: np.random.Generator | int = 0, hidden_size: int = 512,
                input_hw: int = 256,
                n_actions: int = 4) -> dict[str, np.ndarray]:
    """Random fan-in weights with the checkpoint's shapes, as float32
    numpy arrays drawn in the JAX package's order from a numpy generator
    (so both packages hold the same numbers): norm scales 1, biases 0."""
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    params = {}
    for name, shp in param_shapes(hidden_size, input_hw, n_actions).items():
        if name.endswith(".bias") or ".1.weight" in name \
                or ".4.weight" in name or ".7.weight" in name \
                or "downsample.1" in name or "conv1.1" in name \
                or "compression.1" in name:
            val = np.ones(shp, np.float32) if name.endswith("weight") \
                else np.zeros(shp, np.float32)
        else:
            fan_in = int(np.prod(shp[1:])) if len(shp) > 1 else shp[0]
            std = 1.0 / math.sqrt(max(fan_in, 1))
            val = rng.normal(0.0, std, size=shp).astype(np.float32)
        params[name] = val
    return params


def from_params(params: dict, hidden_size: int, input_hw: int = 256,
                n_actions: int = 4, device="cuda") -> DdppoNet:
    """A DdppoNet on `device` holding the named arrays (numpy arrays or
    tensors; every name of param_shapes, with its shape)."""
    net = DdppoNet(hidden_size, input_hw, n_actions)
    net.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                         for k, v in params.items()})
    return net.to(device).eval()


def zero_state(hidden_size: int, batch: int = 1, num_layers: int = 2,
               device="cuda") -> torch.Tensor:
    return torch.zeros((2, num_layers, batch, hidden_size), device=device)


def load_torch_checkpoint(path: str, input_hw: int = 256, device="cuda"):
    """A habitat DD-PPO checkpoint -> (DdppoNet on `device`, hidden
    size): the `actor_critic.` prefix stripped, the hidden size from
    config.RL.PPO.hidden_size or model_args.hidden_size (else 512), each
    parameter checked by name and shape."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "config" in ckpt and hasattr(ckpt["config"], "RL"):
        hidden_size = ckpt["config"].RL.PPO.hidden_size
    elif "model_args" in ckpt:
        hidden_size = ckpt["model_args"].hidden_size
    else:
        hidden_size = 512
    sd = {k[len("actor_critic."):]: v
          for k, v in ckpt["state_dict"].items() if "actor_critic" in k}
    params = {}
    for name, shp in param_shapes(int(hidden_size), input_hw).items():
        if name not in sd:
            raise KeyError(f"checkpoint missing parameter {name}")
        if tuple(sd[name].shape) != tuple(shp):
            raise ValueError(f"{name}: checkpoint shape "
                             f"{tuple(sd[name].shape)} != expected "
                             f"{tuple(shp)}")
        params[name] = sd[name].detach().float()
    net = DdppoNet(int(hidden_size), input_hw)
    net.load_state_dict(params)
    return net.to(device).eval(), int(hidden_size)
