"""The occupancy-prediction UNet of UPEN.

Counterpart of the JAX package's models/networks.py (flax; the
reference's ResNetUNet with a compact conv encoder in place of the
pretrained ResNet18): 3x3 SAME conv blocks at base, 2 base, 4 base and
8 base features, 2x2 max pooling down, nearest x2 upsampling (each cell
repeated) with the skip concatenated after the upsampled features, and a
1x1 head giving the class logits.  torch runs it in NCHW with OIHW
kernels; models/predictors.py keeps the JAX package's NHWC interface
and maps the flax parameter tree (HWIO kernels) onto these modules.

Initialization follows flax's defaults, drawn from an explicit
torch.Generator: each kernel lecun_normal (a normal truncated at two
standard deviations, scaled to variance 1 / fan_in), each bias zero.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2], by which
# flax's variance_scaling divides its scale
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax's lecun_normal on an OIHW kernel (fan_in = I * H * W)."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        weight.mul_(std)
    return weight


def _conv(c_in: int, c_out: int, k: int, generator) -> nn.Conv2d:
    # made on the meta device: torch's own init would draw from the
    # global generator
    conv = nn.Conv2d(c_in, c_out, k, padding=k // 2,
                     device="meta").to_empty(device="cpu")
    lecun_normal_(conv.weight, generator)
    nn.init.zeros_(conv.bias)
    return conv


class ConvBlock(nn.Module):
    """Two 3x3 SAME convs, each followed by a ReLU."""

    def __init__(self, c_in: int, features: int, generator=None):
        super().__init__()
        self.convs = nn.ModuleList([_conv(c_in, features, 3, generator),
                                    _conv(features, features, 3, generator)])

    def forward(self, x):
        for conv in self.convs:
            x = F.relu(conv(x))
        return x


def _up(z):
    """Nearest x2 upsampling: each cell repeated along H and W."""
    return z.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class ResNetUNet(nn.Module):
    """UNet over NCHW ego grids, n_channel_out class logits.  blocks[0..6]
    are flax's ConvBlock_0..6 (encoder e1, e2, e3, bottleneck, decoder u3,
    u2, u1), head its top-level Conv_0."""

    def __init__(self, n_channel_out: int = 3, base: int = 32,
                 n_channel_in: int = 3, generator=None):
        super().__init__()
        b = base
        ins = [n_channel_in, b, 2 * b, 4 * b, 8 * b + 4 * b, 4 * b + 2 * b,
               2 * b + b]
        outs = [b, 2 * b, 4 * b, 8 * b, 4 * b, 2 * b, b]
        self.blocks = nn.ModuleList([ConvBlock(i, o, generator)
                                     for i, o in zip(ins, outs)])
        self.head = _conv(b, n_channel_out, 1, generator)

    def forward(self, x):
        e1 = self.blocks[0](x)
        e2 = self.blocks[1](F.max_pool2d(e1, 2))
        e3 = self.blocks[2](F.max_pool2d(e2, 2))
        b = self.blocks[3](F.max_pool2d(e3, 2))
        u3 = self.blocks[4](torch.cat([_up(b), e3], dim=1))
        u2 = self.blocks[5](torch.cat([_up(u3), e2], dim=1))
        u1 = self.blocks[6](torch.cat([_up(u2), e1], dim=1))
        return self.head(u1)
