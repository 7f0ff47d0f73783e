"""The pretrained perceptual networks: LPIPS(AlexNet) and the DINOv2 ViT
patch descriptors.  The JAX package's models/perceptual.py.

Both are nn.Modules whose state_dict keys are the checkpoints' own names
(torchvision's ``features.{0,3,6,8,10}.*`` and lpips' ``lin{0..4}.model.1
.weight``; DINOv2's ``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``register_tokens``, ``blocks.<i>.*``, ``norm``), so a checkpoint loads
by name.  `from_flat(params)` builds a module from the JAX package's flat
numpy parameter dict (the widths read off the arrays) and `to_flat()`
gives it back: the weights cross between the packages that way.

LPIPS(alex) (lpips v0.1): x in [0, 1] -> 2x - 1 -> the ScalingLayer
(x - shift) / scale -> alexnet.features, tapped after the ReLU of each of
its five convolutions (a 3/2 VALID max pool before the 2nd and 3rd) ->
unit norm over channels (eps 1e-10 inside the sqrt) -> squared
difference -> each tap's 1x1 "lin" conv -> spatial mean -> the sum over
the taps.  It takes (P, H, W, 3) stacks and returns (P,).

The ViT (DINOv2 ViT-*/14): the ImageNet normalisation -> the 14x14
stride-14 patch conv -> [cls | patches] + the position embedding, its
grid resized bicubically as jax.image.resize does (`_resize_matrix`) ->
[cls | registers | patches] -> pre-LN blocks (attention written out as
q kᵀ / sqrt(hd), softmax, x v; LayerScale; the MLP with exact GELU) ->
the final LayerNorm -> the patch tokens.  LayerNorm (eps 1e-6) and every
product keep the JAX package's order of operations.

Every convolution and matmul runs with TF32 off (utils/precision.py), on
cuDNN and cuBLAS on the card.  No weights are in the repository:
`--lpips_weights` and `--dino_weights` name the torch checkpoints.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import no_tf32

# ---------------------------------------------------------------------------
# LPIPS (AlexNet)
# ---------------------------------------------------------------------------

# torchvision alexnet.features conv indices and their (kernel, stride,
# pad); LPIPS taps the ReLU after each.  A max-pool(3, 2) precedes convs 3
# and 6 (features indices 2 and 5).
_ALEX_CONVS = ((0, 11, 4, 2), (3, 5, 1, 2), (6, 3, 1, 1),
               (8, 3, 1, 1), (10, 3, 1, 1))
_POOL_BEFORE = {3, 6}
ALEX_WIDTHS = (64, 192, 384, 256, 256)

# lpips.ScalingLayer buffers (the same for every LPIPS net)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _conv(x, conv: nn.Conv2d, stride=1, padding=0):
    """conv2d, then the bias added as the JAX package adds it."""
    y = F.conv2d(x, conv.weight, None, stride, padding)
    return y if conv.bias is None else y + conv.bias[None, :, None, None]


class _NetLin(nn.Module):
    """lpips' NetLinLayer: (Dropout, 1x1 conv without bias); the dropout
    is the identity in evaluation."""

    def __init__(self, chn_in: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(chn_in, 1, 1, bias=False))


class LPIPSAlex(nn.Module):
    """LPIPS(alex) distance of image pairs: forward(img1, img2) with
    (P, H, W, 3) stacks in [0, 1] -> (P,)."""

    def __init__(self, widths=ALEX_WIDTHS):
        super().__init__()
        c = widths
        # torchvision's alexnet.features up to its last ReLU
        self.features = nn.Sequential(
            nn.Conv2d(3, c[0], 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(c[0], c[1], 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(c[1], c[2], 3, 1, 1), nn.ReLU(),
            nn.Conv2d(c[2], c[3], 3, 1, 1), nn.ReLU(),
            nn.Conv2d(c[3], c[4], 3, 1, 1), nn.ReLU())
        for i, w in enumerate(widths):
            setattr(self, f"lin{i}", _NetLin(w))
        self.register_buffer("shift", torch.from_numpy(_SHIFT),
                             persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE),
                             persistent=False)

    @classmethod
    def from_flat(cls, params: dict) -> "LPIPSAlex":
        """A module holding the JAX package's flat parameter dict."""
        widths = tuple(int(np.shape(params[f"features.{i}.weight"])[0])
                       for i, *_ in _ALEX_CONVS)
        net = cls(widths)
        net.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                             for k, v in params.items()})
        return net.eval()

    def to_flat(self) -> dict:
        return {k: v.detach().cpu().numpy() for k, v in
                self.state_dict().items()}

    def _taps(self, x):
        feats = []
        for idx, _k, s, p in _ALEX_CONVS:
            if idx in _POOL_BEFORE:
                x = F.max_pool2d(x, 3, 2)
            x = torch.relu(_conv(x, self.features[idx], s, p))
            feats.append(x)
        return feats

    def _prep(self, im):
        x = im.float().permute(0, 3, 1, 2) * 2.0 - 1.0
        return ((x - self.shift[None, :, None, None])
                / self.scale[None, :, None, None])

    def forward(self, img1, img2):
        with no_tf32(), torch.no_grad():
            f1 = self._taps(self._prep(img1))
            f2 = self._taps(self._prep(img2))
            total = 0.0
            for i, (a, b) in enumerate(zip(f1, f2)):
                d = (_unit_norm_ch(a) - _unit_norm_ch(b)) ** 2
                lin = getattr(self, f"lin{i}").model[1]
                total = total + torch.mean(_conv(d, lin), dim=(1, 2, 3))
        return total


def _unit_norm_ch(x, eps=1e-10):
    """lpips.normalize_tensor: x / sqrt(sum over channels x² + eps)."""
    return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)


def load_torch_lpips(path: str, alexnet_path: str | None = None) -> dict:
    """LPIPS weights as the flat numpy dict `LPIPSAlex.from_flat` takes:
    one checkpoint with the backbone and the lin weights (a full
    lpips.LPIPS state_dict, whose ``net.sliceK.J.*`` names become
    ``features.J.*``), or the distributed lin-only
    ``lpips/weights/v0.1/alex.pth`` plus torchvision's ``alexnet-owt``
    checkpoint as `alexnet_path`.  The ScalingLayer's buffers are
    dropped (constants here)."""
    out = {}

    def ingest(sd):
        for k, v in sd.items():
            arr = np.asarray(v.detach().cpu().numpy(), np.float32)
            if k.startswith("net.slice"):
                k = "features." + k.split(".", 2)[2]
            if k.startswith("scaling_layer."):
                continue
            out[k] = arr

    ingest(torch.load(path, map_location="cpu"))
    if alexnet_path is not None:
        ingest(torch.load(alexnet_path, map_location="cpu"))
    missing = [k for k in ("features.0.weight", "lin0.model.1.weight")
               if k not in out]
    if missing:
        raise ValueError(f"LPIPS checkpoint missing keys: {missing}")
    return out


# ---------------------------------------------------------------------------
# ViT patch descriptors (DINOv2)
# ---------------------------------------------------------------------------

# the ImageNet normalisation of DINOv2's preprocessing
_IN_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IN_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _keys_cubic(x):
    """Keys' cubic kernel with a = -0.5 (jax.image's CUBIC)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=32)
def _resize_matrix_on(n_in: int, n_out: int, device: str) -> torch.Tensor:
    """_resize_matrix as a tensor on `device`, uploaded once."""
    return torch.as_tensor(_resize_matrix(n_in, n_out), device=device)


@functools.lru_cache(maxsize=32)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of jax.image.resize(..., "bicubic")
    along one axis (jax.image.scale_and_translate's compute_weight_mat
    with antialias, translation 0): half-pixel centres, the kernel widened
    by the shrink factor when downscaling, each output's weights divided
    by their sum, and outputs whose centre falls outside the input
    zeroed.  Built in float64."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) \
        / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def interp_pos_embed(pos, gh: int, gw: int):
    """pos (1, 1 + g0², D) -> (1 + gh gw, D): the patch grid resized
    bicubically as jax.image.resize does, each axis whose size changes
    by one product with its `_resize_matrix`."""
    cls, patch = pos[0, :1], pos[0, 1:]
    g0 = int(round(float(np.sqrt(patch.shape[0]))))
    d = patch.shape[-1]
    if (g0, g0) != (gh, gw):
        grid = patch.reshape(g0, g0, d)
        if gh != g0:
            wh = _resize_matrix_on(g0, gh, str(pos.device))
            grid = torch.einsum("hwd,hi->iwd", grid, wh)
        if gw != g0:
            ww = _resize_matrix_on(g0, gw, str(pos.device))
            grid = torch.einsum("hwd,wj->hjd", grid, ww)
        patch = grid.reshape(gh * gw, d)
    return torch.cat([cls, patch], dim=0)


class _LayerNorm(nn.Module):
    """LayerNorm as the JAX package writes it: (x - mu) rsqrt(var + eps)
    w + b, var the mean of the squared deviations."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x):
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


def _linear(x, lin: nn.Linear):
    y = x @ lin.weight.T
    return y if lin.bias is None else y + lin.bias


class _LayerScale(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(d))


class _Attention(nn.Module):
    def __init__(self, d: int, num_heads: int, bias: bool):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d, bias=bias)
        self.proj = nn.Linear(d, d, bias=bias)
        self.num_heads = num_heads

    def forward(self, x):
        b, t, d = x.shape
        hd = d // self.num_heads
        q, k, v = torch.split(_linear(x, self.qkv), d, dim=-1)
        heads = lambda z: z.reshape(b, t, self.num_heads, hd).transpose(1, 2)
        q, k, v = heads(q), heads(k), heads(v)
        # sqrt(hd) rounded to f32 is the JAX package's f32 sqrt (both
        # correctly rounded)
        a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        o = (a @ v).transpose(1, 2).reshape(b, t, d)
        return _linear(o, self.proj)


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int, bias: bool):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden, bias=bias)
        self.fc2 = nn.Linear(hidden, d, bias=bias)

    def forward(self, x):
        return _linear(F.gelu(_linear(x, self.fc1)), self.fc2)


class _Block(nn.Module):
    def __init__(self, d, num_heads, hidden, bias, layerscale):
        super().__init__()
        self.norm1 = _LayerNorm(d)
        self.attn = _Attention(d, num_heads, bias)
        self.norm2 = _LayerNorm(d)
        self.mlp = _Mlp(d, hidden, bias)
        if layerscale:
            self.ls1 = _LayerScale(d)
            self.ls2 = _LayerScale(d)

    def forward(self, x):
        h = self.attn(self.norm1(x))
        if hasattr(self, "ls1"):
            h = h * self.ls1.gamma
        x = x + h
        m = self.mlp(self.norm2(x))
        if hasattr(self, "ls2"):
            m = m * self.ls2.gamma
        return x + m


class _PatchEmbed(nn.Module):
    def __init__(self, d: int, patch: int, bias: bool):
        super().__init__()
        self.proj = nn.Conv2d(3, d, patch, patch, bias=bias)


class DinoViT(nn.Module):
    """DINOv2-style ViT: forward(imgs (B, H, W, 3) in [0, 1], H and W
    multiples of the patch size) -> (B, gh gw, D) final-norm patch
    tokens, the cls and register tokens dropped.  Defaults: ViT-S/14 at
    DINOv2's widths (D 384, 6 heads, 12 blocks, a 37 x 37 position grid,
    LayerScale)."""

    def __init__(self, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, patch_size: int = 14,
                 pos_grid: int = 37, mlp_hidden: int | None = None,
                 n_registers: int = 0, layerscale: bool = True,
                 bias: bool = True):
        super().__init__()
        d = embed_dim
        self.num_heads = int(num_heads)
        self.patch_size = int(patch_size)
        self.patch_embed = _PatchEmbed(d, patch_size, bias)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid ** 2, d))
        if n_registers:
            self.register_tokens = nn.Parameter(torch.zeros(1, n_registers,
                                                            d))
        self.blocks = nn.ModuleList(
            _Block(d, num_heads, mlp_hidden or 4 * d, bias, layerscale)
            for _ in range(depth))
        self.norm = _LayerNorm(d)
        self.register_buffer("in_mean", torch.from_numpy(_IN_MEAN),
                             persistent=False)
        self.register_buffer("in_std", torch.from_numpy(_IN_STD),
                             persistent=False)

    @classmethod
    def from_flat(cls, params: dict, num_heads: int) -> "DinoViT":
        """A module holding the JAX package's flat parameter dict (the
        widths, depth, grid, registers, LayerScale and biases read off
        it)."""
        w = np.shape(params["patch_embed.proj.weight"])
        depth = 1 + max(int(k.split(".")[1]) for k in params
                        if k.startswith("blocks."))
        n0 = np.shape(params["pos_embed"])[1] - 1
        net = cls(embed_dim=int(w[0]), depth=depth, num_heads=num_heads,
                  patch_size=int(w[-1]),
                  pos_grid=int(round(float(np.sqrt(n0)))),
                  mlp_hidden=int(
                      np.shape(params["blocks.0.mlp.fc1.weight"])[0]),
                  n_registers=(int(np.shape(params["register_tokens"])[1])
                               if "register_tokens" in params else 0),
                  layerscale="blocks.0.ls1.gamma" in params,
                  bias="blocks.0.attn.qkv.bias" in params)
        net.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                             for k, v in params.items()})
        return net.eval()

    def to_flat(self) -> dict:
        return {k: v.detach().cpu().numpy() for k, v in
                self.state_dict().items()}

    def forward(self, imgs):
        with no_tf32(), torch.no_grad():
            x = (imgs.float() - self.in_mean) / self.in_std
            x = _conv(x.permute(0, 3, 1, 2), self.patch_embed.proj,
                      stride=self.patch_size)
            b, d, gh, gw = x.shape
            tokens = x.reshape(b, d, gh * gw).transpose(1, 2)
            tokens = torch.cat([self.cls_token.expand(b, 1, d), tokens], 1)
            tokens = tokens + interp_pos_embed(self.pos_embed, gh, gw)
            n_extra = 1
            if hasattr(self, "register_tokens"):
                reg = self.register_tokens.expand(b, -1, d)
                tokens = torch.cat([tokens[:, :1], reg, tokens[:, 1:]], 1)
                n_extra += reg.shape[1]
            for blk in self.blocks:
                tokens = blk(tokens)
            return self.norm(tokens)[:, n_extra:]


def load_torch_vit(path: str) -> tuple[dict, int]:
    """A DINO / DINOv2 ViT torch checkpoint -> (flat numpy dict,
    num_heads).  A `model` entry holding a dict is unwrapped; the head
    count follows the DINOv2 family's D / 64 (S 384/6, B 768/12, L
    1024/16)."""
    sd = torch.load(path, map_location="cpu")
    if not isinstance(sd, dict):
        sd = sd.state_dict()
    sd = sd.get("model", sd) if isinstance(sd.get("model", None), dict) \
        else sd
    params = {k: np.asarray(v.detach().cpu().numpy(), np.float32)
              for k, v in sd.items() if hasattr(v, "detach")}
    for req in ("patch_embed.proj.weight", "cls_token", "pos_embed",
                "norm.weight"):
        if req not in params:
            raise ValueError(f"ViT checkpoint missing key: {req}")
    d = params["patch_embed.proj.weight"].shape[0]
    return params, max(1, d // 64)


class ViTPatchExtractor:
    """The DINO gate's descriptor extractor (engine/dino_gate.py's
    PatchDescriptorExtractor contract): (H, W, 3) rgb + (H, W) mask ->
    (N, D) L2-normalised ViT patch descriptors of the patches whose mask
    fraction is at least min_mask_frac, as a numpy array ((0, 1) when the
    image holds no patch or none is kept).  The ViT runs on `device`;
    `rgb` may be a numpy array or a tensor, which is used where it lies
    when that is `device` (no host round trip for a frame on the card)."""

    def __init__(self, params: dict, num_heads: int,
                 min_mask_frac: float = 0.3, device="cuda"):
        self.device = torch.device(device)
        self.net = DinoViT.from_flat(params, num_heads).to(self.device)
        self.num_heads = int(num_heads)
        self.min_frac = float(min_mask_frac)
        self.patch = self.net.patch_size

    @classmethod
    def from_checkpoint(cls, path: str, **kw):
        params, heads = load_torch_vit(path)
        return cls(params, heads, **kw)

    def __call__(self, rgb, mask) -> np.ndarray:
        rgb = torch.as_tensor(rgb, dtype=torch.float32, device=self.device)
        mask = np.asarray(mask, bool)
        p = self.patch
        gh, gw = mask.shape[0] // p, mask.shape[1] // p
        if gh == 0 or gw == 0:
            return np.zeros((0, 1), np.float32)
        rgb = rgb[:gh * p, :gw * p]
        frac = mask[:gh * p, :gw * p].reshape(gh, p, gw, p) \
            .mean(axis=(1, 3)).reshape(-1)
        keep = frac >= self.min_frac
        if not keep.any():
            return np.zeros((0, 1), np.float32)
        toks = self.net(rgb[None])[0]
        toks = toks.cpu().numpy()[keep]
        n = np.linalg.norm(toks, axis=1, keepdims=True)
        return (toks / np.maximum(n, 1e-8)).astype(np.float32)
