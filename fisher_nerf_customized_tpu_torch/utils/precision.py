"""Full f32 for cuDNN and cuBLAS.

On the card, PyTorch runs convolutions (and, if asked, matmuls) in TF32
by default, which keeps 10 bits of mantissa: the networks ported from
the JAX package (XLA, full f32 there) would then part from it by ~1e-3.
Each of them runs inside `no_tf32()`.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
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
