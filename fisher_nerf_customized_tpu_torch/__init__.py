"""PyTorch + CUDA port of fisher_nerf_customized_tpu for NVIDIA Hopper.

The JAX package beside it is the reference.  This package imports torch
and numpy only, never JAX or the JAX package; its hand-written CUDA
kernels live in csrc/ and are built with nvcc on first use
(ops/cuda_build.py).  Every entry point runs on "cuda" unless the caller
passes device="cpu", where each kernel's plain PyTorch twin runs instead.
"""

__version__ = "0.1.0"
