"""The yardstick of the rooflines: the card's published peaks and the
operations a kernel does per live (pixel, Gaussian) pair, counted from
the port's CUDA sources when this benchmark was written and frozen here.

A bound is the least time the card could take for the work: the larger
of the bytes over the memory bandwidth and the operations over the
float32 peak.  Bytes are the Gaussians' parameters read once and the
outputs written once; the work is the live pairs that
reference/gaussians.py::live_pairs counts from the map and the camera,
whatever lists or layout an implementation walks."""
from __future__ import annotations

MEM_BW = 3.35e12          # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
FP32_PEAK = 67e12         # H100 SXM float32 outside the tensor cores, flop/s
# evaluating a pair: 2 sub, 9 mul/add for the conic power, 1 exp, the
# opacity multiply, the 0.99 clamp and the 1/255 test
PAIR_EVAL = 14
# per live pair: (operations, operations per channel)
OPS = {
    # K1: w = alpha T, acc += w color (2 C), T (1 - alpha), the median latch
    "k1": (PAIR_EVAL + 5, 2),
    # K2: the suffix sums, dL/dalpha, the conic, mean and opacity
    # gradients and their sums over the pixels
    "k2": (PAIR_EVAL + 39, 4),
    # K3 at 11 (reduced chain) and 20 (full chain) features: two
    # evaluations, the squared gradients of mean and opacity
    "k3.11": (2 * PAIR_EVAL + 2 * 5 + 31, 0),
    "k3.20": (2 * PAIR_EVAL + 2 * 5 + 31 + 26, 0),
}
F32 = 4


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / MEM_BW, n_ops / FP32_PEAK)


def blend_bound_s(kernel: str, pairs: int, n_visible: int, n_pixels: int,
                  n_ch: int) -> float:
    """K1: the visible Gaussians' blend rows (mean 2, conic 3, opacity,
    depth, C channels) read, C + 2 outputs a pixel written.  K2: the
    same rows and C + 1 cotangents a pixel read, 6 + C gradients a
    Gaussian written."""
    base, per_ch = OPS[kernel]
    ops = pairs * (base + per_ch * n_ch)
    rows = n_visible * (7 + n_ch) * F32
    if kernel == "k1":
        n_bytes = rows + n_pixels * (n_ch + 2) * F32
    else:
        n_bytes = rows + n_pixels * (n_ch + 1) * F32 \
            + n_visible * (6 + n_ch) * F32
    return bound_s(n_bytes, ops)


def fisher_bound_s(nf: int, pairs: int, n_visible: int) -> float:
    """K3: the visible Gaussians' nf features read, four Fisher entries a
    Gaussian written."""
    return bound_s(n_visible * (nf + 4) * F32, pairs * OPS[f"k3.{nf}"][0])
