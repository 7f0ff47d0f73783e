// Pieces shared by K1 (blend.cu), K2 (blend_bwd.cu) and K3 (fisher.cu):
// the pair's alpha, the conservative pixel box of a row's blend region,
// the per-warp pixel range it is tested against, and cp.async staging of
// packed rows into shared memory at a padded stride.
//
// Packed row layout of K1 and K2 (global memory, F = 8 + C floats):
// [mu_x, mu_y, con_a, con_b, con_c, opacity, depth, valid, color_0..C-1].
// In shared memory a row takes FP = F rounded up to a multiple of 4
// floats, so that it loads as float4s: r[0] = (mu_x, mu_y, a, b), r[1] =
// (c, opacity, depth, valid), r[2..] = the colors (padding floats are
// never used).  K3's rows start with the same six fields but have no
// valid column (an invalid row has opacity 0): it calls the forms below
// that take the validity as an argument.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace fnc {

constexpr int kBaseF = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaMin = 1.f / 255.f;
constexpr float kSaturatedT = 1e-4f;

__host__ __device__ constexpr int padded_stride(int f) { return (f + 3) & ~3; }

struct Pair {
  float alpha, g, dx, dy;
};

// The pair's alpha, with alpha = g = 0 where the pair does not blend
// (outside the ellipse, an invalid row, alpha below 1/255, or a NaN
// anywhere on the way: the tests are written so that a NaN never blends,
// and the 0.99 clamp keeps a NaN, as torch.clamp and jnp.minimum do).
// r0 = (mu_x, mu_y, a, b), c the conic's third entry, op the opacity.
__device__ __forceinline__ Pair pair_alpha(float4 r0, float c, float op,
                                           bool valid, float px, float py) {
  Pair o;
  o.dx = r0.x - px;
  o.dy = r0.y - py;
  const float power = -0.5f * (r0.z * o.dx * o.dx + c * o.dy * o.dy)
                      - r0.w * o.dx * o.dy;
  o.alpha = 0.f;
  o.g = 0.f;
  if (power <= 0.f && valid) {
    const float g = expf(power);
    const float a0 = op * g;
    const float a = a0 > 0.99f ? 0.99f : a0;
    if (a >= kAlphaMin) {
      o.alpha = a;
      o.g = g;
    }
  }
  return o;
}

__device__ __forceinline__ Pair pair_alpha(float4 r0, float4 r1, float px,
                                           float py) {
  return pair_alpha(r0, r1.x, r1.y, r1.w > 0.5f, px, py);
}

// Conservative pixel box (x0, x1, y0, y1) of a row's blend region: every
// pixel at which pair_alpha gives alpha > 0 lies inside it.  alpha >=
// 1/255 needs opacity * exp(power) >= 1/255, i.e. d^T Q d <= r2 with
// r2 = 2 ln(255 opacity), Q = [[a, b], [b, c]], d = mu - pixel; that
// ellipse's half-widths are r sqrt(c / det) and r sqrt(a / det).  The box
// is widened by 1 % in r2, 0.5 % in each half-width plus 0.01 pixel and
// 1e-6 of |mu| (float rounding of power, of exp, of det and of mu - px).
// No culling (an infinite box) where the region is unbounded (det <= 0 or
// a <= 0) or so elongated (a c / det > 1000) that rounding of power
// outgrows the margin; always culled (an empty box) for an invalid row or
// opacity below 1/255.  Mirrored by ops/cuda_blend.py::row_boxes.
// r0 = (mu_x, mu_y, a, b), c the conic's third entry, op the opacity.
__device__ __forceinline__ float4 row_box(float4 r0, float c, float op,
                                          bool valid) {
  const float a = r0.z, b = r0.w;
  const float inf = __int_as_float(0x7f800000);
  if (!valid || !(op * 1.0001f >= kAlphaMin))
    return make_float4(inf, -inf, inf, -inf);
  const float det = a * c - b * b;
  if (!(det > 0.f && a > 0.f && a * c <= 1000.f * det))
    return make_float4(-inf, inf, -inf, inf);
  const float r2 = fmaxf(2.f * logf(255.f * op), 0.f) * 1.01f + 1e-5f;
  const float hx = sqrtf(r2 * c / det) * 1.005f + 1e-2f
                   + 1e-6f * fabsf(r0.x);
  const float hy = sqrtf(r2 * a / det) * 1.005f + 1e-2f
                   + 1e-6f * fabsf(r0.y);
  return make_float4(r0.x - hx, r0.x + hx, r0.y - hy, r0.y + hy);
}

__device__ __forceinline__ float4 row_box(const float4* r) {
  const float4 r1 = r[1];
  return row_box(r[0], r1.x, r1.y, r1.w > 0.5f);
}

// Pixel range (x0, x1, y0, y1) covered by the calling warp: the min and
// max of its lanes' pixel coordinates (no tile layout assumed).
__device__ __forceinline__ float4 warp_range(float x0, float x1, float y0,
                                             float y1) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(kFull, x0, off));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, off));
    y0 = fminf(y0, __shfl_xor_sync(kFull, y0, off));
    y1 = fmaxf(y1, __shfl_xor_sync(kFull, y1, off));
  }
  return make_float4(x0, x1, y0, y1);
}

// Does box b reach the warp's pixel range w?  False for a NaN box.
__device__ __forceinline__ bool box_hits(float4 b, float4 w) {
  return b.y >= w.x && b.x <= w.y && b.w >= w.z && b.z <= w.w;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Issue the copy of n packed rows (stride F floats) from src to dst
// (stride FP floats) by all threads of the block: 16-byte copies where
// the rows allow them (F a multiple of 4 and src 16-byte aligned), else
// one copy per float.
template <int F>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int n, bool aligned16) {
  constexpr int FP = padded_stride(F);
  if (F % 4 == 0 && aligned16) {
    constexpr int Q = F / 4;
    for (int i = threadIdx.x; i < n * Q; i += blockDim.x) {
      const int row = i / Q;
      cp_async16(dst + row * FP + (i - row * Q) * 4, src + i * 4);
    }
  } else {
    for (int i = threadIdx.x; i < n * F; i += blockDim.x) {
      const int row = i / F;
      cp_async4(dst + row * FP + (i - row * F), src + i);
    }
  }
}

// The row's colors from its staged float4s into registers.
template <int C>
__device__ __forceinline__ void load_colors(const float4* r, float* col) {
#pragma unroll
  for (int q = 0; q < (C + 3) / 4; ++q) {
    const float4 v = r[2 + q];
    if (4 * q + 0 < C) col[4 * q + 0] = v.x;
    if (4 * q + 1 < C) col[4 * q + 1] = v.y;
    if (4 * q + 2 < C) col[4 * q + 2] = v.z;
    if (4 * q + 3 < C) col[4 * q + 3] = v.w;
  }
}

}  // namespace fnc
