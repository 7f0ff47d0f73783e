// K1: per-tile front-to-back alpha blend of packed Gaussian slot rows.
//
// Replaces the Pallas TPU kernel fisher_nerf_customized_tpu/ops/
// pallas_blend.py::_blend_kernel (launched by pallas_blend).  Its plain
// PyTorch twin is ops/cuda_blend.py::blend_plain, which the wrapper
// ops/cuda_blend.py::cuda_blend runs for CPU tensors.
//
// Inputs, per tile t of T:
//   packed (T, K, 8+C) f32 rows [mu_x, mu_y, con_a, con_b, con_c, opacity,
//          depth, valid, color_0..C-1], front to back; valid rows first
//   pix_xy (T, 2, P) f32 pixel coordinates
//   nvalid (T,) i32 number of valid front rows
// Outputs: color (T, P, C), final transmittance (T, P), median depth (T, P)
// (depth at the T=0.5 crossing, max_depth where T never crosses 0.5).
//
// What bounds it on an H100: the per-(pixel, slot) arithmetic.  Each
// packed row is read from device memory once per tile and reused by all
// P pixels, so the kernel moves T*K*(8+C)*4 bytes but does ~(20+2C)
// flops and one expf for every pixel-slot pair it walks: on the main path
// (T=256, P=256, K=256) the operation bound exceeds the byte bound by
// well over 10x (see PERF.md).  The design keeps every pair on chip:
//   * one block per tile, one thread per pixel (P <= 1024);
//   * each chunk of rows is staged once in shared memory (<= 16 KB) and
//     read by all threads as broadcasts, so no bank conflicts;
//   * per pixel, T, the C-channel sum and a first-crossing latch live in
//     registers (C is a template parameter so the sum stays in registers);
//   * after each chunk __syncthreads_or(T >= 1e-4) stops the whole tile
//     once every pixel has saturated: the same chunk-granular rule as the
//     Pallas while_loop cond, so both stop at the same chunk; rows past
//     nvalid (invalid, they blend nothing) are neither loaded nor walked,
//     so empty tiles do nothing.
// Not done yet (later work): warp-cooperative chunk loads with cp.async,
// and skipping whole chunks whose rows all miss the tile.
#include <cuda_runtime.h>

namespace {

constexpr int kBaseF = 8;

template <int C>
__global__ void blend_kernel(const float* __restrict__ packed,
                             const float* __restrict__ pix_xy,
                             const int* __restrict__ nvalid,
                             float* __restrict__ out_color,
                             float* __restrict__ out_t,
                             float* __restrict__ out_med,
                             int K, int P, int chunk, float max_depth) {
  constexpr int F = kBaseF + C;
  extern __shared__ float rows[];  // chunk * F floats
  const int tile = blockIdx.x;
  const int p = threadIdx.x;       // blockDim.x == P
  const float px = pix_xy[(size_t)tile * 2 * P + p];
  const float py = pix_xy[(size_t)tile * 2 * P + P + p];
  const int nv = nvalid[tile];
  const int k_lim = min(K, ((nv + chunk - 1) / chunk) * chunk);
  const float* tile_rows = packed + (size_t)tile * K * F;

  float T = 1.f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float med = 0.f;
  bool has_med = false;

  for (int k0 = 0; k0 < k_lim; k0 += chunk) {
    // rows past nvalid are invalid and blend nothing: skip them
    const int n_rows = min(chunk, nv - k0);
    const float* src = tile_rows + (size_t)k0 * F;
    for (int i = threadIdx.x; i < n_rows * F; i += blockDim.x) rows[i] = src[i];
    __syncthreads();
    for (int j = 0; j < n_rows; ++j) {
      const float* r = rows + j * F;
      const float dx = r[0] - px;
      const float dy = r[1] - py;
      const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy)
                          - r[3] * dx * dy;
      // negated tests so that a NaN never blends
      if (!(power <= 0.f) || !(r[7] > 0.5f)) continue;
      const float alpha = fminf(0.99f, r[5] * expf(power));
      if (!(alpha >= 1.f / 255.f)) continue;
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += w * r[kBaseF + c];
      const float t_after = T * (1.f - alpha);
      if (!has_med && T > 0.5f && t_after < 0.5f) {
        med = r[6];
        has_med = true;
      }
      T = t_after;
    }
    // tile-wide early stop; also the barrier before the next staging
    if (!__syncthreads_or(T >= 1e-4f)) break;
  }

  const size_t px_idx = (size_t)tile * P + p;
#pragma unroll
  for (int c = 0; c < C; ++c) out_color[px_idx * C + c] = acc[c];
  out_t[px_idx] = T;
  out_med[px_idx] = has_med ? med : max_depth;
}

template <int C>
cudaError_t launch(const float* packed, const float* pix_xy,
                   const int* nvalid, float* out_color, float* out_t,
                   float* out_med, int T, int K, int P, int chunk,
                   float max_depth, cudaStream_t stream) {
  const size_t smem = (size_t)chunk * (kBaseF + C) * sizeof(float);
  blend_kernel<C><<<T, P, smem, stream>>>(packed, pix_xy, nvalid, out_color,
                                          out_t, out_med, K, P, chunk,
                                          max_depth);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fnc_blend(const float* packed, const float* pix_xy,
                         const int* nvalid, float* out_color, float* out_t,
                         float* out_med, int T, int K, int C, int P,
                         int chunk, float max_depth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(packed, pix_xy, nvalid, out_color, out_t, out_med, T, K, P, chunk, max_depth, s);
    case 2: return launch<2>(packed, pix_xy, nvalid, out_color, out_t, out_med, T, K, P, chunk, max_depth, s);
    case 3: return launch<3>(packed, pix_xy, nvalid, out_color, out_t, out_med, T, K, P, chunk, max_depth, s);
    case 4: return launch<4>(packed, pix_xy, nvalid, out_color, out_t, out_med, T, K, P, chunk, max_depth, s);
    case 5: return launch<5>(packed, pix_xy, nvalid, out_color, out_t, out_med, T, K, P, chunk, max_depth, s);
    case 6: return launch<6>(packed, pix_xy, nvalid, out_color, out_t, out_med, T, K, P, chunk, max_depth, s);
    case 7: return launch<7>(packed, pix_xy, nvalid, out_color, out_t, out_med, T, K, P, chunk, max_depth, s);
    case 8: return launch<8>(packed, pix_xy, nvalid, out_color, out_t, out_med, T, K, P, chunk, max_depth, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
