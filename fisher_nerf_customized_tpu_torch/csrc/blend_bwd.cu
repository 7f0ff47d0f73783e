// K2: analytic backward of the K1 tile blend, per slot row.
//
// Replaces the Pallas TPU kernel fisher_nerf_customized_tpu/ops/
// pallas_blend_bwd.py::_blend_bwd_kernel (launched by
// pallas_blend_bwd_slots).  Its plain PyTorch twin is
// ops/cuda_blend_bwd.py::blend_bwd_plain, which the wrapper
// ops/cuda_blend_bwd.py::cuda_blend_bwd runs for CPU tensors.
//
// Inputs, per tile t of T:
//   packed (T, K, 8+C) f32 rows [mu_x, mu_y, con_a, con_b, con_c, opacity,
//          depth, valid, color_0..C-1], front to back; valid rows first
//          (K1's layout, so forward and backward share one gather)
//   pix_xy (T, 2, P) f32 pixel coordinates
//   gcol   (T, P, C) f32 cotangent of the blended color
//   g_t    (T, P) f32 cotangent of the final transmittance
//   nvalid (T,) i32 number of valid front rows
// Output: (T, K, 6+C) f32 per slot, summed over the tile's pixels:
// [d mu_x, d mu_y, d con_a, d con_b, d con_c, d opacity, d color_0..C-1];
// rows past the walked chunks or past nvalid are 0.  Conventions of the
// Pallas kernel: the 0.99 alpha clamp does not gate the gradient,
// 1/(1 - alpha) is taken as 1/max(1 - alpha, 1e-2), dL/dalpha is 0 where
// alpha is 0.
//
// What bounds it on an H100: arithmetic.  Each row is read from device
// memory twice per tile (once per pass) and reused by all P pixels, while
// every walked pixel-slot pair costs three alpha evaluations (pass 1 and
// the two sweeps of pass 2), a C-wide dot product per sweep and ~35 flops
// of gradient chain; the operation bound is far above the byte bound
// (PERF.md).  The design keeps every per-pair intermediate on chip:
//   * one block per tile, one thread per pixel (P <= 1024);
//   * pass 1 walks chunks front to back, stores each chunk's starting T
//     per pixel in shared memory (K/chunk x P floats) and stops the tile
//     with __syncthreads_or(T >= 1e-4) after each chunk, K1's rule, so
//     both kernels walk the same chunks; rows past nvalid are not walked;
//   * pass 2 walks those chunks back to front.  Per chunk, sweep A
//     re-walks it from its stored T to get the chunk's total contribution
//     per pixel; sweep B re-walks it and forms the suffix
//     S_behind = carry + (total - inclusive prefix), so no per-slot
//     transmittance is stored (the Pallas kernel's triangular-matrix
//     products, which suit the MXU, are not needed);
//   * per slot the 6+C sums go over the warp by shuffles (skipped when no
//     pixel of the warp blends the slot), then one shared-memory atomicAdd
//     per warp into a chunk x (6+C) accumulator, then one coalesced store
//     per chunk: nothing but the final rows goes to device memory.
// The per-Gaussian scatter-add of the rows stays outside, in torch.
#include <cuda_runtime.h>

namespace {

constexpr int kBaseF = 8;

struct Alpha {
  float alpha, g, dx, dy;
};

// K1's alpha, with alpha = G = 0 where the pair does not blend
__device__ __forceinline__ Alpha pair_alpha(const float* r, float px,
                                            float py) {
  Alpha o;
  o.dx = r[0] - px;
  o.dy = r[1] - py;
  const float power = -0.5f * (r[2] * o.dx * o.dx + r[4] * o.dy * o.dy)
                      - r[3] * o.dx * o.dy;
  o.alpha = 0.f;
  o.g = 0.f;
  // negated tests so that a NaN never blends
  if (power <= 0.f && r[7] > 0.5f) {
    const float g = expf(power);
    const float a = fminf(0.99f, r[5] * g);
    if (a >= 1.f / 255.f) {
      o.alpha = a;
      o.g = g;
    }
  }
  return o;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int C>
__global__ void blend_bwd_kernel(const float* __restrict__ packed,
                                 const float* __restrict__ pix_xy,
                                 const float* __restrict__ gcol,
                                 const float* __restrict__ g_t,
                                 const int* __restrict__ nvalid,
                                 float* __restrict__ out, int K, int P,
                                 int chunk) {
  constexpr int F = kBaseF + C;
  constexpr int G = 6 + C;
  extern __shared__ float smem[];
  float* rows = smem;                           // chunk * F
  float* tstart = rows + chunk * F;             // (K / chunk) * P
  float* acc = tstart + (K / chunk) * P;        // chunk * G

  const int tile = blockIdx.x;
  const int p = threadIdx.x;                    // blockDim.x == P
  const int lane = p & 31;
  const float px = pix_xy[(size_t)tile * 2 * P + p];
  const float py = pix_xy[(size_t)tile * 2 * P + P + p];
  float gc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = gcol[((size_t)tile * P + p) * C + c];
  const int nv = nvalid[tile];
  const int n_chunks = min(K / chunk, (nv + chunk - 1) / chunk);
  const float* slots = packed + (size_t)tile * K * F;
  float* o = out + (size_t)tile * K * G;

  // ---- pass 1: forward walk, record each chunk's starting T -----------
  float t = 1.f;
  int k_eff = 0;
  while (k_eff < n_chunks) {
    const int n_rows = min(chunk, nv - k_eff * chunk);
    const float* src = slots + (size_t)k_eff * chunk * F;
    for (int i = p; i < n_rows * F; i += blockDim.x) rows[i] = src[i];
    tstart[k_eff * P + p] = t;
    __syncthreads();
    for (int j = 0; j < n_rows; ++j)
      t *= 1.f - pair_alpha(rows + j * F, px, py).alpha;
    ++k_eff;
    // tile-wide stop; also the barrier before the next staging
    if (!__syncthreads_or(t >= 1e-4f)) break;
  }
  for (int i = k_eff * chunk * G + p; i < K * G; i += blockDim.x) o[i] = 0.f;
  const float gtf = g_t[(size_t)tile * P + p] * t;   // g_T * T_final

  // ---- pass 2: reverse walk over the k_eff chunks ----------------------
  float s_carry = 0.f;
  for (int ci = k_eff - 1; ci >= 0; --ci) {
    const int n_rows = min(chunk, nv - ci * chunk);
    const float* src = slots + (size_t)ci * chunk * F;
    for (int i = p; i < n_rows * F; i += blockDim.x) rows[i] = src[i];
    for (int i = p; i < chunk * G; i += blockDim.x) acc[i] = 0.f;
    __syncthreads();

    // sweep A: the chunk's total contribution sum_i alpha_i T_i cg_i
    float tot = 0.f;
    t = tstart[ci * P + p];
    for (int j = 0; j < n_rows; ++j) {
      const float* r = rows + j * F;
      const float a = pair_alpha(r, px, py).alpha;
      float cg = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) cg += r[kBaseF + c] * gc[c];
      tot += a * t * cg;
      t *= 1.f - a;
    }

    // sweep B: per-pair gradients, summed over the tile's pixels
    float prefix = 0.f;
    t = tstart[ci * P + p];
    for (int j = 0; j < n_rows; ++j) {
      const float* r = rows + j * F;
      const Alpha al = pair_alpha(r, px, py);
      float cg = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) cg += r[kBaseF + c] * gc[c];
      const float t_before = t;
      const float w = al.alpha * t_before;
      prefix += w * cg;
      t *= 1.f - al.alpha;
      const bool live = al.alpha > 0.f;
      if (!__any_sync(0xffffffffu, live)) continue;
      float v[G];
#pragma unroll
      for (int q = 0; q < G; ++q) v[q] = 0.f;
      if (live) {
        const float s_b = s_carry + (tot - prefix);
        const float inv_om = 1.f / fmaxf(1.f - al.alpha, 1e-2f);
        const float dl_da = t_before * cg - (s_b + gtf) * inv_om;
        const float t1 = r[5] * dl_da * al.g;    // dL/dG * G
        v[0] = -t1 * (r[2] * al.dx + r[3] * al.dy);
        v[1] = -t1 * (r[4] * al.dy + r[3] * al.dx);
        v[2] = -0.5f * t1 * al.dx * al.dx;
        v[3] = -t1 * al.dx * al.dy;
        v[4] = -0.5f * t1 * al.dy * al.dy;
        v[5] = al.g * dl_da;
#pragma unroll
        for (int c = 0; c < C; ++c) v[6 + c] = w * gc[c];
      }
#pragma unroll
      for (int q = 0; q < G; ++q) v[q] = warp_sum(v[q]);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < G; ++q) atomicAdd(&acc[j * G + q], v[q]);
      }
    }
    s_carry += tot;
    __syncthreads();
    for (int i = p; i < chunk * G; i += blockDim.x)
      o[(size_t)ci * chunk * G + i] = acc[i];
    __syncthreads();  // acc and rows are reused by the next chunk
  }
}

template <int C>
cudaError_t launch(const float* packed, const float* pix_xy,
                   const float* gcol, const float* g_t, const int* nvalid,
                   float* out, int T, int K, int P, int chunk,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)chunk * (kBaseF + C) + (size_t)(K / chunk) * P +
       (size_t)chunk * (6 + C));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blend_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  blend_bwd_kernel<C><<<T, P, smem, stream>>>(packed, pix_xy, gcol, g_t,
                                              nvalid, out, K, P, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fnc_blend_bwd(const float* packed, const float* pix_xy,
                             const float* gcol, const float* g_t,
                             const int* nvalid, float* out, int T, int K,
                             int C, int P, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(packed, pix_xy, gcol, g_t, nvalid, out, T, K, P, chunk, s);
    case 2: return launch<2>(packed, pix_xy, gcol, g_t, nvalid, out, T, K, P, chunk, s);
    case 3: return launch<3>(packed, pix_xy, gcol, g_t, nvalid, out, T, K, P, chunk, s);
    case 4: return launch<4>(packed, pix_xy, gcol, g_t, nvalid, out, T, K, P, chunk, s);
    case 5: return launch<5>(packed, pix_xy, gcol, g_t, nvalid, out, T, K, P, chunk, s);
    case 6: return launch<6>(packed, pix_xy, gcol, g_t, nvalid, out, T, K, P, chunk, s);
    case 7: return launch<7>(packed, pix_xy, gcol, g_t, nvalid, out, T, K, P, chunk, s);
    case 8: return launch<8>(packed, pix_xy, gcol, g_t, nvalid, out, T, K, P, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
