// K1: per-tile front-to-back alpha blend of packed Gaussian slot rows.
//
// Replaces the Pallas TPU kernel fisher_nerf_customized_tpu/ops/
// pallas_blend.py::_blend_kernel (launched by pallas_blend).  Its plain
// PyTorch twin is ops/cuda_blend.py::blend_plain, which the wrapper
// ops/cuda_blend.py::cuda_blend runs for CPU tensors.
//
// Inputs, per tile t of T:
//   packed (T, K, 8+C) f32 rows (layout in blend_common.cuh), front to
//          back; valid rows first
//   pix_xy (T, 2, P) f32 pixel coordinates
//   nvalid (T,) i32 number of valid front rows
// Outputs: color (T, P, C), final transmittance (T, P), median depth (T, P)
// (depth at the T=0.5 crossing, max_depth where T never crosses 0.5), and
// walked (T,) i32, the rows walked: chunks entered times chunk, which K2
// reads as the tile's stop.
//
// What bounds it on an H100: instruction issue.  Each packed row is read
// from device memory once per tile and reused by all P pixels; every
// (pixel, row) pair it evaluates costs ~25 instructions (the conic power,
// expf, the alpha tests) and every live pair ~2C+8 more.  A tile's pixels
// walk its rows serially and a tile cannot be split across blocks (the
// stop below needs every pixel of the tile), so the heaviest tile's walk
// sets the time.  The design cuts the instructions per pair:
//   * one block per tile, one thread per pixel (P <= 1024); per pixel, T,
//     the C-channel sum and a first-crossing latch live in registers;
//   * rows are staged into shared memory with cp.async in sub-chunks of
//     64 rows, double-buffered (the next sub-chunk loads while this one is
//     walked), at a stride padded to a multiple of 4 floats, so a row is
//     read as float4 broadcasts (3 loads for C 4 instead of 12);
//   * exact per-warp culling: per sub-chunk one thread per row computes
//     the row's conservative pixel box (blend_common.cuh::row_box); each
//     warp ballots 32 rows at a time against its pixels' range and walks
//     only the rows whose box reaches it (a warp-uniform loop over the set
//     bits, in row order).  A skipped pair has alpha = 0 by the kernel's
//     own test, so T, the colors and the latch are exactly unchanged;
//   * a row blends with selects, not branches, so lanes whose pair does
//     not blend do not split the warp;
//   * after each chunk __syncthreads_or(T >= 1e-4) stops the whole tile
//     once every pixel has saturated: the chunk-granular rule of the
//     Pallas while_loop cond, so both stop at the same chunk; rows past
//     nvalid are neither loaded nor walked, so empty tiles do nothing.
#include "blend_common.cuh"

namespace {

using namespace fnc;

constexpr int kSub = 64;   // rows per staged sub-chunk

// Blend one row into a pixel's state; nothing changes where alpha is 0.
// Written with selects, not branches, so the warp does not diverge.
template <int C>
__device__ __forceinline__ void blend_row(const float4* r, float alpha,
                                          float& T, float (&acc)[C],
                                          float& med, bool& has_med) {
  const bool live = alpha > 0.f;
  float col[C];
  load_colors<C>(r, col);
  const float w = alpha * T;
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = live ? acc[c] + w * col[c] : acc[c];
  const float t_after = T * (1.f - alpha);
  const bool cross = live && !has_med && T > 0.5f && t_after < 0.5f;
  med = cross ? r[1].z : med;
  has_med = has_med || cross;
  T = live ? t_after : T;
}

template <int C>
__global__ void blend_kernel(const float* __restrict__ packed,
                             const float* __restrict__ pix_xy,
                             const int* __restrict__ nvalid,
                             float* __restrict__ out_color,
                             float* __restrict__ out_t,
                             float* __restrict__ out_med,
                             int* __restrict__ out_walked,
                             int K, int P, int chunk, int sub,
                             float max_depth) {
  constexpr int F = kBaseF + C;
  constexpr int FP = padded_stride(F);
  extern __shared__ float4 smem[];
  float4* rows = smem;                       // 2 buffers of sub * FP floats
  float4* boxes = rows + 2 * sub * (FP / 4);  // sub boxes

  const int tile = blockIdx.x;
  const int p = threadIdx.x;                 // blockDim.x == P
  const float px = pix_xy[(size_t)tile * 2 * P + p];
  const float py = pix_xy[(size_t)tile * 2 * P + P + p];
  const float4 wr = warp_range(px, px, py, py);
  const int lane = p & 31;
  const int nv = nvalid[tile];
  const int n_sub = (nv + sub - 1) / sub;    // sub divides chunk
  const int sub_per_chunk = chunk / sub;
  const float* tile_rows = packed + (size_t)tile * K * F;
  const bool aligned16 = (reinterpret_cast<uintptr_t>(packed) & 15) == 0;

  float T = 1.f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float med = 0.f;
  bool has_med = false;
  int walked = 0;

  if (n_sub > 0) {
    stage_rows<F>(reinterpret_cast<float*>(rows), tile_rows, min(sub, nv),
                  aligned16);
    cp_async_commit();
  }
  for (int s = 0; s < n_sub; ++s) {
    const int k0 = s * sub;
    if (s + 1 < n_sub) {
      const int k1 = k0 + sub;
      stage_rows<F>(reinterpret_cast<float*>(rows + ((s + 1) & 1) * sub *
                                             (FP / 4)),
                    tile_rows + (size_t)k1 * F, min(sub, nv - k1), aligned16);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // sub-chunk s has landed
    const int n_rows = min(sub, nv - k0);
    const float4* buf = rows + (s & 1) * sub * (FP / 4);
    for (int j = p; j < n_rows; j += blockDim.x)
      boxes[j] = row_box(buf + j * (FP / 4));
    __syncthreads();
    if (s % sub_per_chunk == 0) walked += chunk;   // a new chunk entered

    for (int g0 = 0; g0 < n_rows; g0 += 32) {
      const int jl = g0 + lane;
      unsigned todo = __ballot_sync(kFull, jl < n_rows && box_hits(boxes[jl], wr));
      while (todo) {                         // the rows in row order
        const int j = g0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const float4* r = buf + j * (FP / 4);
        const Pair pr = pair_alpha(r[0], r[1], px, py);
        blend_row<C>(r, pr.alpha, T, acc, med, has_med);
      }
    }
    if ((s + 1) % sub_per_chunk == 0) {
      // tile-wide early stop after each chunk; also the barrier before
      // the buffer just walked is staged again
      if (!__syncthreads_or(T >= kSaturatedT)) break;
    } else {
      __syncthreads();
    }
  }
  cp_async_wait<0>();   // a prefetch past the stop may still be in flight

  const size_t px_idx = (size_t)tile * P + p;
#pragma unroll
  for (int c = 0; c < C; ++c) out_color[px_idx * C + c] = acc[c];
  out_t[px_idx] = T;
  out_med[px_idx] = has_med ? med : max_depth;
  if (p == 0) out_walked[tile] = walked;
}

template <int C>
cudaError_t launch(const float* packed, const float* pix_xy,
                   const int* nvalid, float* out_color, float* out_t,
                   float* out_med, int* out_walked, int T, int K, int P,
                   int chunk, float max_depth, cudaStream_t stream) {
  const int sub = chunk % kSub == 0 ? kSub : chunk;
  const size_t smem = sizeof(float) *
      ((size_t)2 * sub * padded_stride(kBaseF + C) + (size_t)4 * sub);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blend_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  blend_kernel<C><<<T, P, smem, stream>>>(packed, pix_xy, nvalid, out_color,
                                          out_t, out_med, out_walked, K, P,
                                          chunk, sub, max_depth);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fnc_blend(const float* packed, const float* pix_xy,
                         const int* nvalid, float* out_color, float* out_t,
                         float* out_med, int* out_walked, int T, int K,
                         int C, int P, int chunk, float max_depth,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FNC_BLEND_CASE(CC)                                                 \
  case CC:                                                                 \
    return launch<CC>(packed, pix_xy, nvalid, out_color, out_t, out_med,   \
                      out_walked, T, K, P, chunk, max_depth, s);
  switch (C) {
    FNC_BLEND_CASE(1) FNC_BLEND_CASE(2) FNC_BLEND_CASE(3) FNC_BLEND_CASE(4)
    FNC_BLEND_CASE(5) FNC_BLEND_CASE(6) FNC_BLEND_CASE(7) FNC_BLEND_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FNC_BLEND_CASE
}
