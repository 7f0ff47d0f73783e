// K2: analytic backward of the K1 tile blend, per slot row.
//
// Replaces the Pallas TPU kernel fisher_nerf_customized_tpu/ops/
// pallas_blend_bwd.py::_blend_bwd_kernel (launched by
// pallas_blend_bwd_slots).  Its plain PyTorch twin is
// ops/cuda_blend_bwd.py::blend_bwd_plain, which the wrapper
// ops/cuda_blend_bwd.py::cuda_blend_bwd runs for CPU tensors.
//
// Inputs, per tile t of T:
//   packed (T, K, 8+C) f32 K1's rows (layout in blend_common.cuh)
//   pix_xy (T, 2, P) f32 pixel coordinates
//   gcol   (T, P, C) f32 cotangent of the blended color
//   g_t    (T, P) f32 cotangent of the final transmittance
//   nvalid (T,) i32 number of valid front rows
//   color  (T, P, C) f32 K1's blended color (without background)
//   t_fin  (T, P) f32 K1's final transmittance
//   walked (T,) i32 K1's rows walked (its stop)
// Output: (T, K, 6+C) f32 per slot, summed over the tile's pixels:
// [d mu_x, d mu_y, d con_a, d con_b, d con_c, d opacity, d color_0..C-1];
// rows past the forward's stop or past nvalid are 0.  Conventions of the
// Pallas kernel: the 0.99 alpha clamp does not gate the gradient,
// 1/(1 - alpha) is taken as 1/max(1 - alpha, 1e-2), dL/dalpha is 0 where
// alpha is 0.
//
// What bounds it on an H100: instruction issue and latency of the
// per-pair chain (evaluation, gradient, the sums over pixels), on the
// heaviest tiles; bytes are far below (PERF.md).  The design:
//   * walks once, front to back, over the rows K1 walked (min(walked,
//     nvalid)), carrying per pixel T and run = sum_{j<=i} alpha_j T_j cg_j
//     (cg = color . gcol); the suffix comes from K1's output:
//     S_behind,i = gcol . C_final - run_i, and g_T T_final from K1's final
//     T.  The stop is K1's, so the two kernels cannot disagree on it;
//   * with the stop given, a tile's pixels are independent, so a tile is
//     split over a thread-block cluster of `splits` blocks (the fewest, at
//     least 2, of at most 256 threads), and each pixel over two lanes that
//     take alternate rows of the warp's list: each lane evaluates its own
//     row, the pair swaps alpha and cg by one shuffle each and both advance
//     T and run over the two rows in row order (the same arithmetic as one
//     lane walking both), so a tile has twice the warps and each walks half
//     the steps (PERF.md lists the layouts measured);
//   * per row the 6+C sums over a warp's pixels go through a
//     reduce-scatter butterfly on 16 values: each round halves what a
//     lane carries (8 + 4 + 2 + 1 shuffles), and the four rounds leave the
//     two rows' sums in the even and the odd lanes.  6+C lanes of each
//     half then store the sums with plain stores into the warp's own
//     slice of a per-sub-chunk buffer (no atomics); rows no pixel of the
//     warp blends skip all of it (__any_sync).  After each sub-chunk the
//     block adds the warps' slices, in warp order, into its K x (6+C)
//     accumulator; at the end the cluster adds its blocks' accumulators
//     through distributed shared memory, in rank order, and writes every
//     row of the tile once (zeros past the stop): no global atomics, no
//     memset, and a fixed order of summation across warps and blocks;
//   * staging and culling as in K1 (blend_common.cuh): cp.async into a
//     double buffer of 64-row sub-chunks at a float4 stride, one box per
//     row per sub-chunk, a per-warp ballot of the rows whose box reaches
//     the warp's pixels.  A skipped pair has alpha = 0 by the kernel's own
//     test and contributes nothing, so the results are unchanged.
// The per-Gaussian scatter-add of the rows stays outside, in torch.
//
// The probe-batched variant (fnc_blend_bwd_probes) takes B cotangents of
// one forward, gcol (B, T, P, C) and g_t (B, T, P), and writes
// (B, T, K, 6+C): the Hutchinson estimators' B probes through one VJP,
// which the JAX package runs as jax.vmap over the Pallas VJP.  It is the
// same kernel with the probe on gridDim.y: each block walks its tile for
// one probe, so a probe's rows are those of a lone launch on that probe,
// to the bit, and the tile's packed rows, read once per probe, come from
// L2 after the first.
#include <cooperative_groups.h>

#include "blend_common.cuh"

namespace {

using namespace fnc;
namespace cg = cooperative_groups;

constexpr int kSub = 64;       // rows per staged sub-chunk
constexpr int kMaxThreads = 256;
constexpr int kMaxSplits = 8;  // the portable cluster size

// One round of the reduce-scatter: lanes whose bit (2 H) is set keep the
// upper H of their first 2 H values, the others the lower H, and each adds
// its partner's copy of the half it keeps.
template <int H>
__device__ __forceinline__ void scatter_round(float (&v)[16], int lane) {
  const bool up = lane & (2 * H);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = up ? v[j] : v[j + H];
    const float keep = up ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, 2 * H);
  }
}

// The gradient sums of one (pixel, row) pair: [d mu_x, d mu_y, d con_a,
// d con_b, d con_c, d opacity, d color_0..C-1] in v (zero where alpha is 0).
template <int C>
__device__ __forceinline__ void pair_grads(float (&v)[16], const Pair& pr,
                                           float4 r0, float4 r1,
                                           float t_before, float cg,
                                           float s_b, float gtf,
                                           const float (&gc)[C]) {
#pragma unroll
  for (int q = 0; q < 16; ++q) v[q] = 0.f;
  if (!(pr.alpha > 0.f)) return;
  const float dx = pr.dx, dy = pr.dy;
  const float inv_om = __frcp_rn(fmaxf(1.f - pr.alpha, 1e-2f));
  const float dl_da = t_before * cg - (s_b + gtf) * inv_om;
  const float t1 = r1.y * dl_da * pr.g;   // dL/dG * G
  v[0] = -t1 * (r0.z * dx + r0.w * dy);
  v[1] = -t1 * (r1.x * dy + r0.w * dx);
  v[2] = -0.5f * t1 * dx * dx;
  v[3] = -t1 * dx * dy;
  v[4] = -0.5f * t1 * dy * dy;
  v[5] = pr.g * dl_da;
  const float w = pr.alpha * t_before;
#pragma unroll
  for (int c = 0; c < C; ++c) v[6 + c] = w * gc[c];
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
blend_bwd_kernel(const float* __restrict__ packed,
                 const float* __restrict__ pix_xy,
                 const float* __restrict__ gcol,
                 const float* __restrict__ g_t,
                 const int* __restrict__ nvalid,
                 const float* __restrict__ color,
                 const float* __restrict__ t_fin,
                 const int* __restrict__ walked,
                 float* __restrict__ out, int n_tiles, int K, int P) {
  constexpr int F = kBaseF + C;
  // the probe (gridDim.y): its cotangents and its output rows
  gcol += (size_t)blockIdx.y * n_tiles * P * C;
  g_t += (size_t)blockIdx.y * n_tiles * P;
  out += (size_t)blockIdx.y * n_tiles * K * (6 + C);
  constexpr int FP = padded_stride(F);
  constexpr int G = 6 + C;
  static_assert(G <= 16, "the reduce-scatter carries 16 sums");
  extern __shared__ float4 smem[];
  float4* rows = smem;                          // 2 buffers of kSub * FP
  float4* boxes = rows + 2 * kSub * (FP / 4);   // kSub boxes
  float* acc = reinterpret_cast<float*>(boxes + kSub);   // K * G
  float* part = acc + K * G;                    // warps * kSub * G
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int tile = blockIdx.x / splits;
  const int lane = threadIdx.x & 31;
  // this lane's pixel: 16 consecutive pixels per warp, two lanes each;
  // lane bit 0 (`half`) picks the rows the lane evaluates
  const int half = lane & 1;
  const int p = rank * (P / splits) + warp * 16 + lane / 2;
  const size_t q = (size_t)tile * P + p;
  const float px = pix_xy[(size_t)tile * 2 * P + p];
  const float py = pix_xy[(size_t)tile * 2 * P + P + p];
  float gc[C], gC = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gc[c] = gcol[q * C + c];
    gC += gc[c] * color[q * C + c];
  }
  const float gtf = g_t[q] * t_fin[q];
  float T = 1.f, run = 0.f;
  const float4 wr = warp_range(px, px, py, py);

  const int n_walk = min(walked[tile], nvalid[tile]);
  const int n_sub = (n_walk + kSub - 1) / kSub;
  const float* tile_rows = packed + (size_t)tile * K * F;
  const bool aligned16 = (reinterpret_cast<uintptr_t>(packed) & 15) == 0;
  for (int i = threadIdx.x; i < n_warps * kSub * G; i += blockDim.x)
    part[i] = 0.f;

  if (n_sub > 0) {
    stage_rows<F>(reinterpret_cast<float*>(rows), tile_rows,
                  min(kSub, n_walk), aligned16);
    cp_async_commit();
  }
  for (int s = 0; s < n_sub; ++s) {
    const int k0 = s * kSub;
    if (s + 1 < n_sub) {
      const int k1 = k0 + kSub;
      stage_rows<F>(reinterpret_cast<float*>(rows + ((s + 1) & 1) * kSub *
                                             (FP / 4)),
                    tile_rows + (size_t)k1 * F, min(kSub, n_walk - k1),
                    aligned16);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // sub-chunk s has landed
    const int n_rows = min(kSub, n_walk - k0);
    const float4* buf = rows + (s & 1) * kSub * (FP / 4);
    for (int j = threadIdx.x; j < n_rows; j += blockDim.x)
      boxes[j] = row_box(buf + j * (FP / 4));
    __syncthreads();

    for (int g0 = 0; g0 < n_rows; g0 += 32) {
      const int jl = g0 + lane;
      unsigned todo = __ballot_sync(kFull, jl < n_rows && box_hits(boxes[jl], wr));
      while (todo) {
        // two rows per step, in row order: the even lane takes the first,
        // the odd lane the second
        const int ja = g0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const bool two = todo != 0;
        const int jb = two ? g0 + __ffs(todo) - 1 : ja;
        if (two) todo &= todo - 1;
        const int j = half ? jb : ja;
        const bool mine = !half || two;
        const float4* r = buf + j * (FP / 4);
        const float4 r0 = r[0], r1 = r[1];
        float col[C];
        load_colors<C>(r, col);
        Pair pr = pair_alpha(r0, r1, px, py);
        if (!mine) pr.alpha = 0.f;
        float cg = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) cg += col[c] * gc[c];
        // the pixel's walk over this step's two rows, in row order; both
        // lanes compute it from both rows' alpha and cg
        const float a_o = __shfl_xor_sync(kFull, pr.alpha, 1);
        const float cg_o = __shfl_xor_sync(kFull, cg, 1);
        const float a0 = half ? a_o : pr.alpha, cg0 = half ? cg_o : cg;
        const float a1 = half ? pr.alpha : a_o, cg1 = half ? cg : cg_o;
        const float t0 = T;
        run += a0 * T * cg0;
        T *= 1.f - a0;
        const float run0 = run, t1 = T;
        run += a1 * T * cg1;
        T *= 1.f - a1;
        const float t_before = half ? t1 : t0;
        const float run_incl = half ? run : run0;
        if (!__any_sync(kFull, pr.alpha > 0.f)) continue;
        float v[16];
        pair_grads<C>(v, pr, r0, r1, t_before, cg, gC - run_incl, gtf, gc);
        // sums over the warp's pixels, per row: lane L ends with the sum
        // over the lanes of its half (its row) of value L / 2
        scatter_round<8>(v, lane);
        scatter_round<4>(v, lane);
        scatter_round<2>(v, lane);
        scatter_round<1>(v, lane);
        const int slot = lane >> 1;
        if (slot < G && mine) part[(warp * kSub + j) * G + slot] = v[0];
      }
    }
    // the warps' sums of this sub-chunk into the block's accumulator, in
    // warp order; this barrier also precedes restaging the buffer walked
    __syncthreads();
    for (int e = threadIdx.x; e < n_rows * G; e += blockDim.x) {
      float sum = 0.f;
      for (int w = 0; w < n_warps; ++w) {
        sum += part[w * kSub * G + e];
        part[w * kSub * G + e] = 0.f;
      }
      acc[k0 * G + e] = sum;
    }
  }

  // the cluster adds its blocks' accumulators, in rank order, and writes
  // the tile's rows once
  cluster.sync();
  float* o = out + (size_t)tile * K * G;
  for (int i = rank * blockDim.x + threadIdx.x; i < K * G;
       i += splits * blockDim.x) {
    float sum = 0.f;
    if (i < n_walk * G)
      for (int b = 0; b < splits; ++b) sum += cluster.map_shared_rank(acc, b)[i];
    o[i] = sum;
  }
  cluster.sync();    // no block leaves while another reads its accumulator
}

template <int C>
cudaError_t launch(const float* packed, const float* pix_xy,
                   const float* gcol, const float* g_t, const int* nvalid,
                   const float* color, const float* t_fin, const int* walked,
                   float* out, int B, int T, int K, int P, int splits,
                   cudaStream_t stream) {
  const int threads = 2 * P / splits;       // two lanes per pixel
  if (splits < 1 || splits > kMaxSplits || threads * splits != 2 * P ||
      threads % 32 != 0 || threads > kMaxThreads || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  const int warps = threads / 32;
  const size_t smem = sizeof(float) *
      ((size_t)2 * kSub * padded_stride(kBaseF + C) + (size_t)4 * kSub +
       (size_t)(K + warps * kSub) * (6 + C));
  auto kernel = blend_bwd_kernel<C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T * splits, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, packed, pix_xy, gcol,
                                           g_t, nvalid, color, t_fin, walked,
                                           out, T, K, P);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// splits: blocks (one cluster) per tile, 1 to 8, each of 2 P / splits
// threads, a multiple of 32 and at most 256.
static int dispatch(const float* packed, const float* pix_xy,
                    const float* gcol, const float* g_t, const int* nvalid,
                    const float* color, const float* t_fin, const int* walked,
                    float* out, int B, int T, int K, int C, int P, int splits,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FNC_BWD_CASE(CC)                                                  \
  case CC:                                                                \
    return launch<CC>(packed, pix_xy, gcol, g_t, nvalid, color, t_fin,    \
                      walked, out, B, T, K, P, splits, s);
  switch (C) {
    FNC_BWD_CASE(1) FNC_BWD_CASE(2) FNC_BWD_CASE(3) FNC_BWD_CASE(4)
    FNC_BWD_CASE(5) FNC_BWD_CASE(6) FNC_BWD_CASE(7) FNC_BWD_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FNC_BWD_CASE
}

extern "C" int fnc_blend_bwd(const float* packed, const float* pix_xy,
                             const float* gcol, const float* g_t,
                             const int* nvalid, const float* color,
                             const float* t_fin, const int* walked,
                             float* out, int T, int K, int C, int P,
                             int splits, void* stream) {
  return dispatch(packed, pix_xy, gcol, g_t, nvalid, color, t_fin, walked,
                  out, 1, T, K, C, P, splits, stream);
}

// The probe-batched variant: B cotangents (B, T, P, C) and (B, T, P) of
// one forward, output (B, T, K, 6+C); B at most 65535.
extern "C" int fnc_blend_bwd_probes(const float* packed, const float* pix_xy,
                                    const float* gcol, const float* g_t,
                                    const int* nvalid, const float* color,
                                    const float* t_fin, const int* walked,
                                    float* out, int B, int T, int K, int C,
                                    int P, int splits, void* stream) {
  return dispatch(packed, pix_xy, gcol, g_t, nvalid, color, t_fin, walked,
                  out, B, T, K, C, P, splits, stream);
}
