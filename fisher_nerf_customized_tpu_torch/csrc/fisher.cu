// K3: Fisher squared backward (grad_power = 2) per slot row.
//
// Replaces the Pallas TPU kernel fisher_nerf_customized_tpu/ops/
// pallas_fisher.py::_fisher_kernel (launched by pallas_fisher_slots).
// Its plain PyTorch twin is ops/cuda_fisher.py::fisher_slots_plain, which
// the wrapper ops/cuda_fisher.py::cuda_fisher_slots runs for CPU tensors;
// ops/cuda_fisher.py::fisher_one_walk is this kernel's algebra in plain
// PyTorch.
//
// Inputs, per (pose, tile) row bt of B*T:
//   packed (B*T, K, NF) f32, NF = 11: [mu_x, mu_y, con_a, con_b, con_c,
//          opacity (0 on invalid rows), depth, mc_x, mc_y, mc_z, color sum]
//          or NF = 20: the same plus the 9-entry d(conic)/d(mean_cam)
//          Jacobian (full chain); valid rows first
//   pix_xy (T, 2, P) f32, shared by every pose
//   nvalid (B*T,) i32
//   sums   (B*T, P / 64, K, 4) f32 scratch from the wrapper: each warp's
//          per-row sums over its pixels (only rows it blends are written)
// Output: h (B*T, K, 4) f32, per slot the sum over the tile's pixels of the
// squared per-pixel gradient w.r.t. [mean_cam x, y, z, opacity] under a
// uniform cotangent grad_value; rows past the walked chunks are 0.  The
// tile stops after the first chunk that leaves every pixel's T below
// 1e-4, or at ceil(nvalid / chunk) chunks (the Pallas while_loop's rule).
//
// What bounds it on an H100: operations on live pairs (alpha > 0).  Each
// row is read from device memory once per tile and reused by its P
// pixels; a live pair costs two alpha evaluations (one per pass) and the
// gradient chain, 69 operations in all (95 with the full chain), so the
// operation bound is far above the byte bound (PERF.md).  What the design
// does about it:
//   * one block per (pose, tile), P / 2 threads; each lane holds a 2x1
//     pair of pixels and each warp a compact 8x8 patch of the tile
//     (warp_pixel; mirrored by ops/cuda_fisher.py::fisher_warp_pixels),
//     so that the per-warp box test below culls most rows of the small
//     Gaussians of the Fisher camera (PERF.md has the 16x8 map's times);
//   * the tile's rows are staged chunk by chunk with cp.async at a float4
//     stride (12 or 20 floats), the next chunk while this one is walked,
//     and stay in shared memory for pass 2 (24 KB at K 512, NF 11);
//   * pass 1 walks front to back only the rows whose opacity-aware box
//     (blend_common.cuh::row_box) reaches the warp's patch, carrying per
//     pixel T and the channel-summed total C = sum alpha T csum, and
//     records per warp, by a ballot per 32 rows, the rows that blend at
//     any of its pixels; after each chunk __syncthreads_or(T >= 1e-4)
//     stops the tile;
//   * pass 2 walks the same chunks front to back again, only the rows
//     that blend in the warp, from T = 1 and run = 0 with the same
//     arithmetic, so run repeats pass 1's partial sums of C bit for bit
//     and S_behind = C - run is exact up to the rounding of the suffix's
//     own additions; no per-chunk state is stored.  A row a warp skips
//     has alpha = 0 at every one of its pixels, so no result changes;
//   * per row, a lane adds its pixels' four squared gradients, a 6-shuffle
//     reduce-scatter sums them over the warp, and four lanes store the
//     sums into the warp's rows of the `sums` scratch.  Pass 2 has no
//     barrier: each warp walks all its rows at its own pace (with a
//     barrier after each chunk, as pass 1 needs for the stop, the busiest
//     warp of each chunk set the pace and K3 took 0.54 instead of 0.47 ms,
//     PERF.md).  At the end the block adds, per row, the sums of the warps
//     that blend it in warp order and writes each row of h once, zeros
//     past the walk: no atomics, and two launches give the same h to the
//     bit;
//   * alpha in select form (blend_common.cuh::pair_alpha): a NaN never
//     blends, as in the twin and the Pallas kernel.
// Not used: tensor cores (the transmittance chain is a sequential f32
// product; TF32 would move pairs across the 1/255 cut and the 1e-4 stop)
// and TMA (cp.async suffices for ~450 rows of 44-80 bytes per tile).
// The per-Gaussian scatter-add of the rows stays outside, in torch.
#include "blend_common.cuh"

namespace {

using namespace fnc;

constexpr int kPPL = 2;                    // pixels per lane: a 2x1 pair
constexpr int kMaxThreads = 1024 / kPPL;   // at P = 1024

// Pixel index (into the tile's P pixels) of the i-th pixel of lane `lane`
// of warp `warp`: a lane's 2x1 pair, 4 pairs wide and 8 tall per warp, so
// a warp covers 8x8 pixels; the warps' patches tile the tile row-major.
// The tile is 32 pixels wide at P >= 512 and 16 at P = 256.
__device__ __forceinline__ int warp_pixel(int P, int warp, int lane, int i) {
  const int tw = P >= 512 ? 32 : 16;
  const int per_row = tw / 8;
  const int x = (warp % per_row) * 8 + (lane & 3) * 2 + i;
  const int y = (warp / per_row) * 8 + (lane >> 2);
  return y * tw + x;
}

// Sums of v0..v3 over the warp by a reduce-scatter: lane L ends with the
// sum of value L >> 3 (6 shuffles where four butterflies take 20).
__device__ __forceinline__ float warp_sum4(float v0, float v1, float v2,
                                           float v3, int lane) {
  const bool hi4 = lane & 16;
  const float a = (hi4 ? v2 : v0) + __shfl_xor_sync(kFull, hi4 ? v0 : v2, 16);
  const float b = (hi4 ? v3 : v1) + __shfl_xor_sync(kFull, hi4 ? v1 : v3, 16);
  const bool hi3 = lane & 8;
  float v = (hi3 ? b : a) + __shfl_xor_sync(kFull, hi3 ? a : b, 8);
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 1);
  return v;
}

template <bool FULL>
__global__ void __launch_bounds__(kMaxThreads)
fisher_kernel(const float* __restrict__ packed,
              const float* __restrict__ pix_xy,
              const int* __restrict__ nvalid, float* __restrict__ sums,
              float* __restrict__ out_h, int n_tiles, int K, int P,
              int chunk, float grad_value, float fx, float fy) {
  constexpr int NF = FULL ? 20 : 11;
  constexpr int Q = padded_stride(NF) / 4;      // float4s per staged row
  const int n_warps = blockDim.x >> 5;
  const int n_ck = K / chunk;
  const int groups = (chunk + 31) >> 5;         // 32-row ballots per chunk
  extern __shared__ float4 smem[];
  float4* rows = smem;                          // K * Q: the tile's rows
  float4* boxes = rows + K * Q;                 // chunk boxes
  // per warp and chunk, the rows that blend at some pixel of the warp
  unsigned* blends = reinterpret_cast<unsigned*>(boxes + chunk);

  const int bt = blockIdx.x;                    // pose * n_tiles + tile
  const int tile = bt % n_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* slots = packed + (size_t)bt * K * NF;
  float* h = out_h + (size_t)bt * K * 4;
  const float* tile_sums = sums + (size_t)bt * n_warps * K * 4;
  float* my_sums = sums + ((size_t)bt * n_warps + warp) * K * 4;
  unsigned* my_blends = blends + warp * n_ck * groups;

  float px[kPPL], py[kPPL], T[kPPL], C[kPPL];
  float x0 = 0.f, x1 = 0.f, y0 = 0.f, y1 = 0.f;
#pragma unroll
  for (int i = 0; i < kPPL; ++i) {
    const int p = warp_pixel(P, warp, lane, i);
    px[i] = pix_xy[(size_t)tile * 2 * P + p];
    py[i] = pix_xy[(size_t)tile * 2 * P + P + p];
    T[i] = 1.f;
    C[i] = 0.f;
    x0 = i ? fminf(x0, px[i]) : px[i];
    x1 = i ? fmaxf(x1, px[i]) : px[i];
    y0 = i ? fminf(y0, py[i]) : py[i];
    y1 = i ? fmaxf(y1, py[i]) : py[i];
  }
  const float4 wr = warp_range(x0, x1, y0, y1);
  const int nv = min(nvalid[bt], K);
  const int n_chunks = (nv + chunk - 1) / chunk;
  const bool aligned16 = (reinterpret_cast<uintptr_t>(slots) & 15) == 0;

  // ---- pass 1: front to back, T and C per pixel, the tile's stop --------
  if (n_chunks > 0) {
    stage_rows<NF>(reinterpret_cast<float*>(rows), slots, min(chunk, nv),
                   aligned16);
    cp_async_commit();
  }
  int k_eff = 0;
  while (k_eff < n_chunks) {
    const int k0 = k_eff * chunk;
    if (k_eff + 1 < n_chunks) {
      const int k1 = k0 + chunk;
      stage_rows<NF>(reinterpret_cast<float*>(rows + k1 * Q),
                     slots + (size_t)k1 * NF, min(chunk, nv - k1), aligned16);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                            // chunk k_eff has landed
    const int n_rows = min(chunk, nv - k0);
    float4* buf = rows + k0 * Q;
    for (int j = threadIdx.x; j < n_rows; j += blockDim.x) {
      float4* r = buf + j * Q;
      const float4 r1 = r[1], r2 = r[2];
      boxes[j] = row_box(r[0], r1.x, r1.y, true);
      // pass 2's factors of the chain from the 2D mean to mean_cam, once
      // per row, in place of depth and mean_cam (no walk reads them
      // otherwise): fx / z, fy / z, -fx mc_x / z^2, -fy mc_y / z^2
      const float z = fmaxf(r2.y, 1e-6f);
      const float kx = fx / z, ky = fy / z;
      r[1] = make_float4(r1.x, r1.y, kx, ky);
      r[2] = make_float4(-kx * r1.w / z, -ky * r2.x / z, r2.z, r2.w);
    }
    __syncthreads();
    for (int g = 0; g < groups; ++g) {
      const int jl = g * 32 + lane;
      unsigned todo = __ballot_sync(kFull, jl < n_rows &&
                                               box_hits(boxes[jl], wr));
      unsigned blended = 0;
      while (todo) {                            // the rows in row order
        const int b = __ffs(todo) - 1;
        todo &= todo - 1;
        const float4* r = buf + (g * 32 + b) * Q;
        const float4 r0 = r[0], r1 = r[1];
        const float csum = r[2].z;
        bool any = false;
#pragma unroll
        for (int i = 0; i < kPPL; ++i) {
          const Pair pr = pair_alpha(r0, r1.x, r1.y, true, px[i], py[i]);
          const bool on = pr.alpha > 0.f;
          C[i] = on ? fmaf(pr.alpha * T[i], csum, C[i]) : C[i];
          T[i] = on ? T[i] * (1.f - pr.alpha) : T[i];
          any = any || on;
        }
        if (__any_sync(kFull, any)) blended |= 1u << b;
      }
      if (lane == 0) my_blends[k_eff * groups + g] = blended;
    }
    ++k_eff;
    bool open = false;
#pragma unroll
    for (int i = 0; i < kPPL; ++i) open = open || T[i] >= kSaturatedT;
    // the tile-wide stop; also orders this chunk's reads of `boxes` before
    // the next chunk's writes
    if (!__syncthreads_or(open)) break;
  }
  cp_async_wait<0>();   // a prefetch past the stop may still be in flight

  // ---- pass 2: the same chunks again, gradients from S_behind = C - run --
  float run[kPPL];
#pragma unroll
  for (int i = 0; i < kPPL; ++i) {
    T[i] = 1.f;
    run[i] = 0.f;
  }
  for (int ci = 0; ci < k_eff; ++ci) {
    const float4* buf = rows + ci * chunk * Q;
    for (int g = 0; g < groups; ++g) {
      unsigned todo = my_blends[ci * groups + g];
      while (todo) {
        const int j = g * 32 + __ffs(todo) - 1;
        todo &= todo - 1;
        const float4* r = buf + j * Q;
        const float4 r0 = r[0], r1 = r[1], r2 = r[2];
        const float csum = r2.z, opa = r1.y;
        const float kx = r1.z, ky = r1.w, kzx = r2.x, kzy = r2.y;
        float jac[9];
        if constexpr (FULL) {
          const float4 r3 = r[3], r4 = r[4];
          jac[0] = r2.w; jac[1] = r3.x; jac[2] = r3.y;
          jac[3] = r3.z; jac[4] = r3.w; jac[5] = r4.x;
          jac[6] = r4.y; jac[7] = r4.z; jac[8] = r4.w;
        }
        float hx = 0.f, hy = 0.f, hz = 0.f, ho = 0.f;
#pragma unroll
        for (int i = 0; i < kPPL; ++i) {
          const Pair pr = pair_alpha(r0, r1.x, opa, true, px[i], py[i]);
          const bool on = pr.alpha > 0.f;
          const float tb = T[i];
          run[i] = on ? fmaf(pr.alpha * tb, csum, run[i]) : run[i];
          T[i] = on ? tb * (1.f - pr.alpha) : tb;
          const float s_b = C[i] - run[i];
          const float inv_om = __frcp_rn(fmaxf(1.f - pr.alpha, 1e-2f));
          const float dl_da = grad_value * (tb * csum - s_b * inv_om);
          const float t1 = opa * dl_da * pr.g;          // dL/dG * G
          const float dmx = -t1 * (r0.z * pr.dx + r0.w * pr.dy);
          const float dmy = -t1 * (r1.x * pr.dy + r0.w * pr.dx);
          float gx = dmx * kx, gy = dmy * ky;
          float gz = dmx * kzx + dmy * kzy;
          if constexpr (FULL) {
            // cov2D-through-mean chain: the pixel's conic cotangent
            // contracted with the row's d(conic)/d(mean_cam)
            const float ca = -0.5f * t1 * pr.dx * pr.dx;
            const float cb = -t1 * pr.dx * pr.dy;
            const float cc = -0.5f * t1 * pr.dy * pr.dy;
            gx += ca * jac[0] + cb * jac[3] + cc * jac[6];
            gy += ca * jac[1] + cb * jac[4] + cc * jac[7];
            gz += ca * jac[2] + cb * jac[5] + cc * jac[8];
          }
          const float go = pr.g * dl_da;
          hx = on ? fmaf(gx, gx, hx) : hx;
          hy = on ? fmaf(gy, gy, hy) : hy;
          hz = on ? fmaf(gz, gz, hz) : hz;
          ho = on ? fmaf(go, go, ho) : ho;
        }
        const float v = warp_sum4(hx, hy, hz, ho, lane);
        if ((lane & 7) == 0) my_sums[(ci * chunk + j) * 4 + (lane >> 3)] = v;
      }
    }
  }
  // per row, the sums of the warps that blend it, in warp order
  __syncthreads();
  for (int e = threadIdx.x; e < k_eff * chunk * 4; e += blockDim.x) {
    const int k = e >> 2, ci = k / chunk, j = k - ci * chunk;
    float sum = 0.f;
    for (int w = 0; w < n_warps; ++w)
      if ((blends[(w * n_ck + ci) * groups + (j >> 5)] >> (j & 31)) & 1u)
        sum += tile_sums[(size_t)w * K * 4 + e];
    h[e] = sum;
  }
  for (int i = k_eff * chunk * 4 + threadIdx.x; i < K * 4; i += blockDim.x)
    h[i] = 0.f;
}

template <bool FULL>
cudaError_t launch(const float* packed, const float* pix_xy,
                   const int* nvalid, float* sums, float* out_h, int BT,
                   int n_tiles, int K, int P, int chunk, float grad_value,
                   float fx, float fy, cudaStream_t stream) {
  constexpr int NF = FULL ? 20 : 11;
  const int threads = P / kPPL;
  const int warps = threads / 32;
  const size_t smem = 16 * ((size_t)K * (padded_stride(NF) / 4) + chunk)
                      + 4 * (size_t)warps * (K / chunk) * ((chunk + 31) / 32);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fisher_kernel<FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  fisher_kernel<FULL><<<BT, threads, smem, stream>>>(
      packed, pix_xy, nvalid, sums, out_h, n_tiles, K, P, chunk, grad_value,
      fx, fy);
  return cudaGetLastError();
}

}  // namespace

// P must be 256, 512 or 1024; NF 11 or 20; chunk > 0 must divide K; sums
// holds BT * (P / 64) * K * 4 floats.
extern "C" int fnc_fisher(const float* packed, const float* pix_xy,
                          const int* nvalid, float* sums, float* out_h,
                          int BT, int n_tiles, int K, int NF, int P,
                          int chunk, float grad_value, float fx, float fy,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((NF != 11 && NF != 20) || (P != 256 && P != 512 && P != 1024) ||
      chunk <= 0 || K % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return NF == 20 ? launch<true>(packed, pix_xy, nvalid, sums, out_h, BT,
                                 n_tiles, K, P, chunk, grad_value, fx, fy, s)
                  : launch<false>(packed, pix_xy, nvalid, sums, out_h, BT,
                                  n_tiles, K, P, chunk, grad_value, fx, fy,
                                  s);
}
