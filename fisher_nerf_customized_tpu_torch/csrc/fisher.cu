// K3: Fisher squared backward (grad_power = 2) per slot row.
//
// Replaces the Pallas TPU kernel fisher_nerf_customized_tpu/ops/
// pallas_fisher.py::_fisher_kernel (launched by pallas_fisher_slots).
// Its plain PyTorch twin is ops/cuda_fisher.py::fisher_slots_plain, which
// the wrapper ops/cuda_fisher.py::cuda_fisher_slots runs for CPU tensors.
//
// Inputs, per (pose, tile) row bt of B*T:
//   packed (B*T, K, NF) f32, NF = 11: [mu_x, mu_y, con_a, con_b, con_c,
//          opacity (0 on invalid rows), depth, mc_x, mc_y, mc_z, color sum]
//          or NF = 20: the same plus the 9-entry d(conic)/d(mean_cam)
//          Jacobian (full chain); valid rows first
//   pix_xy (T, 2, P) f32, shared by every pose
//   nvalid (B*T,) i32
// Output: h (B*T, K, 4) f32, per slot the sum over the tile's pixels of the
// squared per-pixel gradient w.r.t. [mean_cam x, y, z, opacity] under a
// uniform cotangent grad_value; rows past the walked chunks are 0.
//
// What bounds it on an H100: arithmetic.  Each row is read twice per
// tile (once per pass) and reused by all P = 1024 pixels, while every
// walked pixel-slot pair costs ~3 alpha evaluations (pass 1 and the two
// sweeps of pass 2) plus ~45 flops of gradient chain (~65 with the full
// chain): the operation bound is far above the byte bound (PERF.md).
// The design keeps all per-pair intermediates in registers:
//   * one block per (pose, tile), 256 threads, PPT = P/256 pixels each;
//   * pass 1 walks chunks front to back, storing each chunk's starting T
//     per pixel in shared memory (the Pallas tstart scratch; 32 KB at
//     K = 512, chunk 64, P = 1024) and stops the tile with
//     __syncthreads_or(T >= 1e-4) at chunk granularity, as the Pallas
//     while_loop cond does; the chunks walked are k_eff;
//   * pass 2 walks the k_eff chunks back to front.  Per chunk, sweep A
//     re-walks the chunk from its stored T to get the chunk's total color
//     contribution per pixel; sweep B re-walks it again and forms the
//     suffix S_behind = carry + (total - inclusive prefix), so no
//     per-slot transmittance is ever stored;
//   * per slot the four squared gradients are summed over the thread's
//     pixels, then over the warp by shuffles (skipped when the whole warp
//     has no live pixel), then one shared-memory atomicAdd per warp into
//     a chunk x 4 accumulator, then one coalesced store per chunk.
// The per-Gaussian scatter-add of the rows stays outside, in torch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Alpha {
  float alpha, g, dx, dy;
};

__device__ __forceinline__ Alpha chunk_alpha(const float* r, float px,
                                             float py) {
  Alpha o;
  o.dx = r[0] - px;
  o.dy = r[1] - py;
  const float power = -0.5f * (r[2] * o.dx * o.dx + r[4] * o.dy * o.dy)
                      - r[3] * o.dx * o.dy;
  o.alpha = 0.f;
  o.g = 0.f;
  if (power <= 0.f) {
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

template <int PPT, bool FULL>
__global__ void __launch_bounds__(kThreads)
fisher_kernel(const float* __restrict__ packed,
              const float* __restrict__ pix_xy,
              const int* __restrict__ nvalid, float* __restrict__ out_h,
              int n_tiles, int K, int chunk, float grad_value, float fx,
              float fy) {
  constexpr int NF = FULL ? 20 : 11;
  constexpr int P = PPT * kThreads;
  extern __shared__ float smem[];
  float* rows = smem;                           // chunk * NF
  float* tstart = rows + chunk * NF;            // (K / chunk) * P
  float* hacc = tstart + (K / chunk) * P;       // chunk * 4

  const int bt = blockIdx.x;                    // pose * n_tiles + tile
  const int tile = bt % n_tiles;
  const float* slots = packed + (size_t)bt * K * NF;
  float* h = out_h + (size_t)bt * K * 4;
  const int lane = threadIdx.x & 31;

  float px[PPT], py[PPT], t[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * kThreads;
    px[i] = pix_xy[(size_t)tile * 2 * P + p];
    py[i] = pix_xy[(size_t)tile * 2 * P + P + p];
    t[i] = 1.f;
  }
  const int nv = nvalid[bt];
  const int n_chunks = min(K / chunk, (nv + chunk - 1) / chunk);
  for (int i = threadIdx.x; i < K * 4; i += kThreads) h[i] = 0.f;

  // ---- pass 1: forward walk, record each chunk's starting T ----------
  int k_eff = 0;
  while (k_eff < n_chunks) {
    // rows past nvalid have opacity 0 and contribute nothing: skip them
    const int n_rows = min(chunk, nv - k_eff * chunk);
    const float* src = slots + (size_t)k_eff * chunk * NF;
    for (int i = threadIdx.x; i < n_rows * NF; i += kThreads) rows[i] = src[i];
#pragma unroll
    for (int i = 0; i < PPT; ++i)
      tstart[k_eff * P + threadIdx.x + i * kThreads] = t[i];
    __syncthreads();
    for (int j = 0; j < n_rows; ++j) {
      const float* r = rows + j * NF;
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        t[i] *= 1.f - chunk_alpha(r, px[i], py[i]).alpha;
    }
    ++k_eff;
    bool live = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) live |= t[i] >= 1e-4f;
    if (!__syncthreads_or(live)) break;
  }

  // ---- pass 2: reverse walk over the k_eff chunks ----------------------
  float s_carry[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) s_carry[i] = 0.f;
  for (int ci = k_eff - 1; ci >= 0; --ci) {
    const int n_rows = min(chunk, nv - ci * chunk);
    const float* src = slots + (size_t)ci * chunk * NF;
    for (int i = threadIdx.x; i < n_rows * NF; i += kThreads) rows[i] = src[i];
    for (int i = threadIdx.x; i < chunk * 4; i += kThreads) hacc[i] = 0.f;
    __syncthreads();

    // sweep A: the chunk's total channel-summed contribution per pixel
    float tot[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      tot[i] = 0.f;
      t[i] = tstart[ci * P + threadIdx.x + i * kThreads];
    }
    for (int j = 0; j < n_rows; ++j) {
      const float* r = rows + j * NF;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float a = chunk_alpha(r, px[i], py[i]).alpha;
        tot[i] += a * t[i] * r[10];
        t[i] *= 1.f - a;
      }
    }

    // sweep B: per-pair gradients, squared, summed over pixels
    float prefix[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      prefix[i] = 0.f;
      t[i] = tstart[ci * P + threadIdx.x + i * kThreads];
    }
    for (int j = 0; j < n_rows; ++j) {
      const float* r = rows + j * NF;
      const float a_ = r[2], b_ = r[3], c_ = r[4], opa = r[5];
      const float csum = r[10];
      const float z = fmaxf(r[9], 1e-6f);
      float hx = 0.f, hy = 0.f, hz = 0.f, ho = 0.f;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const Alpha al = chunk_alpha(r, px[i], py[i]);
        const float t_before = t[i];
        const float contrib = al.alpha * t_before * csum;
        prefix[i] += contrib;
        t[i] *= 1.f - al.alpha;
        if (!(al.alpha > 0.f)) continue;
        const float s_b = s_carry[i] + (tot[i] - prefix[i]);
        const float inv_om = 1.f / fmaxf(1.f - al.alpha, 1e-2f);
        const float dl_da = grad_value * (t_before * csum - s_b * inv_om);
        const float dl_do = al.g * dl_da;
        const float dl_dg = opa * dl_da;
        const float dl_dmx = dl_dg * (-al.g * (a_ * al.dx + b_ * al.dy));
        const float dl_dmy = dl_dg * (-al.g * (c_ * al.dy + b_ * al.dx));
        float gx = dl_dmx * (fx / z);
        float gy = dl_dmy * (fy / z);
        float gz = -(dl_dmx * fx * r[7] + dl_dmy * fy * r[8]) / (z * z);
        if (FULL) {
          // cov2D-through-mean chain: the per-pixel conic cotangent
          // contracted with the packed d(conic)/d(mean_cam) Jacobian
          const float t1 = dl_dg * al.g;
          const float ca = -0.5f * t1 * al.dx * al.dx;
          const float cb = -t1 * al.dx * al.dy;
          const float cc = -0.5f * t1 * al.dy * al.dy;
          gx += ca * r[11] + cb * r[14] + cc * r[17];
          gy += ca * r[12] + cb * r[15] + cc * r[18];
          gz += ca * r[13] + cb * r[16] + cc * r[19];
        }
        hx += gx * gx;
        hy += gy * gy;
        hz += gz * gz;
        ho += dl_do * dl_do;
      }
      const bool any = (hx != 0.f) || (hy != 0.f) || (hz != 0.f) ||
                       (ho != 0.f);
      if (__any_sync(0xffffffffu, any)) {
        hx = warp_sum(hx);
        hy = warp_sum(hy);
        hz = warp_sum(hz);
        ho = warp_sum(ho);
        if (lane == 0) {
          atomicAdd(&hacc[j * 4 + 0], hx);
          atomicAdd(&hacc[j * 4 + 1], hy);
          atomicAdd(&hacc[j * 4 + 2], hz);
          atomicAdd(&hacc[j * 4 + 3], ho);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) s_carry[i] += tot[i];
    __syncthreads();
    for (int i = threadIdx.x; i < chunk * 4; i += kThreads)
      h[(size_t)ci * chunk * 4 + i] = hacc[i];
    __syncthreads();  // hacc and rows are reused by the next chunk
  }
}

template <int PPT, bool FULL>
cudaError_t launch(const float* packed, const float* pix_xy,
                   const int* nvalid, float* out_h, int BT, int n_tiles,
                   int K, int chunk, float grad_value, float fx, float fy,
                   cudaStream_t stream) {
  constexpr int NF = FULL ? 20 : 11;
  constexpr int P = PPT * kThreads;
  const size_t smem = sizeof(float) *
      ((size_t)chunk * NF + (size_t)(K / chunk) * P + (size_t)chunk * 4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fisher_kernel<PPT, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  fisher_kernel<PPT, FULL><<<BT, kThreads, smem, stream>>>(
      packed, pix_xy, nvalid, out_h, n_tiles, K, chunk, grad_value, fx, fy);
  return cudaGetLastError();
}

}  // namespace

// P must be 256, 512 or 1024 (PPT = 1, 2, 4); NF must be 11 or 20.
extern "C" int fnc_fisher(const float* packed, const float* pix_xy,
                          const int* nvalid, float* out_h, int BT,
                          int n_tiles, int K, int NF, int P, int chunk,
                          float grad_value, float fx, float fy,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool full = NF == 20;
  if (NF != 11 && NF != 20) return static_cast<int>(cudaErrorInvalidValue);
#define FNC_LAUNCH(PPT_)                                                     \
  return full ? launch<PPT_, true>(packed, pix_xy, nvalid, out_h, BT,        \
                                   n_tiles, K, chunk, grad_value, fx, fy, s) \
              : launch<PPT_, false>(packed, pix_xy, nvalid, out_h, BT,       \
                                    n_tiles, K, chunk, grad_value, fx, fy, s)
  switch (P) {
    case 256: FNC_LAUNCH(1);
    case 512: FNC_LAUNCH(2);
    case 1024: FNC_LAUNCH(4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FNC_LAUNCH
}
