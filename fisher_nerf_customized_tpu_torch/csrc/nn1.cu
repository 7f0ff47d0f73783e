// 1-NN: for each query point, the nearest unmasked reference point.
//
// Replaces the JAX package's fisher_nerf_customized_tpu/ops/knn.py::knn at
// k = 1 (an XLA program there, not a Pallas kernel: Q x chunk distance
// blocks as |q|^2 + |r|^2 - 2 q.r matmuls and a running top-k merge).  Its
// plain PyTorch twin is ops/cuda_knn.py::nn1_plain, which the wrapper
// ops/cuda_knn.py::cuda_nn1 runs for CPU tensors; ops/knn.py::knn calls the
// wrapper on inputs centred on the references' (masked) mean.
//
// Inputs: queries (Q, 3) f32, refs (R, 3) f32, mask (R,) u8 or null (a ref
// whose byte is 0 is skipped).  Outputs: dist (Q,) f32, the Euclidean
// distance to the nearest ref, and idx (Q,) i32, its row; ties go to the
// lowest row, and a query with no finite distance (every ref masked) gets
// (inf, 0).  scratch (S, Q) f32 and (S, Q) i32 hold the per-split partial
// results (S = gridDim.y of the first pass).
//
// The distance is d2 = (dx*dx + dy*dy) + dz*dz of the direct differences,
// every operation rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn: nvcc
// contracts none of them into an FMA), so the twin, which computes the
// same expression elementwise in PyTorch on the same tensors, gives the
// same d2 and row to the bit.  Direct differences do not cancel as the
// JAX package's expansion does.
//
// What bounds it on an H100: operations.  Every (query, ref) pair costs 9
// (3 subtractions, 3 products, 2 additions, 1 comparison) plus the select
// of the running best, and each point is read once; at the recon metric's
// 1.2 M x 80 000 pairs that is ~13 ms of f32 issue against ~1 us of bytes.
// The design keeps the pair loop to those instructions:
//   * one block of 128 threads covers 1024 queries, 8 per thread, each
//     query's coordinates and running (d2, row) in registers;
//   * the refs stream through shared memory in tiles of 1024 points, as
//     float4 (x, y, z, 0), so one broadcast 16-byte load serves a thread's
//     8 pairs; a masked ref is staged with x = NaN, whose d2 is NaN and
//     never compares smaller, so the pair loop has no mask branch;
//   * a thread replaces its best only on a strictly smaller d2 and walks
//     the refs in ascending order, so ties keep the lowest row;
//   * when the queries fill few blocks (a few thousand new points against
//     the 1.2 M ground truth), the refs are split over gridDim.y into
//     ranges of whole tiles, and a second pass merges the S partial
//     results of each query in ascending split order by (d2, row), strict
//     less again; it also takes the square root.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 8;
constexpr int kQueriesPerBlock = kThreads * kPerThread;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ queries, const float* __restrict__ refs,
           const uint8_t* __restrict__ mask, int Q, int R, int refs_per_split,
           float* __restrict__ part_d2, int* __restrict__ part_idx) {
  __shared__ float4 tile[kTile];
  const int split = blockIdx.y;
  const int r_begin = split * refs_per_split;
  const int r_end = min(R, r_begin + refs_per_split);
  const int q_base = blockIdx.x * kQueriesPerBlock + threadIdx.x;

  float qx[kPerThread], qy[kPerThread], qz[kPerThread];
  float best[kPerThread];
  int best_idx[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = q_base + k * kThreads;
    const bool in = q < Q;
    qx[k] = in ? queries[3 * q + 0] : 0.f;
    qy[k] = in ? queries[3 * q + 1] : 0.f;
    qz[k] = in ? queries[3 * q + 2] : 0.f;
    best[k] = __int_as_float(0x7f800000);   // +inf
    best_idx[k] = 0;
  }

  for (int t0 = r_begin; t0 < r_end; t0 += kTile) {
    const int n = min(kTile, r_end - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int r = t0 + j;
      float x = refs[3 * r + 0];
      if (mask != nullptr && mask[r] == 0) x = __int_as_float(0x7fc00000);
      tile[j] = make_float4(x, refs[3 * r + 1], refs[3 * r + 2], 0.f);
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float4 p = tile[j];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const float dx = __fsub_rn(qx[k], p.x);
        const float dy = __fsub_rn(qy[k], p.y);
        const float dz = __fsub_rn(qz[k], p.z);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (d2 < best[k]) {
          best[k] = d2;
          best_idx[k] = t0 + j;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = q_base + k * kThreads;
    if (q < Q) {
      part_d2[static_cast<size_t>(split) * Q + q] = best[k];
      part_idx[static_cast<size_t>(split) * Q + q] = best_idx[k];
    }
  }
}

__global__ void nn1_merge_kernel(const float* __restrict__ part_d2,
                                 const int* __restrict__ part_idx, int Q,
                                 int S, float* __restrict__ dist,
                                 int* __restrict__ idx) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  float best = part_d2[q];
  int best_idx = part_idx[q];
  for (int s = 1; s < S; ++s) {
    const float d2 = part_d2[static_cast<size_t>(s) * Q + q];
    if (d2 < best) {
      best = d2;
      best_idx = part_idx[static_cast<size_t>(s) * Q + q];
    }
  }
  dist[q] = sqrtf(best);
  idx[q] = best_idx;
}

}  // namespace

extern "C" int fnc_nn1(const float* queries, const float* refs,
                       const uint8_t* mask, float* dist, int* idx,
                       float* scratch_d2, int* scratch_idx, int Q, int R,
                       int splits, int refs_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 0) return 0;
  if (splits < 1 || splits > 65535 ||
      static_cast<long long>(splits) * refs_per_split < R)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Q + kQueriesPerBlock - 1) / kQueriesPerBlock, splits);
  nn1_kernel<<<grid, kThreads, 0, s>>>(queries, refs, mask, Q, R,
                                       refs_per_split, scratch_d2,
                                       scratch_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn1_merge_kernel<<<(Q + 255) / 256, 256, 0, s>>>(scratch_d2, scratch_idx,
                                                   Q, splits, dist, idx);
  return static_cast<int>(cudaGetLastError());
}
