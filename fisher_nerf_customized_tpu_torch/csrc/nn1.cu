// 1-NN: for each query point, the nearest unmasked reference point.
//
// Replaces the JAX package's fisher_nerf_customized_tpu/ops/knn.py::knn at
// k = 1 (an XLA program there, not a Pallas kernel: Q x chunk distance
// blocks as |q|^2 + |r|^2 - 2 q.r matmuls and a running top-k merge).  Its
// plain PyTorch twin is ops/cuda_knn.py::nn1_plain, which the wrapper
// ops/cuda_knn.py::cuda_nn1 runs for CPU tensors; ops/knn.py::knn calls the
// wrapper on inputs centred on the references' (masked) mean.
//
// The function: dist (Q,) f32, the Euclidean distance from each query to
// its nearest unmasked ref, and idx (Q,) i32, that ref's row; ties go to the
// lowest row, and a query with no finite distance gets (inf, 0).  The
// distance is d2 = (dx*dx + dy*dy) + dz*dz of the direct differences, every
// operation rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn: nvcc
// contracts none of them into an FMA), so the twin, which computes the same
// expression elementwise in PyTorch on the same tensors, gives the same d2
// and row to the bit.
//
// What bounds it on an H100: operations, 9 a pair (3 subtractions, 3
// products, 2 additions, 1 comparison) at 67 TFLOP/s; at the recon metric's
// 1.2 M x 80 000 pairs that is ~13 ms against ~1 us of bytes.  The answer
// needs far fewer pairs: these are surface clouds, and for almost every
// pair the ref lies far beyond the query's nearest neighbour.  So the
// culled pass (fnc_nn1) evaluates only the pairs that a box test cannot
// rule out, on clouds that ops/cuda_knn.py::culled_layout has prepared on
// the card:
//   * refs that are masked or not finite, and queries that are not finite,
//     are dropped (neither kind can change an answer); both clouds are
//     sorted by a Morton key, the refs cut into tiles of kTile points with
//     each tile's box (tiles, float4 x, y, z and the ref's original row as
//     int bits in w; the last tile padded with +inf points of row -1);
//   * a block of 8 warps takes 512 consecutive sorted queries, 64 a warp, 2
//     a lane, each query's coordinates and running (d2, row) in registers;
//     each warp has its queries' box (small tiles and warps keep the
//     boxes tight: ops/cuda_knn.py::nn1_culled_plain counts the pairs that
//     other sizes would evaluate);
//   * the block walks the tiles outward from `start` (the tile where its
//     median query's key sorts: visit_tile), so a tight best comes early;
//   * before a tile, a warp computes lb, the lower bound of d2 between its
//     box and the tile's, and rules the tile out when lb > the largest
//     running best among its queries; a tile that passes is needed when
//     some lane finds, for one of its queries, the lower bound between the
//     query (a point) and the tile's box at most that query's own running
//     best.  The first test is cheap, and the second keeps a warp whose
//     queries straddle a jump of the Morton curve (a box across the scene)
//     and include a far query (a large best) from evaluating nearly every
//     tile;
//   * the needed tiles stream into shared memory through a cp.async double
//     buffer: while the warps evaluate one tile the next needed one loads.
//     Which one is next is voted (a ballot over 32 steps, one a lane,
//     OR-ed over the warps) with the bests as they stand before the
//     current tile; a
//     tile that no warp needs then is needed by none later (bests only
//     fall) and is never loaded, and a loaded tile is tested again by each
//     warp with its bests at that point.
//
// Exactness of the skip.  lb is the pair expression on the per-axis gaps
// max(0, qmin - rmax, rmin - qmax), with the same rounded operations in the
// same order (qmin = qmax = q for a query's own bound).  For a query q in
// the box [qmin, qmax] and a ref r in the tile's,
// q - r >= qmin - rmax and r - q >= rmin - qmax exactly, so, rounding to
// nearest being monotone and symmetric, |fl(q - r)| is at least each
// rounded gap and at least 0; squares and sums of non-negative numbers
// round monotonically too, so every pair's computed d2 is at least the
// computed lb.  lb > best (strict) therefore never drops a pair that could
// win or tie, with no slack.  All kept points are finite, so no d2 or lb is
// NaN.
//
// Exactness of the answer whatever the order.  A query's running best is
// the 64-bit key (d2 bits << 32 | original row), replaced by a smaller key:
// d2 >= 0, so its bits order as the floats do, and the minimum key is the
// smallest d2 at its lowest original row, whatever order the tiles and
// their refs come in.  The initial key is (+inf, 0): a pair whose d2
// overflows to +inf never replaces it, as in the twin.
//
// Launch shape: when the queries fill fewer than TARGET_BLOCKS blocks (a
// few thousand new points against the 1.2 M ground truth), gridDim.y = S
// copies of each block take the walk's steps s, s + S, s + 2S, ..., each
// with bests of its own; every copy but the first opens with the walk's
// first tile as well, so that its bests are tight before its own steps
// (a copy opening on a far tile evaluates every tile within that loose
// best), and has at least 8 steps of its own; every copy merges its keys
// into the sorted queries' keys by atomicMin (a minimum: the same in any
// order), and a second kernel writes each query's (sqrt(d2), row) at its
// original position and resets its key for the next launch.  With a
// pointer, the culled pass adds the pairs it evaluated (each evaluated
// tile's refs times its warp's queries) to a device counter, one atomicAdd
// a block.
//
// fnc_nn1_brute keeps the all-pairs pass that the culled pass replaced (no
// path of the port calls it; chip_smoke.py times the two in turns): one
// block of 128 threads covers 1024 queries, 8 a thread; refs stream through
// shared memory in tiles of 1024 (a masked ref staged with x = NaN, whose
// d2 is NaN and never compares smaller); a strictly smaller d2 in ascending
// row order keeps the lowest row; few queries split the refs over
// gridDim.y in ranges of whole tiles, merged in split order by strictly
// smaller d2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---- the culled pass (ops/cuda_knn.py mirrors these sizes)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 2;
constexpr int kWarpQueries = 32 * kPerLane;
constexpr int kBlockQueries = kWarps * kWarpQueries;
constexpr int kTile = 64;
constexpr unsigned long long kInfKey = 0x7f80000000000000ull;  // (+inf, 0)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The tile at `step` of the walk outward from tile c over n tiles: c, c + 1,
// c - 1, c + 2, c - 2, ..., then the longer side's rest in order.
__device__ __forceinline__ int visit_tile(int c, int n, int step) {
  const int left = c, right = n - 1 - c;
  const int m = min(left, right);
  if (step <= 2 * m) {
    const int j = (step + 1) >> 1;
    return (step & 1) ? c + j : c - j;
  }
  return right > left ? c + (step - m) : c - (step - m);
}

__device__ __forceinline__ float gap(float qlo, float qhi, float rlo,
                                     float rhi) {
  return fmaxf(fmaxf(__fsub_rn(qlo, rhi), __fsub_rn(rlo, qhi)), 0.f);
}

// d2's lower bound between the warp's box and a tile's (see the note).
__device__ __forceinline__ float box_lb(const float* lo, const float* hi,
                                        float4 rlo, float4 rhi) {
  const float gx = gap(lo[0], hi[0], rlo.x, rhi.x);
  const float gy = gap(lo[1], hi[1], rlo.y, rhi.y);
  const float gz = gap(lo[2], hi[2], rlo.z, rhi.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

__global__ void __launch_bounds__(kThreads)
nn1_culled_kernel(const float* __restrict__ queries,
                  const float4* __restrict__ refs,
                  const float4* __restrict__ boxes,
                  const int* __restrict__ start, int Qv, int Rv, int T,
                  int S, unsigned long long* __restrict__ keys,
                  unsigned long long* __restrict__ pair_count) {
  __shared__ float4 buf[2][kTile];
  __shared__ unsigned vote[2][kWarps];
  __shared__ unsigned long long warp_pairs[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.y;
  const int c = start[blockIdx.x];
  // split 0 takes the walk's steps 0, S, 2S, ...; split s > 0 takes step 0
  // (the block's first tile, so that its bests are tight from the start)
  // and then s, s + S, s + 2S, ...  (S <= T)
  const int n_steps = split == 0 ? (T + S - 1) / S
                                 : 1 + (T - split + S - 1) / S;
  const int w_base = blockIdx.x * kBlockQueries + warp * kWarpQueries;
  const int w_valid = max(0, min(kWarpQueries, Qv - w_base));

  float qx[kPerLane], qy[kPerLane], qz[kPerLane];
  unsigned long long best[kPerLane];
  float lo[3] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000),
                 __int_as_float(0x7f800000)};
  float hi[3] = {__int_as_float(0xff800000), __int_as_float(0xff800000),
                 __int_as_float(0xff800000)};
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int slot = k * 32 + lane;
    const bool in = slot < w_valid;
    const size_t q = static_cast<size_t>(w_base + (in ? slot : 0));
    qx[k] = in ? queries[3 * q + 0] : 0.f;
    qy[k] = in ? queries[3 * q + 1] : 0.f;
    qz[k] = in ? queries[3 * q + 2] : 0.f;
    best[k] = kInfKey;
    if (in) {
      lo[0] = fminf(lo[0], qx[k]); hi[0] = fmaxf(hi[0], qx[k]);
      lo[1] = fminf(lo[1], qy[k]); hi[1] = fmaxf(hi[1], qy[k]);
      lo[2] = fminf(lo[2], qz[k]); hi[2] = fmaxf(hi[2], qz[k]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
  }
  // the largest running best among the warp's queries
  float max_best = __int_as_float(0x7f800000);
  unsigned long long pairs = 0;

  // the tile of this split's i-th step
  auto tile_of = [&](int i) -> int {
    return visit_tile(c, T, split == 0 ? i * S
                                       : (i == 0 ? 0 : split + (i - 1) * S));
  };
  // may this warp need its split's step i?  (the box test, per lane)
  auto may_need = [&](int i) -> bool {
    if (w_valid == 0 || i >= n_steps) return false;
    const int t = tile_of(i);
    return !(box_lb(lo, hi, __ldg(&boxes[2 * t]), __ldg(&boxes[2 * t + 1]))
             > max_best);
  };
  // does this warp need its split's step i?  (the per-query test, warp-wide)
  auto need = [&](int i) -> bool {
    const int t = tile_of(i);
    const float4 rlo = __ldg(&boxes[2 * t]), rhi = __ldg(&boxes[2 * t + 1]);
    bool mine = false;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const float p[3] = {qx[k], qy[k], qz[k]};
      mine |= k * 32 + lane < w_valid &&
              !(box_lb(p, p, rlo, rhi) >
                __uint_as_float(static_cast<unsigned>(best[k] >> 32)));
    }
    return __any_sync(0xffffffffu, mine);
  };
  // the first step from `from` on that some warp needs, or n_steps; every
  // thread of the block calls it (a barrier a round of 32 steps)
  int parity = 0;
  auto next_needed = [&](int from) -> int {
    for (int i0 = from; i0 < n_steps; i0 += 32) {
      unsigned maybe = __ballot_sync(0xffffffffu, may_need(i0 + lane));
      unsigned m = 0;
      while (maybe != 0) {
        const int j = __ffs(maybe) - 1;
        maybe &= maybe - 1;
        if (need(i0 + j)) m |= 1u << j;
      }
      if (lane == 0) vote[parity][warp] = m;
      __syncthreads();
      unsigned any = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) any |= vote[parity][w];
      parity ^= 1;
      if (any != 0) return i0 + __ffs(any) - 1;
    }
    return n_steps;
  };
  auto load = [&](int i, int b) {
    const float4* src = refs + static_cast<size_t>(tile_of(i)) * kTile;
    for (int j = threadIdx.x; j < kTile; j += kThreads)
      cp_async16(&buf[b][j], src + j);
  };

  int cur = next_needed(0);
  if (cur < n_steps) load(cur, 0);
  cp_async_commit();
  int b = 0;
  while (cur < n_steps) {
    // the barrier inside also tells that every warp is done with buf[b ^ 1]
    const int nxt = next_needed(cur + 1);
    if (nxt < n_steps) load(nxt, b ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (w_valid > 0 && need(cur)) {
      const float4* tile = buf[b];
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        const float4 p = tile[j];
        const unsigned long long row = __float_as_uint(p.w);
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const float dx = __fsub_rn(qx[k], p.x);
          const float dy = __fsub_rn(qy[k], p.y);
          const float dz = __fsub_rn(qz[k], p.z);
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                               __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          const unsigned long long key =
              (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
              row;
          best[k] = key < best[k] ? key : best[k];
        }
      }
      const int t = tile_of(cur);
      pairs += static_cast<unsigned long long>(w_valid) *
               min(kTile, Rv - t * kTile);
      unsigned top = 0;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        if (k * 32 + lane < w_valid)
          top = max(top, static_cast<unsigned>(best[k] >> 32));
      max_best = __uint_as_float(__reduce_max_sync(0xffffffffu, top));
    }
    cur = nxt;
    b ^= 1;
  }

  if (n_steps > 0) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
      if (k * 32 + lane < w_valid)
        atomicMin(&keys[w_base + k * 32 + lane], best[k]);
  }
  if (pair_count != nullptr) {
    if (lane == 0) warp_pairs[warp] = pairs;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long total = 0;
      for (int w = 0; w < kWarps; ++w) total += warp_pairs[w];
      if (total != 0) atomicAdd(pair_count, total);
    }
  }
}

// Each sorted query's answer at its original position; the key is reset.
__global__ void nn1_finalize_kernel(unsigned long long* __restrict__ keys,
                                    const int* __restrict__ q_pos, int Qv,
                                    float* __restrict__ dist,
                                    int* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Qv) return;
  const unsigned long long key = keys[i];
  keys[i] = kInfKey;
  const int q = q_pos[i];
  dist[q] = __fsqrt_rn(__uint_as_float(static_cast<unsigned>(key >> 32)));
  idx[q] = static_cast<int>(static_cast<unsigned>(key & 0xffffffffull));
}

// ---- the all-pairs pass (the design the culled pass replaced)
constexpr int kBruteThreads = 128;
constexpr int kBrutePerThread = 8;
constexpr int kBruteQueriesPerBlock = kBruteThreads * kBrutePerThread;
constexpr int kBruteTile = 1024;

__global__ void __launch_bounds__(kBruteThreads)
nn1_brute_kernel(const float* __restrict__ queries,
                 const float* __restrict__ refs,
                 const uint8_t* __restrict__ mask, int Q, int R,
                 int refs_per_split, float* __restrict__ part_d2,
                 int* __restrict__ part_idx) {
  __shared__ float4 tile[kBruteTile];
  const int split = blockIdx.y;
  const int r_begin = split * refs_per_split;
  const int r_end = min(R, r_begin + refs_per_split);
  const int q_base = blockIdx.x * kBruteQueriesPerBlock + threadIdx.x;

  float qx[kBrutePerThread], qy[kBrutePerThread], qz[kBrutePerThread];
  float best[kBrutePerThread];
  int best_idx[kBrutePerThread];
#pragma unroll
  for (int k = 0; k < kBrutePerThread; ++k) {
    const int q = q_base + k * kBruteThreads;
    const bool in = q < Q;
    qx[k] = in ? queries[3 * q + 0] : 0.f;
    qy[k] = in ? queries[3 * q + 1] : 0.f;
    qz[k] = in ? queries[3 * q + 2] : 0.f;
    best[k] = __int_as_float(0x7f800000);   // +inf
    best_idx[k] = 0;
  }

  for (int t0 = r_begin; t0 < r_end; t0 += kBruteTile) {
    const int n = min(kBruteTile, r_end - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kBruteThreads) {
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
      for (int k = 0; k < kBrutePerThread; ++k) {
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
  for (int k = 0; k < kBrutePerThread; ++k) {
    const int q = q_base + k * kBruteThreads;
    if (q < Q) {
      part_d2[static_cast<size_t>(split) * Q + q] = best[k];
      part_idx[static_cast<size_t>(split) * Q + q] = best_idx[k];
    }
  }
}

__global__ void nn1_brute_merge_kernel(const float* __restrict__ part_d2,
                                       const int* __restrict__ part_idx,
                                       int Q, int S, float* __restrict__ dist,
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

// The culled pass and its finalize on ops/cuda_knn.py::culled_layout's
// arrays: queries (Qv, 3) f32 in key order, refs (T * 64, 4) f32, boxes
// (T, 8) f32, start (ceil(Qv / 512),) i32, q_pos (Qv,) i32, keys (Qv,) u64
// all (+inf, 0) on entry and again on return; dist (Q,) f32 and idx (Q,) i32
// receive the Qv answers at rows q_pos; pair_count (1,) u64 or null.
extern "C" int fnc_nn1(const float* queries, const float* refs,
                       const float* boxes, const int* start, const int* q_pos,
                       unsigned long long* keys, float* dist, int* idx,
                       unsigned long long* pair_count, int Qv, int Rv, int T,
                       int S, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Qv <= 0 || T <= 0) return 0;
  if (S < 1 || S > 65535 || static_cast<long long>(T) * kTile < Rv ||
      static_cast<long long>(T - 1) * kTile >= Rv)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Qv + kBlockQueries - 1) / kBlockQueries, S);
  nn1_culled_kernel<<<grid, kThreads, 0, s>>>(
      queries, reinterpret_cast<const float4*>(refs),
      reinterpret_cast<const float4*>(boxes), start, Qv, Rv, T, S, keys,
      pair_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn1_finalize_kernel<<<(Qv + 255) / 256, 256, 0, s>>>(keys, q_pos, Qv, dist,
                                                       idx);
  return static_cast<int>(cudaGetLastError());
}

// The all-pairs pass: queries (Q, 3) f32, refs (R, 3) f32, mask (R,) u8 or
// null (a ref whose byte is 0 is skipped); dist (Q,) f32, idx (Q,) i32;
// scratch (S, Q) f32 and (S, Q) i32 hold the per-split partial results.
extern "C" int fnc_nn1_brute(const float* queries, const float* refs,
                             const uint8_t* mask, float* dist, int* idx,
                             float* scratch_d2, int* scratch_idx, int Q, int R,
                             int splits, int refs_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 0) return 0;
  if (splits < 1 || splits > 65535 ||
      static_cast<long long>(splits) * refs_per_split < R)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Q + kBruteQueriesPerBlock - 1) / kBruteQueriesPerBlock,
                  splits);
  nn1_brute_kernel<<<grid, kBruteThreads, 0, s>>>(queries, refs, mask, Q, R,
                                                  refs_per_split, scratch_d2,
                                                  scratch_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn1_brute_merge_kernel<<<(Q + 255) / 256, 256, 0, s>>>(
      scratch_d2, scratch_idx, Q, splits, dist, idx);
  return static_cast<int>(cudaGetLastError());
}
