// Hopper (sm_90a) kernels of KMeans: one Lloyd step (assign every row to its
// nearest centre, then per-centre sums and counts) and the per-row nearest
// centre with its partial distance.
//
// Replaces spark_rapids_ml_tpu/ops/pallas_kernels.py:
//   lloyd_step_pallas      (:314) -> srml_lloyd_step, srml_lloyd_step_tc
//   assign_min_dist_pallas (:561) -> srml_assign_min_dist, srml_assign_min_dist_tc
//
// What the Pallas kernels compute. lloyd_step_pallas: per row the argmin
// over centres of ½‖c‖² − x·c, then a one-hot GEMM into (k_pad, d) sums and
// counts held in VMEM over a sequential row grid, x read once. It pads k to
// 128 lanes, marks padded centres with LLOYD_PAD_D2 and routes the invalid
// rows of the boundary block to a "dead lane": tiling artefacts of the TPU.
// Here the centres are exactly (k, d), the outputs exactly k lanes, and rows
// at or past n_valid count nowhere. assign_min_dist_pallas: per row the
// argmin of ‖c‖² − 2x·c and that minimum (no ‖x‖²). Both argmins send ties
// to the LOWEST centre index (jnp.argmin's rule), and so do all kernels
// here: within a thread, across the threads that share a row, across
// warpgroups and across centre chunks. cn (½‖c‖² or ‖c‖²) is computed by
// the wrapper from the centres in the compute dtype, as the Pallas wrapper
// does. The two scores are the same function up to the exact factor 2
// (‖c‖² − 2x·c = 2(½‖c‖² − x·c), and 2·fl(a) = fl(2a)), so their argmins
// agree bit for bit: a Lloyd step's assignment pass may use either.
//
// Two bodies.
//
// * "ffma tiles" (srml_lloyd_step, srml_assign_min_dist): f32 and the bf16
//   launches the tensor-core body cannot take. A block takes 128 rows and,
//   per chunk of 128 centres, computes the 128 x 128 products in f32
//   registers (8 x 8 a thread) from 32 staged columns at a time converted
//   to f32 (never TF32); the running (min, argmin) of each row lives in
//   shared memory. srml_lloyd_step then adds the rows into a block-local
//   f32 (k, d) sum in shared memory (shared-memory atomics, no fixed
//   order) and 64-bit integer counts, flushed once per block; it runs only
//   when the k x d sums fit beside the scoring buffers (the wrapper's plan,
//   kernels.kmeans_plan), else the wrapper makes the step two passes:
//   srml_assign_min_dist into an (n,) index scratch, then srml_lloyd_sums.
//
// * "wgmma scoring" (srml_lloyd_step_tc, srml_assign_min_dist_tc): bf16
//   with d % 8 == 0 and 16-byte aligned operands (kernels.kmeans_route).
//   The scores are a TN GEMM with an argmin epilogue: row-major x and the
//   row-major centres are both K-major, wgmma's natural layout (transpose
//   bits 0, 0), bf16 x bf16 products exact, f32 accumulation.
//   - Persistent blocks, at most one per SM, walk row tiles of x (tile t
//     goes to block t mod grid). One producer thread keeps a ring of TMA
//     loads in flight (64-column boxes, 128-byte swizzle; the tensor map's
//     row extent is the valid rows, so TMA zero-fills the tail and the
//     ragged column edge).
//   - Centres in chunks of N columns of the score tile: the wgmma is
//     m64nNk16 with A 64 staged rows of x and B the centre rows. N is 104
//     for k <= 104 (the narrowest multiple of 8 holding the KMeans path's
//     k = 100 in one chunk; at 128 its fused pass has no room for a
//     two-stage ring) and 256, the widest wgmma, for every larger k. A
//     smaller k pads to 104: its wgmma issue is that of k = 100, still
//     under the card's balance (104 operations per byte of x), but its
//     padded centres take 104·d·2 bytes of shared memory. Each width is
//     one instantiation per mode. When all chunks fit in shared memory
//     beside the ring ("resident", the KMeans path: 104 x 256 bf16,
//     53 KB) they and their score constants are loaded once per block, a
//     tile is 64 rows and a stage a whole 64 x d tile; otherwise
//     ("streamed", the IVF build's quantizer at k = 1,024, d = 768) a tile
//     is 128 rows, a stage one (64-column slab of the tile, centre chunk
//     slab) pair re-read from L2 per chunk, both consumer warpgroups take
//     every stage (64 rows each), sharing the centre slab, and each
//     warpgroup loads a chunk's score constants from global memory while
//     its wgmmas run and stages them in one of two N-float buffers, so the
//     shared memory of a streamed launch does not grow with k: any k runs.
//     The streamed producer stage, consumer chunk and constant staging
//     live in scoring.cuh, which knn.cu's IVF list scan shares.
//   - From the accumulator fragment each thread reduces its two rows'
//     (min, argmin) over its columns in ascending order (strict <), then
//     across the quad that shares the rows (shfl_xor 1, 2, ties to the
//     lower index), then across chunks in registers (strict <: the earlier
//     chunk, the lower index, keeps a tie). Padded centres score +inf.
//   - K = d is at most a few thousand here and each score is one dot
//     product of d exact terms, so the wgmma accumulator needs no
//     promotion: its truncation costs about d ulps of the largest
//     partial sum, far below the gaps the argmin resolves (phase 10 of
//     chip_smoke.py checks every index at the path's shape).
//   - srml_assign_min_dist_tc: both consumer warpgroups score (alternate
//     tiles when the centres are resident) and write (idx, min) per row;
//     the minimum is recomputed at the chosen centre in f32 FFMA (one dot
//     product a row, from the staged tile and the resident centres), since
//     the truncated tensor-core sum biases a KMeans cost (‖x‖² + min, a
//     difference of terms 1e3 times larger on blob data) by 8e-4. dist
//     may be null (the Lloyd two-pass scratch): no recompute.
//   - srml_lloyd_step_tc is the fused pass, when the (k, d) f32 sums fit
//     in shared memory beside the resident centres and a two-stage ring
//     (the KMeans path: 100 KB of sums): warpgroup 1 scores each tile,
//     writes its 64 assignments to shared memory and counts them (integer
//     shared-memory atomics, exact); warpgroup 2 then adds the staged,
//     still swizzled bf16 rows into sums_s[k][d] on the CUDA cores and
//     releases the stage. Each of its threads owns fixed column pairs, so
//     the sums take no atomics and a fixed order (rows in order, four at a
//     time when their centres differ); x is read from memory once. Each
//     block flushes its sums with one bulk reduce per centre row and its
//     counts with 64-bit atomics: blocks meet in no fixed order, so sums
//     may differ in the last bits between runs; counts never do.
//   - Otherwise a Lloyd step is two passes and no row is scored twice:
//     srml_assign_min_dist_tc into the wrapper's (n,) int32 scratch, then
//     srml_lloyd_sums over (column slab x centre chunk x row split)
//     blocks that read idx and their slab of x once.
//   - Registers: the producer warpgroup gives registers back (setmaxnreg
//     40) and the consumers take 232 (an m64n256 accumulator is 128 a
//     thread). The launcher refuses (rc 1998) unless ptxas gave the kernel
//     the 168 a thread that balance assumes; a barrier wait that outlives
//     10 s traps.
//
// Bound on the H100: at the KMeans path's shape (16,764,871 x 256 bf16,
// k = 100) reading x once is 8.58 GB, 2.56 ms, against 2nkd = 8.6e11
// operations, 0.87 ms on the bf16 tensor cores: both kernels are bound by
// bytes (100 operations per byte of x; the card's balance is about 295).
// The fused Lloyd pass also moves about 10 bytes of shared memory per
// element of x for the sums (the staged row read, a read-modify-write of
// the f32 sum), 43 GB or about 1.5 ms of the SM's shared-memory rate,
// beside the wgmma operand reads: shared memory is its second bound. The
// IVF quantizer (1,048,576 x 768, k = 1,024) is bound by operations
// (1.65 TFLOP, 1.67 ms). Index arithmetic is 64-bit: 2^24 x 256 bf16 is
// 8.6 GB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "scoring.cuh"

namespace {

using namespace srml_hopper;  // NOLINT: mbarriers, TMA, wgmma, tensor maps
namespace sc = srml_scoring;  // the streamed layout knn.cu's list scan shares

constexpr int kBM = 128;                     // rows per tile
constexpr int kKC = 128;                     // centres per scoring chunk
constexpr int kDC = 32;                      // feature columns staged per step
constexpr int kThreads = 256;                // 16 x 16 threads, 8 x 8 each
constexpr int kLd = kBM + 4;                 // padded staging row (float4-aligned)
constexpr int kStageRows = kThreads / kDC;   // staging rows per thread pass
constexpr int kStageLoads = kBM / kStageRows;
constexpr int kSmemLimit = 232448;           // 227 KB a block may use
constexpr int kScoreSmem = (2 * kDC * kLd + 2 * kBM) * 4;

static_assert(kKC == kBM, "rows and centres share the staging layout");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int slot(int t, int s) {
  return (s < 4) ? t * 4 + s : 64 + t * 4 + (s - 4);
}

// ---------------------------------------------------------------------------
// The FFMA tile body.
// ---------------------------------------------------------------------------

// Rows row0 .. row0 + rows - 1 (1 <= rows <= kBM) against all k centres:
// best_d[r], best_i[r] = min, argmin over j of cn[j] − scale·(x_r·c_j),
// ties to the lowest j. xs, cs: kDC x kLd staging; best_*: kBM each.
template <typename T>
__device__ void score_tile(const T* __restrict__ x, const T* __restrict__ c,
                           const float* __restrict__ cn, float scale,
                           long long row0, int rows, long long k, long long d,
                           float* xs, float* cs, float* best_d, int* best_i) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lc = tid % kDC;
  const int lr = tid / kDC;
  for (int r = tid; r < kBM; r += kThreads) {
    best_d[r] = __int_as_float(0x7f800000);  // +inf
    best_i[r] = 0;
  }
  __syncthreads();
  for (long long k0 = 0; k0 < k; k0 += kKC) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (long long c0 = 0; c0 < d; c0 += kDC) {
      const long long col = c0 + lc;
      const bool col_ok = col < d;
#pragma unroll
      for (int l = 0; l < kStageLoads; ++l) {
        const int rr = lr + l * kStageRows;
        float v = 0.f, w = 0.f;
        if (col_ok && rr < rows) v = to_f32(x[(row0 + rr) * d + col]);
        if (col_ok && k0 + rr < k) w = to_f32(c[(k0 + rr) * d + col]);
        xs[lc * kLd + rr] = v;
        cs[lc * kLd + rr] = w;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDC; ++kk) {
        float av[8], bv[8];
        const float4 a_lo = *reinterpret_cast<const float4*>(&xs[kk * kLd + ty * 4]);
        const float4 a_hi = *reinterpret_cast<const float4*>(&xs[kk * kLd + 64 + ty * 4]);
        const float4 b_lo = *reinterpret_cast<const float4*>(&cs[kk * kLd + tx * 4]);
        const float4 b_hi = *reinterpret_cast<const float4*>(&cs[kk * kLd + 64 + tx * 4]);
        av[0] = a_lo.x; av[1] = a_lo.y; av[2] = a_lo.z; av[3] = a_lo.w;
        av[4] = a_hi.x; av[5] = a_hi.y; av[6] = a_hi.z; av[7] = a_hi.w;
        bv[0] = b_lo.x; bv[1] = b_lo.y; bv[2] = b_lo.z; bv[3] = b_lo.w;
        bv[4] = b_hi.x; bv[5] = b_hi.y; bv[6] = b_hi.z; bv[7] = b_hi.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    float cnv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long cj = k0 + slot(tx, j);
      cnv[j] = cj < k ? cn[cj] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float bd = __int_as_float(0x7f800000);
      int bi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // slots ascend with j: strict < keeps the lowest
        const long long cj = k0 + slot(tx, j);
        if (cj < k) {
          const float s = cnv[j] - scale * acc[i][j];
          if (s < bd) {
            bd = s;
            bi = static_cast<int>(cj);
          }
        }
      }
      // The 16 threads of a row group are 16 consecutive lanes of a warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (od < bd || (od == bd && oi < bi)) {
          bd = od;
          bi = oi;
        }
      }
      const int r = slot(ty, i);
      // Chunks ascend, so a tie with an earlier chunk keeps the earlier index.
      if (tx == 0 && r < rows && bd < best_d[r]) {
        best_d[r] = bd;
        best_i[r] = bi;
      }
    }
  }
  __syncthreads();
}

// The fused FFMA Lloyd step: the whole (k, d) sums in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lloyd_step_kernel(const T* __restrict__ x, const T* __restrict__ c,
                  const float* __restrict__ c2h, long long rows_valid,
                  long long k, long long d, float* __restrict__ sums,
                  unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* cs = xs + kDC * kLd;
  float* best_d = cs + kDC * kLd;
  int* best_i = reinterpret_cast<int*>(best_d + kBM);
  unsigned int* cnt_s = reinterpret_cast<unsigned int*>(best_i + kBM);
  float* sums_s = reinterpret_cast<float*>(cnt_s + k);

  const int tid = threadIdx.x;
  for (long long e = tid; e < k; e += kThreads) cnt_s[e] = 0;
  for (long long e = tid; e < k * d; e += kThreads) sums_s[e] = 0.f;
  // The sums pass: cols threads per row, row_groups rows at a time.
  const int cols = d < kThreads ? static_cast<int>(d) : kThreads;
  const int row_groups = kThreads / cols;
  const int sc = tid % cols;
  const int sg = tid / cols;
  __syncthreads();

  const long long n_tiles = (rows_valid + kBM - 1) / kBM;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * kBM;
    const int rows = static_cast<int>(min(static_cast<long long>(kBM), rows_valid - row0));
    score_tile(x, c, c2h, 1.f, row0, rows, k, d, xs, cs, best_d, best_i);
    for (int r = tid; r < rows; r += kThreads) atomicAdd(&cnt_s[best_i[r]], 1u);
    if (sg < row_groups) {
      for (int r = sg; r < rows; r += row_groups) {
        const T* xr = x + (row0 + r) * d;
        float* sr = sums_s + static_cast<long long>(best_i[r]) * d;
        for (long long cc = sc; cc < d; cc += cols) atomicAdd(&sr[cc], to_f32(xr[cc]));
      }
    }
    __syncthreads();  // the next tile resets best_*
  }

  for (long long e = tid; e < k * d; e += kThreads) {
    const float v = sums_s[e];
    if (v != 0.f) atomicAdd(&sums[e], v);
  }
  for (long long e = tid; e < k; e += kThreads) {
    if (cnt_s[e] != 0) atomicAdd(&counts[e], static_cast<unsigned long long>(cnt_s[e]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
assign_min_dist_kernel(const T* __restrict__ x, const T* __restrict__ c,
                       const float* __restrict__ c2, long long m, long long k,
                       long long d, int* __restrict__ best_idx,
                       float* __restrict__ best_dist) {
  __shared__ __align__(16) float xs[kDC * kLd];
  __shared__ __align__(16) float cs[kDC * kLd];
  __shared__ float best_d[kBM];
  __shared__ int best_i[kBM];
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  if (row0 >= m) return;  // block-uniform
  const int rows = static_cast<int>(min(static_cast<long long>(kBM), m - row0));
  score_tile(x, c, c2, 2.f, row0, rows, k, d, xs, cs, best_d, best_i);
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    best_idx[row0 + r] = best_i[r];
    if (best_dist != nullptr) best_dist[row0 + r] = best_d[r];
  }
}

// Shared memory of the fused FFMA step, or -1 when its (k, d) sums do not
// fit (the wrapper's plan then makes the step two passes).
long long ffma_lloyd_smem(long long k, long long d) {
  const long long bytes = kScoreSmem + 4 * k * (d + 1);
  return bytes <= kSmemLimit ? bytes : -1;
}

template <typename T>
int launch_lloyd(const T* x, const T* c, const float* c2h, long long rows_valid,
                 long long k, long long d, float* sums,
                 unsigned long long* counts, cudaStream_t s) {
  const long long smem = ffma_lloyd_smem(k, d);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      lloyd_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lloyd_step_kernel<T>, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const long long n_tiles = (rows_valid + kBM - 1) / kBM;
  long long gx = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  gx = gx < n_tiles ? gx : n_tiles;
  gx = gx < 1 ? 1 : gx;
  lloyd_step_kernel<T><<<static_cast<unsigned>(gx), kThreads, smem, s>>>(
      x, c, c2h, rows_valid, k, d, sums, counts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_assign(const T* x, const T* c, const float* c2, long long m,
                  long long k, long long d, int* idx, float* dist,
                  cudaStream_t s) {
  long long blocks = (m + kBM - 1) / kBM;
  blocks = blocks < 1 ? 1 : blocks;
  assign_min_dist_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      x, c, c2, m, k, d, idx, dist);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The second pass of a two-pass Lloyd step: sums and counts from the
// assignments, for both bodies.
// ---------------------------------------------------------------------------

constexpr int kSumThreads = 512;
constexpr int kSumUnroll = 4;  // rows in flight per thread

// Block (slab, split, centre chunk): the centres [k0, k0 + kn) x columns
// [ds0, ds0 + dn) of the sums over rows [split · split_rows, ...) in shared
// memory (f32, shared-memory atomics), counts on the slab-0 blocks; one
// flush per block. Each row of x is read by one block per (slab, chunk).
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
lloyd_sums_kernel(const T* __restrict__ x, const int* __restrict__ idx, long long rows,
                  long long split_rows, long long k, long long d, int slab, int kchunk,
                  float* __restrict__ sums, unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) float sums_s[];
  const long long ds0 = static_cast<long long>(blockIdx.x) * slab;
  const int dn = static_cast<int>(min(static_cast<long long>(slab), d - ds0));
  const long long k0 = static_cast<long long>(blockIdx.z) * kchunk;
  const int kn = static_cast<int>(min(static_cast<long long>(kchunk), k - k0));
  unsigned int* cnt_s = reinterpret_cast<unsigned int*>(sums_s + static_cast<long long>(kn) * dn);
  const bool counting = blockIdx.x == 0;
  const int tid = threadIdx.x;
  for (int e = tid; e < kn * dn; e += kSumThreads) sums_s[e] = 0.f;
  for (int e = tid; e < kn; e += kSumThreads) cnt_s[e] = 0;
  __syncthreads();
  // dn <= kSumThreads (the launcher checks): one column a thread, `groups`
  // rows at a time, kSumUnroll rows' loads in flight before their adds.
  const int groups = kSumThreads / dn;
  const int sc = tid % dn;
  const int sg = tid / dn;
  const long long r_begin = static_cast<long long>(blockIdx.y) * split_rows;
  const long long r_end = min(rows, r_begin + split_rows);
  if (sg < groups) {
    const long long stride = static_cast<long long>(groups) * kSumUnroll;
    for (long long r0 = r_begin + sg; r0 < r_end; r0 += stride) {
      int a[kSumUnroll];
      float v[kSumUnroll];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        const long long r = r0 + static_cast<long long>(u) * groups;
        a[u] = r < r_end ? idx[r] - static_cast<int>(k0) : -1;
        v[u] = a[u] >= 0 && a[u] < kn ? to_f32(x[r * d + ds0 + sc]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        if (a[u] < 0 || a[u] >= kn) continue;
        atomicAdd(&sums_s[a[u] * dn + sc], v[u]);
        if (counting && sc == 0) atomicAdd(&cnt_s[a[u]], 1u);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kn * dn; e += kSumThreads) {
    const float val = sums_s[e];
    if (val != 0.f) atomicAdd(&sums[(k0 + e / dn) * d + ds0 + e % dn], val);
  }
  if (counting) {
    for (int e = tid; e < kn; e += kSumThreads) {
      if (cnt_s[e] != 0) atomicAdd(&counts[k0 + e], static_cast<unsigned long long>(cnt_s[e]));
    }
  }
}

template <typename T>
int launch_sums(const T* x, const int* idx, long long rows, long long d, long long k, int slab,
                int kchunk, long long splits, float* sums, unsigned long long* counts,
                cudaStream_t s) {
  if (rows <= 0) return 0;
  if (slab < 1 || slab > kSumThreads || kchunk < 1 || splits < 1 || splits > 65535 ||
      d < 1 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long slabs = (d + slab - 1) / slab;
  const long long kchunks = (k + kchunk - 1) / kchunk;
  const long long smem = 4LL * kchunk * slab + 4LL * kchunk;
  if (smem > kSmemLimit || slabs > INT_MAX || kchunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      lloyd_sums_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long split_rows = (rows + splits - 1) / splits;
  const dim3 grid(static_cast<unsigned>(slabs), static_cast<unsigned>(splits),
                  static_cast<unsigned>(kchunks));
  lloyd_sums_kernel<T><<<grid, kSumThreads, smem, s>>>(x, idx, rows, split_rows, k, d, slab,
                                                       kchunk, sums, counts);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core scoring body (bf16, d % 8 == 0).
// ---------------------------------------------------------------------------

constexpr int kTcRows = sc::kRows;         // rows per tile: one m64 wgmma
constexpr int kTcBoxBytes = sc::kBoxBytes; // 64 rows x 64 bf16 columns
constexpr int kTcThreads = 384;           // warpgroup 0: producer; 1-2: consumers
constexpr int kTcEntryRegs = 168;         // 65536 / 384, what setmaxnreg 40 / 232 balances
constexpr int kTcMaxStages = 8;

enum TcMode : int {
  kAssign = 0,  // idx (and dist) per row; both consumer warpgroups score
  kFused = 1,   // Lloyd: warpgroup 1 scores and counts, warpgroup 2 sums
};

// Shared-memory layout (byte offsets from the 1 KB-aligned base) of one
// launch. The wrapper plans with kernels.kmeans_smem_bytes, a copy of
// .total; srml_kmeans_tc_smem exports .total so that chip_smoke.py's
// phase 2 holds the two copies equal.
struct TcLayout {
  uint32_t stage_bytes;  // one ring stage
  uint32_t cent_off;     // resident centres: chunk c, column box b at + (c·kboxes + b)·N·128
  uint32_t sums_off;     // kFused: (k, d) f32
  uint32_t cn_off;       // f32 score constants, +inf past k: resident, all chunks·N;
                         // streamed, a chunk's N twice for each consumer warpgroup
  uint32_t idx_off;      // kFused: stages x 64 int32 assignments
  uint32_t cnt_off;      // kFused: k uint32 counts
  uint32_t bar_off;      // full, empty, scored (stages each), centres
  long long total;       // bytes to request, alignment slack included
};

inline TcLayout tc_layout(int mode, int width, long long k, long long d, int resident,
                          int stages) {
  const long long kboxes = (d + 63) / 64;
  const long long chunks = (k + width - 1) / width;
  const long long stage = resident ? kboxes * kTcBoxBytes : sc::stage_bytes(width);
  long long off = stages * stage;
  TcLayout l{};
  l.stage_bytes = static_cast<uint32_t>(stage);
  l.cent_off = static_cast<uint32_t>(off);
  if (resident) off += chunks * kboxes * 128LL * width;
  l.sums_off = static_cast<uint32_t>(off);
  if (mode == kFused) off += 4 * k * d;
  l.cn_off = static_cast<uint32_t>(off);
  off += 4LL * (resident ? chunks : 4) * width;
  l.idx_off = static_cast<uint32_t>(off);
  if (mode == kFused) off += 4LL * stages * kTcRows;
  l.cnt_off = static_cast<uint32_t>(off);
  if (mode == kFused) off += 4 * k;
  off = (off + 7) / 8 * 8;
  l.bar_off = static_cast<uint32_t>(off);
  off += 8LL * (3 * stages + 1);
  l.total = off + 1024;
  return l;
}

struct TcGeom {
  long long rows;   // rows scored; the tensor map zero-fills past them
  long long k, d;
  int kboxes;       // 64-column boxes of a row
  int chunks;       // centre chunks of N
  int resident;     // centres loaded once per block (else streamed with x)
  int stages;       // ring depth
  float scale;      // score = cn − scale · x·c
  TcLayout l;
};

// kAssign: per row of the first g.rows rows, idx = argmin_j cn[j] −
// scale·(x·c_j) (ties to the lowest j) and dist = that minimum (dist may
// be null). kFused (scale 1, cn = ½‖c‖²): sums[j] += Σ x_r and counts[j]
// += #rows over the rows r assigned to j.
template <int kMode, int N>
__global__ void __launch_bounds__(kTcThreads, 1)
kmeans_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap cmap, const float* __restrict__ cn,
                 const __nv_bfloat16* __restrict__ xg, const __nv_bfloat16* __restrict__ cg,
                 TcGeom g, int* __restrict__ idx_out, float* __restrict__ dist_out,
                 float* __restrict__ sums, unsigned long long* __restrict__ counts) {
  constexpr bool kFuse = kMode == kFused;
  constexpr int kAcc = N / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1 KB alignment
  unsigned char* sm = smem_raw + (base - raw);
  float* cn_s = reinterpret_cast<float*>(sm + g.l.cn_off);
  float* sums_s = reinterpret_cast<float*>(sm + g.l.sums_off);
  int* idx_s = reinterpret_cast<int*>(sm + g.l.idx_off);
  unsigned int* cnt_s = reinterpret_cast<unsigned int*>(sm + g.l.cnt_off);
  const uint32_t bars = base + g.l.bar_off;
  const int stages = g.stages;
  // full: TMA landed; empty: consumed; scored: kFused, the stage's
  // assignments are in idx_s; cent: the resident centres landed.
  auto full = [bars](int s) { return bars + 8u * s; };
  auto empty = [bars, stages](int s) { return bars + 8u * (stages + s); };
  auto scored = [bars, stages](int s) { return bars + 8u * (2 * stages + s); };
  const uint32_t cent = bars + 8u * (3 * stages);
  const sc::Ring ring{base, g.l.stage_bytes, full(0), empty(0), stages};

  const int tid = threadIdx.x;
  // Resident centres: 64-row tiles, each scored by one warpgroup (kAssign:
  // alternate tiles). Streamed: 128-row tiles whose stages both
  // warpgroups consume (64 rows each), sharing the centre slab; a
  // warpgroup that skipped the other's stages could wait on a slot
  // several ring rounds ahead, where the barrier's parity aliases.
  const bool shared = !g.resident;
  const int tile_rows = shared ? 2 * kTcRows : kTcRows;
  const long long n_tiles = (g.rows + tile_rows - 1) / tile_rows;
  const long long my_tiles =
      static_cast<long long>(blockIdx.x) < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int per_tile = g.resident ? 1 : g.chunks * g.kboxes;  // stages a tile

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), shared ? 256 : 128);
      mbar_init(scored(s), 128);
    }
    mbar_init(cent, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (g.resident) {
    for (int j = tid; j < g.chunks * N; j += kTcThreads) {
      cn_s[j] = j < g.k ? cn[j] : __int_as_float(0x7f800000);
    }
  }
  if (kFuse) {
    for (long long e = tid; e < g.k * g.d; e += kTcThreads) sums_s[e] = 0.f;
    for (long long e = tid; e < g.k; e += kTcThreads) cnt_s[e] = 0u;
  }
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0 && my_tiles > 0) {
      if (g.resident) {
        mbar_expect_tx(cent, static_cast<uint32_t>(g.chunks * g.kboxes * 128 * N));
        for (int c = 0; c < g.chunks; ++c) {
          for (int b = 0; b < g.kboxes; ++b) {
            tma_load_2d(base + g.l.cent_off + (c * g.kboxes + b) * 128u * N, &cmap, cent, 64 * b,
                        c * N);
          }
        }
      }
      long long stage = 0;
      for (long long i = 0; i < my_tiles; ++i) {
        const int row = static_cast<int>((blockIdx.x + i * gridDim.x) * tile_rows);
        for (int j = 0; j < per_tile; ++j, ++stage) {
          if (g.resident) {
            const int slot = static_cast<int>(stage % stages);
            mbar_wait(empty(slot), (static_cast<uint32_t>(stage / stages) & 1u) ^ 1u);
            const uint32_t st = base + slot * g.l.stage_bytes;
            mbar_expect_tx(full(slot), g.kboxes * kTcBoxBytes);
            for (int b = 0; b < g.kboxes; ++b) {
              tma_load_2d(st + b * kTcBoxBytes, &xmap, full(slot), 64 * b, row);
            }
          } else {
            const int c = j / g.kboxes;
            const int b = j % g.kboxes;
            sc::produce_stage<N>(
                ring, stage, row + kTcRows < g.rows,  // the second 64 rows hold valid rows
                [&](uint32_t dst, uint32_t bar, int half) {
                  tma_load_2d(dst, &xmap, bar, 64 * b, row + kTcRows * half);
                },
                [&](uint32_t dst, uint32_t bar) { tma_load_2d(dst, &cmap, bar, 64 * b, c * N); });
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = (tid - 128) / 128;  // consumer warpgroup 0 or 1
  const int t = tid % 128;
  const int warp = t / 32;
  const int lane = t % 32;

  if (kFuse && cw == 1) {
    // The sums: thread t owns column pairs t, t + 128, ... of the tile.
    const int pairs = static_cast<int>(g.d / 2);
    for (long long i = 0; i < my_tiles; ++i) {
      const int slot = static_cast<int>(i % stages);
      mbar_wait(scored(slot), static_cast<uint32_t>(i / stages) & 1u);
      const unsigned char* st = sm + slot * g.l.stage_bytes;
      const int* ids = idx_s + slot * kTcRows;
      for (int p = t; p < pairs; p += 128) {
        const int col = 2 * p;
        const unsigned char* xb = st + (col >> 6) * kTcBoxBytes + ((col & 7) << 1);
        const int chunk = (col & 63) >> 3;
        float* sp = sums_s + col;
        auto load = [&](int r) {  // the bf16 pair (r, col) of the swizzled tile
          return *reinterpret_cast<const uint32_t*>(xb + r * 128 + ((chunk ^ (r & 7)) << 4));
        };
        for (int r = 0; r < kTcRows; r += 4) {
          const int4 a4 = *reinterpret_cast<const int4*>(ids + r);
          const int a[4] = {a4.x, a4.y, a4.z, a4.w};
          uint32_t w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) w[u] = load(r + u);
          const bool distinct = a[0] >= 0 && a[1] >= 0 && a[2] >= 0 && a[3] >= 0 &&
                                a[0] != a[1] && a[0] != a[2] && a[0] != a[3] &&
                                a[1] != a[2] && a[1] != a[3] && a[2] != a[3];
          if (distinct) {  // four different cells: loads may run ahead of stores
            float2 s[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) s[u] = *reinterpret_cast<const float2*>(sp + a[u] * g.d);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              s[u].x += __uint_as_float(w[u] << 16);  // exact bf16 -> f32
              s[u].y += __uint_as_float(w[u] & 0xffff0000u);
              *reinterpret_cast<float2*>(sp + a[u] * g.d) = s[u];
            }
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (a[u] < 0) continue;  // a row past the valid rows
              float2* q = reinterpret_cast<float2*>(sp + a[u] * g.d);
              float2 s = *q;
              s.x += __uint_as_float(w[u] << 16);
              s.y += __uint_as_float(w[u] & 0xffff0000u);
              *q = s;
            }
          }
        }
      }
      fence_proxy_async();  // these generic reads precede the slot's next TMA write
      mbar_arrive(empty(slot));
    }
    // Flush: one bulk reduce per centre row, after every owner's last add.
    fence_proxy_async();
    asm volatile("bar.sync 2, 128;" ::: "memory");
    for (long long a = t; a < g.k; a += 128) {
      bulk_add_f32(sums + a * g.d, sums_s + a * g.d, static_cast<uint32_t>(g.d * 4));
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    return;
  }

  // Scoring: kAssign with resident centres, warpgroup cw takes the
  // block's tiles i = cw, cw + 2, ...; streamed, both take every tile, rows
  // 64·cw.. of it; kFused, warpgroup 0 takes them all.
  const int first = kFuse || shared ? 0 : cw;
  const int step = kFuse || shared ? 1 : 2;
  const int q4 = lane & 3;
  float acc[kAcc];
#pragma unroll
  for (int v = 0; v < kAcc; ++v) acc[v] = 0.f;
  if (first < my_tiles && g.resident) mbar_wait(cent, 0);
  // Streamed: each warpgroup stages a chunk's constants in one of its two
  // buffers, alternating over its chunks (seq), one named barrier a chunk.
  long long seq = 0;
  for (long long i = first; i < my_tiles; i += step) {
    const long long row0 = (blockIdx.x + i * gridDim.x) * tile_rows + (shared ? kTcRows * cw : 0);
    float best_d[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
    int best_i[2] = {0, 0};
    long long stage = i * per_tile;
    int held = -1;     // kAssign resident / kFused: the tile's slot, released after scoring
    for (int c = 0; c < g.chunks; ++c, ++seq) {
      float pre[sc::per_thread(N)];  // streamed: the chunk's constants, loaded while wgmmas run
      if (!g.resident) {
        sc::fetch_constants<N>(pre, cn, static_cast<long long>(c) * N, g.k, t,
                               __int_as_float(0x7f800000));
      }
      if (g.resident) {
        if (c == 0) {
          held = static_cast<int>(stage % stages);
          mbar_wait(full(held), static_cast<uint32_t>(stage / stages) & 1u);
        }
        const uint32_t st = base + held * g.l.stage_bytes;
        fence_acc(acc);
        wgmma_fence();
        // Every box takes its four k-steps: columns past d are TMA's zeros.
        // (A k-step count that depends on d made ptxas serialize the wgmmas.)
        for (int b = 0; b < g.kboxes; ++b) {
          const uint32_t cb = base + g.l.cent_off + (c * g.kboxes + b) * 128u * N;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint64_t da = sw128_desc(st + b * kTcBoxBytes + 32 * j, 16, 1024);
            const uint64_t db = sw128_desc(cb + 32 * j, 16, 1024);
            wgmma_kk<N>(acc, da, db, (b == 0 && j == 0) ? 0 : 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
      } else {
        sc::consume_chunk<N>(ring, stage, g.kboxes, cw, acc);
      }
      const float* cc = g.resident ? cn_s + c * N  // the chunk's constants
                                   : sc::publish_constants<N>(pre, cn_s, seq, t, cw);
      // acc[v]: row 16·warp + lane/4 + 8·((v >> 1) & 1), column
      // 8·(v >> 2) + 2·(lane % 4) + (v & 1) of the chunk.
      float bd[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
      int bi[2] = {0, 0};
#pragma unroll
      for (int q = 0; q < N / 8; ++q) {
        const int col = c * N + 8 * q + 2 * q4;
        const float2 cq = *reinterpret_cast<const float2*>(cc + 8 * q + 2 * q4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s0 = cq.x - g.scale * acc[4 * q + 2 * h];
          const float s1 = cq.y - g.scale * acc[4 * q + 2 * h + 1];
          if (s0 < bd[h]) {  // columns ascend: strict < keeps the lowest
            bd[h] = s0;
            bi[h] = col;
          }
          if (s1 < bd[h]) {
            bd[h] = s1;
            bi[h] = col + 1;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {  // the quad that shares the row
          const float od = __shfl_xor_sync(0xffffffffu, bd[h], off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[h], off);
          if (od < bd[h] || (od == bd[h] && oi < bi[h])) {
            bd[h] = od;
            bi[h] = oi;
          }
        }
        if (bd[h] < best_d[h]) {  // chunks ascend: a tie keeps the earlier chunk
          best_d[h] = bd[h];
          best_i[h] = bi[h];
        }
      }
    }
    if (kFuse) {
      int* ids = idx_s + held * kTcRows;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + lane / 4 + 8 * h;
        const bool valid = row0 + r < g.rows;
        if (q4 == 0) {
          ids[r] = valid ? best_i[h] : -1;
          if (valid) atomicAdd(&cnt_s[best_i[h]], 1u);
        }
      }
      mbar_arrive(scored(held));
    } else {
      if (dist_out != nullptr) {
        // The minimum again, in f32 FFMA on the CUDA cores, at the chosen
        // centre: the tensor cores truncate inside their accumulation, a
        // bias of a few ulps of x·c, and a cost (‖x‖² + this minimum, with
        // terms 1e3 times the distance on blob data) cannot afford it.
        // Lane q4 of the quad sums every fourth 8-column chunk; the quad
        // adds its partials symmetrically, so its four lanes agree.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + lane / 4 + 8 * h;  // row of the 64-row tile
          const int a = best_i[h];
          float dot = 0.f;
          if (row0 + r < g.rows) {
            const int ca = a / N, ra = a % N;
            for (int j = q4; j < g.d / 8; j += 4) {
              uint4 xv, cv;
              if (g.resident) {  // the staged tile and the resident centres
                xv = *reinterpret_cast<const uint4*>(
                    sm + held * g.l.stage_bytes + (j >> 3) * kTcBoxBytes + r * 128 +
                    (((j & 7) ^ (r & 7)) << 4));
                cv = *reinterpret_cast<const uint4*>(
                    sm + g.l.cent_off + (ca * g.kboxes + (j >> 3)) * 128 * N + ra * 128 +
                    (((j & 7) ^ (ra & 7)) << 4));
              } else {  // streamed: the row and the centre from L2
                xv = *reinterpret_cast<const uint4*>(xg + (row0 + r) * g.d + 8 * j);
                cv = *reinterpret_cast<const uint4*>(cg + static_cast<long long>(a) * g.d + 8 * j);
              }
              const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
              const uint32_t cw4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {  // exact bf16 -> f32
                dot = fmaf(__uint_as_float(xw[u] << 16), __uint_as_float(cw4[u] << 16), dot);
                dot = fmaf(__uint_as_float(xw[u] & 0xffff0000u),
                           __uint_as_float(cw4[u] & 0xffff0000u), dot);
              }
            }
          }
          dot += __shfl_xor_sync(0xffffffffu, dot, 1);
          dot += __shfl_xor_sync(0xffffffffu, dot, 2);
          best_d[h] = (g.resident ? cn_s[a] : __ldg(cn + a)) - g.scale * dot;
        }
      }
      if (g.resident) {
        fence_proxy_async();  // generic reads of the slot precede its next TMA write
        mbar_arrive(empty(held));
      }
      if (q4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + 16 * warp + lane / 4 + 8 * h;
          if (row < g.rows) {
            idx_out[row] = best_i[h];
            if (dist_out != nullptr) dist_out[row] = best_d[h];
          }
        }
      }
    }
  }
  if (kFuse) {  // warpgroup 0 alone touches the counts
    asm volatile("bar.sync 1, 128;" ::: "memory");
    for (long long a = t; a < g.k; a += 128) {
      if (cnt_s[a] != 0) atomicAdd(&counts[a], static_cast<unsigned long long>(cnt_s[a]));
    }
  }
}

template <int kMode, int N>
int launch_tc(const void* x, const void* c, const float* cn, float scale, long long rows,
              long long d, long long k, int resident, int stages, int* idx, float* dist,
              float* sums, unsigned long long* counts, cudaStream_t s) {
  const TcLayout l = tc_layout(kMode, N, k, d, resident, stages);
  const long long chunks = (k + N - 1) / N;
  const bool out_ok = kMode == kFused
      ? (reinterpret_cast<uintptr_t>(sums) % 16 == 0 && counts != nullptr)
      : (idx != nullptr && (dist == nullptr || reinterpret_cast<uintptr_t>(dist) % 4 == 0));
  if (d < 8 || d % 8 != 0 || d > (1LL << 20) || rows < 0 || rows > INT_MAX - kTcRows ||
      k < 1 || k > INT_MAX / 2 || chunks * N > INT_MAX / 2 || stages < 1 ||
      stages > kTcMaxStages || (kMode == kFused && !resident) || l.total > kSmemLimit ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(c) % 16 != 0 ||
      !out_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = reinterpret_cast<const void*>(&kmeans_tc_kernel<kMode, N>);
  static const int regs = kernel_registers(fn);
  if (regs != kTcEntryRegs) return kErrRegisters;  // setmaxnreg would starve or not apply
  CUtensorMap xmap, cmap;
  int rc = bf16_tensor_map(&xmap, x, rows, d, kTcRows);
  if (rc != 0) return rc;
  rc = bf16_tensor_map(&cmap, c, k, d, N);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(l.total));
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  const long long n_tiles = (rows + kTcRows - 1) / kTcRows;
  long long blocks = n_tiles < sms ? n_tiles : sms;
  blocks = blocks < 1 ? 1 : blocks;
  TcGeom g{};
  g.rows = rows;
  g.k = k;
  g.d = d;
  g.kboxes = static_cast<int>((d + 63) / 64);
  g.chunks = static_cast<int>(chunks);
  g.resident = resident;
  g.stages = stages;
  g.scale = scale;
  g.l = l;
  kmeans_tc_kernel<kMode, N><<<static_cast<unsigned>(blocks), kTcThreads, l.total, s>>>(
      xmap, cmap, cn, static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(c),
      g, idx, dist, sums, counts);
  return static_cast<int>(cudaGetLastError());
}

// The chunk widths with a wgmma_kk specialisation (kernels.KMEANS_WIDTHS,
// the rule in the header note).
template <int kMode>
int launch_tc_width(int width, const void* x, const void* c, const float* cn, float scale,
                    long long rows, long long d, long long k, int resident, int stages, int* idx,
                    float* dist, float* sums, unsigned long long* counts, cudaStream_t s) {
#define SRML_WIDTH(n)                                                                    \
  case n:                                                                                \
    return launch_tc<kMode, n>(x, c, cn, scale, rows, d, k, resident, stages, idx, dist, \
                               sums, counts, s);
  switch (width) {
    SRML_WIDTH(104)
    SRML_WIDTH(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SRML_WIDTH
}

long long clamp_rows(long long n, long long n_valid) {
  return n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
}

}  // namespace

extern "C" {

// One Lloyd step over the first min(n, max(n_valid, 0)) rows of x on the
// FFMA body, fused: each row goes to the centre of least ½‖c‖² − x·c (ties
// to the lowest index), and sums[j] += Σ x_r, counts[j] += #rows over the
// rows of centre j. x: (n, d) row-major f32 or bf16; centers: (k, d) in
// x's type; c2h: (k,) f32 = ½‖c‖²; sums: (k, d) f32; counts: (k,) uint64.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue when the
// (k, d) sums do not fit shared memory: the wrapper makes such a step two
// passes, srml_assign_min_dist then srml_lloyd_sums).
int srml_lloyd_step(const void* x, const void* centers, int is_bf16,
                    const float* c2h, long long n, long long d, long long k,
                    long long n_valid, float* sums, unsigned long long* counts,
                    void* stream) {
  const long long rows = clamp_rows(n, n_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_lloyd(static_cast<const __nv_bfloat16*>(x),
                        static_cast<const __nv_bfloat16*>(centers), c2h, rows, k,
                        d, sums, counts, s);
  }
  return launch_lloyd(static_cast<const float*>(x), static_cast<const float*>(centers),
                      c2h, rows, k, d, sums, counts, s);
}

// Per row of x (m, d): idx = argmin_j ‖c_j‖² − 2x·c_j (ties to the lowest
// j) and dist = that minimum, on the FFMA body. centers: (k, d) in x's
// type; c2: (k,) f32 = ‖c‖²; idx: (m,) int32; dist: (m,) f32 or null.
int srml_assign_min_dist(const void* x, const void* centers, int is_bf16,
                         const float* c2, long long m, long long d, long long k,
                         int* idx, float* dist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_assign(static_cast<const __nv_bfloat16*>(x),
                         static_cast<const __nv_bfloat16*>(centers), c2, m, k, d,
                         idx, dist, s);
  }
  return launch_assign(static_cast<const float*>(x), static_cast<const float*>(centers),
                       c2, m, k, d, idx, dist, s);
}

// The second pass of a two-pass Lloyd step: over the first rows of x
// (f32 or bf16, (n, d)) with their centres idx (rows,) int32 in [0, k),
// sums[j] += Σ x_r and counts[j] += #rows. Blocks cover `slab` columns x
// `kchunk` centres x one of `splits` row splits (kernels.kmeans_plan).
int srml_lloyd_sums(const void* x, int is_bf16, const int* idx, long long rows, long long d,
                    long long k, int slab, int kchunk, long long splits, float* sums,
                    unsigned long long* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_sums(static_cast<const __nv_bfloat16*>(x), idx, rows, d, k, slab, kchunk,
                       splits, sums, counts, s);
  }
  return launch_sums(static_cast<const float*>(x), idx, rows, d, k, slab, kchunk, splits, sums,
                     counts, s);
}

// srml_lloyd_step on the tensor-core body, fused, for bf16 x with d % 8 == 0
// and x, centers and sums 16-byte aligned, over the wrapper's plan: centre
// chunks of `width` (a kernels.KMEANS_WIDTHS entry), resident in shared
// memory, a ring of `stages` 64-row tiles. Returns a cudaError_t, or 1000 +
// a CUresult of the tensor-map encode, 1998 (kernel registers) or 1999 (no
// encoder in the driver).
int srml_lloyd_step_tc(const void* x, const void* centers, const float* c2h, long long n,
                       long long d, long long k, long long n_valid, int width, int stages,
                       float* sums, unsigned long long* counts, void* stream) {
  return launch_tc_width<kFused>(width, x, centers, c2h, 1.f, clamp_rows(n, n_valid), d, k, 1,
                                 stages, nullptr, nullptr, sums, counts,
                                 static_cast<cudaStream_t>(stream));
}

// srml_assign_min_dist on the tensor-core body, for bf16 x with d % 8 == 0
// and x and centers 16-byte aligned, over the wrapper's plan: centre chunks
// of `width`, `resident` (1: centres held in shared memory; 0: streamed
// beside x), a ring of `stages`. dist may be null. Return codes as
// srml_lloyd_step_tc.
int srml_assign_min_dist_tc(const void* x, const void* centers, const float* c2, long long m,
                            long long d, long long k, int width, int resident, int stages,
                            int* idx, float* dist, void* stream) {
  return launch_tc_width<kAssign>(width, x, centers, c2, 2.f, m, d, k, resident, stages, idx,
                                  dist, nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

// The shared memory (bytes, alignment slack included) of a tensor-core
// launch: tc_layout's total for the Lloyd fused pass (fused = 1) or the
// assignment (0), as kernels.kmeans_smem_bytes plans it.
int srml_kmeans_tc_smem(int fused, int width, long long k, long long d, int resident,
                        int stages) {
  return static_cast<int>(tc_layout(fused ? kFused : kAssign, width, k, d, resident, stages).total);
}

}  // extern "C"
