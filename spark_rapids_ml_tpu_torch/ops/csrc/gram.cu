// Hopper (sm_90a) kernels of the Gram family: the masked Gram (X·m)ᵀ(X·m),
// the fused count / column sum / XᵀX of the first n_valid rows (PCA), the
// fused normal-equation statistics XᵀX, Xᵀy, Σx, Σy, Σy², n
// (LinearRegression), and the weighted Grams of LogisticRegression: one
// binomial Newton-IRLS pass and the multinomial per-class curvature.
//
// Replaces spark_rapids_ml_tpu/ops/pallas_kernels.py:
//   gram_pallas              (:78)   -> srml_gram, srml_gram_tc
//   gram_colsum_pallas       (:173)  -> srml_gram_colsum, srml_gram_colsum_tc
//   newton_stats_pallas      (:451)  -> srml_newton_stats, srml_newton_stats_tc
//   softmax_curvature_pallas (:1135) -> srml_softmax_curvature, srml_softmax_curvature_tc
//   linreg_stats_pallas      (:1210) -> srml_linreg_stats, srml_linreg_stats_tc
//
// What the Pallas kernels compute: a (d, d) f32 accumulator kept in VMEM for
// the whole sequential row grid, with x read once. An H100 SM has 227 KB of
// shared memory and its blocks run in parallel in no order, so the design is
// turned around, the same way in both bodies below:
//
// * SYRK: blockIdx.x indexes a tile pair (i <= j) of 128 x 128 tiles from
//   a (n_pairs, 2) list the wrapper computes (kernels.tc_tile_pairs: 136
//   pairs at d = 2048, not 256 tiles), times the class (kWeighted: pair · C
//   + class, so the classes of a pair are neighbours); blockIdx.y a row
//   split. An off-diagonal tile S is added to G[i, j] and Sᵀ to G[j, i], so
//   a seeded, non-symmetric G stays exact (no mirror pass); the Hessian and
//   curvature blocks are symmetric, so the pairs cover them too. A diagonal
//   pair stages its panel once for both operands.
// * Split-K over rows: the in-block row loop takes the place of the TPU's
//   "arbitrary" grid axis; the splits keep each f32 sum short and give a
//   small-d Gram enough blocks to fill the SMs. Each block adds its tile
//   into G with atomics (the FFMA body) or bulk reduces (the tensor cores),
//   so the splits of one tile meet in no fixed order (results may differ in
//   the last bits between runs). The caller's G is the seed: the wrapper
//   passes zeros for a fresh result or the streaming state to fold into in
//   place (the seeded gram_colsum_pallas, the donated linreg state).
//
// The five kernels are modes of each body. The vector statistics ride on
// blocks that already stage the columns they need: the diagonal blocks add
// Σx and, for linreg, Xᵀy of their 128 columns from the staged i-panel and
// the rows' y; the blocks of tile (0, 0), one per split, add Σy, Σy² and the
// row count of their split. Rows are weighted by the mask as in the Pallas
// kernel: m² on XᵀX and Xᵀy, m on Σx and Σy. The linreg row count is an
// integer (rows with m != 0), summed in a 64-bit counter, so it is exact at
// any n.
//
// The LogisticRegression statistics are a fourth mode, kWeighted: the
// i-panel is scaled by a per-row weight and the j-panel is raw, so a tile is
// Xᵀdiag(wt)X; the diagonal blocks' column sums of the scaled panel are
// Xᵀwt and, given a residual r, they add Xᵀr from the raw panel. A launch
// covers C weight columns.
//
// * srml_newton_stats(_tc) is two launches. A row pass (one warp per row,
//   the dot product reduced with __shfl_xor_sync) computes z = x·w + b,
//   p = σ(z), r = (p − y)·m and wgt = max(p(1 − p), 1e-10)·m into (n,) f32
//   scratch and adds Σr and Σwgt; then the kWeighted Gram pass with
//   wt = wgt and the residual r gives Xᵀdiag(wgt)X, Xᵀwgt and Xᵀr. The
//   Pallas kernel reads x once per iteration; this reads it twice: z needs
//   all d columns of a row before any weight exists, and a Gram block
//   stages only 128 or 256 of them. At the path's shape (511,943 x 1024
//   bf16) the second read is about 1 GB, 0.3 ms of HBM time; fusing the
//   row pass into the Gram pass is later work.
// * srml_softmax_curvature(_tc) is one kWeighted launch over all C classes
//   with wt = p (already masked): Xᵀdiag(p_c)X and Xᵀp_c per class. x is
//   read again for every class, about 8.5 GB at 129,838 x 1024 bf16,
//   C = 32, 2.5 ms of HBM time, under the 4.4 ms operation bound; the
//   classes of one (pair, split) run side by side so that they meet x in
//   L2. Sharing one staged x tile across a class group, as the Pallas
//   kernel does, needs more than one 128 x 128 accumulator a consumer:
//   later work.
// w, b, z, p, r, wgt and p_c stay f32 (the TPU kernels' bf16 roundings of
// w, r and the borders' weights were MXU and Mosaic constraints), with one
// exception: the tensor-core route's Hessian operand, which a tensor-core
// product must round. It is bf16(x·bf16(wt)), as the Pallas kernels round
// it (pallas_kernels.py:437, :1117).
//
// Two bodies.
//
// gram_ffma_kernel ("ffma syrk") runs every f32 launch and the bf16
// launches the tensor-core body cannot take: d not a multiple of 8, and a
// masked srml_gram (the tensor cores would round x·m to bf16 for a mask
// outside {0, 1}; the Pallas kernel multiplies in f32). f32 operands take
// full-f32 products, as the JAX package's Precision.HIGHEST (never TF32;
// a split-precision tensor-core route is not taken: f32 wgmma reads only
// K-major operands, and XᵀX along rows is MN-major).
// * 256 threads, an 8 x 8 register tile each of the 128 x 128 tile, f32
//   FFMA; two blocks an SM.
// * A ring of 4 stages of 16 rows x 128 columns of both panels (raw f32 or
//   bf16, 16 KB or 8 KB a stage), filled with cp.async.cg 16-byte copies
//   (zero-filled past the split's rows and past d) three stages ahead of
//   the one being multiplied; rows whose byte width is not a multiple of 16
//   stage with plain loads instead. bf16 converts exactly on the read.
// * The mask (or weight) and y (or residual) of a stage's rows stage beside
//   it (cp.async, 4 bytes); the mask scales both operands' values in
//   registers, the weight the A operand's. Without a mask the template
//   pays nothing.
// * Splits of at most 8,192 rows (kernels.ffma_gram_plan): no f32 register
//   sums more rows.
//
// gram_tc_kernel ("wgmma+tma syrk") runs the bf16 launches of
// srml_gram_tc (kGram: an unmasked gram, the default in-memory PCA fit on
// the card), srml_gram_colsum_tc, srml_linreg_stats_tc,
// srml_newton_stats_tc (its Gram pass) and srml_softmax_curvature_tc (the
// wrapper routes bf16 with d % 8 == 0 and 16-byte aligned x and G there,
// kernels.gram_route). Its SYRK pairs and splits are the ones above, split
// rows a multiple of the 64-row stage (kernels.gram_plan); laid out for
// Hopper:
//
// * wgmma, bf16 x bf16 -> f32: two consumer warpgroups, each
//   m64n128k16 over its 64 rows of the tile, four K steps per stage. x is
//   row-major, so a stage of 64 rows x 128 columns has the G index
//   contiguous: both operands are MN-major (transpose bits 1, 1), in the
//   128-byte swizzle TMA writes: 64-column boxes of 64 rows, 128-byte
//   rows, 8-row swizzle atoms of 1 KB (SBO), the two boxes of a panel 8 KB
//   apart (LBO).
// * TMA into a ring of 5 stages (32 KB each: i-panel and j-panel) with
//   full/empty mbarriers; one producer thread. The tensor map's row extent
//   is the valid rows (min(n, max(n_valid, 0)) for gram_colsum, n for
//   linreg), so TMA zero-fills every row past them and the ragged column
//   edge: no per-element bound checks. Boxes wholly past d are not loaded
//   (their columns only reach outputs that are dropped).
// * Split-K over rows, as in the FFMA body: no f32 sum runs over all n
//   rows. Hopper's tensor cores may truncate inside their f32
//   accumulation, so every `promote` stages a consumer adds the wgmma
//   accumulator into a CUDA-core f32 accumulator and restarts it
//   ("promotion"; the wrapper chooses the interval). The epilogue stages
//   the tile (and its transpose) in the ring's memory and adds each row
//   into G with cp.reduce.async.bulk .add.f32: splits meet in G in no
//   fixed order (results may differ in the last bits between runs).
// * Vector statistics with x read once: on a diagonal pair each consumer
//   sums its half of the staged panel (Σx and, for linreg, Xᵀy with y in
//   f32) on the CUDA cores while its wgmma runs; the tile-(0, 0) blocks'
//   spare warps add Σy, Σy² and the 64-bit row count of their split from
//   y and the mask; block (0, 0) adds the gram_colsum count once. The
//   linreg mask is {0, 1} by contract: with a mask, a helper warp zeroes
//   the staged rows where m = 0 before the consumers may read the stage
//   (a third mbarrier, "ready"), and x·m is then exact in bf16.
// * kWeighted: A is fed from registers. Each consumer loads its
//   warpgroup's 64-column share of the raw staged i-panel with
//   ldmatrix.trans (which also undoes the swizzle, one 16-byte row a
//   lane) into wgmma's register fragment, and multiplies it by bf16(wt)
//   with packed bf16 multiplies, one rounding of the exact product; B is
//   the raw panel in shared memory. Helper warp 1 stages each stage's 64
//   weights as bf16 pairs (640 bytes beside the ring) and arrives on
//   `ready`. (Scaling the A panel in shared memory instead, with three
//   helper warps, added 32 KB of shared-memory traffic a stage beside
//   wgmma's and made softmax_curvature 1.5 times as slow: PERF.md §6.)
//   The A registers are read by wgmmas in flight, so a weighted stage
//   waits for its own wgmmas before the next stage loads them. The
//   diagonal pairs' consumers sum Xᵀwt and Xᵀr from the raw panel
//   against f32 weights loaded a stage ahead.
// * Registers: the producer warpgroup gives registers back (setmaxnreg 40)
//   and the consumers take 232 (two 64-float accumulators a thread). The
//   launcher refuses to launch unless ptxas gave the kernel the 168 a
//   thread that balance assumes, and a barrier wait that outlives 10 s
//   traps: a fault in the pipeline is an error, never a hung card.
//
// Bound on the H100: at the PCA path's shape (262,144 x 2048) the fold does
// nd(d+1) = 1.1 TFLOP (G is symmetric, so half of 2nd²) against 1.07 GB
// (bf16) of reads, far above the card's ops-per-byte balance, so it is
// bound by operations (bf16 tensor cores: 1.1 ms; f32 FFMA for the f32
// Gram: 16 ms). The in-memory gram at 1,048,576 x 2048 is 4.4 TFLOP: 4.45
// ms on the bf16 tensor cores, 65.7 ms in f32 FFMA, where the FFMA body's
// per-k-step load of 16 values for 64 FMAs a thread and its atomics
// epilogue keep it under that rate. linreg_stats at 262,144 x 1024 bf16
// is bound the same way (0.28 ms on the tensor cores against 0.16 ms of
// bytes). The tensor-core
// body does exactly the SYRK's operations (plus the diagonal tiles' lower
// halves); what it still lacks is persistence (one block per (pair, split)
// leaves a partial last wave and an unoverlapped epilogue per block) and
// larger tiles or TMA multicast (each 128-column panel is read from L2
// once per pair it belongs to). Index arithmetic is 64-bit: 262,144 x 2048
// f32 is exactly 2^31 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace srml_hopper;  // NOLINT: mbarriers, TMA, wgmma, tensor maps

constexpr int kTile = 128;                        // G tile edge
constexpr int kFRows = 16;                        // FFMA body: rows a ring stage holds
constexpr int kFStages = 4;                       // FFMA body: ring depth
constexpr int kFThreads = 256;                    // FFMA body: 16 x 16 threads, 8 x 8 each
constexpr long long kMaxGridY = 65535;            // gridDim.y limit: row splits
constexpr int kRowThreads = 256;                  // Newton row pass: 8 warps, one row each
constexpr long long kRowBlocks = 4096;            // Newton row pass: grid-stride cap

// What a launch computes besides G.
enum Mode : int {
  kMasked = 0,  // G += (X·m)ᵀ(X·m)                           (gram_pallas)
  kColsum = 1,  // G += XᵀX, colsum += Σx, count += rows       (gram_colsum_pallas)
  kLinreg = 2,  // G, Xᵀy, Σx, Σy, Σy², rows with m != 0       (linreg_stats_pallas)
  kWeighted = 3,  // per class c: G_c += Xᵀdiag(wt_c)X, colsum_c += Xᵀwt_c,
                  // and xty += Xᵀr when r is given (newton_stats_pallas,
                  // softmax_curvature_pallas)
  kGram = 4,    // G += XᵀX alone: the tensor-core route of gram_pallas
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// Row (or column) of the tile that accumulator slot s of thread t covers:
// slots 0-3 at 4t..4t+3, slots 4-7 at 64+4t..64+4t+3, so that the reads of
// a warp from shared memory are contiguous.
__device__ __forceinline__ int slot(int t, int s) {
  return (s < 4) ? t * 4 + s : 64 + t * 4 + (s - 4);
}

// Four consecutive staged elements as f32 into v[o .. o + 3] (bf16 converts
// exactly: its bits are the high half of the f32's).
__device__ __forceinline__ void load4(const float* p, float (&v)[8], int o) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[o] = f.x;
  v[o + 1] = f.y;
  v[o + 2] = f.z;
  v[o + 3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[8], int o) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  v[o] = __uint_as_float(w.x << 16);
  v[o + 1] = __uint_as_float(w.x & 0xffff0000u);
  v[o + 2] = __uint_as_float(w.y << 16);
  v[o + 3] = __uint_as_float(w.y & 0xffff0000u);
}

// cp.async of `bytes` (16 or 4; 0 zero-fills the destination) from global
// to shared memory, grouped by commit and waited for by wait_group.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

struct Outputs {
  float* gram;                // (d, d); (C, d, d) kWeighted
  float* colsum;              // (d,)    kColsum, kLinreg; (C, d) kWeighted
  float* count;               // ()      kColsum
  float* xty;                 // (d,)    kLinreg; kWeighted with a residual
  float* sy;                  // ()      kLinreg
  float* syy;                 // ()      kLinreg
  unsigned long long* rows;   // ()      kLinreg
};

// A launch of either body over a plan the wrapper made (kernels.gram_plan
// or kernels.ffma_gram_plan): blockIdx.x = pair · classes + class over the
// (n_pairs, 2) device list of tile pairs i <= j, blockIdx.y the row split.
struct TcPlan {
  const int* pairs;      // (n_pairs, 2) tile pairs i <= j
  long long rows;        // rows to sum (past them: zeros)
  long long split_rows;  // rows of blockIdx.y's split
  long long d;
  int promote;           // tensor cores: stages between promotions; 0: at the end only
  int classes;           // blockIdx.x = pair · classes + class (1 outside kWeighted)
};

// ---------------------------------------------------------------------------
// The FFMA SYRK body (f32, and the bf16 launches the tensor-core body
// cannot take): see the header note.
// ---------------------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr int ffma_stage_bytes() {
  return 2 * kFRows * kTile * static_cast<int>(sizeof(T)) + 2 * kFRows * 4;
}

// kMasked: G += (X·m)ᵀ(X·m) (kMask: m = mask; else 1). kColsum: G += XᵀX,
// colsum += Σx, count += rows. kLinreg: with m = mask (kMask; else 1) and
// ym = y·m: G += (X·m)ᵀ(X·m), xty += (X·m)ᵀym, colsum += Σx·m, sy += Σym,
// syy += Σym², rows += #(m != 0). kWeighted: with wt = mask[r · classes + c]
// of class c: G_c += (X·wt)ᵀX, colsum_c += Σx·wt and, when y (a residual r)
// is given, xty += Xᵀr. kVec: 16-byte rows (cp.async); else scalar staging.
template <typename T, int kMode, bool kVec, bool kMask>
__global__ void __launch_bounds__(kFThreads, 2)
gram_ffma_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                 const float* __restrict__ y, TcPlan plan, Outputs out) {
  constexpr bool kWgt = kMode == kWeighted;
  constexpr bool kLin = kMode == kLinreg;
  constexpr bool kStats = kMode == kColsum || kLin || kWgt;  // the diagonal blocks' sums
  constexpr bool kScaleB = kMask && !kWgt;                   // x·m on both sides: weight m²
  constexpr int kPanel = kFRows * kTile;                     // elements of a panel
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));     // elements of a 16-byte chunk
  constexpr int kCpr = kTile / kPer;                         // 16-byte chunks of a panel row
  constexpr int kStage = ffma_stage_bytes<T>();
  extern __shared__ __align__(16) unsigned char fsm[];
  __shared__ float red[2][kTile];
  __shared__ float red_xy[2][kTile];
  __shared__ float red_y[kFThreads / 32][2];
  __shared__ unsigned long long red_n[kFThreads / 32];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int pair = static_cast<int>(blockIdx.x) / plan.classes;
  const int cls = static_cast<int>(blockIdx.x) % plan.classes;
  const int ti = plan.pairs[2 * pair];
  const int tj = plan.pairs[2 * pair + 1];
  const bool diag = ti == tj;  // block-uniform
  const long long d = plan.d;
  const long long i0 = static_cast<long long>(ti) * kTile;
  const long long j0 = static_cast<long long>(tj) * kTile;
  const long long r_begin = static_cast<long long>(blockIdx.y) * plan.split_rows;
  const long long r_end = min(plan.rows, r_begin + plan.split_rows);
  const int n_st = r_end > r_begin ? static_cast<int>((r_end - r_begin + kFRows - 1) / kFRows) : 0;
  const bool resid = kWgt && y != nullptr;
  const bool need_y = kLin || resid;
  const long long mstride = kWgt ? plan.classes : 1;
  const float* mcol = kWgt ? mask + cls : mask;
  float* gram = out.gram + (kWgt ? static_cast<long long>(cls) * d * d : 0);

  // Slot s: the i-panel, the j-panel (not loaded on a diagonal pair: the
  // i-panel serves both), then the rows' mask or weight and y or residual.
  auto panel = [&](int s, int h) { return reinterpret_cast<T*>(fsm + s * kStage) + h * kPanel; };
  auto scal = [&](int s, int h) {
    return reinterpret_cast<float*>(fsm + s * kStage + 2 * kPanel * sizeof(T)) + h * kFRows;
  };
  // Stage s (rows r_begin + 16s ..) into slot s % kFStages; one commit
  // group per call, empty past the last stage.
  auto fill = [&](int s) {
    if (s < n_st) {
      const int sl = s % kFStages;
      const long long r0 = r_begin + static_cast<long long>(s) * kFRows;
      for (int h = 0; h < (diag ? 1 : 2); ++h) {
        const long long c0 = h ? j0 : i0;
        T* dst = panel(sl, h);
        if (kVec) {  // rows are 16-byte aligned: a chunk lies wholly inside or past d
          for (int e = tid; e < kFRows * kCpr; e += kFThreads) {
            const int rr = e / kCpr;
            const int cc = e % kCpr;
            const long long r = r0 + rr;
            const long long col = c0 + cc * kPer;
            const bool ok = r < r_end && col < d;
            cp_async16(smem_u32(dst + rr * kTile + cc * kPer), ok ? x + r * d + col : x,
                       ok ? 16 : 0);
          }
        } else {
          for (int e = tid; e < kPanel; e += kFThreads) {
            const int rr = e / kTile;
            const int cc = e % kTile;
            const long long r = r0 + rr;
            const long long col = c0 + cc;
            dst[e] = r < r_end && col < d ? x[r * d + col] : zero_of<T>();
          }
        }
      }
      if (kMask && tid < kFRows) {
        const long long r = r0 + tid;
        const bool ok = r < r_end;
        cp_async4(smem_u32(scal(sl, 0) + tid), ok ? mcol + r * mstride : mask, ok ? 4 : 0);
      }
      if (need_y && tid >= 32 && tid < 32 + kFRows) {
        const long long r = r0 + (tid - 32);
        const bool ok = r < r_end;
        cp_async4(smem_u32(scal(sl, 1) + (tid - 32)), ok ? y + r : y, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float cs = 0.f;  // diagonal pairs: Σ over rows tid/128, +2, ... of column tid % 128
  float xy = 0.f;

  for (int s = 0; s < kFStages - 1; ++s) fill(s);
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<kFStages - 2>();  // stage s has landed (this thread's copies) ...
    __syncthreads();                // ... everyone's, and stage s − 1 is consumed
    fill(s + kFStages - 1);         // into stage s − 1's slot, while this one multiplies
    const int sl = s % kFStages;
    const T* a = panel(sl, 0);
    const T* b = diag ? a : panel(sl, 1);
    const float* m = scal(sl, 0);
#pragma unroll 4
    for (int k = 0; k < kFRows; ++k) {
      float av[8], bv[8];
      load4(a + k * kTile + 4 * ty, av, 0);
      load4(a + k * kTile + 64 + 4 * ty, av, 4);
      load4(b + k * kTile + 4 * tx, bv, 0);
      load4(b + k * kTile + 64 + 4 * tx, bv, 4);
      if (kMask) {
        const float mk = m[k];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          av[i] *= mk;
          if (kScaleB) bv[i] *= mk;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kStats && diag) {
      const int c = tid % kTile;
      const float* yv = scal(sl, 1);
      for (int rr = tid / kTile; rr < kFRows; rr += 2) {
        const float v = to_f32(a[rr * kTile + c]);
        if (kLin) {
          const float mv = kMask ? m[rr] : 1.f;
          const float am = kMask ? v * mv : v;
          cs += am;
          xy += am * (kMask ? yv[rr] * mv : yv[rr]);
        } else if (kWgt) {
          cs += v * m[rr];
          if (resid) xy += v * yv[rr];
        } else {
          cs += v;
        }
      }
    }
  }

  // SYRK epilogue: the tile into G[i, j] and, off the diagonal, its
  // transpose into G[j, i], so a seeded G that is not symmetric stays exact.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gi = i0 + slot(ty, i);
    if (gi >= d) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long gj = j0 + slot(tx, j);
      if (gj >= d) continue;
      atomicAdd(&gram[gi * d + gj], acc[i][j]);
      if (!diag) atomicAdd(&gram[gj * d + gi], acc[i][j]);
    }
  }

  if (kStats && diag) {  // block-uniform: the barrier is safe
    red[tid / kTile][tid % kTile] = cs;
    red_xy[tid / kTile][tid % kTile] = xy;
    __syncthreads();
    if (tid < kTile && i0 + tid < d) {
      float* colsum = out.colsum + (kWgt ? static_cast<long long>(cls) * d : 0);
      atomicAdd(&colsum[i0 + tid], red[0][tid] + red[1][tid]);
      if (need_y) atomicAdd(&out.xty[i0 + tid], red_xy[0][tid] + red_xy[1][tid]);
    }
  }
  if (kLin && ti == 0 && tj == 0) {  // block-uniform: the split's y statistics
    float sy = 0.f, syy = 0.f;
    unsigned long long nn = 0;
    for (long long r = r_begin + tid; r < r_end; r += kFThreads) {
      const float mv = kMask ? mask[r] : 1.f;
      const float ym = y[r] * mv;
      sy += ym;
      syy += ym * ym;
      nn += (mv != 0.f);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      sy += __shfl_xor_sync(0xffffffffu, sy, o);
      syy += __shfl_xor_sync(0xffffffffu, syy, o);
      nn += __shfl_xor_sync(0xffffffffu, nn, o);
    }
    if (tid % 32 == 0) {
      red_y[tid / 32][0] = sy;
      red_y[tid / 32][1] = syy;
      red_n[tid / 32] = nn;
    }
    __syncthreads();
    if (tid == 0) {
      float a0 = 0.f, a1 = 0.f;
      unsigned long long an = 0;
#pragma unroll
      for (int w = 0; w < kFThreads / 32; ++w) {
        a0 += red_y[w][0];
        a1 += red_y[w][1];
        an += red_n[w];
      }
      atomicAdd(out.sy, a0);
      atomicAdd(out.syy, a1);
      atomicAdd(out.rows, an);
    }
  }
  if (kMode == kColsum && pair == 0 && blockIdx.y == 0 && tid == 0) {
    *out.count += static_cast<float>(plan.rows);
  }
}

template <typename T, int kMode, bool kVec, bool kMask>
int launch_ffma_kernel(const void* x, const TcPlan& plan, int n_pairs, long long splits,
                       const float* mask, const float* y, const Outputs& out, cudaStream_t s) {
  const void* fn = reinterpret_cast<const void*>(&gram_ffma_kernel<T, kMode, kVec, kMask>);
  const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             kFStages * ffma_stage_bytes<T>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(n_pairs * plan.classes), static_cast<unsigned>(splits));
  gram_ffma_kernel<T, kMode, kVec, kMask><<<grid, kFThreads, kFStages * ffma_stage_bytes<T>(), s>>>(
      static_cast<const T*>(x), mask, y, plan, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kMode>
int launch_ffma_typed(const void* x, bool vec, const TcPlan& plan, int n_pairs, long long splits,
                      const float* mask, const float* y, const Outputs& out, cudaStream_t s) {
  // kColsum takes no mask; kWeighted always has its weights.
  constexpr bool kMaybeMask = kMode == kMasked || kMode == kLinreg;
  const bool masked = kMode == kWeighted || (kMaybeMask && mask != nullptr);
  if (vec) {
    return masked ? launch_ffma_kernel<T, kMode, true, kMode != kColsum>(x, plan, n_pairs, splits,
                                                                        mask, y, out, s)
                  : launch_ffma_kernel<T, kMode, true, kMode == kWeighted>(x, plan, n_pairs,
                                                                          splits, mask, y, out, s);
  }
  return masked ? launch_ffma_kernel<T, kMode, false, kMode != kColsum>(x, plan, n_pairs, splits,
                                                                       mask, y, out, s)
                : launch_ffma_kernel<T, kMode, false, kMode == kWeighted>(x, plan, n_pairs, splits,
                                                                         mask, y, out, s);
}

// One FFMA launch over a plan the wrapper made: the (n_pairs, 2) int32 tile
// pairs on the device, each for `classes` classes (kWeighted; else 1),
// `splits` row splits of `split_rows` rows covering `rows`.
template <int kMode>
int launch_ffma(const void* x, int is_bf16, long long rows, long long d, const int* pairs,
                int n_pairs, int classes, long long splits, long long split_rows,
                const float* mask, const float* y, const Outputs& out, void* stream) {
  if (d < 1 || rows < 0 || pairs == nullptr || n_pairs < 1 || classes < 1 ||
      static_cast<long long>(n_pairs) * classes > INT_MAX ||
      (kMode != kWeighted && classes != 1) || (kMode == kWeighted && mask == nullptr) ||
      splits < 1 || splits > kMaxGridY || split_rows < 1 || splits * split_rows < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TcPlan plan{pairs, rows, split_rows, d, 0, classes};
  const int elem = is_bf16 ? 2 : 4;
  const bool vec = (d * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_ffma_typed<__nv_bfloat16, kMode>(x, vec, plan, n_pairs, splits, mask, y,
                                                           out, s)
                 : launch_ffma_typed<float, kMode>(x, vec, plan, n_pairs, splits, mask, y, out, s);
}

// The Newton row pass: per row z = x·w + b, p = σ(z), r = (p − y)·m and
// wgt = max(p(1 − p), 1e-10)·m (mask == nullptr: m = 1), written to
// resid and wgt; Σr and Σwgt added into *gb and *hbb. One warp per row,
// grid-stride over rows; lanes stride over the columns.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
newton_row_kernel(const T* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ mask, const float* __restrict__ w,
                  const float* __restrict__ b, long long n, long long d,
                  float* __restrict__ resid, float* __restrict__ wgt,
                  float* gb, float* hbb) {
  constexpr int kWarps = kRowThreads / 32;
  __shared__ float red_r[kWarps];
  __shared__ float red_w[kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float bias = *b;
  float sr = 0.f, sw = 0.f;  // lane 0's sums over this warp's rows
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + warp; r < n;
       r += stride) {
    const T* row = x + r * d;
    float z = 0.f;
    for (long long j = lane; j < d; j += 32) z = fmaf(to_f32(row[j]), w[j], z);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) z += __shfl_xor_sync(0xffffffffu, z, o);
    if (lane == 0) {
      z += bias;
      const float p = 1.f / (1.f + expf(-z));
      const float m = mask == nullptr ? 1.f : mask[r];
      const float rr = (p - y[r]) * m;
      const float ww = fmaxf(p * (1.f - p), 1e-10f) * m;
      resid[r] = rr;
      wgt[r] = ww;
      sr += rr;
      sw += ww;
    }
  }
  if (lane == 0) {
    red_r[warp] = sr;
    red_w[warp] = sw;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s_r = 0.f, s_w = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      s_r += red_r[q];
      s_w += red_w[q];
    }
    atomicAdd(gb, s_r);
    atomicAdd(hbb, s_w);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16, d % 8 == 0): wgmma fed by TMA over SYRK pairs.
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;                          // rows per stage: 4 wgmma K steps
constexpr int kTcBox = 64;                           // columns per TMA box: 128 B, the swizzle span
constexpr int kTcBoxBytes = kTcRows * kTcBox * 2;    // 8 KB
constexpr int kTcPanelBytes = 2 * kTcBoxBytes;       // 128 columns
constexpr int kTcStageBytes = 2 * kTcPanelBytes;     // i-panel, j-panel
constexpr int kTcStages = 5;
constexpr int kTcRingBytes = kTcStages * kTcStageBytes;
constexpr int kTcEpiStride = kTile + 8;              // floats per staged tile row (544 B)
constexpr int kTcEpiBytes = 2 * kTile * kTcEpiStride * 4;  // the tile and its transpose
constexpr int kTcDataBytes = kTcRingBytes > kTcEpiBytes ? kTcRingBytes : kTcEpiBytes;
constexpr int kTcWeightBytes = kTcStages * (kTcRows / 2) * 4;  // kWeighted: bf16 weight pairs a stage
constexpr int kTcSmemBytes =
    1024 + kTcDataBytes + kTcWeightBytes + 3 * kTcStages * 8;  // + alignment, barriers
constexpr int kTcThreads = 384;     // warpgroup 0: producer and helpers; 1-2: consumers
constexpr int kTcConsumers = 256;
constexpr int kTcEntryRegs = 168;   // 65536 / 384, what setmaxnreg 40 / 232 balances

static_assert(kTcDataBytes >= kTcEpiBytes && kTcSmemBytes <= 232448, "shared memory");

__device__ __forceinline__ void consumer_sync() {  // the 256 consumer threads
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// x · w, rounded once to bf16, for two packed bf16 values of x and the
// bf16 weight in both halves of w2 (the product of two bf16 is exact).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x2, uint32_t w2) {
  uint32_t out;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(out) : "r"(x2), "r"(w2));
  return out;
}

// kGram: G += XᵀX over the first plan.rows rows. kColsum: the same, and
// colsum += Σx, count += rows. kLinreg: with m = mask (null: 1) in {0, 1} and ym = y·m over all
// plan.rows rows: G += XᵀX of the rows with m = 1, xty += Xᵀym, colsum +=
// Σx·m, sy += Σym, syy += Σym², rows += #(m != 0). kWeighted: with the
// weights wt_c = mask[c · rows ..] of class c (a (classes, rows) array)
// over all plan.rows rows: G_c += bf16(X·bf16(wt_c))ᵀX, colsum_c += Xᵀwt_c
// and, when y (a residual r) is given, xty += Xᵀr, the last two in f32.
template <int kMode>
__global__ void __launch_bounds__(kTcThreads, 1)
gram_tc_kernel(const __grid_constant__ CUtensorMap xmap, TcPlan plan,
               const float* __restrict__ mask, const float* __restrict__ y, Outputs out) {
  constexpr bool kLin = kMode == kLinreg;
  constexpr bool kWgt = kMode == kWeighted;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1 KB alignment
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t bars = base + kTcDataBytes + kTcWeightBytes;
  // full: TMA landed; ready: a helper warp's work on the stage is done
  // (masked rows zeroed, or the weight pairs staged); empty: consumed.
  auto full = [bars](int s) { return bars + 8u * s; };
  auto ready = [bars](int s) { return bars + 8u * (kTcStages + s); };
  auto empty = [bars](int s) { return bars + 8u * (2 * kTcStages + s); };

  const int pair = static_cast<int>(blockIdx.x) / plan.classes;
  const int cls = static_cast<int>(blockIdx.x) % plan.classes;
  const int ti = plan.pairs[2 * pair];
  const int tj = plan.pairs[2 * pair + 1];
  const bool diag = ti == tj;
  const long long d = plan.d;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const long long r_begin = static_cast<long long>(blockIdx.y) * plan.split_rows;
  const long long r_end = min(plan.rows, r_begin + plan.split_rows);
  const int n_stages =
      r_end > r_begin ? static_cast<int>((r_end - r_begin + kTcRows - 1) / kTcRows) : 0;
  const bool masked = kLin && mask != nullptr;
  const bool edited = masked || kWgt;  // the consumers wait for `ready`
  const bool resid = kWgt && y != nullptr;
  const float* wt = kWgt ? mask + static_cast<long long>(cls) * plan.rows : nullptr;
  float* gram = out.gram + (kWgt ? static_cast<long long>(cls) * d * d : 0);
  float* colsum = kWgt ? out.colsum + static_cast<long long>(cls) * d : out.colsum;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), 1);
      mbar_init(empty(s), kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // Warpgroup 0: warp 0 feeds the ring; warp 1 zeroes masked linreg rows
    // or stages the kWeighted weights; warps 2-3 of the tile-(0, 0) blocks
    // sum the linreg y statistics.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int warp = tid / 32;
    const int lane = tid % 32;
    if (warp == 0 && lane == 0) {
      const int boxes = (i0 + kTcBox < d ? 2 : 1) + (diag ? 0 : (j0 + kTcBox < d ? 2 : 1));
      for (int s = 0; s < n_stages; ++s) {
        const int slot = s % kTcStages;
        const uint32_t round = static_cast<uint32_t>(s / kTcStages);
        mbar_wait(empty(slot), (round & 1u) ^ 1u);
        const uint32_t st = base + slot * kTcStageBytes;
        const int row = static_cast<int>(r_begin + static_cast<long long>(s) * kTcRows);
        mbar_expect_tx(full(slot), boxes * kTcBoxBytes);
        tma_load_2d(st, &xmap, full(slot), i0, row);
        if (i0 + kTcBox < d) tma_load_2d(st + kTcBoxBytes, &xmap, full(slot), i0 + kTcBox, row);
        if (!diag) {
          tma_load_2d(st + kTcPanelBytes, &xmap, full(slot), j0, row);
          if (j0 + kTcBox < d) {
            tma_load_2d(st + kTcPanelBytes + kTcBoxBytes, &xmap, full(slot), j0 + kTcBox, row);
          }
        }
      }
    } else if (warp == 1 && masked) {
      for (int s = 0; s < n_stages; ++s) {
        const int slot = s % kTcStages;
        mbar_wait(full(slot), static_cast<uint32_t>(s / kTcStages) & 1u);
        const long long row0 = r_begin + static_cast<long long>(s) * kTcRows;
        unsigned char* st = sm + slot * kTcStageBytes;
        for (int r = lane; r < kTcRows; r += 32) {
          const long long row = row0 + r;
          if (row < plan.rows && mask[row] == 0.f) {
            for (int b = 0; b < (diag ? 2 : 4); ++b) {
              uint4* p = reinterpret_cast<uint4*>(st + b * kTcBoxBytes + r * 128);
#pragma unroll
              for (int c = 0; c < 8; ++c) p[c] = make_uint4(0u, 0u, 0u, 0u);
            }
          }
        }
        fence_proxy_async();  // the async proxy (wgmma) reads these rows next
        __syncwarp();
        if (lane == 0) mbar_arrive(ready(slot));
      }
    } else if (kWgt && warp == 1) {
      // The stage's 64 weights as 32 bf16 pairs in shared memory, row 2j
      // in the low half of pair j: the consumers scale their A fragments
      // by them. Slot s's pairs are rewritten only after full(s), so after
      // the consumers of its previous round have released it.
      float w_lo = 0.f, w_hi = 0.f;  // the next stage's weights of rows 2·lane, 2·lane + 1
      auto load_w = [&](int stage) {
        const long long row = r_begin + static_cast<long long>(stage) * kTcRows + 2 * lane;
        w_lo = stage < n_stages && row < plan.rows ? wt[row] : 0.f;
        w_hi = stage < n_stages && row + 1 < plan.rows ? wt[row + 1] : 0.f;
      };
      load_w(0);
      uint32_t* wpairs = reinterpret_cast<uint32_t*>(sm + kTcDataBytes);
      for (int s = 0; s < n_stages; ++s) {
        const int slot = s % kTcStages;
        uint32_t w2;
        asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w2) : "f"(w_hi), "f"(w_lo));
        load_w(s + 1);
        mbar_wait(full(slot), static_cast<uint32_t>(s / kTcStages) & 1u);
        wpairs[slot * (kTcRows / 2) + lane] = w2;
        __syncwarp();
        if (lane == 0) mbar_arrive(ready(slot));
      }
    } else if (warp >= 2 && kLin && ti == 0 && tj == 0) {
      constexpr int kUnroll = 4;  // loads in flight per thread, within setmaxnreg's 40
      float s = 0.f, ss = 0.f;
      unsigned long long nn = 0;
      for (long long r0 = r_begin + (tid - 64); r0 < r_end; r0 += 64 * kUnroll) {
        float yv[kUnroll], mv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long r = r0 + 64 * u;
          yv[u] = r < r_end ? y[r] : 0.f;
          mv[u] = r < r_end ? (mask == nullptr ? 1.f : mask[r]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float ym = yv[u] * mv[u];
          s += ym;
          ss += ym * ym;
          nn += (mv[u] != 0.f);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        nn += __shfl_xor_sync(0xffffffffu, nn, o);
      }
      if (lane == 0) {
        atomicAdd(out.sy, s);
        atomicAdd(out.syy, ss);
        atomicAdd(out.rows, nn);
      }
    }
    if (kMode == kColsum && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
      *out.count += static_cast<float>(plan.rows);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = tid - 128;  // consumer thread, 0..255
    const int wg = ct / 128;   // rows 64·wg .. 64·wg + 63 of the tile
    const int t = ct % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int c8 = t % 8;      // statistics: 16-byte column chunk of this half
    const int q = t / 8;       // statistics: rows q, q + 16, q + 32, q + 48
    const uint32_t a_off = wg * kTcBoxBytes;  // this half of the (raw) i-panel
    const uint32_t b_off = diag ? 0u : static_cast<uint32_t>(kTcPanelBytes);
    // kWeighted: this thread's ldmatrix row (lanes 8j..8j+7 give matrix
    // j's rows: x rows 8(j / 2) + lane % 8 of a k-step, 16-byte column
    // chunk 2·warp + j % 2 of the half), unswizzled per k-step below.
    const int frag_row = 8 * (lane >> 4) + (lane & 7);
    const int frag_chunk = 2 * warp + ((lane >> 3) & 1);
    uint32_t af[4][4];  // kWeighted: the stage's A fragments, one per k-step
    float acc[64], tot[64];
#pragma unroll
    for (int v = 0; v < 64; ++v) {
      acc[v] = 0.f;
      tot[v] = 0.f;
    }
    float cs[8], xy[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cs[k] = 0.f;
      xy[k] = 0.f;
    }
    int fresh = 1;    // the next stage starts the wgmma accumulator afresh
    int since = 0;    // stages in the accumulator since the last promotion
    int pending = -1; // slot read by wgmmas that may still be in flight
    // Diagonal pairs: this thread's four rows' y and m (linreg), or
    // residual and weight (kWeighted), loaded one stage ahead so that
    // their latency hides behind a stage of wgmma.
    float y_next[4], m_next[4];
    auto load_ym = [&](int stage) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const long long row = r_begin + static_cast<long long>(stage) * kTcRows + q + 16 * rr;
        const bool in = stage < n_stages && row < plan.rows;
        if (kWgt) {
          y_next[rr] = in && resid ? y[row] : 0.f;
          m_next[rr] = in ? wt[row] : 0.f;
        } else {
          y_next[rr] = in ? y[row] : 0.f;
          m_next[rr] = in ? (mask == nullptr ? 1.f : mask[row]) : 0.f;
        }
      }
    };
    if ((kLin || kWgt) && diag) load_ym(0);
    for (int s = 0; s < n_stages; ++s) {
      const int slot = s % kTcStages;
      const uint32_t parity = static_cast<uint32_t>(s / kTcStages) & 1u;
      mbar_wait(full(slot), parity);
      if (edited) mbar_wait(ready(slot), parity);
      const uint32_t st = base + slot * kTcStageBytes;
      if (kWgt) {
        // A = bf16(x·bf16(wt)) in registers: each k-step's 16 rows of this
        // warpgroup's 64 columns, transposed out of the swizzled panel by
        // ldmatrix, times the rows' weight pairs (k 2t, 2t + 1 and 2t + 8,
        // 2t + 9 of the k-step for t = lane % 4).
        const uint32_t* wp =
            reinterpret_cast<const uint32_t*>(sm + kTcDataBytes) + slot * (kTcRows / 2);
#pragma unroll
        for (int k = 0; k < kTcRows / 16; ++k) {
          const int r = 16 * k + frag_row;
          ldmatrix_x4_trans(af[k], st + a_off + r * 128 + ((frag_chunk ^ (r & 7)) << 4));
          const uint32_t w_lo = wp[8 * k + (lane & 3)];
          const uint32_t w_hi = wp[8 * k + 4 + (lane & 3)];
          af[k][0] = mul_bf16x2(af[k][0], w_lo);
          af[k][1] = mul_bf16x2(af[k][1], w_lo);
          af[k][2] = mul_bf16x2(af[k][2], w_hi);
          af[k][3] = mul_bf16x2(af[k][3], w_hi);
        }
        fence_proxy_async();  // these generic reads precede the slot's next TMA write
      }
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kTcRows / 16; ++k) {
        const uint64_t db = sw128_desc(st + b_off + k * 2048, kTcBoxBytes, 1024);
        if (kWgt) {
          wgmma_m64n128k16_rs(acc, af[k], db, (fresh && k == 0) ? 0 : 1);
        } else {
          const uint64_t da = sw128_desc(st + a_off + k * 2048, kTcBoxBytes, 1024);
          wgmma_m64n128k16(acc, da, db, (fresh && k == 0) ? 0 : 1);
        }
      }
      wgmma_commit();
      fence_acc(acc);
      fresh = 0;
      if (kMode != kGram && diag) {  // block-uniform; overlaps the wgmma just issued
        const unsigned char* p = sm + slot * kTcStageBytes + a_off;
        float ym[4], wm[4];  // linreg: y·m; kWeighted: the residual and the weight
        if (kLin || kWgt) {
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            ym[rr] = kLin ? y_next[rr] * m_next[rr] : y_next[rr];
            wm[rr] = m_next[rr];
          }
          load_ym(s + 1);
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int r = q + 16 * rr;
          const uint4 v = *reinterpret_cast<const uint4*>(p + r * 128 + ((c8 ^ (r & 7)) << 4));
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const float lo = __uint_as_float(w[h] << 16);  // exact bf16 -> f32
            const float hi = __uint_as_float(w[h] & 0xffff0000u);
            if (kWgt) {
              cs[2 * h] = fmaf(lo, wm[rr], cs[2 * h]);
              cs[2 * h + 1] = fmaf(hi, wm[rr], cs[2 * h + 1]);
            } else {
              cs[2 * h] += lo;
              cs[2 * h + 1] += hi;
            }
            if (kLin || resid) {
              xy[2 * h] = fmaf(lo, ym[rr], xy[2 * h]);
              xy[2 * h + 1] = fmaf(hi, ym[rr], xy[2 * h + 1]);
            }
          }
        }
        fence_proxy_async();  // these generic reads precede the slot's next TMA write
      }
      if (plan.promote > 0 && ++since == plan.promote) {
        wgmma_wait<0>();
        fence_acc(acc);
        if (kWgt) fence_frag(af);
        if (pending >= 0) mbar_arrive(empty(pending));
        mbar_arrive(empty(slot));
        pending = -1;
#pragma unroll
        for (int v = 0; v < 64; ++v) tot[v] += acc[v];
        fresh = 1;
        since = 0;
      } else if (kWgt) {
        // The next stage rewrites af: this stage's wgmmas must be done.
        wgmma_wait<0>();
        fence_acc(acc);
        fence_frag(af);
        mbar_arrive(empty(slot));
        if (plan.promote == 0) since = 1;
      } else {
        wgmma_wait<1>();  // the previous stage's wgmmas are done: release it
        fence_acc(acc);
        if (pending >= 0) mbar_arrive(empty(pending));
        pending = slot;
        if (plan.promote == 0) since = 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (pending >= 0) mbar_arrive(empty(pending));
    if (since > 0) {
#pragma unroll
      for (int v = 0; v < 64; ++v) tot[v] += acc[v];
    }

    if (kMode != kGram && diag) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 8);
        cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 16);
        if (kLin || resid) {
          xy[k] += __shfl_xor_sync(0xffffffffu, xy[k], 8);
          xy[k] += __shfl_xor_sync(0xffffffffu, xy[k], 16);
        }
      }
      if (lane < 8) {
        const long long col0 = i0 + kTcBox * wg + 8 * lane;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (col0 + k < d) {
            atomicAdd(&colsum[col0 + k], cs[k]);
            if (kLin || resid) atomicAdd(&out.xty[col0 + k], xy[k]);
          }
        }
      }
    }

    // Epilogue: every consumer is past the ring, whose memory now stages
    // the tile (rows of G[i, j]) and its transpose (rows of G[j, i]).
    consumer_sync();
    float* epi = reinterpret_cast<float*>(sm);
    float* epi_t = epi + kTile * kTcEpiStride;
#pragma unroll
    for (int v = 0; v < 64; v += 2) {
      // wgmma's f32 fragment: row 16·warp + lane/4 (+8), column 8·(v/4) + 2·(lane%4).
      const int m = kTcBox * wg + 16 * warp + lane / 4 + 8 * ((v >> 1) & 1);
      const int n = 8 * (v >> 2) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(epi + m * kTcEpiStride + n) = make_float2(tot[v], tot[v + 1]);
      if (!diag) {
        epi_t[n * kTcEpiStride + m] = tot[v];
        epi_t[(n + 1) * kTcEpiStride + m] = tot[v + 1];
      }
    }
    fence_proxy_async();  // the bulk reduce (async proxy) reads these rows
    consumer_sync();
    if (ct < kTile) {
      const long long gi = i0 + ct;
      if (gi < d) {
        const uint32_t bytes = static_cast<uint32_t>(min(static_cast<long long>(kTile), d - j0)) * 4;
        bulk_add_f32(gram + gi * d + j0, epi + ct * kTcEpiStride, bytes);
      }
    } else if (!diag) {
      const int n = ct - kTile;
      const long long gj = j0 + n;
      if (gj < d) {
        const uint32_t bytes = static_cast<uint32_t>(min(static_cast<long long>(kTile), d - i0)) * 4;
        bulk_add_f32(gram + gj * d + i0, epi_t + n * kTcEpiStride, bytes);
      }
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// One tensor-core launch over a plan the wrapper made: the (n_pairs, 2)
// int32 tile pairs on the device, each for `classes` classes (kWeighted;
// else 1), `splits` row splits of `split_rows` rows covering `rows`, a
// promotion every `promote` stages (0: once).
template <int kMode>
int launch_tc(const void* x, long long rows, long long d, const int* pairs, int n_pairs,
              int classes, long long splits, long long split_rows, int promote,
              const float* mask, const float* y, const Outputs& out, void* stream) {
  if (d < 8 || d % 8 != 0 || d > (1LL << 30) || rows < 0 || rows > INT_MAX ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out.gram) % 16 != 0 ||
      pairs == nullptr || n_pairs < 1 || classes < 1 ||
      static_cast<long long>(n_pairs) * classes > INT_MAX || (kMode != kWeighted && classes != 1) ||
      (kMode == kWeighted && mask == nullptr) || splits < 1 || splits > kMaxGridY ||
      split_rows < kTcRows || split_rows % kTcRows != 0 || splits * split_rows < rows ||
      promote < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const int regs = kernel_registers(reinterpret_cast<const void*>(&gram_tc_kernel<kMode>));
  if (regs != kTcEntryRegs) return kErrRegisters;  // setmaxnreg would starve or not apply
  CUtensorMap map;
  const int rc = bf16_tensor_map(&map, x, rows, d, kTcRows);
  if (rc != 0) return rc;
  const cudaError_t e =
      cudaFuncSetAttribute(reinterpret_cast<const void*>(&gram_tc_kernel<kMode>),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const TcPlan plan{pairs, rows, split_rows, d, promote, classes};
  // The classes of one (pair, split) are neighbours in launch order, so
  // they run side by side and share the split's x panels in L2.
  const dim3 grid(static_cast<unsigned>(n_pairs * classes), static_cast<unsigned>(splits));
  gram_tc_kernel<kMode><<<grid, kTcThreads, kTcSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map, plan, mask, y, out);
  return static_cast<int>(cudaGetLastError());
}

// The Newton row pass over n rows (see newton_row_kernel).
int launch_rows(const void* x, int is_bf16, const float* y, const float* mask, const float* w,
                const float* b, long long n, long long d, float* resid, float* wgt, float* gb,
                float* hbb, cudaStream_t s) {
  if (n <= 0) return 0;
  long long blocks = (n + kRowThreads / 32 - 1) / (kRowThreads / 32);
  blocks = blocks > kRowBlocks ? kRowBlocks : blocks;
  if (is_bf16) {
    newton_row_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kRowThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), y, mask, w, b, n, d, resid, wgt, gb, hbb);
  } else {
    newton_row_kernel<float><<<static_cast<unsigned>(blocks), kRowThreads, 0, s>>>(
        static_cast<const float*>(x), y, mask, w, b, n, d, resid, wgt, gb, hbb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The FFMA entry points take the wrapper's plan (kernels.ffma_gram_plan):
// `pairs` (n_pairs, 2) int32 tile pairs i <= j on the device, `splits` row
// splits of `split_rows` rows covering the rows. Each returns the
// cudaError_t of its launches.

// gram += (x · mask)ᵀ (x · mask). x: (n, d) row-major f32 or bf16; mask: (n,)
// f32, or null for all ones; gram: (d, d) f32.
int srml_gram(const void* x, int is_bf16, const float* mask, long long n, long long d,
              const int* pairs, int n_pairs, long long splits, long long split_rows, float* gram,
              void* stream) {
  const Outputs out{gram, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch_ffma<kMasked>(x, is_bf16, n, d, pairs, n_pairs, 1, splits, split_rows, mask,
                              nullptr, out, stream);
}

// Over the first min(n, max(n_valid, 0)) rows of x: gram += xᵀx,
// colsum += Σx, count += rows. gram (d, d), colsum (d,), count () are f32.
int srml_gram_colsum(const void* x, int is_bf16, long long n, long long d, long long n_valid,
                     const int* pairs, int n_pairs, long long splits, long long split_rows,
                     float* gram, float* colsum, float* count, void* stream) {
  const long long rows = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
  const Outputs out{gram, colsum, count, nullptr, nullptr, nullptr, nullptr};
  return launch_ffma<kColsum>(x, is_bf16, rows, d, pairs, n_pairs, 1, splits, split_rows, nullptr,
                              nullptr, out, stream);
}

// With xm = x·m and ym = y·m over all n rows (mask null: m = 1):
// xtx += xmᵀxm, xty += xmᵀym, sx += Σxm, sy += Σym, syy += Σym²,
// rows += #(m != 0). x: (n, d) f32 or bf16; y, mask: (n,) f32; xtx (d, d),
// xty and sx (d,), sy and syy () f32; rows () uint64.
int srml_linreg_stats(const void* x, int is_bf16, const float* mask, const float* y, long long n,
                      long long d, const int* pairs, int n_pairs, long long splits,
                      long long split_rows, float* xtx, float* xty, float* sx, float* sy,
                      float* syy, unsigned long long* rows, void* stream) {
  const Outputs out{xtx, sx, nullptr, xty, sy, syy, rows};
  return launch_ffma<kLinreg>(x, is_bf16, n, d, pairs, n_pairs, 1, splits, split_rows, mask, y,
                              out, stream);
}

// gram += xᵀx on the tensor-core body: bf16 x with d % 8 == 0, x and gram
// 16-byte aligned, no mask, over the plan of srml_gram_colsum_tc below.
int srml_gram_tc(const void* x, long long n, long long d, const int* pairs, int n_pairs,
                 long long splits, long long split_rows, int promote, float* gram,
                 void* stream) {
  const Outputs out{gram, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch_tc<kGram>(x, n, d, pairs, n_pairs, 1, splits, split_rows, promote, nullptr,
                          nullptr, out, stream);
}

// srml_gram_colsum on the tensor-core body: bf16 x with d % 8 == 0, x and
// gram 16-byte aligned, over the wrapper's plan: `pairs` (n_pairs, 2)
// int32 tile pairs i <= j on the device, `splits` row splits of
// `split_rows` rows (a multiple of 64) covering the rows, the wgmma
// accumulator promoted every `promote` stages (0: once, at the end).
// Returns a cudaError_t, or 1000 + a CUresult of the tensor-map encode,
// 1998 (kernel registers) or 1999 (no encoder in the driver).
int srml_gram_colsum_tc(const void* x, long long n, long long d, long long n_valid,
                        const int* pairs, int n_pairs, long long splits, long long split_rows,
                        int promote, float* gram, float* colsum, float* count, void* stream) {
  const long long rows = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
  const Outputs out{gram, colsum, count, nullptr, nullptr, nullptr, nullptr};
  return launch_tc<kColsum>(x, rows, d, pairs, n_pairs, 1, splits, split_rows, promote, nullptr,
                            nullptr, out, stream);
}

// srml_linreg_stats on the tensor-core body, with the plan arguments of
// srml_gram_colsum_tc; the mask (null: all ones) must be {0, 1}.
int srml_linreg_stats_tc(const void* x, const float* mask, const float* y, long long n,
                         long long d, const int* pairs, int n_pairs, long long splits,
                         long long split_rows, int promote, float* xtx, float* xty, float* sx,
                         float* sy, float* syy, unsigned long long* rows, void* stream) {
  const Outputs out{xtx, sx, nullptr, xty, sy, syy, rows};
  return launch_tc<kLinreg>(x, n, d, pairs, n_pairs, 1, splits, split_rows, promote, mask, y,
                            out, stream);
}

// One binomial Newton-IRLS pass at (w, b) over the n rows of x (f32 or bf16,
// (n, d) row-major): with z = x·w + b, p = σ(z), r = (p − y)·m and
// wgt = max(p(1 − p), 1e-10)·m (mask null: m = 1),
// gw += Xᵀr, gb += Σr, hww += Xᵀdiag(wgt)X, hwb += Xᵀwgt, hbb += Σwgt.
// y, mask: (n,) f32; w: (d,) f32; b: () f32 on the device; resid, wgt: (n,)
// f32 scratch the row pass writes; gw, hwb (d,), hww (d, d), gb, hbb () f32.
int srml_newton_stats(const void* x, int is_bf16, const float* y, const float* mask,
                      const float* w, const float* b, long long n, long long d, const int* pairs,
                      int n_pairs, long long splits, long long split_rows, float* resid,
                      float* wgt, float* gw, float* gb, float* hww, float* hwb, float* hbb,
                      void* stream) {
  const int rc = launch_rows(x, is_bf16, y, mask, w, b, n, d, resid, wgt, gb, hbb,
                             static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  const Outputs out{hww, hwb, nullptr, gw, nullptr, nullptr, nullptr};
  return launch_ffma<kWeighted>(x, is_bf16, n, d, pairs, n_pairs, 1, splits, split_rows, wgt,
                                resid, out, stream);
}

// srml_newton_stats on the tensor-core body for bf16 x (d % 8 == 0, x and
// hww 16-byte aligned), with the plan arguments of srml_gram_colsum_tc:
// the row pass, then the weighted Gram pass, whose Hessian operand is
// bf16(x·bf16(wgt)) (the Pallas kernel's rounding); Xᵀr and Xᵀwgt stay f32.
int srml_newton_stats_tc(const void* x, const float* y, const float* mask, const float* w,
                         const float* b, long long n, long long d, const int* pairs, int n_pairs,
                         long long splits, long long split_rows, int promote, float* resid,
                         float* wgt, float* gw, float* gb, float* hww, float* hwb, float* hbb,
                         void* stream) {
  const int rc = launch_rows(x, 1, y, mask, w, b, n, d, resid, wgt, gb, hbb,
                             static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  const Outputs out{hww, hwb, nullptr, gw, nullptr, nullptr, nullptr};
  return launch_tc<kWeighted>(x, n, d, pairs, n_pairs, 1, splits, split_rows, promote, wgt,
                              resid, out, stream);
}

// Per class c of the (n, C) f32 weights p (softmax probabilities, already
// masked): hw[c] += Xᵀdiag(p_c)X, hwb[c] += Xᵀp_c. x: (n, d) f32 or bf16;
// hw (C, d, d), hwb (C, d) f32; blockIdx.x = pair · C + class.
int srml_softmax_curvature(const void* x, int is_bf16, const float* p, long long n, long long d,
                           int n_classes, const int* pairs, int n_pairs, long long splits,
                           long long split_rows, float* hw, float* hwb, void* stream) {
  const Outputs out{hw, hwb, nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch_ffma<kWeighted>(x, is_bf16, n, d, pairs, n_pairs, n_classes, splits, split_rows,
                                p, nullptr, out, stream);
}

// srml_softmax_curvature on the tensor-core body for bf16 x (as
// srml_newton_stats_tc), the weights given TRANSPOSED: pt (C, n), so that
// a stage's 64 weights of one class are one coalesced load. hw[c] is
// bf16(x·bf16(p_c))ᵀx; hwb[c] = Xᵀp_c stays f32.
int srml_softmax_curvature_tc(const void* x, const float* pt, long long n, long long d,
                              int n_classes, const int* pairs, int n_pairs, long long splits,
                              long long split_rows, int promote, float* hw, float* hwb,
                              void* stream) {
  const Outputs out{hw, hwb, nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch_tc<kWeighted>(x, n, d, pairs, n_pairs, n_classes, splits, split_rows, promote,
                              pt, nullptr, out, stream);
}

}  // extern "C"
