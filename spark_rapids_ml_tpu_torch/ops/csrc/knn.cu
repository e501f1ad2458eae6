// Hopper (sm_90a) kernels of nearest-neighbour search: the exact streaming
// distance top-k, the IVF probe (true ‖q − c‖² to every centroid and the
// nprobe nearest) and the IVF list scan (residual scores and the best
// blk_k rows per query slot).
//
// Replaces spark_rapids_ml_tpu/ops/pallas_kernels.py:
//   dist_topk_pallas       (:678) -> srml_dist_topk, srml_dist_topk_tc
//   ivf_scan_select_pallas (:860) -> srml_ivf_scan_select, srml_ivf_scan_select_tc
//   probe_select_pallas    (:984) -> srml_probe_select, srml_probe_select_fused
//
// What the Pallas kernels compute.
//   dist_topk: per query the k smallest max(q2 + r2 − 2q·r, 0) over the db
//     rows in ascending (distance, id) order, ties to the lowest id; masked
//     rows carry r2 = +inf, and slots without a finite candidate are
//     (+inf, −1). The running k-best stays in VMEM over a sequential grid of
//     db blocks, and k extraction passes merge each block in.
//   probe_select: per query the scores (c2 − 2c·q) + q2 against every
//     centroid at full f32, packed into unique int32 keys (the sortable f32
//     bits with the low pos_bits cleared, the centroid index OR-ed in) and
//     the nprobe smallest keys, decoded to (index, floored value).
//   ivf_scan_select: per list and query slot the scores r2 − 2·(row·qv)
//     over the list's rows, packed the same way with the row position, and
//     the blk_k smallest keys, emitted as (nlist, bk_pad, C) with the
//     sublane-pad rows bk_pad − blk_k set to (3e38, 0).
// Packed keys are unique, so the output is fully determined by the keys:
// any exact selection gives the same bits. The TPU's padding of maxlen and
// nlist to 8 rows changed no output and is not carried over; pos_bits is
// still taken from the 8-padded length, since it sets the mantissa floor.
//
// Design. The three kernels share one product tile: a block of 256 threads
// computes the 128 x 128 dot products of two row sets (queries or query
// slots against db rows, list rows or centroids) in f32 registers (8 x 8
// per thread), staging 32 feature columns of both at a time in shared
// memory converted to f32 (bf16 converts exactly). The scores go to a
// 128 x 129 shared tile that reuses the staging space, and one warp per
// query (or slot) offers the tile's 128 candidates to that query's sorted
// list in shared memory: a ballot finds the lanes whose candidate beats the
// list's last entry, and each such candidate is inserted by the warp (rank
// by counting, shift by lanes). After the first tiles few candidates pass,
// so the selection costs little beside the products.
//   dist_topk (srml_dist_topk: f32, and bf16 launches the tensor-core body
//     below cannot take): a grid of (query tile, db split). A grid over
//     query tiles alone leaves most SMs idle at 4,096 queries, so the db
//     rows are split across blockIdx.y; each split's lists go to a (splits,
//     q, k) scratch and a second launch merges them per query (one warp per
//     query) in the same order. Lists hold (distance, id) pairs, k <= 64.
//   probe_select, sort route (srml_probe_select: nprobe > 96): a product
//     launch writes every query's packed keys to a (q, P) int32 scratch, P
//     the power of two >= nlist; a second launch sorts each query's row
//     (bitonic, one block per query) in shared memory when P <= 16,384, in
//     the scratch row itself beyond, and decodes the first nprobe. Covers
//     nprobe <= nlist <= 65,536.
//   probe_select, fused route (srml_probe_select_fused: nprobe <= 96, the
//     IVF query's nprobe 20). One launch; in device memory only the outputs
//     and a small L2-resident scratch of per-block lists (2.6 MB at the
//     path), where the sort route writes and sorts 16 MB of keys. Four
//     blocks (kProbeSplit) share a 128-query tile (4,096 queries: 128
//     blocks, one an SM, one wave). A block is two independent 256-thread
//     halves, each with its own staging space, named barrier and lists, so
//     an SM runs two FFMA tile groups, as two blocks an SM would (one
//     256-thread block an SM ran its products at half the rate). Half h of
//     block r takes the centroid tiles 2r + h, 2r + h + 8, ...; per tile the
//     products and keys are the keys launch's, with c2 and q2 computed in
//     the half (a warp per row, coalesced: no norm passes of their own);
//     then one warp per query
//     sorts the tile's 128 keys with a bitonic network over its lanes (four
//     keys a lane, 28 compare-exchange steps, no barrier) and merges them
//     into the half's sorted list of nprobe keys for that query
//     (min(v[e], w[127 − e]) is bitonic; seven more steps sort it). Each
//     block publishes its lists to the scratch; the last of a tile's four
//     blocks to finish (an atomic count after a fence) merges the eight
//     lists of each query and decodes them. A thread-block cluster merging
//     through distributed shared memory was measured first: the card held
//     only 30 of the 32 clusters of 4 (or 8) blocks at once, so the last
//     two ran as a second wave (0.43–0.51 ms); the count needs no
//     co-residency. The keys are unique, so the output is the sort route's.
//   ivf_scan_select: a grid of (list, tile of 128 slots); each block streams
//     its list's rows in chunks of 128. Lists hold int32 keys; when
//     128 · blk_k keys outgrow the shared budget the lists live in a
//     (nlist, C, blk_k) scratch that the wrapper allocates.
//
// Arithmetic: f32 FFMA of the input values (never TF32), the score terms in
// the Pallas kernels' order; 2·x is exact, so a contracted FMA rounds the
// same. The products are summed in another order than torch.matmul, so a
// score may differ from the plain version's in its last bits.
//
// ivf_scan_select on the tensor cores (srml_ivf_scan_select_tc; bf16 with
// d % 8 == 0, qv and rows 16-byte aligned, blk_k up to the plan's limit:
// kernels.scan_route). It is the streamed TN scoring layout of kmeans.cu
// (scoring.cuh) in another mode: A a tile of 128 query slots of one list
// (two consumer warpgroups of 64), B the list's rows in chunks of N = 256
// (wgmma m64n256k16, both operands K-major, transpose bits 0, 0), K = d in
// 64-column slabs, a stage one (query slab, list slab) pair of 48 KB.
//   - 3-D tensor maps (nlist, C, d) and (nlist, maxlen, d): a box never
//     crosses into the next list, and TMA zero-fills the slot tail and the
//     maxlen tail. Columns at or past maxlen are keyed as the masked key and
//     never emitted; rows inside maxlen with the r2 >= 1e30 sentinel are
//     real candidates, emitted when a list holds fewer than blk_k valid rows.
//   - Persistent blocks walk (list, slot tile) tasks, the tiles of a list at
//     adjacent task indices, so neighbouring blocks read a list from L2 once.
//     A chunk's 256 r2 values are staged in one of two buffers a warpgroup
//     while its wgmmas run (scoring.cuh).
//   - The epilogue, per chunk: the accumulator gives each lane of a quad two
//     slots and two columns of every 8-column group; the lanes of a pair
//     swap halves with one shuffle a value, so each lane keeps one slot and
//     four columns of each group (128 a chunk). It keys them (score r2 −
//     2·acc, the FFMA tiles' arithmetic) and offers only those below its
//     threshold, held in a register, to its own sorted list of blk_k keys in
//     shared memory (entry j of list t at j · 256 + t: conflict-free, no
//     atomics). At the end of a task the two lists of a slot merge, and the
//     first blk_k are decoded; their partner lanes write the pad rows.
//   - Shared memory: a ring of 2..4 stages beside 4 KB of r2 buffers, 8 KB
//     of a round's candidates and the lists (1 KB per key of blk_k). The plan
//     takes the deepest ring that fits (kernels.scan_stages); blk_k <= 117
//     leaves two stages (so the next stage loads while one multiplies),
//     which covers every width ApproximateNearestNeighbors extracts at k <= 64 by
//     default (ceil(1.2 · 64) = 77). Wider blk_k keeps the FFMA tiles.
//     srml_ivf_scan_tc_smem exports the plan's bytes; chip_smoke.py's phase
//     2 holds them equal to kernels.scan_smem_bytes.
//   - Arithmetic: bf16 x bf16 products are exact and the wgmma accumulates
//     in f32 with truncation, with no promotion (R = 0): a score is one dot
//     product of d <= a few thousand exact terms, and its truncation error
//     (a few ulps of the partial sums) is far below the packed keys' floor
//     of 2^(pos_bits − 23) and phase 17's selection tolerance.
//   - Registers: the producer warpgroup gives registers back (setmaxnreg 40)
//     and the consumers take 232 (an m64n256 accumulator is 128 a thread);
//     the launcher refuses (rc 1998) unless ptxas gave the kernel 168. Each
//     stage waits for its own wgmmas before it is released (scoring.cuh,
//     kOverlap false): with a group in flight across the k-loop's back
//     edge, ptxas moved accumulator registers there before the wgmmas had
//     written them, and whole accumulator registers of every thread came out
//     stale (found by dumping the raw scores on the card). The other
//     warpgroup's wgmmas keep the tensor cores busy across the wait. The
//     epilogue keys 8 columns a round straight-line, sets aside those below
//     the threshold and inserts them in a loop, which keeps ptxas from
//     spilling (ptxas -v: 0 bytes).
//
// dist_topk on the tensor cores (srml_dist_topk_tc; bf16 with d % 8 == 0,
// q and db 16-byte aligned, k up to the plan's limit: kernels.topk_route).
// A third mode of the streamed TN scoring layout (scoring.cuh): A a tile of
// 128 queries (two consumer warpgroups of 64), B the db in chunks of N = 256
// rows (m64n256k16, both operands K-major), K = d in 64-column slabs, 2-D
// tensor maps (q, d) and (m, d) (TMA zero-fills both tails; columns at or
// past m are never candidates).
//   - Persistent blocks walk (db split, query tile) tasks, the 32 query
//     tiles of a split at adjacent task indices, so the blocks that run
//     side by side stream the same chunks: HBM serves the db about once
//     (1.61 GB), L2 the rest. Each chunk reloads the query slabs from L2:
//     (128 + 256) · d · 2 bytes per 2 · 128 · 256 · d operations, 77 GB of L2
//     reads at the path's shape (PERF.md §7).
//   - Keys are 64 bits: the distance's ordered f32 bits (ordered_bits) over
//     id ^ 0x80000000, so ascending unsigned order is ascending (distance,
//     id), negative ids included. Each warpgroup stages a chunk's r2 and
//     ids in two buffers of 256 while its wgmmas run. The epilogue is the
//     scan's (pair swap: one query and four columns of each 8-column group a
//     lane; two sorted lists a query, per lane in shared memory, beside the
//     rows of their keys): a round scores 16 columns straight-line, sets
//     aside (ordered bits, column) of those at or under the threshold's
//     distance, then keys them with their ids and inserts those below the
//     threshold. +inf scores (masked rows) are never candidates: an unfilled
//     slot already emits (+inf, −1). At the end of a task the two lists of a
//     query merge into the (splits, q, k) scratch, k keys with their rows.
//   - A finishing launch (one warp per query) merges the splits' lists,
//     recomputes each finite distance in f32 FFMA from the query and its row
//     (k · d FMAs a query), as assign_min_dist recomputes its minimum:
//     Hopper's tensor cores truncate their f32 sums, which biases
//     q2 + r2 − 2·q·r, terms ~1.7e3 against distances ~190, by up to a few
//     1e-3, near phase 16's 7e-3 tolerance. It re-sorts them by (distance,
//     id) and writes the k pairs.
//   - No slack: the lists hold k keys. The truncation moves every score
//     of a query by about the same amount (the dot products of one query's
//     candidates are of one size), so the selection on the tensor-core
//     scores can swap only candidates whose distances differ by less than
//     the spread of that error, and the recomputed value of a swapped-in
//     candidate is then within it of the one it displaced: inside phase
//     15's and phase 16's tolerances (measured: 3.5e-4 against float64,
//     tolerance 8.3e-3).
//   - No promotion of the accumulator (R = 0), as the scan: the recompute
//     makes the returned values f32 sums of exact products.
//   - Shared memory: a 48 KB stage, 8 KB of r2 and id buffers, 16 KB of u64
//     candidates and the lists (12 bytes per key: 3 KB per unit of k).
//     k = 10 leaves a 3-stage ring; k <= 35 leaves two (kernels.topk_stages,
//     TOPK_TC_MAX_K); a larger k keeps the FFMA tiles, so every k <= 64 has
//     a route. srml_dist_topk_tc_smem exports the plan; phase 2 holds it
//     equal to kernels.topk_smem_bytes.
//   - Registers and hazards: setmaxnreg 40 / 232 and the rc 1998 check of
//     the scan; each stage waits for its own wgmmas (consume_chunk<N,
//     false>).
//
// Bound on the H100 at the slice's shapes (PERF.md): dist_topk over 4,096
// queries x 1,048,576 bf16 rows x 768 is 6.6e12 operations, bound by them
// (6.7 ms on the bf16 tensor cores); the FFMA tiles run at the CUDA cores'
// rate instead. The fused probe (4,096 x 1,024 x 768 f32) is 6.4e9
// operations, 0.096 ms at the f32 FFMA peak: bound by operations. The scan at nlist 1,024 x C
// 208 x maxlen 2,048 x 768 reads 3.2 GB of residual lists (0.96 ms) against
// 0.67 TFLOP of products (0.82 with the padded slots), so it is bound by
// bytes (1.07 ms with its other operands). Index arithmetic is 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "scoring.cuh"

namespace {

using namespace srml_hopper;  // NOLINT: mbarriers, TMA, wgmma, tensor maps
namespace sc = srml_scoring;  // the streamed scoring layout kmeans.cu shares

constexpr int kT = 128;                      // rows of a product tile on each side
constexpr int kDC = 32;                      // feature columns staged per step
constexpr int kThreads = 256;                // 16 x 16 threads, 8 x 8 products each
constexpr int kWarps = kThreads / 32;
constexpr int kLd = kT + 4;                  // padded staging row (float4-aligned)
constexpr int kStageRows = kThreads / kDC;
constexpr int kStageLoads = kT / kStageRows;
constexpr int kSLd = kT + 1;                 // score tile row (bank-conflict pad)
constexpr int kStageFloats = 2 * kDC * kLd;
constexpr int kTileFloats = kT * kSLd;
constexpr int kWorkFloats = kStageFloats > kTileFloats ? kStageFloats : kTileFloats;
constexpr int kSmemLimit = 232448;           // 227 KB a block may use
constexpr int kListSmem = 96 * 1024;         // scan lists beyond this go to scratch
constexpr int kSortSmemKeys = 16384;         // probe rows sorted in shared memory
constexpr int kMaskedKey = 0x7fffffff;       // above every finite packed key
constexpr float kMaskedD2 = 3.0e38f;         // the scan's sublane-pad value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int slot(int t, int s) {
  return (s < 4) ? t * 4 + s : 64 + t * 4 + (s - 4);
}

// The order-preserving f32 <-> int32 bijection (flip the non-sign bits of
// negatives); its own inverse.
__device__ __forceinline__ int sortable(int v) { return v ^ ((v >> 31) & 0x7fffffff); }

__device__ __forceinline__ int pack_key(float score, int pos, int low) {
  return (sortable(__float_as_int(score)) & ~low) | pos;
}

__device__ __forceinline__ float key_value(int key, int low) {
  return __int_as_float(sortable(key ^ (key & low)));
}

// The barrier of a tile's 256 threads: the whole block, or (Half) the named
// barrier `bar` of one 256-thread half of a larger block.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct HalfSync {
  int bar;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, 256;" ::"r"(bar) : "memory");
  }
};

// acc[i][j] = Σ_c a[slot(ty, i)][c] · b[slot(tx, j)][c] over rows na of a and
// nb of b (1 <= na, nb <= kT; missing rows count as zeros). a, b: row-major
// with d columns, pointing at the tiles' first rows; tid: the thread among
// the tile's 256, which meet at `sync`. Ends on a barrier, so the staging
// space is free when it returns.
template <typename T, typename Sync>
__device__ __forceinline__ void tile_products(const T* __restrict__ a, int na,
                                              const T* __restrict__ b, int nb, long long d,
                                              float* as, float* bs, float acc[8][8], int tid,
                                              Sync sync) {
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lc = tid % kDC;
  const int lr = tid / kDC;
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
      if (col_ok && rr < na) v = to_f32(a[static_cast<long long>(rr) * d + col]);
      if (col_ok && rr < nb) w = to_f32(b[static_cast<long long>(rr) * d + col]);
      as[lc * kLd + rr] = v;
      bs[lc * kLd + rr] = w;
    }
    sync();
#pragma unroll 8
    for (int kk = 0; kk < kDC; ++kk) {
      float av[8], bv[8];
      const float4 a_lo = *reinterpret_cast<const float4*>(&as[kk * kLd + ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&as[kk * kLd + 64 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&bs[kk * kLd + tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&bs[kk * kLd + 64 + tx * 4]);
      av[0] = a_lo.x; av[1] = a_lo.y; av[2] = a_lo.z; av[3] = a_lo.w;
      av[4] = a_hi.x; av[5] = a_hi.y; av[6] = a_hi.z; av[7] = a_hi.w;
      bv[0] = b_lo.x; bv[1] = b_lo.y; bv[2] = b_lo.z; bv[3] = b_lo.w;
      bv[4] = b_hi.x; bv[5] = b_hi.y; bv[6] = b_hi.z; bv[7] = b_hi.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    sync();
  }
}

// The same over the whole 256-thread block.
template <typename T>
__device__ __forceinline__ void tile_products(const T* __restrict__ a, int na,
                                              const T* __restrict__ b, int nb, long long d,
                                              float* as, float* bs, float acc[8][8]) {
  tile_products(a, na, b, nb, d, as, bs, acc, static_cast<int>(threadIdx.x), BlockSync{});
}

// ---------------------------------------------------------------------------
// Sorted lists owned by one warp
// ---------------------------------------------------------------------------

struct DI {
  float d;
  int i;
};

__device__ __forceinline__ bool key_less(const DI& a, const DI& b) {
  return a.d < b.d || (a.d == b.d && a.i < b.i);
}
__device__ __forceinline__ bool key_less(int a, int b) { return a < b; }

__device__ __forceinline__ DI shfl(const DI& v, int src) {
  return DI{__shfl_sync(kFull, v.d, src), __shfl_sync(kFull, v.i, src)};
}
__device__ __forceinline__ int shfl(int v, int src) { return __shfl_sync(kFull, v, src); }

// Inserts cand into the ascending list lst[0, len) (shared or global memory),
// dropping the last entry; cand must be less than lst[len − 1]. Called by a
// whole warp with the same cand.
template <typename K>
__device__ void insert_sorted(K* lst, int len, K cand) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  for (int j = lane; j < len; j += 32) cnt += key_less(lst[j], cand) ? 1 : 0;
  const int p = __reduce_add_sync(kFull, cnt);
  for (int top = len - 1; top > p; top -= 32) {
    const int j = top - lane;
    const bool act = j > p;
    K v;
    if (act) v = lst[j - 1];
    __syncwarp();
    if (act) lst[j] = v;
    __syncwarp();
  }
  if (lane == 0) lst[p] = cand;
  __syncwarp();
}

// Offers each lane's candidate to the warp's list; th holds (and is kept
// equal to) the list's last entry.
template <typename K>
__device__ __forceinline__ void offer(K* lst, int len, K cand, K& th) {
  unsigned want = __ballot_sync(kFull, key_less(cand, th));
  while (want) {
    const int src = __ffs(want) - 1;
    want &= want - 1;
    const K c = shfl(cand, src);
    if (key_less(c, th)) {  // the list may have tightened since the ballot
      insert_sorted(lst, len, c);
      th = lst[len - 1];
    }
  }
}

// ---------------------------------------------------------------------------
// dist_topk
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
dist_topk_kernel(const T* __restrict__ q, const T* __restrict__ db,
                 const float* __restrict__ q2, const float* __restrict__ r2,
                 const int* __restrict__ ids, long long nq, long long m, long long d,
                 int k, long long split_rows, DI* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = smem + kDC * kLd;
  float* sc = smem;  // the score tile reuses the staging space
  DI* lists = reinterpret_cast<DI*>(smem + kWorkFloats);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long q0 = static_cast<long long>(blockIdx.x) * kT;
  const int nqt = static_cast<int>(min(static_cast<long long>(kT), nq - q0));
  const long long r_begin = static_cast<long long>(blockIdx.y) * split_rows;
  const long long r_end = min(m, r_begin + split_rows);
  for (int e = tid; e < kT * k; e += kThreads) lists[e] = DI{inf_f(), -1};
  float q2v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = slot(ty, i);
    q2v[i] = qi < nqt ? q2[q0 + qi] : 0.f;
  }
  __syncthreads();
  for (long long r0 = r_begin; r0 < r_end; r0 += kT) {
    const int nr = static_cast<int>(min(static_cast<long long>(kT), r_end - r0));
    float acc[8][8];
    tile_products(q + q0 * d, nqt, db + r0 * d, nr, d, as, bs, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int rj = slot(tx, j);
      const float r2v = rj < nr ? r2[r0 + rj] : inf_f();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // (q2 + r2) − 2·q·r, clipped at 0: the order of sq_euclidean.
        const float s = fmaxf((q2v[i] + r2v) - 2.f * acc[i][j], 0.f);
        sc[slot(ty, i) * kSLd + rj] = rj < nr ? s : inf_f();
      }
    }
    __syncthreads();
    for (int ql = warp; ql < nqt; ql += kWarps) {
      DI* lst = lists + ql * k;
      DI th = lst[k - 1];
      for (int t = 0; t < kT; t += 32) {
        const int rj = t + lane;
        const DI cand = rj < nr ? DI{sc[ql * kSLd + rj], ids[r0 + rj]} : DI{inf_f(), -1};
        offer(lst, k, cand, th);
      }
    }
    __syncthreads();  // the next tile's staging overwrites the scores
  }
  DI* dst = out + (static_cast<long long>(blockIdx.y) * nq + q0) * k;
  for (int e = tid; e < nqt * k; e += kThreads) dst[e] = lists[e];
}

// One warp per query: merges the query's sorted lists of all splits.
__global__ void __launch_bounds__(kThreads)
dist_topk_merge(const DI* __restrict__ part, long long nq, int k, int splits,
                DI* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long qi = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (qi >= nq) return;  // warp-uniform; no block barrier follows
  DI* lst = reinterpret_cast<DI*>(smem) + warp * k;
  for (int j = lane; j < k; j += 32) lst[j] = DI{inf_f(), -1};
  __syncwarp();
  DI th = lst[k - 1];
  for (int s = 0; s < splits; ++s) {
    const DI* src = part + (static_cast<long long>(s) * nq + qi) * k;
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      offer(lst, k, j < k ? src[j] : DI{inf_f(), -1}, th);
    }
  }
  for (int j = lane; j < k; j += 32) out[qi * k + j] = lst[j];
}

template <typename T>
int launch_dist_topk(const T* q, const T* db, const float* q2, const float* r2,
                     const int* ids, long long nq, long long m, long long d, int k,
                     int splits, DI* part, DI* out, cudaStream_t s) {
  if (k < 1 || k > 64 || splits < 1 || splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (kWorkFloats + 2 * static_cast<size_t>(kT) * k) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dist_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_m = (m + kT - 1) / kT;
  const long long split_rows = (tiles_m + splits - 1) / splits * kT;
  const long long used = (m + split_rows - 1) / split_rows;  // splits that hold rows
  const dim3 grid(static_cast<unsigned>((nq + kT - 1) / kT), static_cast<unsigned>(used));
  dist_topk_kernel<T><<<grid, kThreads, smem, s>>>(q, db, q2, r2, ids, nq, m, d, k, split_rows,
                                                   used == 1 ? out : part);
  if ((err = cudaGetLastError()) != cudaSuccess || used == 1) return static_cast<int>(err);
  const size_t msmem = static_cast<size_t>(kWarps) * k * sizeof(DI);
  dist_topk_merge<<<static_cast<unsigned>((nq + kWarps - 1) / kWarps), kThreads, msmem, s>>>(
      part, nq, k, static_cast<int>(used), out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// probe_select
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
probe_keys_kernel(const float* __restrict__ cent, const float* __restrict__ c2,
                  const float* __restrict__ qs, const float* __restrict__ q2, long long nq,
                  long long nlist, long long d, int low, long long stride,
                  int* __restrict__ keys) {
  __shared__ __align__(16) float stage[kStageFloats];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long q0 = static_cast<long long>(blockIdx.x) * kT;
  const long long c0 = static_cast<long long>(blockIdx.y) * kT;
  const int nqt = static_cast<int>(min(static_cast<long long>(kT), nq - q0));
  const int nct = static_cast<int>(min(static_cast<long long>(kT), nlist - c0));
  float acc[8][8];
  tile_products(qs + q0 * d, nqt, cent + c0 * d, nct, d, stage, stage + kDC * kLd, acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cj = slot(tx, j);
    if (cj >= nct) continue;
    const float c2v = c2[c0 + cj];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = slot(ty, i);
      if (qi >= nqt) continue;
      // (c2 − 2·c·q) + q2: the Pallas kernel's order, no clamp.
      const float s = (c2v - 2.f * acc[i][j]) + q2[q0 + qi];
      keys[(q0 + qi) * stride + c0 + cj] = pack_key(s, static_cast<int>(c0 + cj), low);
    }
  }
}

// Ascending bitonic sort of buf[0, n), n a power of two, by the whole block.
__device__ void block_bitonic(int* buf, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const int a = buf[lo];
        const int b = buf[hi];
        if ((a > b) == asc) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// One block per query: sorts the query's P keys (nlist real, the rest
// kMaskedKey) and decodes the first nprobe.
__global__ void __launch_bounds__(kThreads)
probe_sort_kernel(int* __restrict__ keys, long long nlist, int p, int nprobe, int low,
                  int in_smem, int* __restrict__ out_p, float* __restrict__ out_d) {
  extern __shared__ __align__(16) float smem[];
  const long long qi = blockIdx.x;
  int* row = keys + qi * p;
  int* buf = in_smem ? reinterpret_cast<int*>(smem) : row;
  for (int j = threadIdx.x; j < p; j += blockDim.x) buf[j] = j < nlist ? row[j] : kMaskedKey;
  __syncthreads();
  block_bitonic(buf, p);
  for (int j = threadIdx.x; j < nprobe; j += blockDim.x) {
    const int key = buf[j];
    out_p[qi * nprobe + j] = key & low;
    out_d[qi * nprobe + j] = key_value(key, low);
  }
}

int launch_probe(const float* cent, const float* c2, const float* qs, const float* q2,
                 long long nq, long long nlist, long long d, int nprobe, int pos_bits, int p,
                 int* keys, int* out_p, float* out_d, cudaStream_t s) {
  if (pos_bits < 1 || pos_bits > 16 || nprobe < 1 || nprobe > nlist || p < nlist)
    return static_cast<int>(cudaErrorInvalidValue);
  const int low = (1 << pos_bits) - 1;
  const dim3 grid(static_cast<unsigned>((nq + kT - 1) / kT),
                  static_cast<unsigned>((nlist + kT - 1) / kT));
  probe_keys_kernel<<<grid, kThreads, 0, s>>>(cent, c2, qs, q2, nq, nlist, d, low, p, keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int in_smem = p <= kSortSmemKeys;
  const size_t smem = in_smem ? static_cast<size_t>(p) * 4 : 0;
  if ((err = cudaFuncSetAttribute(probe_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kSortSmemKeys * 4))) != cudaSuccess)
    return static_cast<int>(err);
  probe_sort_kernel<<<static_cast<unsigned>(nq), kThreads, smem, s>>>(keys, nlist, p, nprobe, low,
                                                                      in_smem, out_p, out_d);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// probe_select, fused: products, keys and selection in one launch
// ---------------------------------------------------------------------------

constexpr int kProbeSplit = 4;                  // blocks sharing a query tile
constexpr int kProbeThreads = 2 * kThreads;      // two independent 256-thread tile groups a block
constexpr int kProbeGroups = 2 * kProbeSplit;    // lists a query tile merges: one per half

// Compare-exchange of element e = r · 32 + lane with element e ^ j (j < 32:
// the lanes' values) into ascending order of the pair when `up`, else
// descending: the lower element keeps the smaller when up.
__device__ __forceinline__ int cx_lanes(int v, int j, bool up) {
  const int o = __shfl_xor_sync(kFull, v, j);
  const bool lower = (threadIdx.x & j) == 0;
  return (lower == up) ? min(v, o) : max(v, o);
}

// The same for j = 32 · jr (jr 1 or 2): pairs of registers of one lane.
template <int JR>
__device__ __forceinline__ void cx_regs(int (&v)[4], int size) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r & JR) continue;
    const bool up = ((r * 32 + lane) & size) == 0;
    const int a = v[r];
    const int b = v[r | JR];
    v[r] = up ? min(a, b) : max(a, b);
    v[r | JR] = up ? max(a, b) : min(a, b);
  }
}

// Ascending bitonic sort of a warp's 128 keys, element e = r · 32 + lane in
// v[r] of that lane.
__device__ __forceinline__ void warp_sort128(int (&v)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 128; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j == 64) {
        cx_regs<2>(v, size);
      } else if (j == 32) {
        cx_regs<1>(v, size);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] = cx_lanes(v[r], j, ((r * 32 + lane) & size) == 0);
      }
    }
  }
}

// v ascending and w ascending (128 keys each, as above) -> v: the 128
// smallest of both, ascending. min(v[e], w[127 − e]) holds them as a
// bitonic sequence, which the last stage of the network sorts.
__device__ __forceinline__ void warp_merge128(int (&v)[4], const int (&w)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = min(v[r], __shfl_sync(kFull, w[3 - r], 31 - lane));
  cx_regs<2>(v, 128);
  cx_regs<1>(v, 128);
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = cx_lanes(v[r], j, true);
  }
}

// A sorted list of len <= 128 keys as the warp's 128 keys, kMaskedKey past len.
__device__ __forceinline__ void load_list(int (&w)[4], const int* lst, int len) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) w[r] = r * 32 + lane < len ? lst[r * 32 + lane] : kMaskedKey;
}

// Squared norms of rows [0, n) of x (row-major, d columns) into out[0, kT),
// zeros past n: warp w of a half's 8 takes rows w, w + 8, ...; its lanes
// stride the columns (coalesced), then a butterfly. f32 FMA sums.
__device__ __forceinline__ void half_row_norms(const float* __restrict__ x, int n, long long d,
                                               float* out, int warp, int lane) {
  for (int r = warp; r < kT; r += kWarps) {
    float s = 0.f;
    if (r < n) {
      for (long long c = lane; c < d; c += 32) {
        const float v = x[static_cast<long long>(r) * d + c];
        s = fmaf(v, v, s);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) out[r] = s;
  }
}

// Per query tile (blockIdx.y) kProbeSplit blocks (blockIdx.x = rank) of two
// 256-thread halves each: half h of block `rank` is list group g = 2 · rank
// + h and takes the centroid tiles g, g + kProbeGroups, ...: each tile's
// 128 x 128 products as the FFMA tiles compute them (the half's own
// staging space and named barrier 1 + h) and the norms q2 and c2 of its
// rows (half_row_norms), keyed into its score tile, then
// per query (one warp) its 128 keys sorted and merged into the group's
// sorted list of nprobe keys for that query in shared memory. Each block
// then publishes its two groups' lists to part (q_tiles, kProbeGroups, 128,
// nprobe), and the last of the tile's blocks to finish (done[tile], an
// atomic count from 0) merges the kProbeGroups lists of each query and
// decodes the first nprobe.
__global__ void __launch_bounds__(kProbeThreads, 1)
probe_fused_kernel(const float* __restrict__ cent, const float* __restrict__ qs, long long nq,
                   long long nlist, long long d, int nprobe, int low, int* __restrict__ part,
                   unsigned* __restrict__ done, int* __restrict__ out_p,
                   float* __restrict__ out_d) {
  extern __shared__ __align__(16) float smem[];
  const int rank = blockIdx.x;
  const int h = threadIdx.x / kThreads;  // the half
  const int tid = threadIdx.x % kThreads;
  const HalfSync sync{1 + h};
  float* as = smem + h * kWorkFloats;
  float* bs = as + kDC * kLd;
  int* sc = reinterpret_cast<int*>(as);  // the key tile reuses the staging space
  float* q2_s = smem + 2 * kWorkFloats + h * 2 * kT;  // the half's q2 and c2 of the tile's rows
  float* c2_s = q2_s + kT;
  int* mine = reinterpret_cast<int*>(smem + 2 * kWorkFloats + 4 * kT) + h * kT * nprobe;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long q0 = static_cast<long long>(blockIdx.y) * kT;
  const int nqt = static_cast<int>(min(static_cast<long long>(kT), nq - q0));
  const long long tiles = (nlist + kT - 1) / kT;
  for (int e = tid; e < kT * nprobe; e += kThreads) mine[e] = kMaskedKey;
  half_row_norms(qs + q0 * d, nqt, d, q2_s, warp, lane);
  for (long long ct = 2 * rank + h; ct < tiles; ct += kProbeGroups) {
    const long long c0 = ct * kT;
    const int nct = static_cast<int>(min(static_cast<long long>(kT), nlist - c0));
    half_row_norms(cent + c0 * d, nct, d, c2_s, warp, lane);  // read after the barriers below
    float acc[8][8];
    tile_products(qs + q0 * d, nqt, cent + c0 * d, nct, d, as, bs, acc, tid, sync);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cj = slot(tx, j);
      const float c2v = c2_s[cj];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qi = slot(ty, i);
        // (c2 − 2·c·q) + q2: the Pallas kernel's order, no clamp.
        const float s = (c2v - 2.f * acc[i][j]) + q2_s[qi];
        sc[qi * kSLd + cj] =
            cj < nct ? pack_key(s, static_cast<int>(c0 + cj), low) : kMaskedKey;
      }
    }
    sync();
    for (int ql = warp; ql < nqt; ql += kWarps) {
      int v[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = sc[ql * kSLd + r * 32 + lane];
      warp_sort128(v);
      int* lst = mine + ql * nprobe;
      load_list(w, lst, nprobe);
      warp_merge128(v, w);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r * 32 + lane < nprobe) lst[r * 32 + lane] = v[r];
      }
    }
    sync();  // the next tile's staging overwrites the keys
  }
  // Publish the two groups' lists; the tile's last block merges them.
  int* tile_part = part + static_cast<long long>(blockIdx.y) * kProbeGroups * kT * nprobe;
  int* my_part = tile_part + (2 * rank + h) * kT * nprobe;
  for (int e = tid; e < nqt * nprobe; e += kThreads) my_part[e] = mine[e];
  __threadfence();
  __syncthreads();
  int* last = reinterpret_cast<int*>(smem);  // the staging space is free now
  if (threadIdx.x == 0) *last = atomicAdd(done + blockIdx.y, 1u) == kProbeSplit - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();  // the other blocks' lists, published before their count, are visible
  for (int ql = threadIdx.x / 32; ql < nqt; ql += kProbeThreads / 32) {
    int w[kProbeGroups][4];  // all groups' loads in flight at once
#pragma unroll
    for (int g = 0; g < kProbeGroups; ++g) {
      const int* src = tile_part + (g * kT + ql) * nprobe;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        w[g][r] = r * 32 + lane < nprobe ? __ldcg(src + r * 32 + lane) : kMaskedKey;
      }
    }
#pragma unroll
    for (int g = 1; g < kProbeGroups; ++g) warp_merge128(w[0], w[g]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = r * 32 + lane;
      if (e < nprobe) {
        out_p[(q0 + ql) * nprobe + e] = w[0][r] & low;
        out_d[(q0 + ql) * nprobe + e] = key_value(w[0][r], low);
      }
    }
  }
}

// Shared memory of a fused probe launch: a work tile, the tile's q2 and c2,
// and 128 lists of nprobe keys for each half (kernels.probe_smem_bytes
// copies it).
long long probe_fused_smem(int nprobe) {
  return 2 * (static_cast<long long>(kWorkFloats) * 4 + 4LL * 2 * kT + 4LL * kT * nprobe);
}

int launch_probe_fused(const float* cent, const float* qs, long long nq, long long nlist,
                       long long d, int nprobe, int pos_bits, int* part, unsigned* done,
                       int* out_p, float* out_d, cudaStream_t s) {
  const long long q_tiles = (nq + kT - 1) / kT;
  if (pos_bits < 1 || pos_bits > 16 || nprobe < 1 || nprobe > nlist || nprobe > kT || nq < 1 ||
      q_tiles > 65535 || probe_fused_smem(nprobe) > kSmemLimit || part == nullptr ||
      done == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(probe_fused_smem(nprobe));
  cudaError_t err = cudaFuncSetAttribute(probe_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaMemsetAsync(done, 0, static_cast<size_t>(q_tiles) * sizeof(unsigned), s)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid(kProbeSplit, static_cast<unsigned>(q_tiles));
  probe_fused_kernel<<<grid, kProbeThreads, smem, s>>>(cent, qs, nq, nlist, d, nprobe,
                                                       (1 << pos_bits) - 1, part, done, out_p,
                                                       out_d);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// ivf_scan_select
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const T* __restrict__ qv, const T* __restrict__ rows,
                const float* __restrict__ r2, long long n_slots, long long maxlen, long long d,
                int blk_k, int bk_pad, int low, int* __restrict__ scratch,
                float* __restrict__ out_d, int* __restrict__ out_p) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = smem + kDC * kLd;
  int* sc = reinterpret_cast<int*>(smem);  // the key tile reuses the staging space
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long l = blockIdx.x;
  const long long s0 = static_cast<long long>(blockIdx.y) * kT;
  const int nst = static_cast<int>(min(static_cast<long long>(kT), n_slots - s0));
  int* lists = scratch ? scratch + (l * n_slots + s0) * blk_k
                       : reinterpret_cast<int*>(smem + kWorkFloats);
  for (int e = tid; e < nst * blk_k; e += kThreads) lists[e] = kMaskedKey;
  __syncthreads();
  const T* qa = qv + (l * n_slots + s0) * d;
  for (long long r0 = 0; r0 < maxlen; r0 += kT) {
    const int nr = static_cast<int>(min(static_cast<long long>(kT), maxlen - r0));
    float acc[8][8];
    tile_products(qa, nst, rows + (l * maxlen + r0) * d, nr, d, as, bs, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int rj = slot(tx, j);
      const float r2v = rj < nr ? r2[l * maxlen + r0 + rj] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // r2 − 2·(row·qv): the within-list residual score.
        const float s = r2v - 2.f * acc[i][j];
        sc[slot(ty, i) * kSLd + rj] = rj < nr ? pack_key(s, static_cast<int>(r0 + rj), low)
                                              : kMaskedKey;
      }
    }
    __syncthreads();
    for (int sl = warp; sl < nst; sl += kWarps) {
      int* lst = lists + sl * blk_k;
      int th = lst[blk_k - 1];
      for (int t = 0; t < kT; t += 32) offer(lst, blk_k, sc[sl * kSLd + t + lane], th);
    }
    __syncthreads();
  }
  // (nlist, bk_pad, C) out: row j of slot s at ((l·bk_pad + j)·C + s).
  for (int e = tid; e < nst * bk_pad; e += kThreads) {
    const int j = e / nst;
    const int sl = e - j * nst;
    const long long o = (l * bk_pad + j) * n_slots + s0 + sl;
    if (j < blk_k) {
      const int key = lists[sl * blk_k + j];
      out_d[o] = key_value(key, low);
      out_p[o] = key & low;
    } else {
      out_d[o] = kMaskedD2;
      out_p[o] = 0;
    }
  }
}

// Whether 128 slots' lists of blk_k keys fit beside the work tile.
bool scan_lists_in_smem(int blk_k) { return static_cast<long long>(kT) * blk_k * 4 <= kListSmem; }

template <typename T>
int launch_scan(const T* qv, const T* rows, const float* r2, long long nlist, long long n_slots,
                long long maxlen, long long d, int blk_k, int bk_pad, int pos_bits, int* scratch,
                float* out_d, int* out_p, cudaStream_t s) {
  if (pos_bits < 1 || pos_bits > 16 || blk_k < 1 || blk_k > maxlen || bk_pad < blk_k ||
      (n_slots + kT - 1) / kT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool in_smem = scan_lists_in_smem(blk_k);
  if (!in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (kWorkFloats + (in_smem ? static_cast<size_t>(kT) * blk_k : 0)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nlist), static_cast<unsigned>((n_slots + kT - 1) / kT));
  ivf_scan_kernel<T><<<grid, kThreads, smem, s>>>(qv, rows, r2, n_slots, maxlen, d, blk_k, bk_pad,
                                                  (1 << pos_bits) - 1,
                                                  in_smem ? nullptr : scratch, out_d, out_p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// ivf_scan_select on the tensor cores (bf16, d % 8 == 0)
// ---------------------------------------------------------------------------

constexpr int kScanN = 256;          // list rows per chunk: the widest wgmma
constexpr int kScanTile = 128;       // query slots per task: two 64-slot halves
constexpr int kScanThreads = 384;    // warpgroup 0: producer; 1-2: consumers
constexpr int kScanEntryRegs = 168;  // 65536 / 384, what setmaxnreg 40 / 232 balances
constexpr int kScanMaxStages = 4;
constexpr int kScanLists = 256;      // one sorted key list per consumer thread
constexpr int kScanStride = 4 * kScanLists;  // bytes between entries of a list
constexpr int kScanBatch = 2;        // 8-column groups a lane keys before it inserts
constexpr int kScanRound = 4 * kScanBatch;   // candidates a round may set aside

// Shared-memory layout (byte offsets from the 1 KB-aligned base) of a
// launch. kernels.scan_smem_bytes copies .total;
// srml_ivf_scan_tc_smem exports it so that chip_smoke.py's phase 2 holds the
// two equal.
struct ScanLayout {
  uint32_t stage_bytes;  // one ring stage: two 64-slot query slabs, one 256-row list slab
  uint32_t r2_off;       // r2 of a chunk: two 256-float buffers for each consumer warpgroup
  uint32_t cand_off;     // kScanRound x kScanLists int32 candidates, entry i at i · 256 + t
  uint32_t list_off;     // blk_k x kScanLists int32 keys: entry j of list t at j · 256 + t
  uint32_t bar_off;      // full, empty (stages each)
  long long total;       // bytes to request, alignment slack included
};

inline ScanLayout scan_layout(int blk_k, int stages) {
  ScanLayout l{};
  l.stage_bytes = static_cast<uint32_t>(sc::stage_bytes(kScanN));
  long long off = static_cast<long long>(stages) * l.stage_bytes;
  l.r2_off = static_cast<uint32_t>(off);
  off += 4LL * 4 * kScanN;
  l.cand_off = static_cast<uint32_t>(off);
  off += 4LL * kScanRound * kScanLists;
  l.list_off = static_cast<uint32_t>(off);
  off += 4LL * kScanLists * blk_k;
  off = (off + 7) / 8 * 8;
  l.bar_off = static_cast<uint32_t>(off);
  off += 8LL * 2 * stages;
  l.total = off + 1024;
  return l;
}

struct ScanGeom {
  long long n_slots, maxlen;
  int kboxes;      // 64-column boxes of a row
  int chunks;      // 256-row chunks of a list
  int slot_tiles;  // 128-slot tiles of a list; task = list · slot_tiles + tile
  int tasks;
  int stages, blk_k, bk_pad, low;
  ScanLayout l;
};

__device__ __forceinline__ int ld_s32(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_s32(uint32_t addr, int v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// Inserts key (< the list's last entry, th) into a thread's ascending list
// of len keys (entry j at shared address lst + j · kScanStride), dropping
// the last; th becomes the new last entry. Keys are unique, so no entry
// equals key.
__device__ __forceinline__ void list_insert(uint32_t lst, int len, int key, int& th) {
  int j = len - 1;
  while (j > 0) {
    const int prev = ld_s32(lst + (j - 1) * kScanStride);
    if (prev < key) break;
    st_s32(lst + j * kScanStride, prev);
    --j;
  }
  st_s32(lst + j * kScanStride, key);
  th = ld_s32(lst + (len - 1) * kScanStride);
}

// Per task (list l, 128-slot tile): the packed keys of r2[l] − 2·(qv · row)
// for the tile's slots against every row of list l, the blk_k smallest of
// each slot decoded into out_d/out_p (nlist, bk_pad, C), the pad rows
// (3e38, 0). qmap: (nlist, C, d) in 64-slot boxes; rmap: (nlist, maxlen,
// d) in 256-row boxes (TMA zero-fills the slot tail and the maxlen tail).
__global__ void __launch_bounds__(kScanThreads, 1)
ivf_scan_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap rmap, const float* __restrict__ r2,
                   ScanGeom g, float* __restrict__ out_d, int* __restrict__ out_p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1 KB alignment
  unsigned char* sm = smem_raw + (base - raw);
  float* r2_s = reinterpret_cast<float*>(sm + g.l.r2_off);
  const uint32_t bars = base + g.l.bar_off;
  const sc::Ring ring{base, g.l.stage_bytes, bars, bars + 8u * g.stages, g.stages};
  // The tiles of a list are adjacent tasks, so neighbouring blocks score
  // them side by side and read the list from L2 once.
  const int my_tasks =
      static_cast<int>(blockIdx.x) < g.tasks ? (g.tasks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      long long stage = 0;
      for (int i = 0; i < my_tasks; ++i) {
        const int task = blockIdx.x + i * gridDim.x;
        const int l = task / g.slot_tiles;
        const int s0 = task % g.slot_tiles * kScanTile;
        const bool two = s0 + sc::kRows < g.n_slots;  // the second 64 slots hold valid slots
        for (int c = 0; c < g.chunks; ++c) {
          for (int b = 0; b < g.kboxes; ++b, ++stage) {
            sc::produce_stage<kScanN>(
                ring, stage, two,
                [&](uint32_t dst, uint32_t bar, int half) {
                  tma_load_3d(dst, &qmap, bar, 64 * b, s0 + sc::kRows * half, l);
                },
                [&](uint32_t dst, uint32_t bar) {
                  tma_load_3d(dst, &rmap, bar, 64 * b, c * kScanN, l);
                });
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = tid - 128;  // consumer thread, 0..255: owns list ct
  const int cw = ct / 128;   // consumer warpgroup: slots 64·cw .. of the tile
  const int t = ct % 128;
  const int lane = t % 32;
  const int q4 = lane & 3;
  // The accumulator gives a quad two slots (rows lane/4 and lane/4 + 8 of
  // the warp's 16) and two columns of each 8-column group to each lane. The
  // lanes of a pair (q4, q4 ^ 1) swap halves: lane q4 keeps slot row hb =
  // q4 & 1 and the four columns 4p .. 4p + 3 (p = q4 >> 1) of every group,
  // so each slot has two lists (p = 0, 1), merged at the end of a task.
  const int hb = q4 & 1;
  const int p = q4 >> 1;
  const uint32_t lst = base + g.l.list_off + 4u * ct;   // shared addresses
  const uint32_t cand = base + g.l.cand_off + 4u * ct;
  float acc[kScanN / 2];
#pragma unroll
  for (int v = 0; v < kScanN / 2; ++v) acc[v] = 0.f;
  long long stage = 0, seq = 0;
  for (int i = 0; i < my_tasks; ++i) {
    const int task = blockIdx.x + i * gridDim.x;
    for (int j = 0; j < g.blk_k; ++j) st_s32(lst + j * kScanStride, kMaskedKey);
    int th = kMaskedKey;
    for (int c = 0; c < g.chunks; ++c, ++seq) {
      float pre[sc::per_thread(kScanN)];  // the chunk's r2, loaded while its wgmmas run
      sc::fetch_constants<kScanN>(pre, r2 + static_cast<long long>(task / g.slot_tiles) * g.maxlen,
                                  static_cast<long long>(c) * kScanN, g.maxlen, t, 0.f);
      sc::consume_chunk<kScanN, false>(ring, stage, g.kboxes, cw, acc);
      const float* rc = sc::publish_constants<kScanN>(pre, r2_s, seq, t, cw);
      // acc[4q + 2h + e]: slot row lane/4 + 8h, column 8q + 2·q4 + e. In
      // rounds of kScanBatch groups: key the lane's columns straight-line and
      // set aside those below the threshold (predicated stores to its
      // candidate column), then insert them in a loop; the warp reconverges
      // before the next round's shuffles.
#pragma unroll
      for (int r = 0; r < kScanN / 8; r += kScanBatch) {
        int n = 0;
#pragma unroll
        for (int q = r; q < r + kScanBatch; ++q) {
          const float k0 = hb ? acc[4 * q + 2] : acc[4 * q];
          const float k1 = hb ? acc[4 * q + 3] : acc[4 * q + 1];
          const float o0 = __shfl_xor_sync(kFull, hb ? acc[4 * q] : acc[4 * q + 2], 1);
          const float o1 = __shfl_xor_sync(kFull, hb ? acc[4 * q + 1] : acc[4 * q + 3], 1);
          const int col = 8 * q + 4 * p;
          const float4 rv = *reinterpret_cast<const float4*>(rc + col);
          const float v[4] = {hb ? o0 : k0, hb ? o1 : k1, hb ? k0 : o0, hb ? k1 : o1};
          const float r2v[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pos = c * kScanN + col + e;
            // r2 − 2·(row·qv): the within-list residual score.
            const int key = pos < g.maxlen ? pack_key(r2v[e] - 2.f * v[e], pos, g.low) : kMaskedKey;
            if (key < th) {
              st_s32(cand + n * kScanStride, key);
              ++n;
            }
          }
        }
        for (int u = 0; u < n; ++u) {
          const int key = ld_s32(cand + u * kScanStride);
          if (key < th) list_insert(lst, g.blk_k, key, th);
        }
        __syncwarp();
      }
    }
    // The slot's two lists (lanes q4 and q4 ^ 2) merge: the blk_k smallest.
    const long long slot = task % g.slot_tiles * kScanTile + sc::kRows * cw + 16 * (t / 32) +
                           lane / 4 + 8 * hb;
    if (slot < g.n_slots) {
      const long long o = task / g.slot_tiles * g.bk_pad * g.n_slots + slot;  // row j at + j · C
      if (p == 0) {
        const uint32_t other = base + g.l.list_off + 4u * (ct ^ 2);
        int a = 0, b = 0;
        for (int j = 0; j < g.blk_k; ++j) {
          const int ka = ld_s32(lst + a * kScanStride);
          const int kb = ld_s32(other + b * kScanStride);
          const int key = ka < kb ? ka : kb;
          a += ka < kb;
          b += ka < kb ? 0 : 1;
          out_d[o + j * g.n_slots] = key_value(key, g.low);
          out_p[o + j * g.n_slots] = key & g.low;
        }
      } else {
        for (int j = g.blk_k; j < g.bk_pad; ++j) {
          out_d[o + j * g.n_slots] = kMaskedD2;
          out_p[o + j * g.n_slots] = 0;
        }
      }
    }
    __syncwarp();  // the partner has read this list before the next task resets it
  }
}

int launch_scan_tc(const void* qv, const void* rows, const float* r2, long long nlist,
                   long long n_slots, long long maxlen, long long d, int blk_k, int bk_pad,
                   int pos_bits, int stages, float* out_d, int* out_p, cudaStream_t s) {
  const ScanLayout l = scan_layout(blk_k, stages);
  const long long slot_tiles = (n_slots + kScanTile - 1) / kScanTile;
  // Two stages at least, so that a stage loads while the last multiplies.
  if (d < 8 || d % 8 != 0 || d > (1LL << 20) || nlist < 1 || n_slots < 1 ||
      nlist * slot_tiles > INT_MAX / 2 || maxlen < 1 || maxlen > 65536 || pos_bits < 1 ||
      pos_bits > 16 || blk_k < 1 || blk_k > maxlen || bk_pad < blk_k || stages < 2 ||
      stages > kScanMaxStages || l.total > kSmemLimit ||
      reinterpret_cast<uintptr_t>(qv) % 16 != 0 || reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
      r2 == nullptr || out_d == nullptr || out_p == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = reinterpret_cast<const void*>(&ivf_scan_tc_kernel);
  static const int regs = kernel_registers(fn);
  if (regs != kScanEntryRegs) return kErrRegisters;  // setmaxnreg would starve or not apply
  CUtensorMap qmap, rmap;
  int rc = bf16_tensor_map_3d(&qmap, qv, nlist, n_slots, d, sc::kRows);
  if (rc != 0) return rc;
  rc = bf16_tensor_map_3d(&rmap, rows, nlist, maxlen, d, kScanN);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(l.total));
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  ScanGeom g{};
  g.n_slots = n_slots;
  g.maxlen = maxlen;
  g.kboxes = static_cast<int>((d + 63) / 64);
  g.chunks = static_cast<int>((maxlen + kScanN - 1) / kScanN);
  g.slot_tiles = static_cast<int>(slot_tiles);
  g.tasks = static_cast<int>(nlist * slot_tiles);
  g.stages = stages;
  g.blk_k = blk_k;
  g.bk_pad = bk_pad;
  g.low = (1 << pos_bits) - 1;
  g.l = l;
  const int blocks = g.tasks < sms ? g.tasks : sms;
  ivf_scan_tc_kernel<<<static_cast<unsigned>(blocks), kScanThreads, l.total, s>>>(
      qmap, rmap, r2, g, out_d, out_p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// dist_topk on the tensor cores (bf16, d % 8 == 0)
// ---------------------------------------------------------------------------

constexpr int kTopkN = 256;           // db rows per chunk: the widest wgmma
constexpr int kTopkTile = 128;        // queries per task: two 64-query halves
constexpr int kTopkMaxStages = 4;
constexpr int kTopkKeyStride = 8 * kScanLists;   // bytes between entries of a key list
constexpr int kTopkPosStride = 4 * kScanLists;   // bytes between entries of a row list
constexpr int kTopkRound = 4 * kScanBatch;       // candidates a round may set aside
constexpr uint32_t kInfHi = 0xff800000u;         // ordered_bits(+inf)
constexpr unsigned long long kEmptyKey = ~0ull;  // above every candidate's key

// The f32 bits as an unsigned word in the order of the values: flip the sign
// bit of non-negatives, every bit of negatives.
__device__ __forceinline__ uint32_t ordered_bits(float v) {
  const uint32_t b = __float_as_uint(v);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ unsigned long long ld_s64(uint32_t addr) {
  unsigned long long v;
  asm volatile("ld.shared.b64 %0, [%1];" : "=l"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_s64(uint32_t addr, unsigned long long v) {
  asm volatile("st.shared.b64 [%0], %1;" ::"r"(addr), "l"(v) : "memory");
}

// Shared-memory layout (byte offsets from the 1 KB-aligned base) of a
// launch whose lists hold k keys. kernels.topk_smem_bytes copies .total;
// srml_dist_topk_tc_smem exports it so that chip_smoke.py's phase 2 holds
// the two equal.
struct TopkLayout {
  uint32_t stage_bytes;  // one ring stage: two 64-query slabs, one 256-row db slab
  uint32_t r2_off;       // r2 of a chunk: two 256-float buffers for each consumer warpgroup
  uint32_t id_off;       // the chunk's row ids, laid out the same
  uint32_t cand_off;     // kTopkRound x 256 u64 candidates (ordered bits, column)
  uint32_t key_off;      // k x 256 u64 keys: entry j of list t at (j · 256 + t) · 8
  uint32_t pos_off;      // k x 256 int32 db rows of those keys, laid out the same
  uint32_t bar_off;      // full, empty (stages each)
  long long total;       // bytes to request, alignment slack included
};

inline TopkLayout topk_layout(int k, int stages) {
  TopkLayout l{};
  l.stage_bytes = static_cast<uint32_t>(sc::stage_bytes(kTopkN));
  long long off = static_cast<long long>(stages) * l.stage_bytes;
  l.r2_off = static_cast<uint32_t>(off);
  off += 4LL * 4 * kTopkN;
  l.id_off = static_cast<uint32_t>(off);
  off += 4LL * 4 * kTopkN;
  l.cand_off = static_cast<uint32_t>(off);
  off += 8LL * kTopkRound * kScanLists;
  l.key_off = static_cast<uint32_t>(off);
  off += 8LL * kScanLists * k;
  l.pos_off = static_cast<uint32_t>(off);
  off += 4LL * kScanLists * k;
  off = (off + 7) / 8 * 8;
  l.bar_off = static_cast<uint32_t>(off);
  off += 8LL * 2 * stages;
  l.total = off + 1024;
  return l;
}

struct TopkGeom {
  long long nq, m;
  int kboxes;        // 64-column boxes of a row
  int chunks;        // 256-row chunks of the db
  int split_chunks;  // chunks of a split (the last may hold fewer)
  int q_tiles;       // 128-query tiles; task = split · q_tiles + tile
  int tasks;
  int stages, k;
  TopkLayout l;
};

// Inserts (key, row), key < th, into a thread's ascending list of len keys
// (entry j at keys + j · kTopkKeyStride, its row at rows + j ·
// kTopkPosStride), after any equal key, dropping the last; th becomes the
// new last key.
__device__ __forceinline__ void list_insert64(uint32_t keys, uint32_t rows, int len,
                                              unsigned long long key, int row,
                                              unsigned long long& th) {
  int j = len - 1;
  while (j > 0) {
    const unsigned long long prev = ld_s64(keys + (j - 1) * kTopkKeyStride);
    if (prev <= key) break;
    st_s64(keys + j * kTopkKeyStride, prev);
    st_s32(rows + j * kTopkPosStride, ld_s32(rows + (j - 1) * kTopkPosStride));
    --j;
  }
  st_s64(keys + j * kTopkKeyStride, key);
  st_s32(rows + j * kTopkPosStride, row);
  th = ld_s64(keys + (len - 1) * kTopkKeyStride);
}

// Per task (db split, 128-query tile): every query's k smallest 64-bit keys
// (ordered bits of max((q2 + r2) − 2·q·r, 0), then id ^ 0x80000000) over the
// split's rows, with their rows, into part_key / part_pos (splits, nq, k).
// qmap: (nq, d) in 64-row boxes; dmap: (m, d) in 256-row boxes (TMA
// zero-fills the query tail and the db tail).
__global__ void __launch_bounds__(kScanThreads, 1)
dist_topk_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap dmap, const float* __restrict__ q2,
                    const float* __restrict__ r2, const int* __restrict__ ids, TopkGeom g,
                    unsigned long long* __restrict__ part_key, int* __restrict__ part_pos) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1 KB alignment
  unsigned char* sm = smem_raw + (base - raw);
  float* r2_s = reinterpret_cast<float*>(sm + g.l.r2_off);
  int* id_s = reinterpret_cast<int*>(sm + g.l.id_off);
  const uint32_t bars = base + g.l.bar_off;
  const sc::Ring ring{base, g.l.stage_bytes, bars, bars + 8u * g.stages, g.stages};
  // The query tiles of a split are adjacent tasks, so the blocks that run
  // side by side stream the same db chunks, which HBM serves about once.
  const int my_tasks =
      static_cast<int>(blockIdx.x) < g.tasks ? (g.tasks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      long long stage = 0;
      for (int i = 0; i < my_tasks; ++i) {
        const int task = blockIdx.x + i * gridDim.x;
        const int c0 = task / g.q_tiles * g.split_chunks;
        const int c1 = min(c0 + g.split_chunks, g.chunks);
        const int q0 = task % g.q_tiles * kTopkTile;
        const bool two = q0 + sc::kRows < g.nq;  // the second 64 queries hold valid rows
        for (int c = c0; c < c1; ++c) {
          for (int b = 0; b < g.kboxes; ++b, ++stage) {
            sc::produce_stage<kTopkN>(
                ring, stage, two,
                [&](uint32_t dst, uint32_t bar, int half) {
                  tma_load_2d(dst, &qmap, bar, 64 * b, q0 + sc::kRows * half);
                },
                [&](uint32_t dst, uint32_t bar) {
                  tma_load_2d(dst, &dmap, bar, 64 * b, c * kTopkN);
                });
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = tid - 128;  // consumer thread, 0..255: owns list ct
  const int cw = ct / 128;   // consumer warpgroup: queries 64·cw .. of the tile
  const int t = ct % 128;
  const int lane = t % 32;
  const int q4 = lane & 3;
  // The pair swap of the scan: lane q4 keeps query row hb = q4 & 1 and the
  // four columns 4p .. 4p + 3 (p = q4 >> 1) of every 8-column group, so
  // each query has two lists (p = 0, 1), merged at the end of a task.
  const int hb = q4 & 1;
  const int p = q4 >> 1;
  const uint32_t keys = base + g.l.key_off + 8u * ct;  // shared addresses
  const uint32_t rows = base + g.l.pos_off + 4u * ct;
  const uint32_t cand = base + g.l.cand_off + 8u * ct;
  float acc[kTopkN / 2];
#pragma unroll
  for (int v = 0; v < kTopkN / 2; ++v) acc[v] = 0.f;
  long long stage = 0, seq = 0;
  for (int i = 0; i < my_tasks; ++i) {
    const int task = blockIdx.x + i * gridDim.x;
    const int split = task / g.q_tiles;
    const int c0 = split * g.split_chunks;
    const int c1 = min(c0 + g.split_chunks, g.chunks);
    const long long qrow =
        static_cast<long long>(task % g.q_tiles) * kTopkTile + sc::kRows * cw + 16 * (t / 32) +
        lane / 4 + 8 * hb;
    const float q2v = qrow < g.nq ? q2[qrow] : 0.f;
    for (int j = 0; j < g.k; ++j) st_s64(keys + j * kTopkKeyStride, kEmptyKey);
    unsigned long long th = kEmptyKey;
    for (int c = c0; c < c1; ++c, ++seq) {
      const long long cbase = static_cast<long long>(c) * kTopkN;
      // The chunk's r2 and ids, loaded while its wgmmas run.
      float pre[sc::per_thread(kTopkN)];
      int pre_id[sc::per_thread(kTopkN)];
      sc::fetch_constants<kTopkN>(pre, r2, cbase, g.m, t, __int_as_float(0x7f800000));
      sc::fetch_constants<kTopkN>(pre_id, ids, cbase, g.m, t, 0);
      sc::consume_chunk<kTopkN, false>(ring, stage, g.kboxes, cw, acc);
      const int* ic = sc::stage_constants<kTopkN>(pre_id, id_s, seq, t, cw);
      const float* rc = sc::publish_constants<kTopkN>(pre, r2_s, seq, t, cw);
      const int valid = static_cast<int>(min(static_cast<long long>(kTopkN), g.m - cbase));
      // acc[4q + 2h + e]: query row lane/4 + 8h, column 8q + 2·q4 + e. In
      // rounds of kScanBatch groups: score the lane's columns straight-line
      // and set aside (ordered bits, column) of those that may beat the
      // threshold, then key and insert them in a loop; the warp reconverges
      // before the next round's shuffles. +inf scores (masked rows) are never
      // candidates: an unfilled slot already emits (+inf, −1).
#pragma unroll
      for (int r = 0; r < kTopkN / 8; r += kScanBatch) {
        int n = 0;
        const uint32_t th_hi = static_cast<uint32_t>(th >> 32);
#pragma unroll
        for (int q = r; q < r + kScanBatch; ++q) {
          const float k0 = hb ? acc[4 * q + 2] : acc[4 * q];
          const float k1 = hb ? acc[4 * q + 3] : acc[4 * q + 1];
          const float o0 = __shfl_xor_sync(kFull, hb ? acc[4 * q] : acc[4 * q + 2], 1);
          const float o1 = __shfl_xor_sync(kFull, hb ? acc[4 * q + 1] : acc[4 * q + 3], 1);
          const int col = 8 * q + 4 * p;
          const float4 rv = *reinterpret_cast<const float4*>(rc + col);
          const float v[4] = {hb ? o0 : k0, hb ? o1 : k1, hb ? k0 : o0, hb ? k1 : o1};
          const float r2v[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // (q2 + r2) − 2·q·r, clipped at 0: the FFMA tiles' arithmetic.
            const uint32_t hi = ordered_bits(fmaxf((q2v + r2v[e]) - 2.f * v[e], 0.f));
            if (col + e < valid && hi < kInfHi && hi <= th_hi) {
              st_s64(cand + n * kTopkKeyStride,
                     (static_cast<unsigned long long>(hi) << 32) | static_cast<uint32_t>(col + e));
              ++n;
            }
          }
        }
        for (int u = 0; u < n; ++u) {
          const unsigned long long cv = ld_s64(cand + u * kTopkKeyStride);
          const int colx = static_cast<int>(cv & 0xffffu);
          const unsigned long long key =
              (cv & 0xffffffff00000000ull) | (static_cast<uint32_t>(ic[colx]) ^ 0x80000000u);
          if (key < th) list_insert64(keys, rows, g.k, key, static_cast<int>(cbase) + colx, th);
        }
        __syncwarp();
      }
    }
    // The query's two lists (lanes q4 and q4 ^ 2) merge: its k smallest.
    if (qrow < g.nq && p == 0) {
      const uint32_t okeys = base + g.l.key_off + 8u * (ct ^ 2);
      const uint32_t orows = base + g.l.pos_off + 4u * (ct ^ 2);
      const long long o = (static_cast<long long>(split) * g.nq + qrow) * g.k;
      int a = 0, b = 0;
      for (int j = 0; j < g.k; ++j) {
        const unsigned long long ka = ld_s64(keys + a * kTopkKeyStride);
        const unsigned long long kb = ld_s64(okeys + b * kTopkKeyStride);
        const bool mine = ka <= kb;
        part_key[o + j] = mine ? ka : kb;
        part_pos[o + j] =
            mine ? ld_s32(rows + a * kTopkPosStride) : ld_s32(orows + b * kTopkPosStride);
        a += mine ? 1 : 0;
        b += mine ? 0 : 1;
      }
    }
    __syncwarp();  // the partner has read this list before the next task resets it
  }
}

// A key with its db row, as the finishing merge holds them.
struct KeyRow {
  unsigned long long key;
  int row;
  int pad;
};

__device__ __forceinline__ bool key_less(const KeyRow& a, const KeyRow& b) { return a.key < b.key; }

__device__ __forceinline__ KeyRow shfl(const KeyRow& v, int src) {
  return KeyRow{__shfl_sync(kFull, v.key, src), __shfl_sync(kFull, v.row, src), 0};
}

// One warp per query: the k smallest keys of the splits' lists; each
// finite one's distance recomputed in f32 FFMA from the query and its row
// (max((q2 + r2) − 2·q·r, 0), the tensor cores' truncated sum replaced),
// then the k pairs re-sorted by (distance, id) into out.
__global__ void __launch_bounds__(kThreads)
dist_topk_tc_finish(const unsigned long long* __restrict__ part_key,
                    const int* __restrict__ part_pos, const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ db, const float* __restrict__ q2,
                    const float* __restrict__ r2, long long nq, long long d, int k,
                    int splits, DI* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long qi = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (qi >= nq) return;  // warp-uniform; no block barrier follows
  KeyRow* lst = reinterpret_cast<KeyRow*>(smem) + warp * k;
  DI* res = reinterpret_cast<DI*>(reinterpret_cast<KeyRow*>(smem) + kWarps * k) + warp * k;
  for (int j = lane; j < k; j += 32) lst[j] = KeyRow{kEmptyKey, 0, 0};
  __syncwarp();
  KeyRow th = lst[k - 1];
  for (int s = 0; s < splits; ++s) {
    const long long src = (static_cast<long long>(s) * nq + qi) * k;
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      offer(lst, k, j < k ? KeyRow{part_key[src + j], part_pos[src + j], 0}
                            : KeyRow{kEmptyKey, 0, 0},
            th);
    }
  }
  const __nv_bfloat16* qr = q + qi * d;
  for (int j = 0; j < k; ++j) {
    const KeyRow e = lst[j];
    DI out_j{inf_f(), -1};
    if (static_cast<uint32_t>(e.key >> 32) < kInfHi) {
      const __nv_bfloat16* rr = db + static_cast<long long>(e.row) * d;
      float dot = 0.f;
      for (long long c = lane; c < d; c += 32) {
        dot = fmaf(__bfloat162float(qr[c]), __bfloat162float(rr[c]), dot);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
      out_j.d = fmaxf((q2[qi] + r2[e.row]) - 2.f * dot, 0.f);
      out_j.i = static_cast<int>(static_cast<uint32_t>(e.key) ^ 0x80000000u);
    }
    if (lane == 0) res[j] = out_j;
  }
  __syncwarp();
  // The recomputed pairs re-sorted by (distance, id), ties by list order.
  for (int j = lane; j < k; j += 32) {
    const DI mine = res[j];
    int rank = 0;
    for (int u = 0; u < k; ++u) {
      const DI o = res[u];
      rank += (key_less(o, mine) || (o.d == mine.d && o.i == mine.i && u < j)) ? 1 : 0;
    }
    out[qi * k + rank] = mine;
  }
}

long long topk_tc_smem(int k, int stages) { return topk_layout(k, stages).total; }

int launch_topk_tc(const void* q, const void* db, const float* q2, const float* r2,
                   const int* ids, long long nq, long long m, long long d, int k, int splits,
                   int stages, unsigned long long* part_key, int* part_pos, DI* out,
                   cudaStream_t s) {
  const TopkLayout l = topk_layout(k, stages);
  const long long chunks = (m + kTopkN - 1) / kTopkN;
  const long long q_tiles = (nq + kTopkTile - 1) / kTopkTile;
  // Two stages at least, so that a stage loads while the last multiplies.
  if (d < 8 || d % 8 != 0 || d > (1LL << 20) || nq < 1 || m < 1 || m > INT_MAX - kTopkN ||
      k < 1 || k > 64 || splits < 1 || splits > chunks ||
      q_tiles * splits > INT_MAX / 2 || stages < 2 || stages > kTopkMaxStages ||
      l.total > kSmemLimit || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(db) % 16 != 0 || q2 == nullptr || r2 == nullptr ||
      ids == nullptr || part_key == nullptr || part_pos == nullptr || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = reinterpret_cast<const void*>(&dist_topk_tc_kernel);
  static const int regs = kernel_registers(fn);
  if (regs != kScanEntryRegs) return kErrRegisters;  // setmaxnreg would starve or not apply
  CUtensorMap qmap, dmap;
  int rc = bf16_tensor_map(&qmap, q, nq, d, sc::kRows);
  if (rc != 0) return rc;
  rc = bf16_tensor_map(&dmap, db, m, d, kTopkN);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(l.total));
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  TopkGeom g{};
  g.nq = nq;
  g.m = m;
  g.kboxes = static_cast<int>((d + 63) / 64);
  g.chunks = static_cast<int>(chunks);
  g.split_chunks = static_cast<int>((chunks + splits - 1) / splits);
  const int used = (g.chunks + g.split_chunks - 1) / g.split_chunks;  // splits that hold rows
  g.q_tiles = static_cast<int>(q_tiles);
  g.tasks = used * g.q_tiles;
  g.stages = stages;
  g.k = k;
  g.l = l;
  const int blocks = g.tasks < sms ? g.tasks : sms;
  dist_topk_tc_kernel<<<static_cast<unsigned>(blocks), kScanThreads, l.total, s>>>(
      qmap, dmap, q2, r2, ids, g, part_key, part_pos);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const size_t fsmem = static_cast<size_t>(kWarps) * k * (sizeof(KeyRow) + sizeof(DI));
  dist_topk_tc_finish<<<static_cast<unsigned>((nq + kWarps - 1) / kWarps), kThreads, fsmem, s>>>(
      part_key, part_pos, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(db), q2, r2, nq, d, k, used, out);
  return static_cast<int>(cudaGetLastError());
}

static_assert(kWorkFloats * 4 + 2 * kT * 64 * 4 <= kSmemLimit, "dist_topk at k = 64 fits");
static_assert(sizeof(KeyRow) == 16, "a key and its row in two 64-bit words");
static_assert(kWorkFloats * 4 + kListSmem <= kSmemLimit, "scan lists fit beside the tile");
static_assert(sizeof(DI) == 8, "pairs are two 32-bit words");

}  // namespace

extern "C" {

// Per query of q (nq, d): the k <= 64 smallest max((q2 + r2) − 2q·r, 0) over
// the rows r of db (m, d) in ascending (distance, id) order, id = ids[row];
// (+inf, −1) where no finite candidate is left. q, db: row-major f32 or bf16
// (both the same); q2: (nq,) f32 = ‖q‖²; r2: (m,) f32 = ‖r‖², +inf on masked
// rows; out_d/out_i: (nq, k), written as pairs into out (nq·k·8 bytes, the
// caller splits them); part: (splits, nq, k) pairs of scratch when splits > 1.
int srml_dist_topk(const void* q, const void* db, int is_bf16, const float* q2, const float* r2,
                   const int* ids, long long nq, long long m, long long d, int k, int splits,
                   void* part, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_dist_topk(static_cast<const __nv_bfloat16*>(q),
                            static_cast<const __nv_bfloat16*>(db), q2, r2, ids, nq, m, d, k,
                            splits, static_cast<DI*>(part), static_cast<DI*>(out), s);
  }
  return launch_dist_topk(static_cast<const float*>(q), static_cast<const float*>(db), q2, r2, ids,
                          nq, m, d, k, splits, static_cast<DI*>(part), static_cast<DI*>(out), s);
}

// Per query of qs (nq, d) f32: the nprobe smallest packed keys of the scores
// (c2 − 2c·q) + q2 against the centroids cent (nlist, d) f32, decoded to
// out_p (nq, nprobe) int32 centroid indices and out_d (nq, nprobe) f32
// floored values. c2: (nlist,), q2: (nq,) f32; keys: (nq, p) int32 scratch,
// p the power of two >= nlist; pos_bits: the packed position width.
int srml_probe_select(const float* cent, const float* c2, const float* qs, const float* q2,
                      long long nq, long long nlist, long long d, int nprobe, int pos_bits,
                      int p, int* keys, int* out_p, float* out_d, void* stream) {
  return launch_probe(cent, c2, qs, q2, nq, nlist, d, nprobe, pos_bits, p, keys, out_p, out_d,
                      static_cast<cudaStream_t>(stream));
}

// srml_probe_select in one launch (probe_fused_kernel), for nprobe <= 96,
// the norms c2 and q2 computed in the kernel: the same outputs. part:
// (ceil(nq / 128), 8, 128, nprobe) int32 scratch for the blocks' lists;
// done: ceil(nq / 128) uint32 scratch (zeroed here). Returns a cudaError_t.
int srml_probe_select_fused(const float* cent, const float* qs, long long nq, long long nlist,
                            long long d, int nprobe, int pos_bits, int* part, void* done,
                            int* out_p, float* out_d, void* stream) {
  return launch_probe_fused(cent, qs, nq, nlist, d, nprobe, pos_bits, part,
                            static_cast<unsigned*>(done), out_p, out_d,
                            static_cast<cudaStream_t>(stream));
}

// The shared memory (bytes) of a fused probe launch, as kernels.probe_smem_bytes plans it.
int srml_probe_fused_smem(int nprobe) { return static_cast<int>(probe_fused_smem(nprobe)); }

// srml_dist_topk on the tensor cores, for bf16 q and db with d % 8 == 0, both
// 16-byte aligned: the k smallest keys of each split on the wgmma scores
// into part_key (splits, nq, k) u64 / part_pos (splits, nq, k)
// int32, then the finishing merge recomputes their distances in f32 FFMA
// and writes the k smallest (distance, id) pairs into out (nq · k · 8
// bytes). splits: db splits of 256-row chunks (kernels.topk_splits);
// stages: the ring (kernels.topk_stages(k)). Returns a cudaError_t, or 1000
// + a CUresult of the tensor-map encode, 1998 (kernel registers) or 1999 (no
// encoder).
int srml_dist_topk_tc(const void* q, const void* db, const float* q2, const float* r2,
                      const int* ids, long long nq, long long m, long long d, int k,
                      int splits, int stages, void* part_key, int* part_pos, void* out,
                      void* stream) {
  return launch_topk_tc(q, db, q2, r2, ids, nq, m, d, k, splits, stages,
                        static_cast<unsigned long long*>(part_key), part_pos,
                        static_cast<DI*>(out), static_cast<cudaStream_t>(stream));
}

// The shared memory (bytes, alignment slack included) of a tensor-core
// dist_topk launch: topk_layout's total, as kernels.topk_smem_bytes plans it.
int srml_dist_topk_tc_smem(int k, int stages) { return static_cast<int>(topk_tc_smem(k, stages)); }

// Per list l and slot c: the blk_k smallest packed keys of r2[l] − 2·(rows[l]
// · qv[l, c]) over the list's maxlen rows, decoded into out_d/out_p (nlist,
// bk_pad, C) f32/int32; rows blk_k .. bk_pad − 1 are (3e38, 0). qv: (nlist,
// C, d), rows: (nlist, maxlen, d), both f32 or both bf16; r2: (nlist, maxlen)
// f32. scratch: (nlist, C, blk_k) int32 when the lists outgrow shared memory
// (srml_scan_needs_scratch), else may be null.
int srml_ivf_scan_select(const void* qv, const void* rows, int is_bf16, const float* r2,
                         long long nlist, long long n_slots, long long maxlen, long long d,
                         int blk_k, int bk_pad, int pos_bits, int* scratch, float* out_d,
                         int* out_p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_scan(static_cast<const __nv_bfloat16*>(qv),
                       static_cast<const __nv_bfloat16*>(rows), r2, nlist, n_slots, maxlen, d,
                       blk_k, bk_pad, pos_bits, scratch, out_d, out_p, s);
  }
  return launch_scan(static_cast<const float*>(qv), static_cast<const float*>(rows), r2, nlist,
                     n_slots, maxlen, d, blk_k, bk_pad, pos_bits, scratch, out_d, out_p, s);
}

// Whether srml_ivf_scan_select needs its (nlist, C, blk_k) scratch.
int srml_scan_needs_scratch(int blk_k) { return scan_lists_in_smem(blk_k) ? 0 : 1; }

// srml_ivf_scan_select on the tensor cores, for bf16 qv and rows with
// d % 8 == 0, both 16-byte aligned, over the wrapper's plan: a ring of
// `stages` (kernels.scan_plan; the lists of blk_k keys take 1 KB per key
// beside it). Same outputs. Returns a cudaError_t, or 1000 + a CUresult of
// the tensor-map encode, 1998 (kernel registers) or 1999 (no encoder).
int srml_ivf_scan_select_tc(const void* qv, const void* rows, const float* r2, long long nlist,
                            long long n_slots, long long maxlen, long long d, int blk_k,
                            int bk_pad, int pos_bits, int stages, float* out_d, int* out_p,
                            void* stream) {
  return launch_scan_tc(qv, rows, r2, nlist, n_slots, maxlen, d, blk_k, bk_pad, pos_bits, stages,
                        out_d, out_p, static_cast<cudaStream_t>(stream));
}

// The shared memory (bytes, alignment slack included) of a tensor-core
// scan launch: scan_layout's total, as kernels.scan_smem_bytes plans it.
int srml_ivf_scan_tc_smem(int blk_k, int stages) {
  return static_cast<int>(scan_layout(blk_k, stages).total);
}

}  // extern "C"
