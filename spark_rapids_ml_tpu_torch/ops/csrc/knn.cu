// Hopper (sm_90a) kernels of nearest-neighbour search: the exact streaming
// distance top-k, the IVF probe (true ‖q − c‖² to every centroid and the
// nprobe nearest) and the IVF list scan (residual scores and the best
// blk_k rows per query slot).
//
// Replaces spark_rapids_ml_tpu/ops/pallas_kernels.py:
//   dist_topk_pallas       (:678) -> srml_dist_topk
//   ivf_scan_select_pallas (:860) -> srml_ivf_scan_select
//   probe_select_pallas    (:984) -> srml_probe_select
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
//   dist_topk: a grid of (query tile, db split). A grid over query tiles
//     alone leaves most SMs idle at 4,096 queries, so the db rows are split
//     across blockIdx.y; each split's lists go to a (splits, q, k) scratch
//     and a second launch merges them per query (one warp per query) in the
//     same order. Lists hold (distance, id) pairs, k <= 64.
//   probe_select: a product launch writes every query's packed keys to a
//     (q, P) int32 scratch, P the power of two >= nlist; a second launch
//     sorts each query's row (bitonic, one block per query) in shared
//     memory when P <= 16,384, in the scratch row itself beyond, and
//     decodes the first nprobe. Covers nprobe <= nlist <= 65,536.
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
// Bound on the H100 at the slice's shapes (PERF.md): dist_topk over 4,096
// queries x 1,048,576 bf16 rows x 768 is 6.6e12 operations, bound by them
// (6.7 ms on the bf16 tensor cores); these tiles run on CUDA cores in FFMA,
// so their rate, not the bytes, bounds them. The scan reads the residual
// lists once per slot tile. Index arithmetic is 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// acc[i][j] = Σ_c a[slot(ty, i)][c] · b[slot(tx, j)][c] over rows na of a and
// nb of b (1 <= na, nb <= kT; missing rows count as zeros). a, b: row-major
// with d columns, pointing at the tiles' first rows. Ends on a barrier, so
// the staging space is free when it returns.
template <typename T>
__device__ __forceinline__ void tile_products(const T* __restrict__ a, int na,
                                              const T* __restrict__ b, int nb, long long d,
                                              float* as, float* bs, float acc[8][8]) {
  const int tid = threadIdx.x;
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
    __syncthreads();
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
    __syncthreads();
  }
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

static_assert(kWorkFloats * 4 + 2 * kT * 64 * 4 <= kSmemLimit, "dist_topk at k = 64 fits");
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

}  // extern "C"
