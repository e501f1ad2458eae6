// Hopper (sm_90a) kernels of KMeans: one Lloyd step (assign every row to its
// nearest centre, then per-centre sums and counts) and the per-row nearest
// centre with its partial distance.
//
// Replaces spark_rapids_ml_tpu/ops/pallas_kernels.py:
//   lloyd_step_pallas      (:314) -> srml_lloyd_step
//   assign_min_dist_pallas (:561) -> srml_assign_min_dist
//
// What the Pallas kernels compute. lloyd_step_pallas: per row the argmin
// over centres of ½‖c‖² − x·c, then a one-hot GEMM into (k_pad, d) sums and
// counts held in VMEM over a sequential row grid, x read once. It pads k to
// 128 lanes, marks padded centres with LLOYD_PAD_D2 and routes the invalid
// rows of the boundary block to a "dead lane": tiling artefacts of the TPU.
// Here the centres are exactly (k, d), the outputs exactly k lanes, and rows
// at or past n_valid count nowhere. assign_min_dist_pallas: per row the
// argmin of ‖c‖² − 2x·c and that minimum (no ‖x‖²).
//
// Design. Both kernels share one scoring body: a block takes 128 rows, and
// for each chunk of 128 centres computes the 128 x 128 products x·c in f32
// registers (8 x 8 per thread), staging 32 feature columns of the rows and
// of the centres at a time in shared memory (converted to f32). The scores
// cn[j] − scale·(x·c) are reduced per row to (min, argmin) within the thread,
// across the 16 threads that share the rows (warp shuffles), and across
// centre chunks, with ties to the LOWEST centre index (jnp.argmin's rule).
// The rows' running (min, argmin) live in shared memory. cn (½‖c‖² or
// ‖c‖²) is computed by the wrapper from the centres in the compute dtype,
// as the Pallas wrapper does.
//
// lloyd_step then adds the block's rows into a block-local f32 sum of
// (KS centres x DS columns) in shared memory (shared-memory atomics) and
// integer counts, and flushes both once at the end with one global atomic
// per element: a block walks many 128-row tiles (a grid of about one block
// per SM), so the flush is small next to x. When the k x d sums do not fit
// shared memory, blockIdx.y picks the (centre, column) chunk of the sums
// that a block owns, and each such block scores its rows again. Counts are
// 64-bit integers, exact at any n; the wrapper converts them to f32.
//
// Arithmetic: f32 FFMA (never TF32); bf16 input converts exactly to f32.
// The sums of one centre are added in no fixed order (atomics), so they may
// differ in the last bits between runs; the assignments do not.
//
// Bound on the H100: at the KMeans path's shape (16,764,871 x 256 bf16,
// k = 100) reading x once is 8.58 GB, 2.56 ms, against 2nkd = 8.6e11
// operations, 0.87 ms on the bf16 tensor cores: both kernels are bound by
// bytes (100 operations per byte of x; the card's balance is about 295).
// This kernel runs its products on CUDA cores in f32 FFMA (12.8 ms at the
// 67 TFLOP/s peak), so it is bound by its FFMA rate, not by the bytes; the
// tensor-core (wgmma) product is a later step. x is read once from device
// memory; the centres are re-staged from L2 for every tile. Index
// arithmetic is 64-bit: 2^24 x 256 bf16 is 8.6 GB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
lloyd_step_kernel(const T* __restrict__ x, const T* __restrict__ c,
                  const float* __restrict__ c2h, long long rows_valid,
                  long long k, long long d, int ks_chunk, int ds_chunk,
                  int n_dchunks, float* __restrict__ sums,
                  unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* cs = xs + kDC * kLd;
  float* best_d = cs + kDC * kLd;
  int* best_i = reinterpret_cast<int*>(best_d + kBM);
  unsigned int* cnt_s = reinterpret_cast<unsigned int*>(best_i + kBM);
  float* sums_s = reinterpret_cast<float*>(cnt_s + ks_chunk);

  const int tid = threadIdx.x;
  const int kc = blockIdx.y / n_dchunks;
  const int dc = blockIdx.y % n_dchunks;
  const long long ks0 = static_cast<long long>(kc) * ks_chunk;
  const int ks_n = static_cast<int>(min(static_cast<long long>(ks_chunk), k - ks0));
  const long long ds0 = static_cast<long long>(dc) * ds_chunk;
  const int ds_n = static_cast<int>(min(static_cast<long long>(ds_chunk), d - ds0));
  for (int e = tid; e < ks_n; e += kThreads) cnt_s[e] = 0;
  for (int e = tid; e < ks_n * ds_n; e += kThreads) sums_s[e] = 0.f;
  // The sums pass: cols threads per row, row_groups rows at a time.
  const int cols = ds_n < kThreads ? ds_n : kThreads;
  const int row_groups = kThreads / cols;
  const int sc = tid % cols;
  const int sg = tid / cols;
  __syncthreads();

  const long long n_tiles = (rows_valid + kBM - 1) / kBM;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * kBM;
    const int rows = static_cast<int>(min(static_cast<long long>(kBM), rows_valid - row0));
    score_tile(x, c, c2h, 1.f, row0, rows, k, d, xs, cs, best_d, best_i);
    if (dc == 0) {
      for (int r = tid; r < rows; r += kThreads) {
        const long long a = best_i[r] - ks0;
        if (a >= 0 && a < ks_n) atomicAdd(&cnt_s[a], 1u);
      }
    }
    if (sg < row_groups) {
      for (int r = sg; r < rows; r += row_groups) {
        const long long a = best_i[r] - ks0;
        if (a < 0 || a >= ks_n) continue;
        const T* xr = x + (row0 + r) * d + ds0;
        float* sr = sums_s + a * ds_n;
        for (int cc = sc; cc < ds_n; cc += cols) atomicAdd(&sr[cc], to_f32(xr[cc]));
      }
    }
    __syncthreads();  // the next tile resets best_*
  }

  for (int e = tid; e < ks_n * ds_n; e += kThreads) {
    const float v = sums_s[e];
    if (v != 0.f) {
      const long long a = e / ds_n;
      atomicAdd(&sums[(ks0 + a) * d + ds0 + (e - a * ds_n)], v);
    }
  }
  if (dc == 0) {
    for (int e = tid; e < ks_n; e += kThreads) {
      if (cnt_s[e] != 0) atomicAdd(&counts[ks0 + e], static_cast<unsigned long long>(cnt_s[e]));
    }
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
    best_dist[row0 + r] = best_d[r];
  }
}

// Sums chunk (KS centres x DS columns) that fits the shared memory left
// after the scoring buffers: the whole k x d when it fits.
void sums_chunk(long long k, long long d, int* ks, int* ds) {
  const long long avail = (kSmemLimit - kScoreSmem) / 4;  // floats (counts take one each)
  if (k * (d + 1) <= avail) {
    *ks = static_cast<int>(k);
    *ds = static_cast<int>(d);
  } else if (avail / k - 1 >= kDC) {
    *ks = static_cast<int>(k);
    *ds = static_cast<int>(avail / k - 1);
  } else {
    *ds = static_cast<int>(d < 256 ? d : 256);
    *ks = static_cast<int>(avail / (*ds + 1));
  }
}

template <typename T>
int launch_lloyd(const T* x, const T* c, const float* c2h, long long rows_valid,
                 long long k, long long d, float* sums,
                 unsigned long long* counts, cudaStream_t s) {
  int ks, ds;
  sums_chunk(k, d, &ks, &ds);
  const long long n_kchunks = (k + ks - 1) / ks;
  const long long n_dchunks = (d + ds - 1) / ds;
  const size_t smem = kScoreSmem + 4 * static_cast<size_t>(ks) * (ds + 1);
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
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(n_kchunks * n_dchunks));
  lloyd_step_kernel<T><<<grid, kThreads, smem, s>>>(
      x, c, c2h, rows_valid, k, d, ks, ds, static_cast<int>(n_dchunks), sums, counts);
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

}  // namespace

extern "C" {

// One Lloyd step over the first min(n, max(n_valid, 0)) rows of x: each row
// goes to the centre of least ½‖c‖² − x·c (ties to the lowest index), and
// sums[j] += Σ x_r, counts[j] += #rows over the rows of centre j.
// x: (n, d) row-major f32 or bf16; centers: (k, d) in x's type; c2h: (k,)
// f32 = ½‖c‖²; sums: (k, d) f32; counts: (k,) uint64. Returns the
// cudaError_t of the launch.
int srml_lloyd_step(const void* x, const void* centers, int is_bf16,
                    const float* c2h, long long n, long long d, long long k,
                    long long n_valid, float* sums, unsigned long long* counts,
                    void* stream) {
  const long long rows = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
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
// j) and dist = that minimum. centers: (k, d) in x's type; c2: (k,) f32 =
// ‖c‖²; idx: (m,) int32; dist: (m,) f32.
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

}  // extern "C"
