// Hopper (sm_90a) kernels of the Gram family: the masked Gram (X·m)ᵀ(X·m),
// the fused count / column sum / XᵀX of the first n_valid rows (PCA), and
// the fused normal-equation statistics XᵀX, Xᵀy, Σx, Σy, Σy², n
// (LinearRegression).
//
// Replaces spark_rapids_ml_tpu/ops/pallas_kernels.py:
//   gram_pallas         (:78)   -> srml_gram
//   gram_colsum_pallas  (:173)  -> srml_gram_colsum
//   linreg_stats_pallas (:1210) -> srml_linreg_stats
//
// What the Pallas kernels compute: a (d, d) f32 accumulator kept in VMEM for
// the whole sequential row grid, with x read once. An H100 SM has 227 KB of
// shared memory and its blocks run in parallel in no order, so the design is
// turned around: a 3-D grid of 128 x 128 output tiles of G times row splits
// of at most kRowsPerSplit rows. Each block loops over its split's rows in
// chunks of kChunk, stages the i-panel and the j-panel (kChunk x 128 each,
// converted to f32) in shared memory and accumulates in f32 registers, 8 x 8
// per thread. The in-block row loop takes the place of the TPU's
// "arbitrary" grid axis; the split keeps each f32 register's sum short
// (kRowsPerSplit terms, not all n) and gives a small-d Gram enough blocks to
// fill the SMs. At the end the block adds its tile into G with atomicAdd, so
// the splits of one tile are summed in no fixed order (results may differ
// in the last bits between runs). The caller's G is the seed: the wrapper
// passes zeros for a fresh result or the streaming state to fold into in
// place (the seeded gram_colsum_pallas, the donated linreg state).
//
// The three kernels are one templated body. The vector statistics ride on
// blocks that already stage the columns they need: the diagonal blocks
// (i-panel == j-panel) add Σx and, for linreg, Xᵀy of their 128 columns
// from the staged i-panel and the rows' y; the blocks of tile (0, 0), one
// per split, add Σy, Σy² and the row count of their split. Rows are weighted
// by the mask as in the Pallas kernel: m² on XᵀX and Xᵀy, m on Σx and Σy.
// The linreg row count is an integer (rows with m != 0), summed in a 64-bit
// counter, so it is exact at any n.
//
// Arithmetic: f32 input multiplies in plain f32 FFMA (never TF32), as the
// JAX package's Precision.HIGHEST; bf16 input converts with
// __bfloat162float (exact) and accumulates in f32.
//
// Bound on the H100: at the PCA path's shape (262,144 x 2048) the fold does
// nd(d+1) = 1.1 TFLOP (G is symmetric, so half of 2nd²) against 1.07 GB
// (bf16) of reads, far above the card's ops-per-byte balance, so it is
// bound by operations (bf16 tensor cores: 1.1 ms; f32 FFMA for the f32
// Gram: 16 ms). linreg_stats at 262,144 x 1024 bf16 is bound the same way
// (0.28 ms on the tensor cores against 0.16 ms of bytes). This simple
// CUDA-core kernel cannot reach the tensor-core bound; wgmma, TMA and the
// SYRK symmetry (half the tiles) are the later steps. Index arithmetic is
// 64-bit: 262,144 x 2048 f32 is exactly 2^31 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;                        // G tile edge
constexpr int kChunk = 16;                        // rows staged per step
constexpr int kThreads = 256;                     // 16 x 16 threads, 8 x 8 each
constexpr int kRowsPerPass = kThreads / kTile;    // staging rows per thread pass
constexpr int kLoads = kChunk / kRowsPerPass;     // panel elements per thread
constexpr long long kRowsPerSplit = 8192;         // longest f32 sum per register
constexpr long long kMaxSplits = 65535;           // gridDim.z limit

// What a launch computes besides G.
enum Mode : int {
  kMasked = 0,  // G += (X·m)ᵀ(X·m)                           (gram_pallas)
  kColsum = 1,  // G += XᵀX, colsum += Σx, count += rows       (gram_colsum_pallas)
  kLinreg = 2,  // G, Xᵀy, Σx, Σy, Σy², rows with m != 0       (linreg_stats_pallas)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Row (or column) of the tile that accumulator slot s of thread t covers:
// slots 0-3 at 4t..4t+3, slots 4-7 at 64+4t..64+4t+3, so that the float4
// reads of a warp from shared memory are contiguous.
__device__ __forceinline__ int slot(int t, int s) {
  return (s < 4) ? t * 4 + s : 64 + t * 4 + (s - 4);
}

struct Outputs {
  float* gram;                // (d, d)
  float* colsum;              // (d,)    kColsum, kLinreg
  float* count;               // ()      kColsum
  float* xty;                 // (d,)    kLinreg
  float* sy;                  // ()      kLinreg
  float* syy;                 // ()      kLinreg
  unsigned long long* rows;   // ()      kLinreg
};

// Rows [blockIdx.z * split_rows, min(n_rows, (blockIdx.z + 1) * split_rows)).
// mask == nullptr means all ones (kMasked, kLinreg); y is read by kLinreg.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
gram_tile_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                 const float* __restrict__ y, long long n_rows,
                 long long split_rows, long long d, Outputs out) {
  constexpr bool kUseMask = kMode != kColsum;
  constexpr bool kLin = kMode == kLinreg;
  __shared__ __align__(16) float a_s[kChunk][kTile];
  __shared__ __align__(16) float b_s[kChunk][kTile];
  __shared__ float red[kRowsPerPass][kTile];
  __shared__ float red_y[kRowsPerPass][2];
  __shared__ unsigned long long red_n[kRowsPerPass];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long i0 = static_cast<long long>(blockIdx.y) * kTile;  // G rows
  const long long j0 = static_cast<long long>(blockIdx.x) * kTile;  // G cols
  const int lc = tid % kTile;  // staged column
  const int lr = tid / kTile;  // first staged row
  const bool a_ok = i0 + lc < d;
  const bool b_ok = j0 + lc < d;
  const bool diag = blockIdx.x == blockIdx.y;              // block-uniform
  const bool y_block = kLin && blockIdx.x == 0 && blockIdx.y == 0;
  const bool y_thread = y_block && lc == 0;                // one per staged row

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float csum = 0.f;   // Σ a over this thread's rows (column i0 + lc)
  float xysum = 0.f;  // Σ a·(y·m) (kLinreg)
  float ys = 0.f, yys = 0.f;
  unsigned long long nrows = 0;

  const long long r_begin = static_cast<long long>(blockIdx.z) * split_rows;
  const long long r_end = min(n_rows, r_begin + split_rows);
  for (long long r0 = r_begin; r0 < r_end; r0 += kChunk) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int rr = lr + l * kRowsPerPass;
      const long long r = r0 + rr;
      float a = 0.f, b = 0.f;
      if (r < r_end) {
        const T* row = x + r * d;
        if (a_ok) a = to_f32(row[i0 + lc]);
        if (b_ok) b = to_f32(row[j0 + lc]);
        float m = 1.f;
        if (kUseMask && mask != nullptr) {
          m = mask[r];
          a *= m;
          b *= m;
        }
        if (kLin && diag) {
          const float ym = y[r] * m;
          xysum += a * ym;
          if (y_thread) {
            ys += ym;
            yys += ym * ym;
            nrows += (m != 0.f);
          }
        }
      }
      a_s[rr][lc] = a;
      b_s[rr][lc] = b;
      csum += a;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      float av[8], bv[8];
      const float4 a_lo = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&a_s[k][64 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&b_s[k][64 + tx * 4]);
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

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gi = i0 + slot(ty, i);
    if (gi >= d) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long gj = j0 + slot(tx, j);
      if (gj < d) atomicAdd(&out.gram[gi * d + gj], acc[i][j]);
    }
  }

  if (kMode == kMasked) return;
  if (diag) {  // block-uniform: the barriers are safe
    red[lr][lc] = csum;
    __syncthreads();
    if (tid < kTile && i0 + tid < d) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kRowsPerPass; ++q) s += red[q][tid];
      atomicAdd(&out.colsum[i0 + tid], s);
    }
    if (kLin) {
      __syncthreads();
      red[lr][lc] = xysum;
      if (lc == 0) {
        red_y[lr][0] = ys;
        red_y[lr][1] = yys;
        red_n[lr] = nrows;
      }
      __syncthreads();
      if (tid < kTile && i0 + tid < d) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < kRowsPerPass; ++q) s += red[q][tid];
        atomicAdd(&out.xty[i0 + tid], s);
      }
      if (y_block && tid == 0) {
        float s = 0.f, ss = 0.f;
        unsigned long long nn = 0;
#pragma unroll
        for (int q = 0; q < kRowsPerPass; ++q) {
          s += red_y[q][0];
          ss += red_y[q][1];
          nn += red_n[q];
        }
        atomicAdd(out.sy, s);
        atomicAdd(out.syy, ss);
        atomicAdd(out.rows, nn);
      }
    }
  }
  if (kMode == kColsum && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      tid == 0) {
    *out.count += static_cast<float>(n_rows);
  }
}

template <int kMode>
int launch(const void* x, int is_bf16, const float* mask, const float* y,
           long long n_rows, long long d, const Outputs& out, void* stream) {
  const unsigned tiles = static_cast<unsigned>((d + kTile - 1) / kTile);
  long long splits = (n_rows + kRowsPerSplit - 1) / kRowsPerSplit;
  splits = splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits);
  long long split_rows = (n_rows + splits - 1) / splits;
  split_rows = (split_rows + kChunk - 1) / kChunk * kChunk;
  const dim3 grid(tiles, tiles, static_cast<unsigned>(splits));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gram_tile_kernel<__nv_bfloat16, kMode><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), mask, y, n_rows, split_rows, d, out);
  } else {
    gram_tile_kernel<float, kMode><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), mask, y, n_rows, split_rows, d, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// gram += (x · mask)ᵀ (x · mask). x: (n, d) row-major f32 or bf16; mask: (n,)
// f32, or null for all ones; gram: (d, d) f32. Returns the cudaError_t of
// the launch.
int srml_gram(const void* x, int is_bf16, const float* mask, long long n,
              long long d, float* gram, void* stream) {
  const Outputs out{gram, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch<kMasked>(x, is_bf16, mask, nullptr, n, d, out, stream);
}

// Over the first min(n, max(n_valid, 0)) rows of x: gram += xᵀx,
// colsum += Σx, count += rows. gram (d, d), colsum (d,), count () are f32.
int srml_gram_colsum(const void* x, int is_bf16, long long n, long long d,
                     long long n_valid, float* gram, float* colsum,
                     float* count, void* stream) {
  const long long rows = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
  const Outputs out{gram, colsum, count, nullptr, nullptr, nullptr, nullptr};
  return launch<kColsum>(x, is_bf16, nullptr, nullptr, rows, d, out, stream);
}

// With xm = x·m and ym = y·m over all n rows (mask null: m = 1):
// xtx += xmᵀxm, xty += xmᵀym, sx += Σxm, sy += Σym, syy += Σym²,
// rows += #(m != 0). x: (n, d) f32 or bf16; y, mask: (n,) f32; xtx (d, d),
// xty and sx (d,), sy and syy () f32; rows () uint64.
int srml_linreg_stats(const void* x, int is_bf16, const float* mask,
                      const float* y, long long n, long long d, float* xtx,
                      float* xty, float* sx, float* sy, float* syy,
                      unsigned long long* rows, void* stream) {
  const Outputs out{xtx, sx, nullptr, xty, sy, syy, rows};
  return launch<kLinreg>(x, is_bf16, mask, y, n, d, out, stream);
}

}  // extern "C"
