// Hopper (sm_90a) kernels of the PCA fold: the masked Gram (X·m)ᵀ(X·m) and
// the fused count / column sum / XᵀX of the first n_valid rows.
//
// Replaces spark_rapids_ml_tpu/ops/pallas_kernels.py:
//   gram_pallas        (:78)  -> srml_gram
//   gram_colsum_pallas (:173) -> srml_gram_colsum
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
// place (the seeded gram_colsum_pallas).
//
// Arithmetic: f32 input multiplies in plain f32 FFMA (never TF32), as the
// JAX package's Precision.HIGHEST; bf16 input converts with
// __bfloat162float (exact) and accumulates in f32.
//
// Bound on the H100: at the main path's shape (262,144 x 2048) the fold does
// nd(d+1) = 1.1 TFLOP (G is symmetric, so half of 2nd²) against 1.07 GB
// (bf16) of reads, far above the card's ops-per-byte balance, so it is
// bound by operations (bf16 tensor cores: 1.1 ms; f32 FFMA for the f32
// Gram: 16 ms). This simple CUDA-core kernel cannot reach the tensor-core
// bound; wgmma, TMA and the SYRK symmetry (half the tiles) are the later
// steps. Index arithmetic is 64-bit:
// 262,144 x 2048 f32 is exactly 2^31 bytes.

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Row (or column) of the tile that accumulator slot s of thread t covers:
// slots 0-3 at 4t..4t+3, slots 4-7 at 64+4t..64+4t+3, so that the float4
// reads of a warp from shared memory are contiguous.
__device__ __forceinline__ int slot(int t, int s) {
  return (s < 4) ? t * 4 + s : 64 + t * 4 + (s - 4);
}

// Rows [blockIdx.z * split_rows, min(n_rows, (blockIdx.z + 1) * split_rows)).
// kMask: G += (X·m)ᵀ(X·m) (gram_pallas); mask == nullptr means all ones.
// !kMask: G += XᵀX, the diagonal blocks add the column sums of their
// columns, and block (0, 0, 0) adds n_rows to the count (gram_colsum_pallas).
template <typename T, bool kMask>
__global__ void __launch_bounds__(kThreads)
gram_tile_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                 long long n_rows, long long split_rows, long long d,
                 float* __restrict__ gram, float* __restrict__ colsum,
                 float* __restrict__ count) {
  __shared__ __align__(16) float a_s[kChunk][kTile];
  __shared__ __align__(16) float b_s[kChunk][kTile];
  __shared__ float red[kRowsPerPass][kTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long i0 = static_cast<long long>(blockIdx.y) * kTile;  // G rows
  const long long j0 = static_cast<long long>(blockIdx.x) * kTile;  // G cols
  const int lc = tid % kTile;  // staged column
  const int lr = tid / kTile;  // first staged row
  const bool a_ok = i0 + lc < d;
  const bool b_ok = j0 + lc < d;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float csum = 0.f;

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
        if (kMask && mask != nullptr) {
          const float m = mask[r];
          a *= m;
          b *= m;
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
      if (gj < d) atomicAdd(&gram[gi * d + gj], acc[i][j]);
    }
  }

  if (!kMask) {
    if (blockIdx.x == blockIdx.y) {  // block-uniform: the barrier is safe
      red[lr][lc] = csum;
      __syncthreads();
      if (tid < kTile && i0 + tid < d) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < kRowsPerPass; ++q) s += red[q][tid];
        atomicAdd(&colsum[i0 + tid], s);
      }
    }
    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && tid == 0) {
      *count += static_cast<float>(n_rows);
    }
  }
}

template <bool kMask>
int launch(const void* x, int is_bf16, const float* mask, long long n_rows,
           long long d, float* gram, float* colsum, float* count, void* stream) {
  const unsigned tiles = static_cast<unsigned>((d + kTile - 1) / kTile);
  long long splits = (n_rows + kRowsPerSplit - 1) / kRowsPerSplit;
  splits = splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits);
  long long split_rows = (n_rows + splits - 1) / splits;
  split_rows = (split_rows + kChunk - 1) / kChunk * kChunk;
  const dim3 grid(tiles, tiles, static_cast<unsigned>(splits));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gram_tile_kernel<__nv_bfloat16, kMask><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), mask, n_rows, split_rows, d, gram,
        colsum, count);
  } else {
    gram_tile_kernel<float, kMask><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), mask, n_rows, split_rows, d, gram, colsum,
        count);
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
  return launch<true>(x, is_bf16, mask, n, d, gram, nullptr, nullptr, stream);
}

// Over the first min(n, max(n_valid, 0)) rows of x: gram += xᵀx,
// colsum += Σx, count += rows. gram (d, d), colsum (d,), count () are f32.
int srml_gram_colsum(const void* x, int is_bf16, long long n, long long d,
                     long long n_valid, float* gram, float* colsum,
                     float* count, void* stream) {
  const long long rows = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
  return launch<false>(x, is_bf16, nullptr, rows, d, gram, colsum, count, stream);
}

}  // extern "C"
