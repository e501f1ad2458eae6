// Hopper (sm_90a) kernels of the Gram family: the masked Gram (X·m)ᵀ(X·m),
// the fused count / column sum / XᵀX of the first n_valid rows (PCA), the
// fused normal-equation statistics XᵀX, Xᵀy, Σx, Σy, Σy², n
// (LinearRegression), and the weighted Grams of LogisticRegression: one
// binomial Newton-IRLS pass and the multinomial per-class curvature.
//
// Replaces spark_rapids_ml_tpu/ops/pallas_kernels.py:
//   gram_pallas              (:78)   -> srml_gram
//   gram_colsum_pallas       (:173)  -> srml_gram_colsum
//   newton_stats_pallas      (:451)  -> srml_newton_stats
//   softmax_curvature_pallas (:1135) -> srml_softmax_curvature
//   linreg_stats_pallas      (:1210) -> srml_linreg_stats
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
// The LogisticRegression statistics are the same body in a fourth mode,
// kWeighted: the i-panel is scaled by a per-row weight on staging and the
// j-panel is raw, so a tile is Xᵀdiag(wt)X; the diagonal blocks' column sums
// of the scaled panel are Xᵀwt and, given a residual r, they add Xᵀr from
// the raw panel. A launch covers C weight columns (wt is (n, C), read at
// stride C): blockIdx.z = split·C + class, each class with its own (d, d)
// and (d,) outputs.
//
// * srml_newton_stats is two launches. A row pass (one warp per row, the
//   dot product reduced with __shfl_xor_sync) computes z = x·w + b,
//   p = σ(z), r = (p − y)·m and wgt = max(p(1 − p), 1e-10)·m into (n,) f32
//   scratch and adds Σr and Σwgt; then the kWeighted Gram pass with
//   wt = wgt and the residual r gives Xᵀdiag(wgt)X, Xᵀwgt and Xᵀr. The
//   Pallas kernel reads x once per iteration; this reads it twice. At the
//   path's shape (511,943 x 1024 bf16) the second read is about 1 GB, or
//   0.3 ms of HBM time, against about 45 ms of FFMA: it is the first thing
//   the tensor-core redesign removes (z must then come from the same
//   staged tiles as the Hessian).
// * srml_softmax_curvature is one kWeighted launch over all C classes with
//   wt = p (already masked): Xᵀdiag(p_c)X and Xᵀp_c per class. x is read
//   again for every class, about 8.5 GB at 129,838 x 1024 bf16, C = 32, or
//   2.5 ms of HBM time against about 350 ms of FFMA; sharing one staged x
//   tile across a class group, as the Pallas kernel does, is later work.
// w, b, z, p, r, wgt and p_c stay f32: the TPU kernels' bf16 roundings of
// w, r, wgt and p_c were MXU and Mosaic constraints and are not carried over.
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
constexpr long long kMaxGridZ = 65535;            // gridDim.z limit: splits x classes
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
  float* gram;                // (d, d); (C, d, d) kWeighted
  float* colsum;              // (d,)    kColsum, kLinreg; (C, d) kWeighted
  float* count;               // ()      kColsum
  float* xty;                 // (d,)    kLinreg; kWeighted with a residual
  float* sy;                  // ()      kLinreg
  float* syy;                 // ()      kLinreg
  unsigned long long* rows;   // ()      kLinreg
};

// blockIdx.z = split * n_classes + class; the split covers rows
// [split * split_rows, min(n_rows, (split + 1) * split_rows)). n_classes is 1
// outside kWeighted. mask == nullptr means all ones (kMasked, kLinreg); y is
// read by kLinreg. kWeighted: mask is the (n, n_classes) weight matrix and y
// the (n,) residual, or nullptr for none.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
gram_tile_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                 const float* __restrict__ y, long long n_rows,
                 long long split_rows, long long d, int n_classes, Outputs out) {
  constexpr bool kWgt = kMode == kWeighted;
  constexpr bool kUseMask = kMode == kMasked || kMode == kLinreg;
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
  const bool resid_block = kWgt && diag && y != nullptr;   // adds Xᵀr
  const int cls = static_cast<int>(blockIdx.z % n_classes);
  const long long split = blockIdx.z / n_classes;
  float* gram = out.gram + static_cast<long long>(cls) * d * d;
  float* colsum = kMode == kMasked ? nullptr : out.colsum + static_cast<long long>(cls) * d;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float csum = 0.f;   // Σ a over this thread's rows (column i0 + lc)
  float xysum = 0.f;  // Σ a·(y·m) (kLinreg); Σ a·r before the weight (kWeighted)
  float ys = 0.f, yys = 0.f;
  unsigned long long nrows = 0;

  const long long r_begin = split * split_rows;
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
        if (kWgt) {
          if (resid_block) xysum += a * y[r];  // a is still the raw column
          a *= mask[r * n_classes + cls];
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

  if (kMode == kMasked) return;
  if (diag) {  // block-uniform: the barriers are safe
    red[lr][lc] = csum;
    __syncthreads();
    if (tid < kTile && i0 + tid < d) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kRowsPerPass; ++q) s += red[q][tid];
      atomicAdd(&colsum[i0 + tid], s);
    }
    if (kLin || resid_block) {
      __syncthreads();
      red[lr][lc] = xysum;
      if (kLin && lc == 0) {
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
      if (kLin && y_block && tid == 0) {
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
           long long n_rows, long long d, int n_classes, const Outputs& out,
           void* stream) {
  if (n_classes < 1 || n_classes > kMaxGridZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long max_splits = kMaxGridZ / n_classes;
  const unsigned tiles = static_cast<unsigned>((d + kTile - 1) / kTile);
  long long splits = (n_rows + kRowsPerSplit - 1) / kRowsPerSplit;
  splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
  long long split_rows = (n_rows + splits - 1) / splits;
  split_rows = (split_rows + kChunk - 1) / kChunk * kChunk;
  const dim3 grid(tiles, tiles, static_cast<unsigned>(splits * n_classes));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gram_tile_kernel<__nv_bfloat16, kMode><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), mask, y, n_rows, split_rows, d,
        n_classes, out);
  } else {
    gram_tile_kernel<float, kMode><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), mask, y, n_rows, split_rows, d,
        n_classes, out);
  }
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

extern "C" {

// gram += (x · mask)ᵀ (x · mask). x: (n, d) row-major f32 or bf16; mask: (n,)
// f32, or null for all ones; gram: (d, d) f32. Returns the cudaError_t of
// the launch.
int srml_gram(const void* x, int is_bf16, const float* mask, long long n,
              long long d, float* gram, void* stream) {
  const Outputs out{gram, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch<kMasked>(x, is_bf16, mask, nullptr, n, d, 1, out, stream);
}

// Over the first min(n, max(n_valid, 0)) rows of x: gram += xᵀx,
// colsum += Σx, count += rows. gram (d, d), colsum (d,), count () are f32.
int srml_gram_colsum(const void* x, int is_bf16, long long n, long long d,
                     long long n_valid, float* gram, float* colsum,
                     float* count, void* stream) {
  const long long rows = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
  const Outputs out{gram, colsum, count, nullptr, nullptr, nullptr, nullptr};
  return launch<kColsum>(x, is_bf16, nullptr, nullptr, rows, d, 1, out, stream);
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
  return launch<kLinreg>(x, is_bf16, mask, y, n, d, 1, out, stream);
}

// One binomial Newton-IRLS pass at (w, b) over the n rows of x (f32 or bf16,
// (n, d) row-major): with z = x·w + b, p = σ(z), r = (p − y)·m and
// wgt = max(p(1 − p), 1e-10)·m (mask null: m = 1),
// gw += Xᵀr, gb += Σr, hww += Xᵀdiag(wgt)X, hwb += Xᵀwgt, hbb += Σwgt.
// y, mask: (n,) f32; w: (d,) f32; b: () f32 on the device; resid, wgt: (n,)
// f32 scratch the row pass writes; gw, hwb (d,), hww (d, d), gb, hbb () f32.
int srml_newton_stats(const void* x, int is_bf16, const float* y,
                      const float* mask, const float* w, const float* b,
                      long long n, long long d, float* resid, float* wgt,
                      float* gw, float* gb, float* hww, float* hwb, float* hbb,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    long long blocks = (n + kRowThreads / 32 - 1) / (kRowThreads / 32);
    blocks = blocks > kRowBlocks ? kRowBlocks : blocks;
    if (is_bf16) {
      newton_row_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kRowThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), y, mask, w, b, n, d, resid, wgt, gb, hbb);
    } else {
      newton_row_kernel<float><<<static_cast<unsigned>(blocks), kRowThreads, 0, s>>>(
          static_cast<const float*>(x), y, mask, w, b, n, d, resid, wgt, gb, hbb);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Outputs out{hww, hwb, nullptr, gw, nullptr, nullptr, nullptr};
  return launch<kWeighted>(x, is_bf16, wgt, resid, n, d, 1, out, stream);
}

// Per class c of the (n, C) f32 weights p (softmax probabilities, already
// masked): hw[c] += Xᵀdiag(p_c)X, hwb[c] += Xᵀp_c. x: (n, d) f32 or bf16;
// hw (C, d, d), hwb (C, d) f32. 1 <= C <= 65535.
int srml_softmax_curvature(const void* x, int is_bf16, const float* p,
                           long long n, long long d, int n_classes, float* hw,
                           float* hwb, void* stream) {
  const Outputs out{hw, hwb, nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch<kWeighted>(x, is_bf16, p, nullptr, n, d, n_classes, out, stream);
}

}  // extern "C"
