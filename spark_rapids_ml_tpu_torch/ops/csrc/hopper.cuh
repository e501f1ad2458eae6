// Hopper (sm_90a) device helpers shared by the port's tensor-core bodies
// (gram.cu, kmeans.cu, knn.cu): mbarriers, TMA loads, wgmma descriptors and
// instructions, the bulk reduce, the tensor-map encoder and the register
// check behind the launchers' rc 1998. Each .cu is its own library, so the
// helpers are inline and live in a namespace of their own.

#ifndef SRML_HOPPER_CUH_
#define SRML_HOPPER_CUH_

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace srml_hopper {

constexpr long long kWaitNs = 10000000000LL;  // a barrier wait past this traps
constexpr int kErrTensorMap = 1000;  // + CUresult: cuTensorMapEncodeTiled failed
constexpr int kErrNoEncoder = 1999;  // the driver has no cuTensorMapEncodeTiled
constexpr int kErrRegisters = 1998;  // ptxas did not give the kernel its register budget

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (start == 0) {
      start = now;
    } else if (now - start > static_cast<uint64_t>(kWaitNs)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// The same for a 3-D tensor map: {col, row, plane} (a plane is one IVF list).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma descriptor of an operand in the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B layout: 128-byte rows, 8-row atoms of 1 KB).
// MN-major: `sbo` bytes between 8-row atoms along K, `lbo` bytes between
// 64-element column blocks along M (or N). K-major: `sbo` (1 KB) between
// 8-row atoms along M (or N); `lbo` is not read (16).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int M>
__device__ __forceinline__ void fence_acc(float (&acc)[M]) {
#pragma unroll
  for (int v = 0; v < M; ++v) asm volatile("" : "+f"(acc[v])::"memory");
}

#define SRML_ACC4(i) "+f"(acc[i]), "+f"(acc[i + 1]), "+f"(acc[i + 2]), "+f"(acc[i + 3])
#define SRML_ACC8(i) SRML_ACC4(i), SRML_ACC4(i + 4)

// acc (64 x 128 f32 fragment) = [acc if scale_d] + Aᵀ-tile · B-tile, both
// bf16 MN-major (transpose bits 1, 1).
__device__ __forceinline__ void wgmma_m64n128k16(float (&acc)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      " %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51,"
      " %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 1, 1;\n}\n"
      : SRML_ACC8(0), SRML_ACC8(8), SRML_ACC8(16), SRML_ACC8(24), SRML_ACC8(32), SRML_ACC8(40),
        SRML_ACC8(48), SRML_ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with A in registers: a 64 x 16 bf16 tile in wgmma's register
// fragment layout (warp w of the warpgroup rows 16w..16w+15; a thread's
// four b32 hold (row g, k 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..) for g = lane / 4, t = lane % 4).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&acc)[64], const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      " %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51,"
      " %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SRML_ACC8(0), SRML_ACC8(8), SRML_ACC8(16), SRML_ACC8(24), SRML_ACC8(32), SRML_ACC8(40),
        SRML_ACC8(48), SRML_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// acc (64 x N f32 fragment) = [acc if scale_d] + A · Bᵀ with A (64 x 16)
// and B (N x 16) both bf16 K-major (transpose bits 0, 0): rows of x and of
// the centres as they lie in memory. Specialised for the chunk widths the
// KMeans body uses (kernels.KMEANS_WIDTHS); the IVF scan takes 256.
template <int N>
__device__ void wgmma_kk(float (&acc)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_kk<104>(float (&acc)[52], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %54, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51"
      "}, %52, %53, p, 1, 1, 0, 0;\n}\n"
      : SRML_ACC4(0), SRML_ACC4(4), SRML_ACC4(8), SRML_ACC4(12), SRML_ACC4(16),
        SRML_ACC4(20), SRML_ACC4(24), SRML_ACC4(28), SRML_ACC4(32), SRML_ACC4(36),
        SRML_ACC4(40), SRML_ACC4(44), SRML_ACC4(48)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_kk<256>(float (&acc)[128], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      " %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123,"
      " %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : SRML_ACC4(0), SRML_ACC4(4), SRML_ACC4(8), SRML_ACC4(12), SRML_ACC4(16),
        SRML_ACC4(20), SRML_ACC4(24), SRML_ACC4(28), SRML_ACC4(32), SRML_ACC4(36),
        SRML_ACC4(40), SRML_ACC4(44), SRML_ACC4(48), SRML_ACC4(52), SRML_ACC4(56),
        SRML_ACC4(60), SRML_ACC4(64), SRML_ACC4(68), SRML_ACC4(72), SRML_ACC4(76),
        SRML_ACC4(80), SRML_ACC4(84), SRML_ACC4(88), SRML_ACC4(92), SRML_ACC4(96),
        SRML_ACC4(100), SRML_ACC4(104), SRML_ACC4(108), SRML_ACC4(112), SRML_ACC4(116),
        SRML_ACC4(120), SRML_ACC4(124)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef SRML_ACC8
#undef SRML_ACC4

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8j..8j+7
// give the 16-byte rows of matrix j, and each thread gets, in register j,
// two consecutive ROWS of matrix j at column lane / 4 (rows 2(lane % 4)
// and 2(lane % 4) + 1, the first in the low half).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Keeps A fragments in their registers while a wgmma that reads them may
// still be in flight (the compiler sees the asm consume them at issue).
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int v = 0; v < 4; ++v) asm volatile("" : "+r"(a[k][v])::"memory");
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Adds `bytes` of f32 from shared memory into global memory (TMA reduce).
__device__ __forceinline__ void bulk_add_f32(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call; the runtime hands out its entry
// point, so the library links no libcuda of its own.
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                   : nullptr;
  }();
  return fn;
}

// A bf16 (rows, cols) row-major tensor map with 64-column boxes of
// `box_rows` rows in the 128-byte swizzle; the row extent is `rows` (at
// least 1), so TMA zero-fills every row past it and the ragged column edge.
// Returns 0, or kErrNoEncoder / kErrTensorMap + CUresult.
inline int bf16_tensor_map(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                           int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(r);
}

// A bf16 (planes, rows, cols) row-major tensor map with boxes of 64
// columns x `box_rows` rows x one plane in the 128-byte swizzle: a box never
// crosses into the next plane, and TMA zero-fills rows past `rows` and the
// ragged column edge. Returns as bf16_tensor_map.
inline int bf16_tensor_map_3d(CUtensorMap* map, const void* ptr, long long planes, long long rows,
                              long long cols, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows * cols) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(r);
}

// The registers ptxas gave a kernel (-1 if the runtime cannot say): a
// setmaxnreg balance holds only at the entry count it was planned for.
inline int kernel_registers(const void* fn) {
  cudaFuncAttributes attr{};
  return cudaFuncGetAttributes(&attr, fn) == cudaSuccess ? attr.numRegs : -1;
}

}  // namespace srml_hopper

#endif  // SRML_HOPPER_CUH_
