// The streamed TN scoring layout shared by the port's tensor-core scoring
// kernels: kmeans.cu's streamed centre chunks (kmeans_tc_kernel with
// resident = 0: x rows against centre chunks) and knn.cu's IVF list scan
// (ivf_scan_tc_kernel: query slots against list-row chunks).
//
// A task is a 128-row A tile (two 64-row halves, one per consumer
// warpgroup) scored against B in chunks of N rows, both operands bf16 and
// K-major (rows as they lie in memory: wgmma transpose bits 0, 0). K = d
// streams in 64-column slabs: a stage of the ring holds one slab of both A
// halves and one slab of the B chunk, 2 · 8 KB + 128 · N bytes, in TMA's
// 128-byte swizzle. One producer thread fills the ring; both consumer
// warpgroups take every stage (empty barriers count 256 arrivals), so they
// share the B slab and stay within a ring of each other (a warpgroup that
// skipped the other's stages could wait on a slot several rounds ahead,
// where the barrier's parity aliases). Each warpgroup stages a chunk's
// per-column constants (‖c‖² of the centres, r2 of the list rows) in one of
// two N-float buffers while its wgmmas run.
//
// Both kernels order their stages the same way: task i of a block, chunk c,
// column box b is stage i · chunks · kboxes + c · kboxes + b, slot
// stage % stages, parity (stage / stages) & 1.

#ifndef SRML_SCORING_CUH_
#define SRML_SCORING_CUH_

#include "hopper.cuh"

namespace srml_scoring {

using namespace srml_hopper;  // NOLINT: mbarriers, TMA, wgmma

constexpr int kRows = 64;                // rows of an A half: one m64 wgmma
constexpr int kBoxBytes = kRows * 128;   // 64 rows x 64 bf16 columns

// Bytes of one stage at chunk width N.
__host__ __device__ constexpr long long stage_bytes(int n) { return 2LL * kBoxBytes + 128LL * n; }

// The ring: `stages` slots of `slot_bytes` from `base` (1 KB aligned), and
// the full / empty mbarriers (8 bytes each) from `full0` / `empty0`.
struct Ring {
  uint32_t base;
  uint32_t slot_bytes;
  uint32_t full0;
  uint32_t empty0;
  int stages;
  __device__ __forceinline__ uint32_t full(int s) const { return full0 + 8u * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return empty0 + 8u * s; }
  __device__ __forceinline__ uint32_t slot(int s) const { return base + s * slot_bytes; }
};

// Producer: stage `stage` of the ring, once its slot is free. load_a(dst,
// bar, half) issues the TMA load of A half 0 or 1 (half 1 only when `two`:
// the tile's second 64 rows hold valid rows) and load_b(dst, bar) that of
// the B chunk's slab, each into its place of the slot.
template <int N, class LoadA, class LoadB>
__device__ __forceinline__ void produce_stage(const Ring& r, long long stage, bool two,
                                              LoadA load_a, LoadB load_b) {
  const int slot = static_cast<int>(stage % r.stages);
  const uint32_t round = static_cast<uint32_t>(stage / r.stages);
  mbar_wait(r.empty(slot), (round & 1u) ^ 1u);
  const uint32_t st = r.slot(slot);
  mbar_expect_tx(r.full(slot), (two ? 2 : 1) * kBoxBytes + 128 * N);
  load_a(st, r.full(slot), 0);
  if (two) load_a(st + kBoxBytes, r.full(slot), 1);
  load_b(st + 2 * kBoxBytes, r.full(slot));
}

// Consumer warpgroup cw (0 or 1): acc = its A half · the chunk's B rowsᵀ
// over the `kboxes` stages from `stage` (advanced past them). Every box
// takes its four k-steps (columns past d are TMA's zeros: a k-step count
// that depends on d made ptxas serialize the wgmmas).
// kOverlap: a stage is released once the next one's wgmmas are issued and
// its own are done, the last after the chunk's final wait, so one group is
// in flight across the loop's back edge. Otherwise each stage waits for its
// own wgmmas before it is released: nothing is in flight where the compiler
// may move the accumulator between registers (a register-hungry epilogue
// made it do so at the back edge, and the moves read the accumulator before
// the wgmmas had written it).
template <int N, bool kOverlap = true>
__device__ __forceinline__ void consume_chunk(const Ring& r, long long& stage, int kboxes, int cw,
                                              float (&acc)[N / 2]) {
  int pending = -1;  // slot read by wgmmas that may still be in flight
  for (int b = 0; b < kboxes; ++b, ++stage) {
    const int slot = static_cast<int>(stage % r.stages);
    mbar_wait(r.full(slot), static_cast<uint32_t>(stage / r.stages) & 1u);
    const uint32_t st = r.slot(slot);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t da = sw128_desc(st + cw * kBoxBytes + 32 * j, 16, 1024);
      const uint64_t db = sw128_desc(st + 2 * kBoxBytes + 32 * j, 16, 1024);
      wgmma_kk<N>(acc, da, db, (b == 0 && j == 0) ? 0 : 1);
    }
    wgmma_commit();
    if (kOverlap) {
      wgmma_wait<1>();  // the previous stage's wgmmas are done: release it
      fence_acc(acc);
      if (pending >= 0) mbar_arrive(r.empty(pending));
      pending = slot;
    } else {
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(r.empty(slot));
    }
  }
  if (kOverlap) {
    wgmma_wait<0>();
    fence_acc(acc);
    if (pending >= 0) mbar_arrive(r.empty(pending));
  }
}

__host__ __device__ constexpr int per_thread(int n) { return (n + 127) / 128; }

// A chunk's N constants, thread t's share (columns t, t + 128, ...): src[col]
// for col < valid, else `fill` (f32 norms, or int32 ids). Issued before the
// chunk's wgmmas, so the loads run while they do.
template <int N, typename T>
__device__ __forceinline__ void fetch_constants(T (&pre)[per_thread(N)], const T* src,
                                                long long col0, long long valid, int t, T fill) {
#pragma unroll
  for (int u = 0; u < per_thread(N); ++u) {
    const long long col = col0 + t + 128 * u;
    pre[u] = col < valid ? __ldg(src + col) : fill;
  }
}

// Writes the fetched constants into buffer seq & 1 of warpgroup cw's pair
// (bufs: 2 · N values a warpgroup) without waiting; returns the buffer.
template <int N, typename T>
__device__ __forceinline__ const T* stage_constants(const T (&pre)[per_thread(N)], T* bufs,
                                                    long long seq, int t, int cw) {
  T* buf = bufs + 2 * N * cw + (seq & 1) * N;
#pragma unroll
  for (int u = 0; u < per_thread(N); ++u) {
    if (t + 128 * u < N) buf[t + 128 * u] = pre[u];
  }
  return buf;
}

// stage_constants, then a wait for the warpgroup's 128 threads (named
// barrier 3 + cw), which also publishes any buffer staged before it. Its
// readers two chunks back have passed the previous chunk's barrier, so the
// rewrite is safe.
template <int N>
__device__ __forceinline__ const float* publish_constants(const float (&pre)[per_thread(N)],
                                                          float* bufs, long long seq, int t,
                                                          int cw) {
  const float* buf = stage_constants<N>(pre, bufs, seq, t, cw);
  asm volatile("bar.sync %0, 128;" ::"r"(3 + cw) : "memory");
  return buf;
}

}  // namespace srml_scoring

#endif  // SRML_SCORING_CUH_
