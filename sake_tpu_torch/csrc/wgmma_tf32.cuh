// The x-mixing product of the sparse edge row on Hopper's warpgroup tensor-core
// product (wgmma), to f32 accuracy by 3xTF32 with chunked sums: out = A @ W for
// a tile of up to 64 neighbour slots (the M tile of wgmma.m64n128k8) against
// a 256 x 256 weight. Used by #13, #14 and #15 (sparse_edge.cuh's edge_row; #15
// with a slot's value and tangent rows in the two halves of the tile): the
// forward tanh(he_att @ w_xmix) and the pullback's d_xm @ w_xmix^T.
//
// The block's two warpgroups split the 256 output columns, 128 each, and both
// run all 64 rows: each thread keeps 64 f32 accumulators of the running sum and
// 64 of the chunk sum (ROADMAP's precision rule: the tensor cores add into their
// accumulator with truncation, so each chunk of kTcSumSteps k-steps sums from
// zero and joins the running sum by an f32 add; mma_tf32x3.cuh measured 3.7e-7
// of max |ref| from float64 that way against 2.2e-6 with one running sum).
//
// A comes from registers: the caller's af(r, k) reads each fragment value from
// its tile in shared memory (he_att for the forward, d_xm for the pullback,
// both in sparse_edge.cuh's X tile), split into hi = tf32(a) and lo = tf32(a -
// hi) with cvt.rna.
// B comes from shared memory: TF32 wgmma takes only K-major operands, so B is
// W's transpose stored row by row (the forward's B is t_xmix, the pullback's
// w_xmix itself), split on the host once per layer into hi and lo planes
// (sparse_ef.xmix_planes) and packed in the order one k-step of wgmma reads it:
// per k-step of 8, per plane, 32 core matrices of 8 rows x 8 k (two 8 x 16-byte
// halves, 128 bytes each), so that one stage (both planes, 16 KB) is one
// contiguous bulk copy (the TMA's cp.async.bulk) completing on an mbarrier. A
// ring of stages in shared memory lets the copies of the next k-steps land
// while the current one computes; an "empty" mbarrier per stage, arrived at by
// each warpgroup once its k-step has completed, lets thread 0 refill it.
//
// Each k-step issues three wgmma into the chunk sum: lo(A) hi(B), hi(A) lo(B),
// hi(A) hi(B) (lo lo is dropped, as in mma_tf32x3.cuh). A double-buffered A
// fragment lets the next k-step's fragments be formed while the current
// k-step's products run (wgmma.wait_group 1).
#pragma once

#include "mma_tf32x3.cuh"

namespace sake {

constexpr int kWgRows = 64;                     // the M tile: neighbour slots per product
constexpr int kWgCols = 256;                    // output columns (two warpgroups of n128)
constexpr int kWgDepth = 256;                   // k of the product
constexpr int kWgSteps = kWgDepth / 8;          // k-steps of wgmma.m64n128k8
constexpr int kWgPlane = kWgCols * 8;           // floats of one plane of one k-step
constexpr int kWgStage = 2 * kWgPlane;          // floats of one stage: hi and lo planes
constexpr int kWgMinStages = 2, kWgMaxStages = 4;
constexpr int kWgXPad = 4;                      // the X buffer's row stride is kWgCols + kWgXPad
// core-matrix strides of a packed plane: the two k halves (LBO) and the 8-row
// groups of columns (SBO), in bytes
constexpr int kWgLbo = 128, kWgSbo = 256;


// The ring of B stages and its barriers, and the running count of k-steps
// this block has consumed (every thread keeps the same count: stage = q mod
// stages, phase parity = (q / stages) & 1).
struct WgRing {
  float* ring;
  unsigned long long* full;   // one per stage: the stage's bytes have landed
  unsigned long long* empty;  // one per stage: both warpgroups are done with it
  int stages;
  unsigned q;
};

#ifndef SAKE_CUDA_EMU  // the CPU emulator (tools/cuda_emu) supplies these
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* b, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
// The TMA's bulk copy: bytes (a multiple of 16, both addresses 16-byte
// aligned) from device memory to shared memory, completing on the mbarrier.
__device__ __forceinline__ void bulk_g2s(float* dst, const float* src, unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Orders this thread's generic accesses to shared memory before the async
// proxy's (the bulk copies into the ring) that follow a block barrier.
__device__ __forceinline__ void wg_fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}
// Keeps the compiler from moving an access to an accumulator across the
// asynchronous wgmma that writes it (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void wg_fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
// d (+)= a b for the warpgroup: A (64 x 8, TF32) from the four registers of
// this thread's fragment (warp w of the warpgroup holds rows 16w ... 16w + 15:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), g = lane / 4,
// t = lane % 4), B (8 x 128, TF32, K-major) by its descriptor; d (64 x 128,
// f32) as the PTX ISA lays it out: d[4j + i] at row g + 8 (i / 2), column 8j +
// 2t + i % 2 of the warp's 16 rows. scale_d 0: d = a b.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}
#endif

// The shared-memory descriptor of a packed plane's 8 x 128 tile at p (no
// swizzle: 8 x 16-byte core matrices, 128 bytes each, k halves kWgLbo and
// column groups kWgSbo apart; the address and both offsets in 16-byte units).
__device__ __forceinline__ uint64_t wg_desc(const float* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(kWgLbo >> 4) << 16) |
         ((uint64_t)(kWgSbo >> 4) << 32);
}

// Thread 0: copy k-step ks of a packed weight into the stage of the block's
// k-step count q, once both warpgroups are done with that stage's last use.
__device__ __forceinline__ void wg_fill(const WgRing& rg, const float* __restrict__ bpk,
                                        unsigned q, int ks) {
  const int s = (int)(q % (unsigned)rg.stages);
  const unsigned use = q / (unsigned)rg.stages;
  if (use > 0) mbar_wait(&rg.empty[s], (use - 1) & 1);
  mbar_expect_tx(&rg.full[s], kWgStage * 4);
  bulk_g2s(rg.ring + (size_t)s * kWgStage, bpk + (size_t)ks * kWgStage, kWgStage * 4,
           &rg.full[s]);
}

// Thread 0 (before any product): the ring's barriers; a block barrier must
// follow before their first use.
__device__ __forceinline__ void wg_init(const WgRing& rg) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < rg.stages; ++s) {
      mbar_init(&rg.full[s], 1);   // thread 0's expect_tx arrival, then the bytes
      mbar_init(&rg.empty[s], 2);  // one arrival per warpgroup
    }
    mbar_fence_init();
  }
}

// Thread 0: copy the first k-steps of a packed weight (as many as the ring holds)
// into the ring for the next wg_xmix<true>, so that they land while the block
// does other work. Every generic access to the ring's space comes before it.
__device__ __forceinline__ void wg_prefill(const WgRing& rg, const float* __restrict__ bpk) {
  if (threadIdx.x == 0)
    for (int s = 0; s < rg.stages && s < kWgSteps; ++s) wg_fill(rg, bpk, rg.q + s, s);
}

// out(r, c) = sum_k af(r, k) B(k, c) for r < n <= 64, c < 256, k < 256, each
// handed to st(r, c, value); rows r >= n read as zeros and are not stored. bpk:
// the packed hi and lo planes of B (kWgSteps stages of kWgStage floats, 16-byte
// aligned). All 256 threads of the block take part (two warpgroups); af reads
// what the caller's barriers have made ready; a block barrier separates the
// last read of af from the first st, so st may overwrite what af read.
// kPrefilled: the caller's wg_prefill has started the first k-steps' copies.
// kSlot, kWaitSlot (the clock probe's, probe.cuh; -1 none): thread 0 charges
// its time before each wait for a k-step's stage to kSlot, the wait to kWaitSlot.
template <bool kPrefilled = false, int kSlot = -1, int kWaitSlot = -1, class AF, class ST>
__device__ __forceinline__ void wg_xmix(int n, AF af, const float* __restrict__ bpk, WgRing& rg,
                                        ST st) {
  static_assert(kTcSumSteps % 2 == 0 && kWgSteps % kTcSumSteps == 0,
                "whole chunks; the A double buffer alternates within a chunk");
  const int tid = threadIdx.x, wgi = tid >> 7, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * ((tid >> 5) & 3) + g, r1 = r0 + 8;  // this thread's A and D rows
  const unsigned q0 = rg.q;
  if constexpr (!kPrefilled) {
    if (tid == 0)
      for (int s = 0; s < rg.stages && s < kWgSteps; ++s) wg_fill(rg, bpk, q0 + s, s);
  }
  __syncwarp();  // the warp converges before its aligned wgmma instructions
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t ah[2][4], al[2][4];  // the A fragment of two k-steps: hi and lo
  // one k-step: form its A fragment, wait for its stage, issue its three
  // products into the chunk sum (from zero at a chunk's first step), then
  // free the previous k-step's stage and refill it
  auto step = [&](int ks, int buf, bool first, bool last) {
    const int k = 8 * ks + t;
    tf32_split(r0 < n ? af(r0, k) : 0.f, ah[buf][0], al[buf][0]);
    tf32_split(r1 < n ? af(r1, k) : 0.f, ah[buf][1], al[buf][1]);
    tf32_split(r0 < n ? af(r0, k + 4) : 0.f, ah[buf][2], al[buf][2]);
    tf32_split(r1 < n ? af(r1, k + 4) : 0.f, ah[buf][3], al[buf][3]);
    const unsigned q = q0 + ks;
    const int s = (int)(q % (unsigned)rg.stages);
    if constexpr (kWaitSlot >= 0) SAKE_PROBE(kSlot);
    mbar_wait(&rg.full[s], (q / (unsigned)rg.stages) & 1);
    if constexpr (kWaitSlot >= 0) SAKE_PROBE(kWaitSlot);
    const float* hi = rg.ring + (size_t)s * kWgStage + wgi * (kWgPlane / 2);
    const uint64_t dh = wg_desc(hi), dl = wg_desc(hi + kWgPlane);
    wg_fence();
    wgmma_tf32(part, al[buf], dh, first ? 0 : 1);
    wgmma_tf32(part, ah[buf], dl, 1);
    wgmma_tf32(part, ah[buf], dh, 1);
    wg_commit();
    if (last) {
      wg_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        wg_fence_operand(part[i]);
        acc[i] += part[i];
      }
    } else {
      wg_wait<1>();
    }
    if (ks > 0) {  // k-step ks - 1 has completed in this warpgroup
      if ((tid & 127) == 0) mbar_arrive(&rg.empty[(q - 1) % (unsigned)rg.stages]);
      if (tid == 0 && ks - 1 + rg.stages < kWgSteps)
        wg_fill(rg, bpk, q - 1 + rg.stages, ks - 1 + rg.stages);
      __syncwarp();
    }
  };
#pragma unroll 1
  for (int k0 = 0; k0 < kWgSteps; k0 += kTcSumSteps) {
#pragma unroll
    for (int j = 0; j < kTcSumSteps; ++j) step(k0 + j, j & 1, j == 0, j == kTcSumSteps - 1);
  }
  if ((tid & 127) == 0) mbar_arrive(&rg.empty[(q0 + kWgSteps - 1) % (unsigned)rg.stages]);
  rg.q = q0 + kWgSteps;
  __syncthreads();  // every read of af is done before st may overwrite it
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i & 2) ? r1 : r0;
    if (r < n) st(r, wgi * (kWgCols / 2) + 8 * (i >> 2) + 2 * t + (i & 1), acc[i]);
  }
}

}  // namespace sake
