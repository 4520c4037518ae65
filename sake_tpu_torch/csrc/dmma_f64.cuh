// The f64 tensor-core (DMMA) tile of the two gradient contractions,
// sparse_contract.cu and param_grads.cu: out[m, n] = sum over rows e of
// a[e, m] * g[e, n], every product and sum in f64 from the first product.
//
// A block of kDmThreads = 256 threads owns a tile of kDmM = 64 output rows (a
// slab of operand a's columns) and 32 * NT output columns (NT = 8: 256, the
// whole width of w_xmix's g; NT = 2: 64). Its 8 warps split it 2 x 4: warp w
// takes rows 32 (w / 4) .. + 32 and columns 8 NT (w % 4) .. + 8 NT, 2 x NT
// m16n8 tiles of mma.sync.aligned.m16n8k8.row.col.f64 with their sums in f64
// registers (8 NT doubles a thread).
//
// The operands' raw f32 rows reach shared memory through a ring of kDmRing
// slots of kDmK rows each, filled by cp.async (DmStream; kDmRing - 2 stages
// in flight) or, where an operand is formed by loaders, stored from
// registers. The products read their fragments from the ring, form them where
// the operand is a product of rows (w_xmix's h_e * att2, its tangent),
// convert each to f64 and run them on DMMA: no f64 copy of a stage and no
// pass over it. One block barrier a stage (dm_run) publishes a stage's copies
// and orders the refill of a slot after the products that read it. f32
// products are exact in f64 and the tensor cores add them in f64 in a fixed
// order: two launches agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe.cuh"

namespace sake {

constexpr int kDmThreads = 256;
constexpr int kDmM = 64;    // output rows of a block tile
constexpr int kDmK = 16;    // rows (the contracted index) of a stage
constexpr int kDmRing = 6;  // ring slots: kDmRing - 2 stages in flight

// Row stride, in floats, of a ring slot of wc-wide rows: rows of whole
// 16-byte pieces (wc a multiple of 4) are padded to wc + 8, so that the
// fragment loads of a k8 step (rows t and t + 4, columns g of a tile; t =
// lane % 4, g = lane / 4) fall in 32 distinct banks; other widths stay flat,
// their pieces running across rows.
__host__ __device__ constexpr int dm_ldr(int wc) { return wc % 4 == 0 ? wc + 8 : wc; }

#ifndef SAKE_CUDA_EMU  // the CPU emulator (tools/cuda_emu) supplies these four
// d += a b for one m16n8k8 f64 tile (PTX ISA fragment layout, that of
// mma_tf32's m16n8k8: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t +
// 4); b0 (t, g), b1 (t + 4, g); d (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1); g = lane / 4, t = lane % 4).
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
// 16 bytes from device to shared memory, of which the first `bytes` are read
// and the rest are zeros.
__device__ __forceinline__ void dm_cp_async(float* smem, const float* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void dm_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Waits until at most N of this thread's newest groups are in flight.
template <int N>
__device__ __forceinline__ void dm_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#endif

// The f64 sums of one block tile.
template <int NT>
struct DmTile {
  double acc[2][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;
  }

  // acc += A^T B over the kDmK rows of one stage, the operands read by op:
  // op.template a<K8>(k, m) and op.template b<K8>(k, n), row k (< 8) of the
  // stage's k8 step K8, as f64. Output rows >= m_live and columns >= n_live
  // are never read, so the m16 and n8 tiles wholly beyond them are skipped
  // (the test is uniform over the warp).
  template <class Op>
  __device__ __forceinline__ void mma(const Op& op, int m_live, int n_live) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = 32 * (w >> 2), n0 = 8 * NT * (w & 3);
    step<0>(op, m_live, n_live, g, t, m0, n0);
    step<1>(op, m_live, n_live, g, t, m0, n0);
  }

  template <int K8, class Op>
  __device__ __forceinline__ void step(const Op& op, int m_live, int n_live, int g, int t,
                                       int m0, int n0) {
    double a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + 16 * i + g;
      a[i][0] = op.template a<K8>(t, m);
      a[i][1] = op.template a<K8>(t, m + 8);
      a[i][2] = op.template a<K8>(t + 4, m);
      a[i][3] = op.template a<K8>(t + 4, m + 8);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (n0 + 8 * j >= n_live) break;
      const int n = n0 + 8 * j + g;
      const double b[2] = {op.template b<K8>(t, n), op.template b<K8>(t + 4, n)};
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (m0 + 16 * i < m_live) dmma(acc[i][j], a[i], b);
    }
  }

  // out(m, n, value) for every live output of this thread.
  template <class Out>
  __device__ __forceinline__ void store(int m_live, int n_live, Out&& out) const {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = 32 * (w >> 2), n0 = 8 * NT * (w & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = m0 + 16 * i + g + 8 * (q >> 1), n = n0 + 8 * j + 2 * t + (q & 1);
          if (m < m_live && n < n_live) out(m, n, acc[i][j][q]);
        }
  }
};

// Stages 0 .. n_stages - 1 of a block through its tile. fill.start() begins
// the ring's first copies; fill.prefetch(s) starts the loads of stage s that
// go to registers (before stage s - 1's products, so that they are in flight
// during them); fill.stage(s) makes this thread's part of stage s whole in
// its slot (waits for its copies, or stores its formed values) and starts
// the copies of stage s + kDmRing - 2, into the slot of stage s - 2;
// fill.op(s) reads stage s for the products. The barrier at the top of each
// stage publishes every thread's part of it, and every warp has left stage
// s - 2's products before its slot is refilled. The probe slots take the
// staging and the products.
template <int NT, class Fill>
__device__ __forceinline__ void dm_run(DmTile<NT>& tile, int n_stages, int m_live, int n_live,
                                       Fill& fill, int stage_slot, int mma_slot) {
  tile.zero();
  fill.start();
  if (n_stages > 0) {
    fill.prefetch(0);
    fill.stage(0);
  }
  for (int s = 0; s < n_stages; ++s) {
    __syncthreads();
    SAKE_PROBE(stage_slot);
    if (s + 1 < n_stages) fill.prefetch(s + 1);
    tile.mma(fill.op(s), m_live, n_live);
    SAKE_PROBE_BARRIER(mma_slot);
    if (s + 1 < n_stages) fill.stage(s + 1);
  }
  (void)stage_slot;
  (void)mma_slot;
}

// One operand's raw stream through the ring: `rows` rows of width w floats
// from base (row 0 at base), of which the columns [c0, c0 + wc) are staged:
// the whole width (wc == w, rows contiguous, any w) or a slab (w and c0
// multiples of 4). A slot holds n stage rows at stride ld = dm_ldr(wc); this
// thread copies its kP 16-byte pieces of a stage (piece i: floats 4q .. 4q +
// 3 of the stage's n x wc, q = threadIdx.x + i kDmThreads). Where each piece
// lies is the same in every stage, so it is worked out once (init).
template <int kP>
struct DmStream {
  const float* base;
  long long rows;
  int w, wc, ld, n;
  int src[kP], dst[kP];  // piece i's offset in the stage's rows and in the slot; -1: none

  __device__ __forceinline__ void init(const float* base_, long long rows_, int w_, int c0,
                                       int wc_, int n_) {
    base = base_;
    rows = rows_;
    w = w_;
    wc = wc_;
    ld = dm_ldr(wc_);
    n = n_;
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int f = 4 * (threadIdx.x + i * kDmThreads), r = f / wc, c = f - r * wc;
      const bool live = f < n * wc;
      src[i] = live ? (ld == wc ? f : r * w + c0 + c) : -1;
      dst[i] = live ? (ld == wc ? f : r * ld + c) : -1;
    }
  }

  // The copies of the stage of rows r0 .. r0 + n - 1 (beyond `rows`: zeros)
  // into `slot`.
  __device__ __forceinline__ void issue(float* slot, long long r0) const {
    const long long live = r0 >= rows ? 0 : (rows - r0 < n ? rows - r0 : n);
    const int flat = (int)live * wc;
    const float* from = base + r0 * w;
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      if (src[i] >= 0) {
        const int f = 4 * (threadIdx.x + i * kDmThreads);
        const int bytes = f >= flat ? 0 : 4 * (flat - f < 4 ? flat - f : 4);
        dm_cp_async(slot + dst[i], bytes ? from + src[i] : base, bytes);
      }
    }
  }
};

}  // namespace sake
