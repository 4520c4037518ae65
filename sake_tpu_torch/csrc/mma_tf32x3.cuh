// The x-mixing product on the tensor cores, to f32 accuracy: out = A @ W for
// A (n x 256) in shared memory and W (256 x 256) in device memory, by 3xTF32
// on mma.sync.m16n8k8. Used by the kTc instantiations of the layer bodies
// (K1, K2, #11, #12, #20, #22, #24), with mm_tc_small below for their edge
// products o_f and o1.
//
// Passes (kPasses, tc_passes): 3 in f32. In #20's bf16 tier every weight is a
// bf16 value, which TF32 holds exactly, so W's lo is 0 and its pass is left out:
// 2 passes (lo(a) hi(w) + hi(a) hi(w)) where the activation operand is an f32
// value (a pullback's cotangent g, the x-mixing's bf16(h_e) att), 1 (hi(a)
// hi(w)) where it is rounded to bf16 too (the forward's o_f and o1: exact).
// In resid_ef's bf16 tier (K1, K2, #4-#6) both operands of every edge product
// are rounded to bf16, so every such product takes 1 pass.
//
// 3xTF32: each operand splits as a = hi + lo, hi = tf32(a), lo = tf32(a - hi)
// (cvt.rna: round to nearest, ties away from zero), and the product sums
// lo*hi + hi*lo + hi*hi in f32. lo keeps 11 of the bits below hi, so each
// operand carries about 22 of f32's 24, and lo*lo is dropped: at these shapes
// the product lies 5.3-5.7e-7 of max |ref| from a float64 product, where one
// TF32 pass lies 2.7-3.2e-4 off (tests/test_torch_tf32x3.py).
//
// Layout: a warp owns a strip of 16 output columns and every row of A (n8
// tiles of the transposed product, rows >= n read as zeros), so the 16 warps
// of a 512-thread block cover the 256 columns (K1's 256-thread tensor-core
// kernel: 8 warps, two strips each, kTcFwdWarps). A warp streams its strip of W
// through a ring of its own in shared memory, kTcStages k-steps of 8 rows
// deep, with cp.async: no block barrier, and each element of W is read from
// L2 once per product (the CUDA-core tiling read it once per 7-row tile).
// W is split in registers as its fragments are read: W stays the f32 leaf,
// and one plane is half the L2 traffic and ring of precomputed hi/lo planes
// (#12's carve has room for the f32 ring only).
//
// Bank conflicts: A's rows are read 8 at a time, so the bodies give A a row
// stride of k + kTcPad (264 floats) and the k slots t, t + 4 of the mma read
// A's columns 2t, 2t + 1 (one 64-bit load; W's rows are paired the same
// way); the ring's stage is XOR-swizzled so that rows 0, 2, 4, 6 (and 1, 3,
// 5, 7) of a 16-column strip fall in 32 distinct banks.
#pragma once

#include "resid_common.cuh"

namespace sake {

constexpr int kTcK = 256;       // k and output columns of the products taken
constexpr int kTcPad = 8;       // A's row stride is its width + kTcPad
constexpr int kTcStrip = 16;    // output columns per warp strip
constexpr int kTcStrips = kTcK / kTcStrip;
constexpr int kTcWarps = 16;    // ring slots: the warps of a 512-thread block
// K1's tensor-core route: 256-thread blocks, two a SM, so a ring of 8 warps
// (each takes two 16-column strips, one after the other)
constexpr int kTcFwdWarps = 8;
constexpr int kTcStages = 2;    // ring depth, in k-steps of 8 rows (deeper gained nothing)
constexpr int kTcStage = 8 * kTcStrip;  // floats of one stage of one warp
constexpr int kTcSumSteps = 4;  // mm_tc's k-steps per chunk sum (see mm_tc)
// receivers: up to 22, #12's carve with the padding and the ring fits a block
// (222,480 of 232,448 bytes at 21, 241,568 at 23, where the CUDA-core carve
// still fits: there the bodies keep their CUDA-core products); MD17's
// molecules have at most 21 atoms
constexpr int kTcMaxN = 22;
constexpr int kTcSmallK = 64;   // widest k of mm_tc_small (the rbf and hidden widths)

// The passes of a tensor-core product (see the top): 3 in f32; in bf16 (the
// weight exact in TF32) 1 when the activation operand is a bf16 value too
// (kExactA), else 2.
template <bool kBf16, bool kExactA = false>
__host__ __device__ constexpr int tc_passes() {
  return kBf16 ? (kExactA ? 1 : 2) : 3;
}

// Whether the kTc bodies take the tensor cores at these widths (aspirin's:
// H * K = C = 256, H and R at most 64, N <= 22); otherwise they run the
// CUDA-core products. Uniform over the block, decided by the shape.
__host__ __device__ inline bool tc_dims(const Dims& d) {
  return d.H * d.K == kTcK && d.C == kTcK && d.N <= kTcMaxN && d.H <= kTcSmallK &&
         d.R <= kTcSmallK;
}
// Row stride of a kTc body's A operand of width w (padded only where taken).
__host__ __device__ inline int tc_ld(const Dims& d, int w) {
  return tc_dims(d) ? w + kTcPad : w;
}
// Floats of the W ring a kTc kernel of kWarps warps carves for its bodies (none
// where not taken).
template <int kWarps = kTcWarps>
__host__ __device__ inline long long tc_ring_floats(const Dims& d) {
  return tc_dims(d) ? (long long)kWarps * kTcStages * kTcStage : 0;
}

// The cluster instantiations (kCl: #4 and #5 with a molecule's receivers split
// over two CTAs, cluster.cuh) take the tensor cores up to 32 receivers, four n8
// tiles of mm_tc: their halved receiver buffers leave room for the padding and
// the ring at QM9's N = 29. kTcMaxN and tc_dims stay #11's and #12's.
constexpr int kTcClMaxN = 32;
template <bool kCl>
__host__ __device__ inline bool tc_dims_of(const Dims& d) {
  if constexpr (kCl)
    return d.H * d.K == kTcK && d.C == kTcK && d.N <= kTcClMaxN && d.H <= kTcSmallK &&
           d.R <= kTcSmallK;
  else
    return tc_dims(d);
}
template <bool kCl>
__host__ __device__ inline int tc_ld_of(const Dims& d, int w) {
  return tc_dims_of<kCl>(d) ? w + kTcPad : w;
}
template <bool kCl>
__host__ __device__ inline long long tc_ring_floats_of(const Dims& d) {
  return tc_dims_of<kCl>(d) ? (long long)kTcWarps * kTcStages * kTcStage : 0;
}
// mm_tc's n8 tiles of receivers: 24 rows (#11, #12), 32 (kCl).
template <bool kCl>
__host__ __device__ constexpr int tc_tiles() {
  return kCl ? kTcClMaxN / 8 : 3;
}

#ifndef SAKE_CUDA_EMU  // the CPU emulator (tools/cuda_emu) supplies these four
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// d += a b for one m16n8k8 tile (PTX ISA fragment layout: a0 (g, t), a1 (g +
// 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); d (g,
// 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1); g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
#endif

// x as an mma operand when it is exact in TF32 (a bf16 value): its own bits.
__device__ __forceinline__ uint32_t tf32_exact(float x) { return __float_as_uint(x); }

// hi = tf32(x), lo = tf32(x - hi), as the mma's 32-bit operands.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b in 3xTF32: the small products first, then the large one.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Float offset of (row kk, column c) in a swizzled ring stage (8 x 16): odd
// rows in the second half, rows 4-7 of each half with columns 0-7 and 8-15
// swapped.
__device__ __forceinline__ int tc_stage_at(int kk, int c) {
  return (kk & 1) * 64 + (kk >> 1) * 16 + (c ^ ((kk & 4) ? 8 : 0));
}

// out(r, c) = sum_k A(r, k) W(k, c) for r < n <= 8 * kTiles, k, c < 256,
// each handed to st(r, c, value). The mma computes the transpose, out^T =
// W^T A^T: W's 16 columns of a strip are the m16 rows of the tile, the
// receivers' rows are its n8 columns, so 21 rows pad to 24 (three n8 tiles),
// not to 32 (two m16 tiles). A: shared memory, row stride lda (even;
// tc_ld's); W: row-major (256, 256), 16-byte aligned; ring: tc_ring_floats.
// Every lane of every warp takes part; no block barrier inside (the caller's
// barriers order A and the outputs). Accumulation: the tensor cores add into
// their accumulator with truncation, so 96 mma into one running sum drift
// (2.2e-6 of max |ref| from float64 at 21 rows, against 7.5e-7 for the CUDA
// cores' f32 product; tools/mma_bench.py). Each chunk of kTcSumSteps k-steps
// therefore sums in a chain of mma from zero and joins the running sum by an
// f32 add (3.7e-7): a chain keeps the tensor cores busy, where an add after
// every k-step waits on each mma and was slower. kPasses: 3, or 2 for a W of
// bf16 values (its hi only; tc_passes), or 1 for a W of bf16 values and A
// rounded to bf16 as it is read (resid_ef's bf16 tier: exact products).
// kWarps: the ring's warp slots (tc_ring_floats<kWarps>); kTcWarps takes the
// block's warps as it runs, at most 16 (the 512-thread blocks); fewer, such as
// K1's kTcFwdWarps, takes exactly that many, each warp then taking kTcStrips /
// kWarps strips in turn.
template <int kTiles, int kPasses = 3, int kWarps = kTcWarps, class ST>
__device__ __forceinline__ void mm_tc(int n, const float* A, int lda,
                                      const float* __restrict__ W, float* ring, ST st) {
  constexpr int kSteps = kTcK / 8;
  static_assert(kPasses >= 1 && kPasses <= 3, "3 passes, 2 with W exact, 1 with both exact");
  static_assert((kTcStages & (kTcStages - 1)) == 0, "the ring's slot is a mask");
  static_assert(kSteps % kTcSumSteps == 0, "whole chunks");
  static_assert(kWarps <= kTcWarps && kTcStrips % kWarps == 0, "whole strips per warp");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = kWarps == kTcWarps ? blockDim.x >> 5 : kWarps;
  const int g = lane >> 2, t = lane & 3;
  float* my = ring + warp * (kTcStages * kTcStage);
  // this lane's 16-byte copy of a stage: row lane / 4, columns 4 (lane % 4) ...
  const int ck = lane >> 2, cc = 4 * (lane & 3);
  const int cdst = tc_stage_at(ck, cc);
  // ... its fragments of W^T (the mma's A): k slots t, t + 4 are W's rows 2t,
  // 2t + 1 of a step, tile rows g, g + 8 its strip columns g, g + 8
  int woff[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) woff[q] = tc_stage_at(2 * t + (q >> 1), g + 8 * (q & 1));
  // ... and its A rows (the mma's B), at the k slots' columns (null: a row
  // past n, read as zeros)
  const float* pa[kTiles];
#pragma unroll
  for (int ni = 0; ni < kTiles; ++ni) {
    const int r = 8 * ni + g;
    pa[ni] = r < n ? A + (size_t)r * lda + 2 * t : nullptr;
  }
  for (int strip = warp; strip < kTcStrips; strip += nwarp) {
    const int c0 = strip * kTcStrip;
    const float* src = W + (size_t)ck * kTcK + c0 + cc;
#pragma unroll
    for (int s = 0; s < kTcStages - 1; ++s) {
      cp_async16(my + s * kTcStage + cdst, src + (size_t)s * 8 * kTcK);
      cp_async_commit();
    }
    float acc[kTiles][4];  // the running sums
#pragma unroll
    for (int ni = 0; ni < kTiles; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[ni][q] = 0.f;
    for (int k0 = 0; k0 < kSteps; k0 += kTcSumSteps) {
      float part[kTiles][4] = {};  // this chunk's sums: a chain of mma on the tensor cores
      for (int ks = k0; ks < k0 + kTcSumSteps; ++ks) {
        const int nx = ks + kTcStages - 1;
        if (nx < kSteps)
          cp_async16(my + (nx & (kTcStages - 1)) * kTcStage + cdst, src + (size_t)nx * 8 * kTcK);
        cp_async_commit();  // an empty group at the tail keeps the count
        cp_async_wait<kTcStages - 1>();
        __syncwarp();
        const float* sb = my + (ks & (kTcStages - 1)) * kTcStage;
        uint32_t wh[4], wl[4];  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
        if constexpr (kPasses == 3) {
          tf32_split(sb[woff[0]], wh[0], wl[0]);
          tf32_split(sb[woff[1]], wh[1], wl[1]);
          tf32_split(sb[woff[2]], wh[2], wl[2]);
          tf32_split(sb[woff[3]], wh[3], wl[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) wh[q] = tf32_exact(sb[woff[q]]);
        }
#pragma unroll
        for (int ni = 0; ni < kTiles; ++ni) {
          float2 x = make_float2(0.f, 0.f);
          if (pa[ni]) x = *reinterpret_cast<const float2*>(pa[ni] + 8 * ks);
          if constexpr (kPasses == 1) {  // bf16(a) hi(w): exact
            mma_tf32(part[ni], wh, tf32_exact(bf16r(x.x)), tf32_exact(bf16r(x.y)));
          } else {
            uint32_t xh0, xl0, xh1, xl1;
            tf32_split(x.x, xh0, xl0);
            tf32_split(x.y, xh1, xl1);
            if constexpr (kPasses == 3) {
              mma_tf32x3(part[ni], wh, wl, xh0, xh1, xl0, xl1);
            } else {  // hi(w) lo(a), then hi(w) hi(a)
              mma_tf32(part[ni], wh, xl0, xl1);
              mma_tf32(part[ni], wh, xh0, xh1);
            }
          }
        }
        __syncwarp();  // the stage is free before a later step's copy lands in it
      }
#pragma unroll
      for (int ni = 0; ni < kTiles; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[ni][q] += part[ni][q];
    }
    cp_async_wait<0>();
#pragma unroll
    for (int ni = 0; ni < kTiles; ++ni) {  // d (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
      const int r = 8 * ni + 2 * t, c = c0 + g;
      if (r < n) {
        st(r, c, acc[ni][0]);
        st(r, c + 8, acc[ni][2]);
      }
      if (r + 1 < n) {
        st(r + 1, c, acc[ni][1]);
        st(r + 1, c + 8, acc[ni][3]);
      }
    }
  }
}

// The small products of a row (the edge MLP's o_f and o1, k and columns 50
// or 64) in 3xTF32: out(r, c) = sum_k A(r, k) W(k, c) for r < n, k < kd <=
// kTcSmallK, c < m, each to st(r, c, value). A: shared memory, row stride lda;
// W: row-major (kd, m) in device memory, small enough (16 KB at most) to be
// read through the L1 cache per fragment. k and c are padded to 8 with
// zeros. A warp takes one (m16 tile, n8 tile) pair at a time, so a 21-row
// product of 64 columns keeps all 16 warps busy (the CUDA-core tiling kept 48
// threads busy there). The three passes sum in accumulators of their own,
// added at the end, so a warp's chain of dependent mma is a third as long.
// kPasses (tc_passes): 3; 2 for a W of bf16 values (lo(a) hi(w) + hi(a)
// hi(w)); 1 for bf16 values on both sides, each A(r, k) rounded to bf16 as it
// is read (hi(a) hi(w), exact).
template <int kPasses = 3, class ST>
__device__ __forceinline__ void mm_tc_small(int n, int kd, int m, const float* A, int lda,
                                            const float* __restrict__ W, ST st) {
  static_assert(kPasses >= 1 && kPasses <= 3, "1, 2 or 3 passes");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ntn = (m + 7) >> 3, tasks = ntn * ((n + 15) >> 4);
  for (int task = warp; task < tasks; task += nwarp) {
    const int c0 = 8 * (task % ntn), r0 = 16 * (task / ntn);
    const int cb = c0 + g, ra = r0 + g, rb = ra + 8;  // this lane's W column, A rows
    float acc[3][4] = {};  // lo * hi, hi * lo, hi * hi
#pragma unroll
    for (int s = 0; s < kTcSmallK / 8; ++s) {
      const int k1 = 8 * s + 2 * t, k2 = k1 + 1;  // k slots t, t + 4
      if (8 * s < kd) {
        const float w1 = cb < m && k1 < kd ? __ldg(W + (size_t)k1 * m + cb) : 0.f;
        const float w2 = cb < m && k2 < kd ? __ldg(W + (size_t)k2 * m + cb) : 0.f;
        const float a0 = ra < n && k1 < kd ? A[(size_t)ra * lda + k1] : 0.f;
        const float a1 = rb < n && k1 < kd ? A[(size_t)rb * lda + k1] : 0.f;
        const float a2 = ra < n && k2 < kd ? A[(size_t)ra * lda + k2] : 0.f;
        const float a3 = rb < n && k2 < kd ? A[(size_t)rb * lda + k2] : 0.f;
        uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
        if constexpr (kPasses == 3) {
          tf32_split(a0, ah[0], al[0]);
          tf32_split(a1, ah[1], al[1]);
          tf32_split(a2, ah[2], al[2]);
          tf32_split(a3, ah[3], al[3]);
          tf32_split(w1, bh0, bl0);
          tf32_split(w2, bh1, bl1);
          mma_tf32(acc[0], al, bh0, bh1);
          mma_tf32(acc[1], ah, bl0, bl1);
          mma_tf32(acc[2], ah, bh0, bh1);
        } else if constexpr (kPasses == 2) {
          tf32_split(a0, ah[0], al[0]);
          tf32_split(a1, ah[1], al[1]);
          tf32_split(a2, ah[2], al[2]);
          tf32_split(a3, ah[3], al[3]);
          bh0 = tf32_exact(w1);
          bh1 = tf32_exact(w2);
          mma_tf32(acc[0], al, bh0, bh1);
          mma_tf32(acc[2], ah, bh0, bh1);
        } else {
          ah[0] = tf32_exact(bf16r(a0));
          ah[1] = tf32_exact(bf16r(a1));
          ah[2] = tf32_exact(bf16r(a2));
          ah[3] = tf32_exact(bf16r(a3));
          mma_tf32(acc[2], ah, tf32_exact(w1), tf32_exact(w2));
        }
      }
    }
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (kPasses == 3) o[q] = (acc[0][q] + acc[1][q]) + acc[2][q];
      else if constexpr (kPasses == 2) o[q] = acc[0][q] + acc[2][q];
      else o[q] = acc[2][q];
    }
    const int c = c0 + 2 * t;
    if (ra < n) {
      if (c < m) st(ra, c, o[0]);
      if (c + 1 < m) st(ra, c + 1, o[1]);
    }
    if (rb < n) {
      if (c < m) st(rb, c, o[2]);
      if (c + 1 < m) st(rb, c + 1, o[3]);
    }
  }
}

}  // namespace sake
