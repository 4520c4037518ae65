// Shared pieces of the resid_ef kernels: leaf/residual tables and the
// block-level products both kernels are built from.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "probe.cuh"

namespace sake {

constexpr int kLeaves = 29;
constexpr int kResids = 17;

// Order of sake_tpu_torch.kernels.leaves.LEAF_NAMES.
enum Leaf {
  W_IN_J, W_IN_I, B_IN, RBF_M, RBF_B,
  W_O_J, W_O_I, W_O_F, W_O_R, B_O0, W_O1, B_O1,
  W_SEM, B_SEM, W_XMIX,
  W_POST0, B_POST0, W_POST1, B_POST1,
  W_NODE_H, W_NODE_AGG, W_NODE_COMB, B_NODE0, W_NODE1, B_NODE1,
  W_VMIX, W_VEL0, B_VEL0, W_VEL1
};

// Order of EDGE_RESIDS + NODE_RESIDS in sake_tpu_torch.kernels.resid_ef.
enum Resid {
  RS_R, RS_T, RS_RBF, RS_E0, RS_H_E, RS_SEM_PRE, RS_ATT, RS_COEFF,
  RS_POOL0, RS_POOL1, RS_POOL2, RS_PS0, RS_PS1, RS_NODE_PRE, RS_UV,
  RS_G0, RS_G1
};

// Order of ROWS (EDGE_ROWS + NODE_ROWS) in sake_tpu_torch.kernels.resid_ef:
// the cotangent rows the training pullback writes for the parameter
// gradients. Edge rows are (depth, B, N*N, ch), node rows (depth, B, N, ch).
constexpr int kRows = 20;
enum Row {
  RW_DE0, RW_DHE, RW_DSEM, RW_DXM, RW_ATT2, RW_FILT, RW_DRBF,
  RW_DAJ, RW_DAI, RW_DOJ, RW_DOI, RW_DPS0, RW_DPS1, RW_DNP, RW_DUV, RW_DG0,
  RW_DG1, RW_DDEL, RW_HATT, RW_PSQ
};

struct Rows {
  float* p[kRows];
};

struct Leaves {
  const float* p[kLeaves];
  long long stride[kLeaves];  // elements per layer
  __device__ __forceinline__ const float* at(int leaf, int layer) const {
    return p[leaf] + stride[leaf] * layer;
  }
};

struct Resids {
  float* p[kResids];
};

// An element of a bf16 residual stream (resid_ef's bf16 tier): the upper 16
// bits of bf16r's value. It is read and written only through get_res and
// put_res.
struct Bf16 {
  unsigned short bits;
};

// The residual table of resid_ef's bf16 tier: every stream but r and t holds
// Bf16 elements (p[RS_R] and p[RS_T] are null); r and t stay f32.
struct Resids16 {
  Bf16* p[kResids];
  float* r;
  float* t;
};
// The table of a tier: Resids16 in the bf16 one (kLow), else Resids.
template <bool kLow>
using ResidsOf = std::conditional_t<kLow, Resids16, Resids>;
// The element type of a low-precision stream of a tier.
template <bool kLow>
using ResOf = std::conditional_t<kLow, Bf16, float>;

// The f32 streams r and t of either table.
__host__ __device__ __forceinline__ float* res_r(const Resids& R) { return R.p[RS_R]; }
__host__ __device__ __forceinline__ float* res_t(const Resids& R) { return R.p[RS_T]; }
__host__ __device__ __forceinline__ float* res_r(const Resids16& R) { return R.r; }
__host__ __device__ __forceinline__ float* res_t(const Resids16& R) { return R.t; }

struct Dims {
  int B, N, F, H, R, K, C, depth;
};

// The tables as the host passes them: arrays of device pointers (and each
// leaf's elements per layer).
inline Leaves leaves_of(const void* const* ptrs, const long long* strides) {
  Leaves L;
  for (int i = 0; i < kLeaves; ++i) {
    L.p[i] = static_cast<const float*>(ptrs[i]);
    L.stride[i] = strides[i];
  }
  return L;
}
inline Resids resids_of(void* const* ptrs) {
  Resids R;
  for (int i = 0; i < kResids; ++i) R.p[i] = static_cast<float*>(ptrs[i]);
  return R;
}
inline Resids16 resids16_of(void* const* ptrs) {
  Resids16 R;
  for (int i = 0; i < kResids; ++i)
    R.p[i] = i == RS_R || i == RS_T ? nullptr : static_cast<Bf16*>(ptrs[i]);
  R.r = static_cast<float*>(ptrs[RS_R]);
  R.t = static_cast<float*>(ptrs[RS_T]);
  return R;
}
// The table of either tier: Resids16 with kLow, else Resids.
template <bool kLow>
inline ResidsOf<kLow> resids_as(void* const* ptrs) {
  if constexpr (kLow) return resids16_of(ptrs);
  else return resids_of(ptrs);
}
// The table of a forward that keeps no residuals: only the pooled vectors, in
// a one-layer (3, B, N, C) scratch.
inline Resids pool_resids(float* pool, const Dims& d) {
  Resids R{};
  const size_t plane = (size_t)d.B * d.N * d.C;
  R.p[RS_POOL0] = pool;
  R.p[RS_POOL1] = pool + plane;
  R.p[RS_POOL2] = pool + 2 * plane;
  return R;
}
inline Rows rows_of(void* const* ptrs) {
  Rows R;
  for (int i = 0; i < kRows; ++i) R.p[i] = static_cast<float*>(ptrs[i]);
  return R;
}

// Layer l's leaves, as the layer-0 leaves of a one-layer stack.
__host__ __device__ inline Leaves layer_of(const Leaves& L, int l) {
  Leaves out = L;
  for (int i = 0; i < kLeaves; ++i) out.p[i] = L.p[i] + L.stride[i] * l;
  return out;
}

// Width of residual stream r (node_channels / edge_channels in resid_ef.py).
__host__ __device__ inline int resid_width(int r, const Dims& d) {
  switch (r) {
    case RS_RBF: return d.R;
    case RS_E0: case RS_H_E: case RS_PS0: case RS_PS1: case RS_NODE_PRE: case RS_G0: return d.H;
    case RS_SEM_PRE: case RS_ATT: return d.K;
    case RS_COEFF: case RS_POOL0: case RS_POOL1: case RS_POOL2: return d.C;
    case RS_UV: return d.F;
    default: return 1;  // r, t, g1
  }
}

// Layer l of (depth, B, ...) residual streams, as a one-layer stack.
__host__ __device__ inline Resids layer_of(const Resids& R, const Dims& d, int l) {
  Resids out;
  for (int r = 0; r < kResids; ++r) {
    const long long rows = (long long)d.B * d.N * (r <= RS_COEFF ? d.N : 1);
    out.p[r] = R.p[r] + (long long)l * rows * resid_width(r, d);
  }
  return out;
}

constexpr float kEps = 1e-5f;  // inside the distance sqrt
constexpr float kInf = 1e5f;   // subtracted from self-pair and masked logits

// With an edge mask (B, N, N), pooled sums divide by the receiver's sender
// count + 1e-8 and the velocity update by count + 1e-10; without, both by N.
__device__ __forceinline__ float pool_denom(bool masked, float count, float n) {
  return masked ? count + 1e-8f : n;
}
__device__ __forceinline__ float dv_denom(bool masked, float count, float n) {
  return masked ? count + 1e-10f : n;
}

// cnt[i] = sum_j mask[i, j] for one molecule's (N, N) mask (0 without one).
__device__ __forceinline__ void sender_counts(const float* __restrict__ mask, int N,
                                              float* cnt) {
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float c = 0.f;
    if (mask)
      for (int j = 0; j < N; ++j) c += mask[i * N + j];
    cnt[i] = c;
  }
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float siluf_(float x) { return x * sigmoidf_(x); }
__device__ __forceinline__ float dsiluf_(float x) {
  const float s = sigmoidf_(x);
  return s * (1.f + x * (1.f - s));
}

// A dual number, a value and its tangent, for the forward-mode (jvp) kernels.
struct Dl {
  float v, t;
};
__device__ __forceinline__ Dl operator+(Dl a, Dl b) { return {a.v + b.v, a.t + b.t}; }
__device__ __forceinline__ Dl operator-(Dl a, Dl b) { return {a.v - b.v, a.t - b.t}; }
__device__ __forceinline__ Dl operator-(Dl a) { return {-a.v, -a.t}; }
__device__ __forceinline__ Dl operator-(Dl a, float s) { return {a.v - s, a.t}; }
__device__ __forceinline__ Dl operator*(Dl a, Dl b) { return {a.v * b.v, a.v * b.t + a.t * b.v}; }
__device__ __forceinline__ Dl operator*(float s, Dl a) { return {s * a.v, s * a.t}; }
__device__ __forceinline__ Dl operator*(Dl a, float s) { return {s * a.v, s * a.t}; }
__device__ __forceinline__ Dl& operator+=(Dl& a, Dl b) {
  a.v += b.v;
  a.t += b.t;
  return a;
}
__device__ __forceinline__ Dl silu_d(Dl x) { return {siluf_(x.v), dsiluf_(x.v) * x.t}; }
// silu'(x) and its tangent: silu''(x) = s (1 - s) (2 + x (1 - 2 s))
__device__ __forceinline__ Dl dsilu_d(Dl x) {
  const float s = sigmoidf_(x.v);
  return {s * (1.f + x.v * (1.f - s)), s * (1.f - s) * (2.f + x.v * (1.f - 2.f * s)) * x.t};
}
__device__ __forceinline__ Dl sigmoid_d(Dl x) {
  const float s = sigmoidf_(x.v);
  return {s, s * (1.f - s) * x.t};
}

// x rounded to the nearest bf16 value (ties to even), kept as a float: the
// operand rounding of the bf16 products (torch's and JAX's rounding, for
// finite x). A product of two such values is exact in f32.
__device__ __forceinline__ float bf16r(float x) {
  unsigned u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// bf16r(x) in a body's bf16 instantiation, x itself in its f32 one.
template <bool kBf16>
__device__ __forceinline__ float rd(float x) {
  if constexpr (kBf16) return bf16r(x);
  else return x;
}

// Element i of a residual stream: an f32 one, or a bf16 one of resid_ef's
// bf16 tier (put_res rounds to nearest, ties to even, as bf16r).
template <class I>
__device__ __forceinline__ void put_res(float* p, I i, float v) {
  p[i] = v;
}
template <class I>
__device__ __forceinline__ void put_res(Bf16* p, I i, float v) {
  p[i].bits = (unsigned short)(__float_as_uint(bf16r(v)) >> 16);
}
template <class I>
__device__ __forceinline__ float get_res(const float* p, I i) {
  return p[i];
}
template <class I>
__device__ __forceinline__ float get_res(const Bf16* p, I i) {
  return __uint_as_float((unsigned)p[i].bits << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kTileRows = 7;  // divides aspirin's N = 21: no idle rows

// Block-level products out(r, c) = sum_k A(r, k) * W[k * m + c] for r < n,
// c < m, each output handed to st(r, c, value). W is row-major (kd, m) in
// device memory (L2-resident), A lives in shared memory. Every variant
// sums over k in order. With kRoundA each A(r, k) is rounded to bf16 as it
// is read (the bf16 products; W is passed already rounded).
//
// Register-tiled: each thread owns kTileRows rows and CT (2 or 4)
// adjacent columns and reads A (row stride lda) as float4, so one shared
// load feeds 4 * CT FMAs. Needs kd, m and lda to be multiples of 4 and
// 16-byte aligned A and W.
template <int CT, bool kRoundA = false, class ST>
__device__ __forceinline__ void mm_tiled(int n, int kd, int m, const float* A, int lda,
                                         const float* __restrict__ W, ST st) {
  static_assert(CT == 2 || CT == 4, "column tile is a float2 or a float4");
  const int mc = m / CT;
  const int nch = (n + kTileRows - 1) / kTileRows;
  for (int it = threadIdx.x; it < nch * mc; it += blockDim.x) {
    const int c = (it % mc) * CT;
    const int r0 = (it / mc) * kTileRows;
    float acc[kTileRows][CT];
#pragma unroll
    for (int q = 0; q < kTileRows; ++q)
#pragma unroll
      for (int t = 0; t < CT; ++t) acc[q][t] = 0.f;
    for (int k = 0; k < kd; k += 4) {
      float w[4][CT];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* wk = W + (size_t)(k + u) * m + c;
        if constexpr (CT == 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(wk));
          w[u][0] = v.x; w[u][1] = v.y; w[u][2] = v.z; w[u][3] = v.w;
        } else {
          const float2 v = __ldg(reinterpret_cast<const float2*>(wk));
          w[u][0] = v.x; w[u][1] = v.y;
        }
      }
#pragma unroll
      for (int q = 0; q < kTileRows; ++q) {
        float4 a = *reinterpret_cast<const float4*>(A + (size_t)min(r0 + q, n - 1) * lda + k);
        if constexpr (kRoundA) {
          a.x = bf16r(a.x); a.y = bf16r(a.y); a.z = bf16r(a.z); a.w = bf16r(a.w);
        }
#pragma unroll
        for (int t = 0; t < CT; ++t) {
          acc[q][t] = fmaf(a.x, w[0][t], acc[q][t]);
          acc[q][t] = fmaf(a.y, w[1][t], acc[q][t]);
          acc[q][t] = fmaf(a.z, w[2][t], acc[q][t]);
          acc[q][t] = fmaf(a.w, w[3][t], acc[q][t]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kTileRows; ++q) {
      const int r = r0 + q;
      if (r < n) {
#pragma unroll
        for (int t = 0; t < CT; ++t) st(r, c + t, acc[q][t]);
      }
    }
  }
}

// One output per thread: out(r, c) as a dot product over k. A warp covers
// consecutive columns of one row, so A is a broadcast and W coalesced.
// For products of medium width (m = 50 or 64 here), where the tiled
// product would leave most of the block idle.
template <class AF, class ST>
__device__ __forceinline__ void mm_cols(int n, int kd, int m, AF A,
                                        const float* __restrict__ W, ST st) {
  for (int it = threadIdx.x; it < n * m; it += blockDim.x) {
    const int r = it / m, c = it % m;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < kd; ++k) acc = fmaf(A(r, k), __ldg(W + (size_t)k * m + c), acc);
    st(r, c, acc);
  }
}

// One warp per row for very narrow products (m <= 8, e.g. the 4 semantic
// heads): lanes split k, a shuffle tree sums the partials.
template <bool kRoundA = false, class ST>
__device__ __forceinline__ void mm_warp(int n, int kd, int m, const float* A, int lda,
                                        const float* __restrict__ W, ST st) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n; r += blockDim.x >> 5) {
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    for (int k = lane; k < kd; k += 32) {
      const float a = rd<kRoundA>(A[r * lda + k]);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c < m) acc[c] = fmaf(a, __ldg(W + (size_t)k * m + c), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c < m) {
        const float v = warp_sum(acc[c]);
        if (lane == 0) st(r, c, v);
      }
    }
  }
}

// A @ W for A in shared memory, picked by width (uniform across the block):
// register-tiled with CT-column tiles for products at least MinCols wide
// when widths and alignments allow, a warp per row for m <= 8, else one
// output per thread. Each kernel fixes both for its block size; measured
// on an H100 at aspirin's widths: K1 (256 threads) is fastest with 4-column
// tiles for every product from 16 columns up, K2 (512 threads) with
// 2-column tiles for the products of 128 columns and more only.
template <int CT, int MinCols, bool kRoundA = false, class ST>
__device__ __forceinline__ void mm_smem(int n, int kd, int m, const float* A, int lda,
                                        const float* __restrict__ W, ST st) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(W);
  const bool aligned = (addr & 15) == 0;
  if (m >= MinCols && aligned && ((kd | m | lda) & 3) == 0) {
    mm_tiled<CT, kRoundA>(n, kd, m, A, lda, W, st);
  } else if (m <= 8) {
    mm_warp<kRoundA>(n, kd, m, A, lda, W, st);
  } else {
    mm_cols(n, kd, m, [&](int r, int k) { return rd<kRoundA>(A[r * lda + k]); }, W, st);
  }
}

// dst[0:n] = src[0:n], shared <- device, in float4 where alignment allows.
__device__ __forceinline__ void load_smem(float* dst, const float* src, int n) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src);
  if (((addr & 15) | (n & 3)) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int e = threadIdx.x; e < (n >> 2); e += blockDim.x) d4[e] = s4[e];
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
  }
}

// dst[0:n] = n elements of a bf16 residual stream from src, widened to f32.
__device__ __forceinline__ void load_low(float* dst, const Bf16* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = get_res(src, e);
}

// Carves 16-byte-aligned float buffers out of dynamic shared memory. With
// a null base it only counts, which is how the host sizes the allocation
// with the same code the kernel uses.
struct Carver {
  float* base;
  long long off = 0;
  __host__ __device__ float* take(long long n) {
    float* p = base ? base + off : nullptr;
    off += (n + 3) & ~3LL;
    return p;
  }
};

}  // namespace sake
