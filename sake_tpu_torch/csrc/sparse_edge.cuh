// The per-receiver-row edge chain of the cutoff-sparse layer and its
// hand-written pullback: the body of the sparse edge kernels #13-#15
// (sparse_fwd.cu, sparse_bwd.cu, sparse_bwd2.cu).
//
// Port of sake_tpu/kernels/sparse_ef.py: _edge_chain (:108-170) and
// _edge_pullback (:173-304), followed line by line. One block owns one
// receiver row at a time, because the semantic softmax and its mask
// renormalisation run over the row's K neighbour slots. The body is a
// template on its scalar type T: float for the forward (#13) and the
// pullback (#14), and the dual number Dl for #15, which runs the same
// chain and pullback forward-over-reverse (values plus tangents along the
// incoming cotangents), so that the tangent of every output is the VJP the
// JAX kernel takes with jax.vjp (see sparse_bwd2.cu).
//
// Shared memory holds the row's narrow edge intermediates (K x R, K x H,
// K x heads). The narrow products run on the CUDA cores: mmT streams its
// weight from L2, mm_wide stages 16 rows of it at a time in shared memory, and
// each thread keeps a small tile of outputs in registers. The wide part (the
// head expansion he_att, K x HK, and the x-mixing product, K x C, whose weight
// w_xmix is HK x C = 256 KB) runs on the tensor cores (wgmma_tf32.cuh), up to
// 64 rows at a time as the M tile of one product, so the weight streams from
// L2 once per tile and product. #13 and #14 (float) put up to 64 slots in a
// tile (edge_wide_wg); #15 (Dl) puts 32 slots' values and their tangents in
// one (edge_wide_dl). Every sum runs in a fixed order (one thread per output,
// no atomics), so results do not vary from run to run. The block synchronises
// by __syncthreads and the product ring's mbarriers. To fit long rows beside
// the 66.5 KB product tile, the route lays the buffers that its wide part never
// touches over that tile and its ring (carve_wg).
#pragma once

#include <type_traits>

#include "resid_common.cuh"
#include "wgmma_tf32.cuh"

namespace sake {

constexpr int kEdgeThreads = 256;
constexpr int kEdgeRows = 12;  // the cotangent rows the parameter gradients contract

// Order of EDGE_ROWS in sake_tpu_torch/kernels/sparse_ef.py.
enum EdgeRow {
  ER_D_PRE, ER_D_E0, ER_Q_M, ER_Q_B, ER_FILT, ER_R, ER_SE, ER_D_H_E, ER_H_E, ER_D_SEM,
  ER_HE_ATT, ER_D_XM
};

struct EDims {
  int NR, K, F, R, H, Kh, C;
};

// The 11 edge leaves (EDGE_LEAVES order, row-major (in, out)) and the
// transposes the pullback's products read.
struct EdgeW {
  const float *w_in_j, *w_o_j, *rbf_m, *rbf_b, *w_o_f, *w_o_r, *w_o1, *b_o1, *w_sem, *b_sem,
      *w_xmix;
  const float *t_in_j, *t_o_j, *t_o_f, *t_o1, *t_sem, *t_xmix;
};
constexpr int kEdgeWPtrs = 17;

// Whether the edge kernels take these widths on the tensor cores: the
// x-mixing product's H * heads = C = 256 (wgmma_tf32.cuh).
__host__ __device__ inline bool wg_dims(const EDims& d) {
  return d.H * d.Kh == kWgDepth && d.C == kWgCols;
}

// The packed hi and lo TF32 planes of the x-mixing weight that the edge
// kernels read on the tensor cores (sparse_ef.xmix_planes): the forward's (t_xmix
// rows) and the pullback's (w_xmix rows). They follow the 17 weight pointers.
struct WgPlanes {
  const float *fwd, *bwd;
};

struct EdgeArgs {
  EDims d;
  // inputs: h_g (NR, K, F), a_i (NR, R), o_i (NR, H), d0 (3, NR, K), m (NR, K)
  const float *hg, *ai, *oi, *d0, *m;
  // their tangents (the cotangents c of #15), or null
  const float *c_hg, *c_ai, *c_oi, *c_d0;
  EdgeW W;
  // cotangents on the chain's outputs: pooled (3, NR, C), hatt (NR, HK)
  const float *gp, *gh;
  // outputs: the chain's pooled (3, NR, C) and hatt (NR, HK), the pullback's
  // d_hg (NR, K, F), d_ai (NR, R), d_oi (NR, H), d_d0 (3, NR, K); with Dl the
  // tangents of each
  float *pooled, *hatt, *d_hg, *d_ai, *d_oi, *d_d0;
  // rows (E, width) with E = NR * K; with Dl also their tangents
  float* rows[kEdgeRows];
  float* t_rows[kEdgeRows];
};

// ---- scalar helpers for float and Dl ---------------------------------------
__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dl x) { return x.v; }
template <class T> __device__ __forceinline__ T mk(float v, float t);
template <> __device__ __forceinline__ float mk<float>(float v, float) { return v; }
template <> __device__ __forceinline__ Dl mk<Dl>(float v, float t) { return {v, t}; }
template <class T>
__device__ __forceinline__ T ld(const float* v, const float* t, size_t i) {
  return mk<T>(v[i], t ? t[i] : 0.f);
}
__device__ __forceinline__ void put(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void put(float* p, size_t i, Dl x) { p[i] = x.t; }  // tangents out
__device__ __forceinline__ void put_row(const EdgeArgs& A, int k, size_t i, float x) {
  A.rows[k][i] = x;
}
__device__ __forceinline__ void put_row(const EdgeArgs& A, int k, size_t i, Dl x) {
  A.rows[k][i] = x.v;
  A.t_rows[k][i] = x.t;
}

__device__ __forceinline__ Dl operator+(Dl a, float s) { return {a.v + s, a.t}; }
__device__ __forceinline__ Dl operator-(float s, Dl a) { return {s - a.v, -a.t}; }
__device__ __forceinline__ Dl operator/(Dl a, Dl b) {
  const float q = a.v / b.v;
  return {q, (a.t - q * b.t) / b.v};
}
__device__ __forceinline__ Dl operator/(float s, Dl b) {
  const float q = s / b.v;
  return {q, -q * b.t / b.v};
}

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ Dl exp_(Dl x) {
  const float e = expf(x.v);
  return {e, e * x.t};
}
__device__ __forceinline__ float tanh_(float x) { return tanhf(x); }
__device__ __forceinline__ Dl tanh_(Dl x) {
  const float y = tanhf(x.v);
  return {y, (1.f - y * y) * x.t};
}
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ Dl sqrt_(Dl x) {
  const float s = sqrtf(x.v);
  return {s, 0.5f * x.t / s};
}
// relu with a zero derivative at 0, as jax.nn.relu
__device__ __forceinline__ float relu_(float x) { return x > 0.f ? x : 0.f; }
__device__ __forceinline__ Dl relu_(Dl x) { return x.v > 0.f ? x : Dl{0.f, 0.f}; }
__device__ __forceinline__ float silu_(float x) { return siluf_(x); }
__device__ __forceinline__ Dl silu_(Dl x) { return silu_d(x); }
__device__ __forceinline__ float dsilu_(float x) { return dsiluf_(x); }
__device__ __forceinline__ Dl dsilu_(Dl x) { return dsilu_d(x); }
// celu with alpha 2, and its derivative, branching on the value
template <class T> __device__ __forceinline__ T celu2_(T x) {
  return val(x) > 0.f ? x : 2.f * (exp_(0.5f * x) - 1.f);
}
template <class T> __device__ __forceinline__ T dcelu2_(T x) {
  return val(x) > 0.f ? mk<T>(1.f, 0.f) : exp_(0.5f * x);
}

template <class T> struct RowTile { static constexpr int value = 8; };
template <> struct RowTile<Dl> { static constexpr int value = 4; };
constexpr int kWStage = 4;  // float4s of a W tile each thread stages (mm_wide)

// out(r, c) = sum_k A(r, k) * W[k * m + c] for r < n, c < m, handed to
// st(r, c, value). W (row-major, float) streams from L2; A(r, k) reads
// shared memory. Each thread keeps RT rows of one column in registers, so
// one W load feeds RT multiply-adds; a warp covers consecutive columns of
// the same rows (W coalesced, A a broadcast). Sums run over k in order.
template <class T, int RT = RowTile<T>::value, class AF, class ST>
__device__ __forceinline__ void mmT(int n, int kd, int m, AF A, const float* __restrict__ W,
                                    ST st) {
  const int ng = (n + RT - 1) / RT;
  for (int it = threadIdx.x; it < ng * m; it += blockDim.x) {
    const int c = it % m, r0 = (it / m) * RT;
    T acc[RT];
#pragma unroll
    for (int q = 0; q < RT; ++q) acc[q] = mk<T>(0.f, 0.f);
    for (int k = 0; k < kd; ++k) {
      const float w = __ldg(W + (size_t)k * m + c);
#pragma unroll
      for (int q = 0; q < RT; ++q) acc[q] += A(min(r0 + q, n - 1), k) * w;
    }
#pragma unroll
    for (int q = 0; q < RT; ++q)
      if (r0 + q < n) st(r0 + q, c, acc[q]);
  }
}

constexpr int kWTile = 16;  // rows of W a wide product stages at a time

// The products whose width is a multiple of 4 (the edge row's H- and F-wide
// ones, and the split path's x-mixing, split_edge.cuh): out(r, c) =
// sum_k A[r * lda + k] * W[k * m + c], with kWTile rows of W staged in
// shared memory (Ws, kWTile * m floats) at a time, so each W element is read
// from L2 once per call, and each thread keeping a 4 x 4 tile of outputs in
// registers. The next tile's L2 loads are issued into registers before the
// current tile is computed, so they land while it runs. The k loop steps
// by 4: four float4 W loads and sixteen A loads are issued before their 64
// multiply-adds, so the few warps of a block overlap their shared-memory
// latency. Needs m and kd multiples of 4, at most one 4 x 4 tile and
// kWStage staged float4s per thread, and a 16-byte aligned W; otherwise it
// is mmT. Sums run over k in order. Every thread reaches every barrier.
template <class T, class ST>
__device__ __forceinline__ void mm_wide(int n, int kd, int m, const T* A, int lda,
                                        const float* __restrict__ W, float* Ws, ST st) {
  const int mc = m / 4, ng = (n + 3) / 4;
  if ((m & 3) || (kd & 3) || ng * mc > (int)blockDim.x ||
      kWTile * mc > kWStage * (int)blockDim.x || (reinterpret_cast<uintptr_t>(W) & 15)) {
    mmT<T>(n, kd, m, [&](int r, int k) { return A[r * lda + k]; }, W, st);
    return;
  }
  const int it = threadIdx.x;
  const bool active = it < ng * mc;
  const int c4 = it % mc, r0 = (it / mc) * 4;
  T acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[q][t] = mk<T>(0.f, 0.f);
  float4 next[kWStage];  // this thread's float4s of the next tile
  auto fetch = [&](int k0) {
    const int nv = min(kWTile, kd - k0) * mc;
    const float4* src = reinterpret_cast<const float4*>(W + (size_t)k0 * m);
#pragma unroll
    for (int v = 0; v < kWStage; ++v) {
      const int e = threadIdx.x + v * blockDim.x;
      if (e < nv) next[v] = __ldg(src + e);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < kd; k0 += kWTile) {
    const int kt = min(kWTile, kd - k0);
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int v = 0; v < kWStage; ++v) {
      const int e = threadIdx.x + v * blockDim.x;
      if (e < kt * mc) reinterpret_cast<float4*>(Ws)[e] = next[v];
    }
    __syncthreads();
    if (k0 + kWTile < kd) fetch(k0 + kWTile);
    if (active) {
      for (int kk = 0; kk < kt; kk += 4) {
        float4 w[4];
        T a[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) w[u] = reinterpret_cast<const float4*>(Ws + (kk + u) * m)[c4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int u = 0; u < 4; ++u) a[q][u] = A[min(r0 + q, n - 1) * lda + k0 + kk + u];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q][0] += a[q][u] * w[u].x;
            acc[q][1] += a[q][u] * w[u].y;
            acc[q][2] += a[q][u] * w[u].z;
            acc[q][3] += a[q][u] * w[u].w;
          }
      }
    }
  }
  if (active)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r0 + q < n)
#pragma unroll
        for (int t = 0; t < 4; ++t) st(r0 + q, c4 * 4 + t, acc[q][t]);
}

// Shared-memory layout of one row, in units of T but for the cotangents gp and
// gh, which carry no tangent, and mm_wide's W tile: floats.
template <class T> struct ESmem {
  T *d0, *m, *r, *t, *ir, *u, *du, *dr;  // 3K, K, K, K, K, 3K, 3K, K
  T *ai, *oi;                             // R, H
  float *gp, *gh;                         // 3C, HK (cotangents)
  T *hg;                                  // K * max(F, H): h_g, then h_e
  T *pre, *rbf, *e0;                      // K*R, K*R, K*H (e0, then d_e0)
  T *dhe, *df;                            // K*H (silu(e0), then d_h_e), K*R (pullback)
  T *sem, *att, *att2, *datt2;            // K*Kh each
  T *den, *dg;                            // Kh each
  T *pool, *hatt;                         // 3C, HK (the chain's outputs)
  float* ws;                              // kWTile * max(F, H): mm_wide's W tile
};

template <class T>
__host__ __device__ inline T* take_t(Carver& cv, long long n) {
  return reinterpret_cast<T*>(cv.take(n * (long long)(sizeof(T) / sizeof(float))));
}

// The row's buffers but those that carve_wg places beside the tensor-core
// route's (pre, rbf, df, dr, ws: null here, where they stood before carve_wg
// took them, which keeps #14's SASS as it was); the chain's outputs only with
// kFwdOut.
template <class T, bool kPull, bool kFwdOut>
__host__ __device__ inline ESmem<T> carve_edge(Carver& cv, const EDims& d) {
  const long long K = d.K, HK = (long long)d.H * d.Kh;
  ESmem<T> S;
  S.d0 = take_t<T>(cv, 3 * K);
  S.m = take_t<T>(cv, K);
  S.r = take_t<T>(cv, K);
  S.t = take_t<T>(cv, K);
  S.ir = take_t<T>(cv, K);
  S.u = take_t<T>(cv, 3 * K);
  S.du = kPull ? take_t<T>(cv, 3 * K) : nullptr;
  S.dr = nullptr;
  S.ai = take_t<T>(cv, d.R);
  S.oi = take_t<T>(cv, d.H);
  S.gp = kPull ? cv.take(3LL * d.C) : nullptr;
  S.gh = kPull ? cv.take(HK) : nullptr;
  S.hg = take_t<T>(cv, K * (d.F > d.H ? d.F : d.H));
  S.pre = nullptr;
  S.rbf = nullptr;
  S.e0 = take_t<T>(cv, K * d.H);
  S.dhe = take_t<T>(cv, K * d.H);
  S.df = nullptr;
  S.sem = take_t<T>(cv, K * d.Kh);
  S.att = take_t<T>(cv, K * d.Kh);
  S.att2 = take_t<T>(cv, K * d.Kh);
  S.datt2 = kPull ? take_t<T>(cv, K * d.Kh) : nullptr;
  S.den = take_t<T>(cv, d.Kh);
  S.dg = take_t<T>(cv, d.Kh);
  S.pool = kFwdOut ? take_t<T>(cv, 3LL * d.C) : nullptr;
  S.hatt = kFwdOut ? take_t<T>(cv, HK) : nullptr;
  S.ws = nullptr;
  return S;
}

// The tensor-core route's buffers beside the row's: the products' 64-slot
// output tile X (row stride kWgCols + kWgXPad, so that a warp's A fragment
// reads hit 32 banks), the ring of B stages and its barriers, and the planes;
// recompute: pre and rbf lie under X and the ring, and the tail remakes them
// (#14) or reads them back from the rows where they were parked (#15; carve_wg).
struct WgCtx {
  float* x;
  WgRing rg;
  WgPlanes P;
  bool recompute;
};

// The row's buffers and the ring's barriers, then X and the ring, with the
// buffers that the wide part never touches laid over them: d_filt, d_r and
// mm_wide's W tile, which the pullback's tail writes afresh, and pre and rbf,
// which #13 is done with by then. The pullback's tail reads pre and rbf again,
// so they sit beside X and the ring unless recompute, where the tail remakes or
// reloads them (edge_row): the space a K over 100 needs at the sparse widths,
// where a slot costs 1,284 B without it and 884 with it (#14), and #15's K = 48
// (a dual slot costs 1,768 B with it). X, the ring and mm_wide's W tile hold
// floats, the row's buffers T.
template <bool kFwdOut, bool kPull, class T = float>
__host__ __device__ inline WgCtx carve_wg(Carver& cv, const EDims& d, int stages,
                                          bool recompute, ESmem<T>* S) {
  ESmem<T> s = carve_edge<T, kPull, kFwdOut>(cv, d);
  const long long K = d.K;
  WgCtx wg{};
  wg.rg.full = reinterpret_cast<unsigned long long*>(cv.take(4LL * stages));
  wg.rg.empty = wg.rg.full ? wg.rg.full + stages : nullptr;
  wg.rg.stages = stages;
  wg.recompute = kPull && recompute;
  const bool over = !kPull || recompute;  // pre and rbf under X and the ring
  if (!over) {
    s.pre = take_t<T>(cv, K * d.R);
    s.rbf = take_t<T>(cv, K * d.R);
  }
  float* at = cv.base ? cv.base + cv.off : nullptr;
  Carver wide{at}, rest{at};
  wg.x = wide.take((long long)kWgRows * (kWgCols + kWgXPad));
  wg.rg.ring = wide.take((long long)stages * kWgStage);
  if (over) {
    s.pre = take_t<T>(rest, K * d.R);
    s.rbf = take_t<T>(rest, K * d.R);
  }
  s.df = kPull ? take_t<T>(rest, K * d.R) : nullptr;
  s.dr = kPull ? take_t<T>(rest, K) : nullptr;
  s.ws = rest.take((long long)kWTile * (d.F > d.H ? d.F : d.H));  // the H- and F-wide weights
  cv.off += wide.off > rest.off ? wide.off : rest.off;
  if (S) *S = s;
  return wg;
}

template <bool kFwdOut, bool kPull, class T = float>
inline long long edge_wg_smem_bytes(const EDims& d, int stages, bool recompute) {
  Carver cv{nullptr};
  carve_wg<kFwdOut, kPull, T>(cv, d, stages, recompute, nullptr);
  return cv.off * (long long)sizeof(float);
}

// The most neighbour slots a row may have on the tensor-core route at these
// widths: its shared memory, with the shallowest ring and the pullback's tail
// recomputing pre and rbf, fits one block.
template <bool kFwdOut, bool kPull, class T = float>
inline int wg_max_slots(EDims d) {
  for (d.K = 1; d.K < (1 << 16); ++d.K)
    if (edge_wg_smem_bytes<kFwdOut, kPull, T>(d, kWgMinStages, true) > 232448) break;
  return d.K - 1;
}

// #14 with pre and rbf under X and the ring (carve_wg's recompute): remake them
// in the tail as the narrow phase made them, bit for bit, from h_g reloaded
// over h_e (read for the last time before this) and t.
__device__ __forceinline__ void wg_recompute_pre_rbf(const EdgeArgs& A, const ESmem<float>& S,
                                                     int row) {
  const int K = A.d.K, F = A.d.F, R = A.d.R;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t eb = (size_t)row * K;
  for (int j = tid; j < K * F; j += nt) S.hg[j] = A.hg[eb * F + j];
  __syncthreads();
  mmT<float>(K, F, R, [&](int r, int k) { return S.hg[r * F + k]; }, A.W.w_in_j,
             [&](int r, int c, float v) { S.pre[r * R + c] = v + S.ai[c]; });
  for (int j = tid; j < K * R; j += nt) {
    const int e = j / R, c = j % R;
    const float tm = S.t[e] - A.W.rbf_m[c];
    S.rbf[j] = exp_(-A.W.rbf_b[c] * (tm * tm));
  }
}

// #15 with pre and rbf under X and the ring (carve_wg's recompute): they wait
// in global memory across the wide part, in the cotangent rows ER_D_PRE and
// ER_FILT (values and tangents), which the tail writes only after reading them
// back: out after the narrow phase (in = false), in before the tail's first use
// (in = true), each between block barriers. Cheaper than remaking them as #14
// does (a dual pre product), and #15 always writes its rows.
__device__ __forceinline__ void dl_park_pre_rbf(const EdgeArgs& A, const ESmem<Dl>& S, int row,
                                                bool in) {
  const int n = A.d.K * A.d.R;
  const size_t b = (size_t)row * n;
  float *pv = A.rows[ER_D_PRE] + b, *pt = A.t_rows[ER_D_PRE] + b;
  float *rv = A.rows[ER_FILT] + b, *rt = A.t_rows[ER_FILT] + b;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    if (in) {
      S.pre[j] = Dl{pv[j], pt[j]};
      S.rbf[j] = Dl{rv[j], rt[j]};
    } else {
      pv[j] = S.pre[j].v;
      pt[j] = S.pre[j].t;
      rv[j] = S.rbf[j].v;
      rt[j] = S.rbf[j].t;
    }
  }
}

// The wide part of a row on the tensor cores (#13, #14): up to kWgRows slots
// at a time, he_att formed in X (which the product's output then overwrites:
// no buffer of its own), the x-mixing product and with kPull its transpose by
// wg_xmix, reading their A fragments from X. #15's edge_wide_dl runs the same
// epilogues on dual numbers: a fix to one belongs in the other (one body for
// float and Dl, through views of the buffers, cost #13 14% on the card;
// PERF.md).
template <bool kFwdOut, bool kPull, bool kRows>
__device__ void edge_wide_wg(const EdgeArgs& A, const ESmem<float>& S, int row, WgCtx& wg) {
  const EDims d = A.d;
  const int K = d.K, H = d.H, Kh = d.Kh, C = d.C, HK = H * Kh;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t eb = (size_t)row * K;
  const float* he = S.hg;
  float* X = wg.x;
  constexpr int ldx = kWgCols + kWgXPad;
  // this thread's accesses to the space that the ring shares (carve_wg) come
  // before the ring's bulk copies
  wg_fence_proxy();
  for (int t0 = 0; t0 < K; t0 += kWgRows) {
    const int n = min(kWgRows, K - t0);
    // he_att[e, h*Kh + hd] = h_e[e, h] * att2[e, hd], a column per thread;
    // hatt = sum_K he_att
    for (int q = tid; q < HK; q += nt) {
      const int h = q / Kh, hd = q % Kh;
      float sum = 0.f;
      for (int e = 0; e < n; ++e) {
        const float a = he[(t0 + e) * H + h] * S.att2[(t0 + e) * Kh + hd];
        X[e * ldx + q] = a;
        sum += a;
        if constexpr (kRows) put_row(A, ER_HE_ATT, (eb + t0 + e) * HK + q, a);
      }
      if constexpr (kFwdOut) S.hatt[q] = S.hatt[q] + sum;
    }
    __syncthreads();
    SAKE_PROBE(PR_SP_HEATT);
    // tanh(he_att @ w_xmix)
    wg_xmix(n, [&](int r, int k) { return X[r * ldx + k]; }, wg.P.fwd, wg.rg,
            [&](int r, int c, float v) { X[r * ldx + c] = tanh_(v); });
    __syncthreads();
    SAKE_PROBE(PR_SP_XMIX_F);
    if constexpr (kFwdOut) {
      // pooled_k = sum_K coeff * u_k, coeff = tanh * m
      for (int c = tid; c < C; c += nt) {
        float p0 = S.pool[c], p1 = S.pool[C + c], p2 = S.pool[2 * C + c];
        for (int e = 0; e < n; ++e) {
          const float co = X[e * ldx + c] * S.m[t0 + e];
          p0 += co * S.u[t0 + e];
          p1 += co * S.u[K + t0 + e];
          p2 += co * S.u[2 * K + t0 + e];
        }
        S.pool[c] = p0;
        S.pool[C + c] = p1;
        S.pool[2 * C + c] = p2;
      }
    }
    if constexpr (kPull) {
      // d_u_k = sum_C coeff * g_pooled_k
      for (int q = tid; q < 3 * n; q += nt) {
        const int k = q / n, e = q % n;
        float acc = 0.f;
        for (int c = 0; c < C; ++c) acc += X[e * ldx + c] * S.gp[k * C + c];
        S.du[k * K + t0 + e] = acc * S.m[t0 + e];
      }
      __syncthreads();
      SAKE_PROBE(PR_SP_EPI);
      // d_xm = d_coeff * m * (1 - tanh^2), d_coeff = sum_k g_pooled_k * u_k
      for (int j = tid; j < n * C; j += nt) {
        const int e = j / C, c = j % C;
        const float dco = S.gp[c] * S.u[t0 + e] + S.gp[C + c] * S.u[K + t0 + e] +
                          S.gp[2 * C + c] * S.u[2 * K + t0 + e];
        const float th = X[e * ldx + c];
        X[e * ldx + c] = dco * S.m[t0 + e] * (1.f - th * th);
      }
      __syncthreads();
      SAKE_PROBE(PR_SP_EPI);
      if constexpr (kRows) {
        for (int j = tid; j < n * C; j += nt)
          put_row(A, ER_D_XM, (eb + t0) * C + j, X[(j / C) * ldx + j % C]);
        SAKE_PROBE_BARRIER(PR_SP_STORE);
      }
      // d_he_att = d_xm @ w_xmix^T + g_hatt, into X (wg_xmix's barrier puts
      // the stores after every read of d_xm)
      wg_xmix(n, [&](int r, int k) { return X[r * ldx + k]; }, wg.P.bwd, wg.rg,
              [&](int r, int c, float v) { X[r * ldx + c] = v + S.gh[c]; });
      __syncthreads();
      SAKE_PROBE(PR_SP_XMIX_B);
      // d_h_e = sum_hd d_he_att * att2; d_att2 = sum_h d_he_att * h_e
      for (int j = tid; j < n * H; j += nt) {
        const int e = j / H, h = j % H;
        float acc = 0.f;
        for (int hd = 0; hd < Kh; ++hd)
          acc += X[e * ldx + h * Kh + hd] * S.att2[(t0 + e) * Kh + hd];
        S.dhe[(t0 + e) * H + h] = acc;
      }
      for (int j = tid; j < n * Kh; j += nt) {
        const int e = j / Kh, hd = j % Kh;
        float acc = 0.f;
        for (int h = 0; h < H; ++h) acc += X[e * ldx + h * Kh + hd] * he[(t0 + e) * H + h];
        S.datt2[(t0 + e) * Kh + hd] = acc;
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_SP_EPI);
  }
}

// The wide part of a row on the tensor cores for #15 (Dl). w_xmix carries no
// tangent, so a slot's value row and its tangent row multiply the same B: a
// tile of X holds kWgHalf slots, their values in rows 0 ... 31 and their
// tangents in rows 32 ... 63, and one wg_xmix gives both halves of 32 dual
// slots. A row of K slots takes ceil(K / 32) tiles (K = 48: 32, then 16, the
// unused rows of each half read as zeros and never stored), each plane
// streaming twice per row and product. The dual tanh pairs row r with row r +
// 32, which other warps hold: the product stores its sums into X and the
// epilogue reads both back. The epilogues are edge_wide_wg's, on dual numbers
// (pair and set read and write a slot's value and tangent in X).
constexpr int kWgHalf = kWgRows / 2;

template <bool kFwdOut, bool kPull, bool kRows>
__device__ void edge_wide_dl(const EdgeArgs& A, const ESmem<Dl>& S, int row, WgCtx& wg) {
  static_assert(kFwdOut && kPull && kRows,
                "#15 writes the chain's outputs, the pullback's and its rows (and parks pre "
                "and rbf in them)");
  const EDims d = A.d;
  const int K = d.K, H = d.H, Kh = d.Kh, C = d.C, HK = H * Kh;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t eb = (size_t)row * K;
  const Dl* he = S.hg;
  const Dl zero{0.f, 0.f};
  float* X = wg.x;
  constexpr int ldx = kWgCols + kWgXPad;
  constexpr int tan = kWgHalf * ldx;  // from a slot's value row to its tangent row
  auto pair = [&](int e, int c) { return Dl{X[e * ldx + c], X[tan + e * ldx + c]}; };
  auto set = [&](int e, int c, Dl v) {
    X[e * ldx + c] = v.v;
    X[tan + e * ldx + c] = v.t;
  };
  // this thread's accesses to the space that the ring shares (carve_wg) come
  // before the ring's bulk copies
  wg_fence_proxy();
  for (int t0 = 0; t0 < K; t0 += kWgHalf) {
    const int n = min(kWgHalf, K - t0);
    // tile row r holds slot t0 + r % 32 (its value or its tangent): in use below n
    auto used = [&](int r) { return (r & (kWgHalf - 1)) < n; };
    auto af = [&](int r, int k) { return used(r) ? X[r * ldx + k] : 0.f; };
    // he_att[e, h*Kh + hd] = h_e[e, h] * att2[e, hd], a column per thread;
    // hatt = sum_K he_att
    for (int q = tid; q < HK; q += nt) {
      const int h = q / Kh, hd = q % Kh;
      Dl sum = zero;
      for (int e = 0; e < n; ++e) {
        const Dl a = he[(t0 + e) * H + h] * S.att2[(t0 + e) * Kh + hd];
        set(e, q, a);
        sum += a;
        put_row(A, ER_HE_ATT, (eb + t0 + e) * HK + q, a);
      }
      S.hatt[q] = S.hatt[q] + sum;
    }
    __syncthreads();
    SAKE_PROBE(PR_SP_HEATT);
    // tanh(he_att @ w_xmix): both halves' sums into X, then the dual tanh
    wg_xmix(kWgRows, af, wg.P.fwd, wg.rg, [&](int r, int c, float v) {
      if (used(r)) X[r * ldx + c] = v;
    });
    __syncthreads();
    for (int j = tid; j < n * C; j += nt) set(j / C, j % C, tanh_(pair(j / C, j % C)));
    __syncthreads();
    SAKE_PROBE(PR_SP_XMIX_F);
    // pooled_k = sum_K coeff * u_k, coeff = tanh * m
    for (int c = tid; c < C; c += nt) {
      Dl p0 = S.pool[c], p1 = S.pool[C + c], p2 = S.pool[2 * C + c];
      for (int e = 0; e < n; ++e) {
        const Dl co = pair(e, c) * val(S.m[t0 + e]);
        p0 += co * S.u[t0 + e];
        p1 += co * S.u[K + t0 + e];
        p2 += co * S.u[2 * K + t0 + e];
      }
      S.pool[c] = p0;
      S.pool[C + c] = p1;
      S.pool[2 * C + c] = p2;
    }
    // d_u_k = sum_C coeff * g_pooled_k: a warp a slot, its lanes over C, then
    // the lanes' sums in a fixed order (warp_sum)
    for (int e = tid >> 5; e < n; e += nt >> 5) {
      Dl acc[3] = {zero, zero, zero};
      for (int c = tid & 31; c < C; c += 32) {
        const Dl co = pair(e, c);
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[k] += co * S.gp[k * C + c];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const Dl sum{warp_sum(acc[k].v), warp_sum(acc[k].t)};
        if ((tid & 31) == 0) S.du[k * K + t0 + e] = sum * val(S.m[t0 + e]);
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_SP_EPI);
    // d_xm = d_coeff * m * (1 - tanh^2), d_coeff = sum_k g_pooled_k * u_k
    for (int j = tid; j < n * C; j += nt) {
      const int e = j / C, c = j % C;
      const Dl dco = S.gp[c] * S.u[t0 + e] + S.gp[C + c] * S.u[K + t0 + e] +
                     S.gp[2 * C + c] * S.u[2 * K + t0 + e];
      const Dl th = pair(e, c);
      set(e, c, dco * val(S.m[t0 + e]) * (1.f - th * th));
    }
    __syncthreads();
    SAKE_PROBE(PR_SP_EPI);
    for (int j = tid; j < n * C; j += nt)
      put_row(A, ER_D_XM, (eb + t0) * C + j, pair(j / C, j % C));
    SAKE_PROBE_BARRIER(PR_SP_STORE);
    // d_he_att = d_xm @ w_xmix^T + g_hatt (g_hatt carries no tangent), into X
    // (wg_xmix's barrier puts the stores after every read of d_xm)
    wg_xmix(kWgRows, af, wg.P.bwd, wg.rg, [&](int r, int c, float v) {
      if (used(r)) X[r * ldx + c] = r < kWgHalf ? v + S.gh[c] : v;
    });
    __syncthreads();
    SAKE_PROBE(PR_SP_XMIX_B);
    // d_h_e = sum_hd d_he_att * att2; d_att2 = sum_h d_he_att * h_e
    for (int j = tid; j < n * H; j += nt) {
      const int e = j / H, h = j % H;
      Dl acc = zero;
      for (int hd = 0; hd < Kh; ++hd) acc += pair(e, h * Kh + hd) * S.att2[(t0 + e) * Kh + hd];
      S.dhe[(t0 + e) * H + h] = acc;
    }
    for (int j = tid; j < n * Kh; j += nt) {
      const int e = j / Kh, hd = j % Kh;
      Dl acc = zero;
      for (int h = 0; h < H; ++h) acc += pair(e, h * Kh + hd) * he[(t0 + e) * H + h];
      S.datt2[(t0 + e) * Kh + hd] = acc;
    }
    __syncthreads();
    SAKE_PROBE(PR_SP_EPI);
  }
}

// One receiver row: the chain (kFwdOut: write pooled and hatt), and with
// kPull its pullback (input cotangents), with kRows also the cotangent
// rows of the 11 edge-leaf gradients; the wide part on the tensor cores
// (edge_wide_wg for float, edge_wide_dl for Dl).
template <class T, bool kFwdOut, bool kPull, bool kRows>
__device__ void edge_row(const EdgeArgs& A, const ESmem<T>& S, int row, WgCtx& wg) {
  const EDims d = A.d;
  const int K = d.K, F = d.F, R = d.R, H = d.H, Kh = d.Kh, C = d.C, HK = H * Kh;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t NRK = (size_t)d.NR * K;
  const size_t eb = (size_t)row * K;  // the row's first edge
  const EdgeW& W = A.W;
  const T zero = mk<T>(0.f, 0.f);

  // -- geometry: r = sqrt(relu(|d0|^2) + eps), t = exp(-r), u = d0 / (r + 1e-5)
  for (int e = tid; e < K; e += nt) {
    T dd[3];
    T s = zero;
    for (int k = 0; k < 3; ++k) {
      dd[k] = ld<T>(A.d0, A.c_d0, k * NRK + eb + e);
      S.d0[k * K + e] = dd[k];
      s += dd[k] * dd[k];
    }
    S.m[e] = mk<T>(A.m[eb + e], 0.f);
    const T r = sqrt_(relu_(s) + kEps);
    const T ir = 1.f / (r + 1e-5f);
    S.r[e] = r;
    S.t[e] = exp_(-r);
    S.ir[e] = ir;
    for (int k = 0; k < 3; ++k) S.u[k * K + e] = dd[k] * ir;
  }
  for (int j = tid; j < R; j += nt) S.ai[j] = ld<T>(A.ai, A.c_ai, (size_t)row * R + j);
  for (int j = tid; j < H; j += nt) S.oi[j] = ld<T>(A.oi, A.c_oi, (size_t)row * H + j);
  for (int j = tid; j < K * F; j += nt) S.hg[j] = ld<T>(A.hg, A.c_hg, eb * F + j);
  if constexpr (kPull) {
    for (int j = tid; j < 3 * C; j += nt)
      S.gp[j] = A.gp[(size_t)(j / C) * d.NR * C + (size_t)row * C + j % C];
    for (int j = tid; j < HK; j += nt) S.gh[j] = A.gh[(size_t)row * HK + j];
  }
  if constexpr (kFwdOut) {
    for (int j = tid; j < 3 * C; j += nt) S.pool[j] = zero;
    for (int j = tid; j < HK; j += nt) S.hatt[j] = zero;
  }
  __syncthreads();
  SAKE_PROBE(PR_SP_LOAD);

  // -- pre = h_g @ w_in_j + a_i; oji = h_g @ w_o_j + o_i; rbf
  mmT<T>(K, F, R, [&](int r, int k) { return S.hg[r * F + k]; }, W.w_in_j,
         [&](int r, int c, T v) { S.pre[r * R + c] = v + S.ai[c]; });
  for (int j = tid; j < K * R; j += nt) {
    const int e = j / R, c = j % R;
    const T tm = S.t[e] - W.rbf_m[c];
    S.rbf[j] = exp_(-W.rbf_b[c] * (tm * tm));
  }
  mm_wide<T>(K, F, H, S.hg, F, W.w_o_j, S.ws,
             [&](int r, int c, T v) { S.e0[r * H + c] = v + S.oi[c]; });
  __syncthreads();
  if constexpr (std::is_same<T, Dl>::value)
    if (wg.recompute) dl_park_pre_rbf(A, S, row, false);
  // -- e0 = oji + (rbf * pre) @ w_o_f + r * w_o_r
  mmT<T>(K, R, H, [&](int r, int k) { return S.rbf[r * R + k] * S.pre[r * R + k]; }, W.w_o_f,
         [&](int r, int c, T v) { S.e0[r * H + c] = S.e0[r * H + c] + v + S.r[r] * W.w_o_r[c]; });
  __syncthreads();
  // -- h_e = silu(e0) @ w_o1 + b_o1 into the h_g buffer, silu(e0) once into
  //    the d_h_e buffer (free until the wide part)
  T* he = S.hg;
  for (int j = tid; j < K * H; j += nt) S.dhe[j] = silu_(S.e0[j]);
  __syncthreads();
  mm_wide<T>(K, H, H, S.dhe, H, W.w_o1, S.ws,
             [&](int r, int c, T v) { he[r * H + c] = v + W.b_o1[c]; });
  __syncthreads();
  // -- sem_pre = h_e @ w_sem + b_sem
  mmT<T, 1>(K, H, Kh, [&](int r, int k) { return he[r * H + k]; }, W.w_sem,
            [&](int r, int c, T v) { S.sem[r * Kh + c] = v + W.b_sem[c]; });
  __syncthreads();
  SAKE_PROBE(PR_SP_NARROW);
  // -- softmax over the K slots per head, then the mask renormalisation: the
  //    elementwise steps by all threads, each sum over K in order by one
  //    thread a head (the max parks in dg and the sum in den)
  for (int j = tid; j < K * Kh; j += nt)
    S.att[j] = celu2_(S.sem[j]) - kInf * (1.f - val(S.m[j / Kh]));
  __syncthreads();
  for (int hd = tid; hd < Kh; hd += nt) {
    float mx = -INFINITY;
    for (int e = 0; e < K; ++e) mx = fmaxf(mx, val(S.att[e * Kh + hd]));
    S.dg[hd] = mk<T>(mx, 0.f);
  }
  __syncthreads();
  for (int j = tid; j < K * Kh; j += nt) S.att[j] = exp_(S.att[j] - val(S.dg[j % Kh]));
  __syncthreads();
  for (int hd = tid; hd < Kh; hd += nt) {
    T sum = zero;
    for (int e = 0; e < K; ++e) sum += S.att[e * Kh + hd];
    S.den[hd] = sum;
  }
  __syncthreads();
  for (int j = tid; j < K * Kh; j += nt) S.att[j] = S.att[j] / S.den[j % Kh];
  __syncthreads();
  for (int hd = tid; hd < Kh; hd += nt) {
    T den = zero;
    for (int e = 0; e < K; ++e) den += S.att[e * Kh + hd] * val(S.m[e]);
    S.den[hd] = den;
    S.dg[hd] = val(den) == 0.f ? mk<T>(1.f, 0.f) : den;
  }
  __syncthreads();
  for (int j = tid; j < K * Kh; j += nt)
    S.att2[j] = (S.att[j] * val(S.m[j / Kh])) / S.dg[j % Kh];
  __syncthreads();
  SAKE_PROBE(PR_SP_SOFTMAX);

  if constexpr (std::is_same<T, Dl>::value)
    edge_wide_dl<kFwdOut, kPull, kRows>(A, S, row, wg);
  else
    edge_wide_wg<kFwdOut, kPull, kRows>(A, S, row, wg);
  if constexpr (kFwdOut) {
    for (int j = tid; j < 3 * C; j += nt)
      put(A.pooled, (size_t)(j / C) * d.NR * C + (size_t)row * C + j % C, S.pool[j]);
    for (int j = tid; j < HK; j += nt) put(A.hatt, (size_t)row * HK + j, S.hatt[j]);
  }
  if constexpr (!kPull) return;
  SAKE_PROBE_BARRIER(PR_SP_EPI);

  // -- renormalisation (with its live factor), softmax and celu2 pullbacks
  for (int hd = tid; hd < Kh; hd += nt) {
    T s = zero;
    for (int e = 0; e < K; ++e) s += S.datt2[e * Kh + hd] * (S.att[e * Kh + hd] * val(S.m[e]));
    const float live = val(S.den[hd]) != 0.f ? 1.f : 0.f;
    const T dg = S.dg[hd];
    const T corr = live * s / (dg * dg);
    T q = zero;
    for (int e = 0; e < K; ++e) {
      const T da = (S.datt2[e * Kh + hd] / dg - corr) * val(S.m[e]);
      S.datt2[e * Kh + hd] = da;
      q += da * S.att[e * Kh + hd];
    }
    for (int e = 0; e < K; ++e) {
      const int j = e * Kh + hd;
      S.datt2[j] = S.att[j] * (S.datt2[j] - q) * dcelu2_(S.sem[j]);  // d_sem
    }
  }
  __syncthreads();
  // -- d_h_e += d_sem @ w_sem^T
  mmT<T>(K, Kh, H, [&](int r, int k) { return S.datt2[r * Kh + k]; }, W.t_sem,
         [&](int r, int c, T v) { S.dhe[r * H + c] = S.dhe[r * H + c] + v; });
  if constexpr (kRows) {
    SAKE_PROBE_BARRIER(PR_SP_TAIL);
    for (int j = tid; j < K * H; j += nt) {
      put_row(A, ER_H_E, eb * H + j, he[j]);
      put_row(A, ER_SE, eb * H + j, silu_(S.e0[j]));
    }
    for (int j = tid; j < K * Kh; j += nt) put_row(A, ER_D_SEM, eb * Kh + j, S.datt2[j]);
  }
  __syncthreads();
  SAKE_PROBE(kRows ? PR_SP_STORE : PR_SP_TAIL);
  if constexpr (kRows) {
    for (int j = tid; j < K * H; j += nt) put_row(A, ER_D_H_E, eb * H + j, S.dhe[j]);
    SAKE_PROBE_BARRIER(PR_SP_STORE);
  }
  if (wg.recompute) {
    if constexpr (std::is_same<T, Dl>::value)
      dl_park_pre_rbf(A, S, row, true);
    else
      wg_recompute_pre_rbf(A, S, row);
  }
  // -- d_e0 = (d_h_e @ w_o1^T) * silu'(e0), in place of e0
  mm_wide<T>(K, H, H, S.dhe, H, W.t_o1, S.ws,
             [&](int r, int c, T v) { S.e0[r * H + c] = v * dsilu_(S.e0[r * H + c]); });
  __syncthreads();
  // -- d_r = d_e0 . w_o_r; d_filt = d_e0 @ w_o_f^T; d_o_i = sum_K d_e0
  for (int e = tid; e < K; e += nt) {
    T acc = zero;
    for (int h = 0; h < H; ++h) acc += S.e0[e * H + h] * W.w_o_r[h];
    S.dr[e] = acc;
  }
  mmT<T>(K, H, R, [&](int r, int k) { return S.e0[r * H + k]; }, W.t_o_f,
         [&](int r, int c, T v) { S.df[r * R + c] = v; });
  for (int h = tid; h < H; h += nt) {
    T acc = zero;
    for (int e = 0; e < K; ++e) acc += S.e0[e * H + h];
    put(A.d_oi, (size_t)row * H + h, acc);
  }
  if constexpr (kRows) {
    SAKE_PROBE_BARRIER(PR_SP_TAIL);
    for (int j = tid; j < K * H; j += nt) put_row(A, ER_D_E0, eb * H + j, S.e0[j]);
    for (int e = tid; e < K; e += nt) put_row(A, ER_R, eb + e, S.r[e]);
  }
  __syncthreads();
  SAKE_PROBE(kRows ? PR_SP_STORE : PR_SP_TAIL);
  // -- d_rbf = d_filt * pre; d_t = sum_R d_rbf * rbf * (-2 b (t - m)); d_r -= t d_t
  for (int e = tid; e < K; e += nt) {
    T acc = zero;
    for (int c = 0; c < R; ++c) {
      const T tm = S.t[e] - W.rbf_m[c];
      acc += S.df[e * R + c] * S.pre[e * R + c] * S.rbf[e * R + c] * (-2.f * W.rbf_b[c] * tm);
    }
    S.dr[e] = S.dr[e] + (-S.t[e]) * acc;
  }
  if constexpr (kRows) {
    SAKE_PROBE_BARRIER(PR_SP_TAIL);
    for (int j = tid; j < K * R; j += nt) {
      const int e = j / R, c = j % R;
      const T tm = S.t[e] - W.rbf_m[c];
      const T q = S.df[j] * S.pre[j] * S.rbf[j];
      put_row(A, ER_Q_M, eb * R + j, q * (2.f * W.rbf_b[c] * tm));
      put_row(A, ER_Q_B, eb * R + j, q * (-(tm * tm)));
      put_row(A, ER_FILT, eb * R + j, S.rbf[j] * S.pre[j]);
    }
  }
  __syncthreads();
  SAKE_PROBE(kRows ? PR_SP_STORE : PR_SP_TAIL);
  // -- d_pre = d_filt * rbf, in place
  for (int j = tid; j < K * R; j += nt) S.df[j] = S.df[j] * S.rbf[j];
  __syncthreads();
  SAKE_PROBE(PR_SP_TAIL);
  if constexpr (kRows) {
    for (int j = tid; j < K * R; j += nt) put_row(A, ER_D_PRE, eb * R + j, S.df[j]);
    SAKE_PROBE_BARRIER(PR_SP_STORE);
  }
  // -- d_a_i = sum_K d_pre; d_h_g = d_pre @ w_in_j^T + d_e0 @ w_o_j^T
  for (int c = tid; c < R; c += nt) {
    T acc = zero;
    for (int e = 0; e < K; ++e) acc += S.df[e * R + c];
    put(A.d_ai, (size_t)row * R + c, acc);
  }
  mmT<T>(K, R, F, [&](int r, int k) { return S.df[r * R + k]; }, W.t_in_j,
         [&](int r, int c, T v) { S.hg[r * F + c] = v; });
  // -- d_d0 = d_u * inv_r + 2 d0 d_s, with d_r -= inv_r^2 (d_u . d0) and
  //    d_s = d_r * 0.5 / r where r^2 > eps (the relu)
  for (int e = tid; e < K; e += nt) {
    const T ir = S.ir[e];
    const T dir = S.du[e] * S.d0[e] + S.du[K + e] * S.d0[K + e] + S.du[2 * K + e] * S.d0[2 * K + e];
    const T dr = S.dr[e] - (ir * ir) * dir;
    const T r = S.r[e];
    const float pos = val(r) * val(r) > kEps ? 1.f : 0.f;
    const T ds = dr * (0.5f / r) * pos;
    for (int k = 0; k < 3; ++k)
      put(A.d_d0, k * NRK + eb + e, S.du[k * K + e] * ir + 2.f * S.d0[k * K + e] * ds);
  }
  __syncthreads();
  mm_wide<T>(K, H, F, S.e0, H, W.t_o_j, S.ws,
             [&](int r, int c, T v) { put(A.d_hg, (eb + r) * F + c, S.hg[r * F + c] + v); });
  __syncthreads();  // the next row reuses the buffers
  SAKE_PROBE(PR_SP_TAIL);
}

// #13 and #14: the float instantiations, the route's buffers carved after the
// row's; one block per receiver row, rows strided over the grid.
template <bool kFwdOut, bool kPull, bool kRows>
__global__ void __launch_bounds__(kEdgeThreads, 1)
    edge_wg_kernel(EdgeArgs A, WgPlanes P, int stages, int recompute) {
  extern __shared__ float4 smem4[];
  Carver cv{reinterpret_cast<float*>(smem4)};
  ESmem<float> S;
  WgCtx wg = carve_wg<kFwdOut, kPull>(cv, A.d, stages, recompute != 0, &S);
  wg.P = P;
  wg_init(wg.rg);
  __syncthreads();
  SAKE_PROBE_START();
  for (int row = blockIdx.x; row < A.d.NR; row += gridDim.x)
    edge_row<float, kFwdOut, kPull, kRows>(A, S, row, wg);
}

// #15: the Dl instantiation (a kernel of its own, so that the float ones keep
// their text).
template <bool kFwdOut, bool kPull, bool kRows>
__global__ void __launch_bounds__(kEdgeThreads, 1)
    edge_wg_dl_kernel(EdgeArgs A, WgPlanes P, int stages, int recompute) {
  extern __shared__ float4 smem4[];
  Carver cv{reinterpret_cast<float*>(smem4)};
  ESmem<Dl> S;
  WgCtx wg = carve_wg<kFwdOut, kPull, Dl>(cv, A.d, stages, recompute != 0, &S);
  wg.P = P;
  wg_init(wg.rg);
  __syncthreads();
  SAKE_PROBE_START();
  for (int row = blockIdx.x; row < A.d.NR; row += gridDim.x)
    edge_row<Dl, kFwdOut, kPull, kRows>(A, S, row, wg);
}

// The kernel of an instantiation: T float (#13, #14) or Dl (#15).
template <class T, bool kFwdOut, bool kPull, bool kRows>
constexpr auto edge_wg_entry() {
  if constexpr (std::is_same<T, Dl>::value)
    return edge_wg_dl_kernel<kFwdOut, kPull, kRows>;
  else
    return edge_wg_kernel<kFwdOut, kPull, kRows>;
}

// Launch with the deepest ring (kWgMaxStages ... kWgMinStages) whose shared
// memory fits one block, first with pre and rbf kept through the wide part, then
// (the pullbacks) with the tail remaking or reloading them; an invalid value where the
// widths are not the route's (wg_dims) or nothing fits (K over wg_max_slots).
template <bool kFwdOut, bool kPull, bool kRows, class T = float>
int launch_edge_wg(const EdgeArgs& A, const WgPlanes& P, void* stream) {
  if (!wg_dims(A.d) || !P.fwd || (kPull && !P.bwd))
    return (int)cudaErrorInvalidValue;
  for (int recompute = 0; recompute <= (kPull ? 1 : 0); ++recompute)
    for (int stages = kWgMaxStages; stages >= kWgMinStages; --stages) {
      const long long smem = edge_wg_smem_bytes<kFwdOut, kPull, T>(A.d, stages, recompute);
      if (smem > 232448) continue;
      auto kern = edge_wg_entry<T, kFwdOut, kPull, kRows>();
      cudaError_t err =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      if (A.d.NR > 0)
        kern<<<A.d.NR, kEdgeThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, P, stages,
                                                                                 recompute);
      return (int)cudaGetLastError();
    }
  return (int)cudaErrorInvalidValue;
}

inline WgPlanes edge_planes(const void* const* w) {
  return WgPlanes{static_cast<const float*>(w[kEdgeWPtrs]),
                  static_cast<const float*>(w[kEdgeWPtrs + 1])};
}

inline EdgeW edge_weights(const void* const* w) {
  const float* p[kEdgeWPtrs];
  for (int i = 0; i < kEdgeWPtrs; ++i) p[i] = static_cast<const float*>(w[i]);
  return EdgeW{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
               p[11], p[12], p[13], p[14], p[15], p[16]};
}

}  // namespace sake
