// The O(N^2) middle of a dense SAKE layer as the split ops compute it, and its
// hand-written pullback: the body of the split kernels #25-#28 (split_fwd.cu,
// split_bwd.cu).
//
// Port of sake_tpu/kernels/split_ef.py: _edge_att_body (:56-75),
// _coeff_pool_body (:101-116) and _merged_body (:394-403), followed line by
// line, and their VJPs, which the JAX backward kernels take with jax.vjp
// (:190-207, :471-508). One body, three compositions, chosen by template
// flags:
// - kEA, the edge_att op: positions and the node-level halves a_j, a_i,
//   o_j, o_i -> h_e (B, N, N, H) and the semantic attention att (B, N, N, Kh)
//   (a softmax over the senders j, the diagonal pushed down by kInf);
// - kCP, the coeff_pool op: positions, h_e and att -> the pooled planes
//   (B, N, C) x 3 and hatt_sum (B, N, H * Kh);
// - both, the merged op: h_e and att stay in shared memory.
// A pullback runs its forward again and then the pullback of the cotangents
// of its outputs; with kRows it also writes the per-edge cotangent rows
// (SplitRow) whose contraction over all edges is the weight cotangent
// (sparse_contract.cu sums them in a fixed order).
//
// Everything forward is local to a receiver row i, so a forward block needs no
// molecule of its own. The pullback does: x_j, a_j and o_j get cotangents from
// every receiver. A pullback block owns a whole molecule and adds the
// sender-side cotangents into shared memory (N * (R + H + 3) floats) one thread
// per element, in row order, so results do not vary from run to run (no
// atomics). Both directions have two routes, chosen per shape by split_bwd_tc
// and split_fwd_tc:
// - the CUDA-core route (split_kernel): the pullback runs the molecule's N rows
//   one after another through split_row (kPull), the forward one row a block.
//   The products reuse the sparse edge chain's helpers (sparse_edge.cuh):
//   mm_wide stages kWTile rows of a weight (w_xmix is 256 KB) in shared memory,
//   mmT streams narrow ones from L2; the head expansion he_att[j, h * Kh + k] =
//   h_e[j, h] * att[j, k] and the x-mixing run in chunks of at most 16 senders.
//   The forwards #25 and #27 take it where the widths are not the tensor-core
//   route's (hidden 8 and 16: H * Kh != 256).
// - the tensor-core route (split_tc_kernel, split_group): g = 64 / N receiver
//   rows at a time (three at aspirin's 21 atoms, 63 edges), their edges stacked
//   as the rows of one 64-row tile X, so that the x-mixing product and its
//   transpose each run once per group on wgmma in 3xTF32 (wgmma_tf32.cuh's
//   wg_xmix, w_xmix's packed planes streamed through a ring of bulk copies),
//   and the edge products o_f, o1, d_h_e @ w1^T and d_e0 @ w_r^T on mma.sync
//   in 3xTF32 (mma_tf32x3.cuh's mm_tc_small) over the group's edges. The
//   products with the 4 heads on one side (h_e @ w_sem, d_sem @ w_sem^T) stay
//   on the CUDA cores (mmT): k or n = 4 fills half an m16n8k8 tile at most.
//   Taken where H * Kh = 256 (and C = 256 where the op mixes x), R and H are at
//   most kTcSmallK, N at most kWgRows and the carve fits one block. The
//   forwards' kernel (split_tc_fwd_kernel, split_group_fwd) runs the forward
//   half of the same group on the same products, with the JAX bodies' epilogue
//   (hatt_sum, the pooled planes; no sender-side sums), a block striding over
//   the groups of all molecules.
// The softmax's cotangent row sums run in f64 on both routes: they cancel.
#pragma once

#include "sparse_edge.cuh"

// A block barrier of the split bodies, marked for the clock probe (probe.cuh,
// -DSAKE_PROBE): thread 0 charges its own work since its last mark to slot,
// then its wait for the block's slowest thread to PR_SPL_BAR. Otherwise a
// barrier.
#ifdef SAKE_PROBE
#define SPLIT_SYNC(slot)                  \
  do {                                    \
    SAKE_PROBE(slot);                     \
    __syncthreads();                      \
    SAKE_PROBE(::sake::PR_SPL_BAR);       \
  } while (0)
#else
#define SPLIT_SYNC(slot) __syncthreads()
#endif

namespace sake {

constexpr int kSplitThreads = 256;
constexpr int kSplitRows = 11;

// Order of SPLIT_ROWS in sake_tpu_torch/kernels/split_ef.py; each row is
// (E = B * N * N, width), edge e = (b * N + i) * N + j.
enum SplitRow {
  SR_Q_M, SR_Q_B, SR_FILT, SR_D_E0, SR_R, SR_SE, SR_D_H_E, SR_H_E, SR_D_SEM, SR_HE_ATT, SR_D_XM
};

// The ops, as split_ef.py's _OPS numbers them.
enum SplitOp { OP_EDGE_ATT = 0, OP_COEFF_POOL = 1, OP_MERGED = 2 };

struct SDims {
  int B, N, R, H, Kh, C;
};

// Weights (row-major, JAX shapes) and the transposes the pullback reads.
constexpr int kSplitWPtrs = 14;

struct SplitArgs {
  SDims d;
  // inputs: x planes (B, N); a_j, a_i (B, N, R); o_j, o_i (B, N, H); the
  // coeff_pool op's h_e (B, N, N, H) and att (B, N, N, Kh)
  const float* x[3];
  const float *aj, *ai, *oj, *oi, *he_in, *att_in;
  // rbf_m, rbf_b (R), w_r (R, H), w_rr, b0 (H), w1 (H, H), b1 (H), w_sem
  // (H, Kh), b_sem (Kh), w_xmix (HK, C); w_r^T, w1^T, w_sem^T, w_xmix^T
  const float *rbf_m, *rbf_b, *w_r, *w_rr, *b0, *w1, *b1, *w_sem, *b_sem, *w_xmix;
  const float *t_r, *t_1, *t_sem, *t_xmix;
  // forward outputs: h_e, att (edge_att); pooled (B, N, C) x 3 and hatt_sum
  // (B, N, HK) (coeff_pool, merged)
  float *he_out, *att_out, *pool[3], *hs;
  // cotangents of the outputs: g_he, g_att (edge_att); g_pooled x 3 and
  // g_hatt_sum (coeff_pool, merged)
  const float *g_he, *g_att, *gp[3], *g_hs;
  // input cotangents: x planes; a_j, a_i, o_j, o_i (edge_att, merged); h_e,
  // att (coeff_pool)
  float *dx[3], *d_aj, *d_ai, *d_oj, *d_oi, *d_he, *d_att;
  float* rows[kSplitRows];
};

// Shared memory of one block.
struct SSmem {
  float *d, *s, *r, *t, *ir;  // 3N, N, N, N, N: x_j - x_i, |d|^2, r, exp(-r), 1/(r + 1e-5)
  float *he, *att;            // N*H, N*Kh
  float *ai, *oi;             // R, H (kEA)
  float *pre, *rbf;           // N*R each (kEA)
  float *e0, *se, *sem;       // N*H, N*H (silu(e0)), N*Kh (kEA); e0 becomes d_e0, sem d_sem
  float *wa, *wb;             // kc*HK (he_att, then d_he_att), kc*C (tanh, then d_xm) (kCP)
  float *pool, *hs;           // 3C, HK (kCP forward)
  float *gp, *ghs;            // 3C, HK (kCP pullback)
  float *ghe, *gatt;          // N*H, N*Kh: cotangents of h_e and att (pullback)
  float *du, *dr;             // 3N, N: cotangents of u (then of d) and r (pullback)
  float *df;                  // N*R: d_filtered, then d_pre (kEA pullback)
  float *ax, *aaj, *aoj;      // 3N, N*R, N*H: the molecule's sender-side sums (pullback)
  float* ws;                  // kWTile * max(H, HK, C): mm_wide's weight tile
};

template <bool kEA, bool kCP, bool kPull>
__host__ __device__ inline SSmem carve_split(Carver& cv, const SDims& d, int kc) {
  const long long N = d.N, R = d.R, H = d.H, Kh = d.Kh, C = d.C, HK = H * Kh;
  SSmem S{};
  S.d = cv.take(3 * N);
  S.s = cv.take(N);
  S.r = cv.take(N);
  S.t = cv.take(N);
  S.ir = cv.take(N);
  S.he = cv.take(N * H);
  S.att = cv.take(N * Kh);
  if (kEA) {
    S.ai = cv.take(R);
    S.oi = cv.take(H);
    S.pre = cv.take(N * R);
    S.rbf = cv.take(N * R);
    S.e0 = cv.take(N * H);
    S.se = cv.take(N * H);
    S.sem = cv.take(N * Kh);
  }
  if (kCP) {
    S.wa = cv.take(kc * HK);
    S.wb = cv.take(kc * C);
    if (kPull) {
      S.gp = cv.take(3 * C);
      S.ghs = cv.take(HK);
    } else {
      S.pool = cv.take(3 * C);
      S.hs = cv.take(HK);
    }
  }
  if (kPull) {
    S.ghe = cv.take(N * H);
    S.gatt = cv.take(N * Kh);
    S.du = cv.take(3 * N);
    S.dr = cv.take(N);
    S.ax = cv.take(3 * N);
    if (kEA) {
      S.df = cv.take(N * R);
      S.aaj = cv.take(N * R);
      S.aoj = cv.take(N * H);
    }
  }
  long long wmax = H > HK ? H : HK;
  if (C > wmax) wmax = C;
  S.ws = cv.take(kWTile * wmax);
  return S;
}

// Senders per chunk of the head expansion: at most 16 (mm_wide's 4 x 4
// tiles cover 16 rows of a 256-wide product with 256 threads), balanced.
__host__ __device__ inline int split_chunk(int N) {
  const int n_chunks = (N + 15) / 16;
  return n_chunks > 0 ? (N + n_chunks - 1) / n_chunks : 1;
}

template <bool kEA, bool kCP, bool kPull>
inline long long split_smem_bytes(const SDims& d) {
  Carver cv{nullptr};
  carve_split<kEA, kCP, kPull>(cv, d, split_chunk(d.N));
  return cv.off * (long long)sizeof(float);
}

// Receiver row i of molecule b.
template <bool kEA, bool kCP, bool kPull, bool kRows>
__device__ void split_row(const SplitArgs& A, const SSmem& S, int b, int i, int kc) {
  const SDims d = A.d;
  const int N = d.N, R = d.R, H = d.H, Kh = d.Kh, C = d.C, HK = H * Kh;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t mol = (size_t)b * N;  // the molecule's first atom
  const size_t row = mol + i;
  const size_t eb = row * N;         // the row's first edge (b, i, 0)

  // -- geometry: d = x_j - x_i, r = sqrt(relu(|d|^2) + eps), t = exp(-r),
  //    inv_r = 1 / (r + 1e-5)
  for (int j = tid; j < N; j += nt) {
    float s = 0.f;
    for (int k = 0; k < 3; ++k) {
      const float dk = A.x[k][mol + j] - A.x[k][row];
      S.d[k * N + j] = dk;
      s += dk * dk;
    }
    const float r = sqrtf(fmaxf(s, 0.f) + kEps);
    S.s[j] = s;
    S.r[j] = r;
    S.t[j] = expf(-r);
    S.ir[j] = 1.f / (r + 1e-5f);
    if constexpr (kPull) {
      S.dr[j] = 0.f;
      for (int k = 0; k < 3; ++k) S.du[k * N + j] = 0.f;
    }
  }
  if constexpr (kEA) {
    for (int c = tid; c < R; c += nt) S.ai[c] = A.ai[row * R + c];
    for (int c = tid; c < H; c += nt) S.oi[c] = A.oi[row * H + c];
  } else {
    for (int q = tid; q < N * H; q += nt) S.he[q] = A.he_in[eb * H + q];
    for (int q = tid; q < N * Kh; q += nt) S.att[q] = A.att_in[eb * Kh + q];
  }
  if constexpr (kPull && kCP) {
    for (int q = tid; q < 3 * C; q += nt) S.gp[q] = A.gp[q / C][row * C + q % C];
    for (int q = tid; q < HK; q += nt) S.ghs[q] = A.g_hs[row * HK + q];
  }
  if constexpr (kPull && !kCP) {
    for (int q = tid; q < N * H; q += nt) S.ghe[q] = A.g_he[eb * H + q];
    for (int q = tid; q < N * Kh; q += nt) S.gatt[q] = A.g_att[eb * Kh + q];
  }
  if constexpr (kCP && !kPull) {
    for (int q = tid; q < 3 * C; q += nt) S.pool[q] = 0.f;
    for (int q = tid; q < HK; q += nt) S.hs[q] = 0.f;
  }
  SPLIT_SYNC(PR_SPL_LOAD);

  if constexpr (kEA) {
    // -- pre = a_j + a_i (b_in folded into a_i); rbf = exp(-b (t - m)^2)
    for (int q = tid; q < N * R; q += nt) {
      const int j = q / R, c = q % R;
      S.pre[q] = A.aj[(mol + j) * R + c] + S.ai[c];
      const float tm = S.t[j] - A.rbf_m[c];
      S.rbf[q] = expf(-A.rbf_b[c] * (tm * tm));
    }
    SPLIT_SYNC(PR_SPL_ROW);
    // -- e0 = o_j + o_i + (rbf * pre) @ w_r + r * w_rr + b0
    mmT<float>(N, R, H, [&](int r, int k) { return S.rbf[r * R + k] * S.pre[r * R + k]; }, A.w_r,
               [&](int r, int c, float v) {
                 S.e0[r * H + c] = A.oj[(mol + r) * H + c] + S.oi[c] + v + S.r[r] * A.w_rr[c] +
                                   A.b0[c];
               });
    SPLIT_SYNC(PR_SPL_MM);
    for (int q = tid; q < N * H; q += nt) S.se[q] = siluf_(S.e0[q]);
    SPLIT_SYNC(PR_SPL_ROW);
    // -- h_e = silu(e0) @ w1 + b1
    mm_wide<float>(N, H, H, S.se, H, A.w1, S.ws,
                   [&](int r, int c, float v) { S.he[r * H + c] = v + A.b1[c]; });
    SPLIT_SYNC(PR_SPL_MM);
    // -- sem_pre = h_e @ w_sem + b_sem
    mmT<float, 1>(N, H, Kh, [&](int r, int k) { return S.he[r * H + k]; }, A.w_sem,
                  [&](int r, int c, float v) { S.sem[r * Kh + c] = v + A.b_sem[c]; });
    SPLIT_SYNC(PR_SPL_SEM);
    // -- att = softmax over j of celu2(sem_pre) - kInf * [j == i], one thread a head
    for (int k = tid; k < Kh; k += nt) {
      float mx = -INFINITY;
      for (int j = 0; j < N; ++j) {
        const float l = celu2_(S.sem[j * Kh + k]) - (j == i ? kInf : 0.f);
        S.att[j * Kh + k] = l;
        mx = fmaxf(mx, l);
      }
      float sum = 0.f;
      for (int j = 0; j < N; ++j) {
        const float e = expf(S.att[j * Kh + k] - mx);
        S.att[j * Kh + k] = e;
        sum += e;
      }
      for (int j = 0; j < N; ++j) S.att[j * Kh + k] = S.att[j * Kh + k] / sum;
    }
    SPLIT_SYNC(PR_SPL_SEM);
    if constexpr (!kCP && !kPull) {
      for (int q = tid; q < N * H; q += nt) A.he_out[eb * H + q] = S.he[q];
      for (int q = tid; q < N * Kh; q += nt) A.att_out[eb * Kh + q] = S.att[q];
    }
  }

  if constexpr (kCP) {
    for (int c0 = 0; c0 < N; c0 += kc) {
      const int n = min(kc, N - c0);
      // he_att[e, h * Kh + k] = h_e[e, h] * att[e, k]
      for (int q = tid; q < n * HK; q += nt) {
        const int e = q / HK, p = q % HK;
        S.wa[q] = S.he[(c0 + e) * H + p / Kh] * S.att[(c0 + e) * Kh + p % Kh];
      }
      SPLIT_SYNC(PR_SPL_EPI);
      // coeff = tanh(he_att @ w_xmix)
      mm_wide<float>(n, HK, C, S.wa, HK, A.w_xmix, S.ws,
                     [&](int r, int c, float v) { S.wb[r * C + c] = tanhf(v); });
      SPLIT_SYNC(PR_SPL_XMIX);
      if constexpr (!kPull) {
        // pooled_k = sum_j coeff * d_k * inv_r; hatt_sum = sum_j he_att
        for (int c = tid; c < C; c += nt) {
          float p0 = S.pool[c], p1 = S.pool[C + c], p2 = S.pool[2 * C + c];
          for (int e = 0; e < n; ++e) {
            const int j = c0 + e;
            const float co = S.wb[e * C + c], ir = S.ir[j];
            p0 += co * (S.d[j] * ir);
            p1 += co * (S.d[N + j] * ir);
            p2 += co * (S.d[2 * N + j] * ir);
          }
          S.pool[c] = p0;
          S.pool[C + c] = p1;
          S.pool[2 * C + c] = p2;
        }
        for (int p = tid; p < HK; p += nt) {
          float a = S.hs[p];
          for (int e = 0; e < n; ++e) a += S.wa[e * HK + p];
          S.hs[p] = a;
        }
      } else {
        // d_u_k = sum_C coeff * g_pooled_k
        for (int q = tid; q < 3 * n; q += nt) {
          const int k = q / n, e = q % n;
          float acc = 0.f;
          for (int c = 0; c < C; ++c) acc += S.wb[e * C + c] * S.gp[k * C + c];
          S.du[k * N + c0 + e] = acc;
        }
        SPLIT_SYNC(PR_SPL_EPI);
        // d_xm = (sum_k g_pooled_k * u_k) * (1 - tanh^2), in place
        for (int q = tid; q < n * C; q += nt) {
          const int e = q / C, c = q % C, j = c0 + e;
          const float ir = S.ir[j];
          const float dco = S.gp[c] * (S.d[j] * ir) + S.gp[C + c] * (S.d[N + j] * ir) +
                            S.gp[2 * C + c] * (S.d[2 * N + j] * ir);
          const float th = S.wb[q];
          S.wb[q] = dco * (1.f - th * th);
        }
        if constexpr (kRows)
          for (int q = tid; q < n * HK; q += nt) A.rows[SR_HE_ATT][(eb + c0) * HK + q] = S.wa[q];
        SPLIT_SYNC(PR_SPL_EPI);
        if constexpr (kRows)
          for (int q = tid; q < n * C; q += nt) A.rows[SR_D_XM][(eb + c0) * C + q] = S.wb[q];
        // d_he_att = d_xm @ w_xmix^T + g_hatt_sum
        mm_wide<float>(n, C, HK, S.wb, C, A.t_xmix, S.ws,
                       [&](int r, int c, float v) { S.wa[r * HK + c] = v + S.ghs[c]; });
        SPLIT_SYNC(PR_SPL_XMIX);
        // d_h_e = sum_k d_he_att * att; d_att = sum_h d_he_att * h_e
        for (int q = tid; q < n * H; q += nt) {
          const int e = q / H, h = q % H;
          float acc = 0.f;
          for (int k = 0; k < Kh; ++k) acc += S.wa[e * HK + h * Kh + k] * S.att[(c0 + e) * Kh + k];
          S.ghe[(c0 + e) * H + h] = acc;
        }
        for (int q = tid; q < n * Kh; q += nt) {
          const int e = q / Kh, k = q % Kh;
          float acc = 0.f;
          for (int h = 0; h < H; ++h) acc += S.wa[e * HK + h * Kh + k] * S.he[(c0 + e) * H + h];
          S.gatt[(c0 + e) * Kh + k] = acc;
        }
      }
      SPLIT_SYNC(PR_SPL_EPI);
    }
    if constexpr (!kPull) {
      for (int q = tid; q < 3 * C; q += nt) A.pool[q / C][row * C + q % C] = S.pool[q];
      for (int q = tid; q < HK; q += nt) A.hs[row * HK + q] = S.hs[q];
    } else if constexpr (!kEA) {
      for (int q = tid; q < N * H; q += nt) A.d_he[eb * H + q] = S.ghe[q];
      for (int q = tid; q < N * Kh; q += nt) A.d_att[eb * Kh + q] = S.gatt[q];
    }
  }

  if constexpr (kPull && kEA) {
    // -- softmax and celu2: d_sem = att (g_att - sum_j att g_att) celu2'(sem_pre),
    //    the row sum in f64, into sem
    for (int k = tid; k < Kh; k += nt) {
      double q = 0.0;
      for (int j = 0; j < N; ++j) q += (double)S.att[j * Kh + k] * (double)S.gatt[j * Kh + k];
      for (int j = 0; j < N; ++j) {
        const int p = j * Kh + k;
        S.sem[p] = (float)((double)S.att[p] * ((double)S.gatt[p] - q)) * dcelu2_(S.sem[p]);
      }
    }
    SPLIT_SYNC(PR_SPL_SEM);
    // -- d_h_e = g_h_e + d_sem @ w_sem^T
    mmT<float>(N, Kh, H, [&](int r, int k) { return S.sem[r * Kh + k]; }, A.t_sem,
               [&](int r, int c, float v) { S.ghe[r * H + c] += v; });
    if constexpr (kRows) {
      for (int q = tid; q < N * H; q += nt) {
        A.rows[SR_H_E][eb * H + q] = S.he[q];
        A.rows[SR_SE][eb * H + q] = S.se[q];
      }
      for (int q = tid; q < N * Kh; q += nt) A.rows[SR_D_SEM][eb * Kh + q] = S.sem[q];
    }
    SPLIT_SYNC(PR_SPL_SEM);
    if constexpr (kRows)
      for (int q = tid; q < N * H; q += nt) A.rows[SR_D_H_E][eb * H + q] = S.ghe[q];
    // -- d_e0 = (d_h_e @ w1^T) * silu'(e0), in place of e0
    mm_wide<float>(N, H, H, S.ghe, H, A.t_1, S.ws,
                   [&](int r, int c, float v) { S.e0[r * H + c] = v * dsiluf_(S.e0[r * H + c]); });
    SPLIT_SYNC(PR_SPL_MM_B);
    // -- d_r = d_e0 . w_rr; d_filtered = d_e0 @ w_r^T; d_o_i = sum_j d_e0; the
    //    senders' d_o_j += d_e0
    for (int j = tid; j < N; j += nt) {
      float acc = 0.f;
      for (int h = 0; h < H; ++h) acc += S.e0[j * H + h] * A.w_rr[h];
      S.dr[j] += acc;
    }
    mmT<float>(N, H, R, [&](int r, int k) { return S.e0[r * H + k]; }, A.t_r,
               [&](int r, int c, float v) { S.df[r * R + c] = v; });
    for (int h = tid; h < H; h += nt) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += S.e0[j * H + h];
      A.d_oi[row * H + h] = acc;
    }
    for (int q = tid; q < N * H; q += nt) S.aoj[q] += S.e0[q];
    if constexpr (kRows) {
      for (int q = tid; q < N * H; q += nt) A.rows[SR_D_E0][eb * H + q] = S.e0[q];
      for (int j = tid; j < N; j += nt) A.rows[SR_R][eb + j] = S.r[j];
    }
    SPLIT_SYNC(PR_SPL_MM_B);
    // -- d_t = sum_R d_filtered * pre * rbf * (-2 b (t - m)); d_r -= t d_t
    for (int j = tid; j < N; j += nt) {
      float acc = 0.f;
      for (int c = 0; c < R; ++c) {
        const float tm = S.t[j] - A.rbf_m[c];
        acc += S.df[j * R + c] * S.pre[j * R + c] * S.rbf[j * R + c] * (-2.f * A.rbf_b[c] * tm);
      }
      S.dr[j] += (-S.t[j]) * acc;
    }
    if constexpr (kRows) {
      for (int q = tid; q < N * R; q += nt) {
        const int j = q / R, c = q % R;
        const float tm = S.t[j] - A.rbf_m[c];
        const float g = S.df[q] * S.pre[q] * S.rbf[q];
        A.rows[SR_Q_M][eb * R + q] = g * (2.f * A.rbf_b[c] * tm);
        A.rows[SR_Q_B][eb * R + q] = g * (-(tm * tm));
        A.rows[SR_FILT][eb * R + q] = S.rbf[q] * S.pre[q];
      }
    }
    SPLIT_SYNC(PR_SPL_ROW);
    // -- d_pre = d_filtered * rbf; d_a_i = sum_j d_pre; the senders' d_a_j += d_pre
    for (int q = tid; q < N * R; q += nt) S.df[q] *= S.rbf[q];
    SPLIT_SYNC(PR_SPL_ROW);
    for (int c = tid; c < R; c += nt) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += S.df[j * R + c];
      A.d_ai[row * R + c] = acc;
    }
    for (int q = tid; q < N * R; q += nt) S.aaj[q] += S.df[q];
  }

  if constexpr (kPull) {
    SPLIT_SYNC(PR_SPL_ROW);
    // -- d_d = d_u inv_r + 2 d d_s, with d_r -= inv_r^2 (d_u . d) and d_s =
    //    d_r * 0.5 / r where |d|^2 > 0 (the relu), into du
    for (int j = tid; j < N; j += nt) {
      const float ir = S.ir[j];
      const float dir = S.du[j] * S.d[j] + S.du[N + j] * S.d[N + j] + S.du[2 * N + j] * S.d[2 * N + j];
      const float dr = S.dr[j] - (ir * ir) * dir;
      const float ds = S.s[j] > 0.f ? dr * (0.5f / S.r[j]) : 0.f;
      for (int k = 0; k < 3; ++k) S.du[k * N + j] = S.du[k * N + j] * ir + 2.f * S.d[k * N + j] * ds;
    }
    SPLIT_SYNC(PR_SPL_ROW);
    // -- d = x_j - x_i: the sender x_j gets d_d, the receiver x_i minus the row's sum
    for (int q = tid; q < 3 * N; q += nt) {
      const int k = q / N, j = q % N;
      float v = S.du[q];
      if (j == i)
        for (int jj = 0; jj < N; ++jj) v -= S.du[k * N + jj];
      S.ax[q] += v;
    }
  }
  SPLIT_SYNC(PR_SPL_ROW);  // the next row reuses the buffers
}

// The kernel: a forward block owns one receiver row (rows strided over the
// grid), a pullback block one molecule (molecules strided over the grid).
template <bool kEA, bool kCP, bool kPull, bool kRows>
__global__ void __launch_bounds__(kSplitThreads) split_kernel(SplitArgs A) {
  extern __shared__ float4 smem4[];
  Carver cv{reinterpret_cast<float*>(smem4)};
  const int kc = split_chunk(A.d.N);
  const SSmem S = carve_split<kEA, kCP, kPull>(cv, A.d, kc);
  const int N = A.d.N;
  SAKE_PROBE_START();
  if constexpr (!kPull) {
    for (long long row = blockIdx.x; row < (long long)A.d.B * N; row += gridDim.x)
      split_row<kEA, kCP, false, false>(A, S, (int)(row / N), (int)(row % N), kc);
  } else {
    const int R = A.d.R, H = A.d.H;
    for (int b = blockIdx.x; b < A.d.B; b += gridDim.x) {
      const size_t mol = (size_t)b * N;
      for (int q = threadIdx.x; q < 3 * N; q += blockDim.x) S.ax[q] = 0.f;
      if constexpr (kEA) {
        for (int q = threadIdx.x; q < N * R; q += blockDim.x) S.aaj[q] = 0.f;
        for (int q = threadIdx.x; q < N * H; q += blockDim.x) S.aoj[q] = 0.f;
      }
      SPLIT_SYNC(PR_SPL_LOAD);
      for (int i = 0; i < N; ++i) split_row<kEA, kCP, true, kRows>(A, S, b, i, kc);
      for (int q = threadIdx.x; q < 3 * N; q += blockDim.x) A.dx[q / N][mol + q % N] = S.ax[q];
      if constexpr (kEA) {
        for (int q = threadIdx.x; q < N * R; q += blockDim.x) A.d_aj[mol * R + q] = S.aaj[q];
        for (int q = threadIdx.x; q < N * H; q += blockDim.x) A.d_oj[mol * H + q] = S.aoj[q];
      }
      SPLIT_SYNC(PR_SPL_ROW);
    }
  }
}

constexpr long long kSplitSmemLimit = 232448;

template <bool kEA, bool kCP, bool kPull, bool kRows>
int launch_split(const SplitArgs& A, void* stream) {
  const long long smem = split_smem_bytes<kEA, kCP, kPull>(A.d);
  if (smem > kSplitSmemLimit) return (int)cudaErrorInvalidValue;
  auto kern = split_kernel<kEA, kCP, kPull, kRows>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = kPull ? (long long)A.d.B : (long long)A.d.B * A.d.N;
  if (grid > 0)
    kern<<<(unsigned)grid, kSplitThreads, smem, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

// ---- the tensor-core pullback route (split_tc_kernel) ------------------------

// Receiver rows a group stacks into the 64-row tile: floor(64 / N), at most N.
__host__ __device__ inline int split_tc_rows(int N) {
  const int g = N > 0 ? kWgRows / N : 1;
  return g < N ? g : N;
}

constexpr int kSplitMaxHeads = 16;  // the head expansion's pullback keeps a sum a head

// Whether the widths are the route's: the x-mixing's H * Kh = 256 (and C =
// 256 where the op mixes x, kCP; the edge_att op has no C), the edge
// products' k at most kTcSmallK, at most kSplitMaxHeads heads, and at least
// one receiver row a tile.
__host__ __device__ inline bool split_tc_dims(const SDims& d, bool cp) {
  return d.N >= 1 && d.N <= kWgRows && d.H * d.Kh == kWgDepth && (!cp || d.C == kWgCols) &&
         d.R <= kTcSmallK && d.H <= kTcSmallK && d.Kh <= kSplitMaxHeads;
}

// The route's shared memory: the group's buffers (SSmem, sized for g rows of N
// edges, M = g N; ai, oi, gp, ghs a row each, gp as [k][row][c]), the
// molecule's sender-side sums and (kEA) its a_j and o_j, the edge_att weights'
// vectors, then (kCP) the product tile X and the ring of B stages, with se and df
// laid over them and over each other: the wide part reads neither (se is o1's
// operand; df o_f's operand, then d_filtered), and se is made after o_f has read
// df and read before d_filtered is made. rbf is made again where it is read
// (split_rbf), so that the edge_att op's carve leaves room for two blocks an SM
// at aspirin's widths; wa, wb, ws and rbf are not used.
struct STc {
  SSmem S;
  float* x;
  WgRing rg;
  float *aj, *oj;                                // N*R, N*H: the molecule's (kEA)
  float *rbf_m, *rbf_b, *w_rr, *b0, *b1, *b_sem;  // R, R, H, H, H, Kh (kEA)
  float* w_sem;                                  // H*Kh (kEA)
};

template <bool kEA, bool kCP>
__host__ __device__ inline STc carve_split_tc(Carver& cv, const SDims& d, int stages) {
  const long long N = d.N, R = d.R, H = d.H, Kh = d.Kh, C = d.C, HK = H * Kh;
  const long long g = split_tc_rows(d.N), M = g * N;
  STc T{};
  SSmem& S = T.S;
  S.d = cv.take(3 * M);
  S.s = cv.take(M);
  S.r = cv.take(M);
  S.t = cv.take(M);
  S.ir = cv.take(M);
  S.he = cv.take(M * H);
  S.att = cv.take(M * Kh);
  S.ghe = cv.take(M * H);
  S.gatt = cv.take(M * Kh);
  S.du = cv.take(3 * M);
  S.dr = cv.take(M);
  S.ax = cv.take(3 * N);
  if (kEA) {
    S.ai = cv.take(g * R);
    S.oi = cv.take(g * H);
    S.pre = cv.take(M * R);
    S.e0 = cv.take(M * H);
    S.sem = cv.take(M * Kh);
    S.aaj = cv.take(N * R);
    S.aoj = cv.take(N * H);
    T.aj = cv.take(N * R);
    T.oj = cv.take(N * H);
    T.rbf_m = cv.take(R);
    T.rbf_b = cv.take(R);
    T.w_rr = cv.take(H);
    T.b0 = cv.take(H);
    T.b1 = cv.take(H);
    T.b_sem = cv.take(Kh);
    T.w_sem = cv.take(H * Kh);
  }
  if (kCP) {
    S.gp = cv.take(3 * g * C);
    S.ghs = cv.take(g * HK);
    T.rg.full = reinterpret_cast<unsigned long long*>(cv.take(4LL * stages));
    T.rg.empty = T.rg.full ? T.rg.full + stages : nullptr;
    T.rg.stages = stages;
  }
  float* at = cv.base ? cv.base + cv.off : nullptr;
  Carver wide{at}, rest{at};
  if (kCP) {
    T.x = wide.take((long long)kWgRows * (kWgCols + kWgXPad));
    T.rg.ring = wide.take((long long)stages * kWgStage);
  }
  if (kEA) S.se = S.df = rest.take(M * (H > R ? H : R));
  cv.off += wide.off > rest.off ? wide.off : rest.off;
  return T;
}

template <bool kEA, bool kCP>
inline long long split_tc_smem_bytes(const SDims& d, int stages) {
  Carver cv{nullptr};
  carve_split_tc<kEA, kCP>(cv, d, stages);
  return cv.off * (long long)sizeof(float);
}

// The deepest ring (kWgMaxStages ... kWgMinStages) whose carve fits one block
// (kCP; the edge_att op has no ring: 0), or -1 where none does.
template <bool kEA, bool kCP>
inline int split_tc_stages(const SDims& d) {
  if (!kCP) return split_tc_smem_bytes<kEA, kCP>(d, 0) <= kSplitSmemLimit ? 0 : -1;
  for (int s = kWgMaxStages; s >= kWgMinStages; --s)
    if (split_tc_smem_bytes<kEA, kCP>(d, s) <= kSplitSmemLimit) return s;
  return -1;
}

// The pullback's route: the tensor cores where the widths are the route's and
// its carve fits, else the CUDA cores (split_kernel).
template <bool kEA, bool kCP>
inline bool split_tc_route(const SDims& d) {
  return split_tc_dims(d, kCP) && split_tc_stages<kEA, kCP>(d) >= 0;
}

inline bool split_bwd_tc(int op, const SDims& d) {
#ifdef SAKE_SPLIT_CUDA_CORES  // tools/probe_split.py's probe build of the CUDA-core route
  return false;
#endif
  switch (op) {
    case OP_EDGE_ATT: return split_tc_route<true, false>(d);
    case OP_COEFF_POOL: return split_tc_route<false, true>(d);
    default: return split_tc_route<true, true>(d);
  }
}

// n floats from device memory into shared memory, four loads a thread in flight
// before their stores (the block's threads, strided).
__device__ __forceinline__ void split_copy(float* __restrict__ dst, const float* __restrict__ src,
                                           int n) {
  const int nt = blockDim.x;
  for (int q0 = threadIdx.x; q0 < n; q0 += 4 * nt) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = q0 + u * nt < n ? src[q0 + u * nt] : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (q0 + u * nt < n) dst[q0 + u * nt] = v[u];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q / d and q % d by a multiply (the group's index arithmetic: q < 2^16, so
// the rounded-up reciprocal is exact), in place of an integer division.
struct FastDiv {
  unsigned d, m;
  __host__ __device__ explicit FastDiv(int dv)
      : d((unsigned)dv), m(dv > 1 ? (unsigned)(((1ull << 32) + dv - 1) / dv) : 0u) {}
  __device__ __forceinline__ int div(int q) const {
    return d == 1 ? q : (int)__umulhi((unsigned)q, m);
  }
  __device__ __forceinline__ int mod(int q) const { return q - div(q) * (int)d; }
};

// rbf = exp(-b (t - m)^2) of channel c at t = exp(-r).
__device__ __forceinline__ float split_rbf(const STc& T, float t, int c) {
  const float tm = t - T.rbf_m[c];
  return expf(-T.rbf_b[c] * (tm * tm));
}

// Rows i0 ... i0 + gn - 1 of molecule b, their M = gn N edges (q = ii N + j for
// receiver i0 + ii and sender j) stacked in that order: the group's edges are
// the contiguous range from (b, i0, 0) of every (B, N, N, .) tensor. split_row's
// steps on M edges at once, the sums over an edge's wide rows by a warp each;
// the sender-side sums take the rows in order.
template <bool kEA, bool kCP, bool kRows>
__device__ void split_group(const SplitArgs& A, STc& T, const WgPlanes& P, int b, int i0,
                            int gn) {
  const SDims d = A.d;
  const int N = d.N, R = d.R, H = d.H, Kh = d.Kh, C = d.C, HK = H * Kh, M = gn * N;
  const SSmem& S = T.S;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
  const size_t mol = (size_t)b * N;  // the molecule's first atom
  const size_t row0 = mol + i0;      // the group's first receiver
  const size_t eb = row0 * N;        // the group's first edge (b, i0, 0)
  const FastDiv fN(N), fR(R), fH(H), fK(Kh);

  // -- geometry: d = x_j - x_i, r = sqrt(relu(|d|^2) + eps), t = exp(-r),
  //    inv_r = 1 / (r + 1e-5)
  for (int q = tid; q < M; q += nt) {
    const int j = fN.mod(q);
    const size_t row = row0 + fN.div(q);
    float xj[3], xi[3];
    for (int k = 0; k < 3; ++k) {
      xj[k] = A.x[k][mol + j];
      xi[k] = A.x[k][row];
    }
    float s = 0.f;
    for (int k = 0; k < 3; ++k) {
      const float dk = xj[k] - xi[k];
      S.d[k * M + q] = dk;
      s += dk * dk;
    }
    const float r = sqrtf(fmaxf(s, 0.f) + kEps);
    S.s[q] = s;
    S.r[q] = r;
    S.t[q] = expf(-r);
    S.ir[q] = 1.f / (r + 1e-5f);
    S.dr[q] = 0.f;
    for (int k = 0; k < 3; ++k) S.du[k * M + q] = 0.f;
  }
  if constexpr (kEA) {
    split_copy(S.ai, A.ai + row0 * R, gn * R);
    split_copy(S.oi, A.oi + row0 * H, gn * H);
  } else {
    split_copy(S.he, A.he_in + eb * H, M * H);
    split_copy(S.att, A.att_in + eb * Kh, M * Kh);
  }
  if constexpr (kCP) {
    for (int k = 0; k < 3; ++k) split_copy(S.gp + k * gn * C, A.gp[k] + row0 * C, gn * C);
    split_copy(S.ghs, A.g_hs + row0 * HK, gn * HK);
  } else {
    split_copy(S.ghe, A.g_he + eb * H, M * H);
    split_copy(S.gatt, A.g_att + eb * Kh, M * Kh);
  }
  SPLIT_SYNC(PR_SPL_LOAD);

  if constexpr (kEA) {
    // -- pre = a_j + a_i (b_in folded into a_i); filtered = rbf * pre, o_f's
    //    operand, in df
    for (int q = tid; q < M * R; q += nt) {
      const int e = fR.div(q), c = q - e * R, ii = fN.div(e);
      const float pre = T.aj[(e - ii * N) * R + c] + S.ai[ii * R + c];
      S.pre[q] = pre;
      S.df[q] = split_rbf(T, S.t[e], c) * pre;
    }
    SPLIT_SYNC(PR_SPL_ROW);
    // -- e0 = o_j + o_i + filtered @ w_r + r * w_rr + b0
    mm_tc_small(M, R, H, S.df, R, A.w_r, [&](int e, int c, float v) {
      const int ii = fN.div(e);
      S.e0[e * H + c] =
          T.oj[(e - ii * N) * H + c] + S.oi[ii * H + c] + v + S.r[e] * T.w_rr[c] + T.b0[c];
    });
    SPLIT_SYNC(PR_SPL_MM);
    for (int q = tid; q < M * H; q += nt) S.se[q] = siluf_(S.e0[q]);  // over df
    SPLIT_SYNC(PR_SPL_ROW);
    // -- h_e = silu(e0) @ w1 + b1
    mm_tc_small(M, H, H, S.se, H, A.w1,
                [&](int e, int c, float v) { S.he[e * H + c] = v + T.b1[c]; });
    SPLIT_SYNC(PR_SPL_MM);
    // -- sem_pre = h_e @ w_sem + b_sem, a warp an edge
    for (int e = warp; e < M; e += nwarp) {
      float part[kSplitMaxHeads];  // this lane's share, a head each
#pragma unroll
      for (int c = 0; c < kSplitMaxHeads; ++c) part[c] = 0.f;
      for (int k = lane; k < H; k += 32) {
        const float hv = S.he[e * H + k];
#pragma unroll
        for (int c = 0; c < kSplitMaxHeads; ++c)
          if (c < Kh) part[c] += hv * T.w_sem[k * Kh + c];
      }
#pragma unroll
      for (int c = 0; c < kSplitMaxHeads; ++c)
        if (c < Kh) {
          const float v = warp_sum(part[c]);
          if (lane == 0) S.sem[e * Kh + c] = v + T.b_sem[c];
        }
    }
    SPLIT_SYNC(PR_SPL_SEM);
    // -- att = softmax over j of celu2(sem_pre) - kInf * [j == i], a warp a
    //    (row, head)
    for (int p = warp; p < gn * Kh; p += nwarp) {
      const int ii = p / Kh, i = i0 + ii;
      float* at = S.att + ii * N * Kh + p % Kh;
      const float* sm = S.sem + ii * N * Kh + p % Kh;
      float mx = -INFINITY;
      for (int j = lane; j < N; j += 32) {
        const float l = celu2_(sm[j * Kh]) - (j == i ? kInf : 0.f);
        at[j * Kh] = l;
        mx = fmaxf(mx, l);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float e = expf(at[j * Kh] - mx);
        at[j * Kh] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < N; j += 32) at[j * Kh] = at[j * Kh] / sum;
    }
    SPLIT_SYNC(PR_SPL_SEM);
  }

  if constexpr (kCP) {
    float* X = T.x;
    constexpr int ldx = kWgCols + kWgXPad;
    // -- he_att[e, h * Kh + k] = h_e[e, h] * att[e, k], the group's edges as the
    //    tile's rows
    for (int p = tid; p < HK; p += nt) {
      const int h = fK.div(p), k = p - h * Kh;
      for (int e = 0; e < M; ++e) {
        const float a = S.he[e * H + h] * S.att[e * Kh + k];
        X[e * ldx + p] = a;
        if constexpr (kRows) A.rows[SR_HE_ATT][(eb + e) * HK + p] = a;
      }
    }
    // this thread's accesses to the space that the ring shares (se, df) come
    // before the ring's bulk copies
    wg_fence_proxy();
    SPLIT_SYNC(PR_SPL_EPI);
    // -- coeff = tanh(he_att @ w_xmix), into X
    auto af = [&](int r, int k) { return X[r * ldx + k]; };
    wg_xmix(M, af, P.fwd, T.rg, [&](int r, int c, float v) { X[r * ldx + c] = tanhf(v); });
    SPLIT_SYNC(PR_SPL_XMIX);
    // -- a warp an edge: d_u_k = sum_C coeff * g_pooled_k (of the edge's
    //    receiver), and d_xm = (sum_k g_pooled_k * u_k) * (1 - tanh^2) in place
    for (int e = warp; e < M; e += nwarp) {
      const float* g0 = S.gp + (e / N) * C;
      const float* g1 = g0 + gn * C;
      const float* g2 = g1 + gn * C;
      const float ir = S.ir[e];
      const float u0 = S.d[e] * ir, u1 = S.d[M + e] * ir, u2 = S.d[2 * M + e] * ir;
      float* xr = X + e * ldx;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float th = xr[c];
        a0 += th * g0[c];
        a1 += th * g1[c];
        a2 += th * g2[c];
        xr[c] = (g0[c] * u0 + g1[c] * u1 + g2[c] * u2) * (1.f - th * th);
      }
      a0 = warp_sum(a0);
      a1 = warp_sum(a1);
      a2 = warp_sum(a2);
      if (lane == 0) {
        S.du[e] = a0;
        S.du[M + e] = a1;
        S.du[2 * M + e] = a2;
      }
    }
    SPLIT_SYNC(PR_SPL_EPI);
    if constexpr (kRows)
      for (int e = 0; e < M; ++e)
        for (int c = tid; c < C; c += nt) A.rows[SR_D_XM][(eb + e) * C + c] = X[e * ldx + c];
    // -- d_he_att = d_xm @ w_xmix^T + g_hatt_sum, into X (wg_xmix's barrier puts
    //    the stores after every read of d_xm, the row stores' too)
    wg_xmix(M, af, P.bwd, T.rg,
            [&](int r, int c, float v) { X[r * ldx + c] = v + S.ghs[fN.div(r) * HK + c]; });
    SPLIT_SYNC(PR_SPL_XMIX);
    // -- a warp an edge: d_h_e = sum_k d_he_att * att; d_att = sum_h d_he_att * h_e
    for (int e = warp; e < M; e += nwarp) {
      const float* xr = X + e * ldx;
      const float* at = S.att + e * Kh;
      const float* he = S.he + e * H;
      float part[kSplitMaxHeads];  // this lane's share of d_att, a head each
#pragma unroll
      for (int k = 0; k < kSplitMaxHeads; ++k) part[k] = 0.f;
      for (int h = lane; h < H; h += 32) {
        const float hv = he[h];
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kSplitMaxHeads; ++k)
          if (k < Kh) {
            const float x = xr[h * Kh + k];
            acc += x * at[k];
            part[k] += x * hv;
          }
        S.ghe[e * H + h] = acc;
      }
#pragma unroll
      for (int k = 0; k < kSplitMaxHeads; ++k)
        if (k < Kh) {
          const float v = warp_sum(part[k]);
          if (lane == 0) S.gatt[e * Kh + k] = v;
        }
    }
    SPLIT_SYNC(PR_SPL_EPI);
    if constexpr (!kEA) {
      for (int q = tid; q < M * H; q += nt) A.d_he[eb * H + q] = S.ghe[q];
      for (int q = tid; q < M * Kh; q += nt) A.d_att[eb * Kh + q] = S.gatt[q];
    }
  }

  if constexpr (kEA) {
    // -- softmax and celu2: d_sem = att (g_att - sum_j att g_att) celu2'(sem_pre),
    //    the row sum in f64, into sem, a warp a (row, head)
    for (int p = warp; p < gn * Kh; p += nwarp) {
      const int o = (p / Kh) * N * Kh + p % Kh;
      double q = 0.0;
      for (int j = lane; j < N; j += 32)
        q += (double)S.att[o + j * Kh] * (double)S.gatt[o + j * Kh];
      q = warp_sum_f64(q);
      for (int j = lane; j < N; j += 32) {
        const int e = o + j * Kh;
        S.sem[e] = (float)((double)S.att[e] * ((double)S.gatt[e] - q)) * dcelu2_(S.sem[e]);
      }
    }
    SPLIT_SYNC(PR_SPL_SEM);
    // -- d_h_e = g_h_e + d_sem @ w_sem^T
    for (int q = tid; q < M * H; q += nt) {
      const int e = fH.div(q), h = q - e * H;
      float acc = 0.f;
      for (int k = 0; k < Kh; ++k) acc += S.sem[e * Kh + k] * T.w_sem[h * Kh + k];
      S.ghe[q] += acc;
    }
    if constexpr (kRows) {
      for (int q = tid; q < M * H; q += nt) {
        A.rows[SR_H_E][eb * H + q] = S.he[q];
        A.rows[SR_SE][eb * H + q] = siluf_(S.e0[q]);  // se lies under df: made again
      }
      for (int q = tid; q < M * Kh; q += nt) A.rows[SR_D_SEM][eb * Kh + q] = S.sem[q];
    }
    SPLIT_SYNC(PR_SPL_SEM);
    if constexpr (kRows)
      for (int q = tid; q < M * H; q += nt) A.rows[SR_D_H_E][eb * H + q] = S.ghe[q];
    // -- d_e0 = (d_h_e @ w1^T) * silu'(e0), in place of e0
    mm_tc_small(M, H, H, S.ghe, H, A.t_1,
                [&](int e, int c, float v) { S.e0[e * H + c] = v * dsiluf_(S.e0[e * H + c]); });
    SPLIT_SYNC(PR_SPL_MM_B);
    // -- d_filtered = d_e0 @ w_r^T, into df; d_r = d_e0 . w_rr, a warp an edge;
    //    d_o_i = sum_j d_e0 per row; the senders' d_o_j += d_e0, the rows in order
    mm_tc_small(M, H, R, S.e0, H, A.t_r, [&](int e, int c, float v) { S.df[e * R + c] = v; });
    for (int e = warp; e < M; e += nwarp) {
      float acc = 0.f;
      for (int h = lane; h < H; h += 32) acc += S.e0[e * H + h] * T.w_rr[h];
      acc = warp_sum(acc);
      if (lane == 0) S.dr[e] += acc;
    }
    for (int p = tid; p < gn * H; p += nt) {
      const int ii = p / H, h = p % H;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += S.e0[(ii * N + j) * H + h];
      A.d_oi[row0 * H + p] = acc;
    }
    for (int q = tid; q < N * H; q += nt) {
      float acc = S.aoj[q];
      for (int ii = 0; ii < gn; ++ii) acc += S.e0[ii * N * H + q];
      S.aoj[q] = acc;
    }
    if constexpr (kRows) {
      for (int q = tid; q < M * H; q += nt) A.rows[SR_D_E0][eb * H + q] = S.e0[q];
      for (int q = tid; q < M; q += nt) A.rows[SR_R][eb + q] = S.r[q];
    }
    SPLIT_SYNC(PR_SPL_MM_B);
    // -- d_t = sum_R d_filtered * pre * rbf * (-2 b (t - m)); d_r -= t d_t, a
    //    warp an edge
    for (int e = warp; e < M; e += nwarp) {
      const float t = S.t[e];
      float acc = 0.f;
      for (int c = lane; c < R; c += 32) {
        const float tm = t - T.rbf_m[c];
        const int q = e * R + c;
        acc += S.df[q] * S.pre[q] * split_rbf(T, t, c) * (-2.f * T.rbf_b[c] * tm);
      }
      acc = warp_sum(acc);
      if (lane == 0) S.dr[e] += (-t) * acc;
    }
    if constexpr (kRows) {
      for (int q = tid; q < M * R; q += nt) {
        const int e = fR.div(q), c = q - e * R;
        const float tm = S.t[e] - T.rbf_m[c];
        const float rbf = split_rbf(T, S.t[e], c);
        const float g = S.df[q] * S.pre[q] * rbf;
        A.rows[SR_Q_M][eb * R + q] = g * (2.f * T.rbf_b[c] * tm);
        A.rows[SR_Q_B][eb * R + q] = g * (-(tm * tm));
        A.rows[SR_FILT][eb * R + q] = rbf * S.pre[q];
      }
    }
    SPLIT_SYNC(PR_SPL_ROW);
    // -- d_pre = d_filtered * rbf; d_a_i = sum_j d_pre per row; the senders'
    //    d_a_j += d_pre, the rows in order
    for (int q = tid; q < M * R; q += nt) {
      const int e = fR.div(q);
      S.df[q] *= split_rbf(T, S.t[e], q - e * R);
    }
    SPLIT_SYNC(PR_SPL_ROW);
    for (int p = tid; p < gn * R; p += nt) {
      const int ii = p / R, c = p % R;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += S.df[(ii * N + j) * R + c];
      A.d_ai[row0 * R + p] = acc;
    }
    for (int q = tid; q < N * R; q += nt) {
      float acc = S.aaj[q];
      for (int ii = 0; ii < gn; ++ii) acc += S.df[ii * N * R + q];
      S.aaj[q] = acc;
    }
  }

  SPLIT_SYNC(PR_SPL_ROW);
  // -- d_d = d_u inv_r + 2 d d_s, with d_r -= inv_r^2 (d_u . d) and d_s = d_r *
  //    0.5 / r where |d|^2 > 0 (the relu), into du
  for (int q = tid; q < M; q += nt) {
    const float ir = S.ir[q];
    const float dir =
        S.du[q] * S.d[q] + S.du[M + q] * S.d[M + q] + S.du[2 * M + q] * S.d[2 * M + q];
    const float dr = S.dr[q] - (ir * ir) * dir;
    const float ds = S.s[q] > 0.f ? dr * (0.5f / S.r[q]) : 0.f;
    for (int k = 0; k < 3; ++k) S.du[k * M + q] = S.du[k * M + q] * ir + 2.f * S.d[k * M + q] * ds;
  }
  SPLIT_SYNC(PR_SPL_ROW);
  // -- d = x_j - x_i: the sender x_j gets d_d, the receiver x_i minus its row's
  //    sum; the rows in order
  for (int p = tid; p < 3 * N; p += nt) {
    const int k = p / N, j = p % N;
    const float* du = S.du + k * M;
    float acc = S.ax[p];
    for (int ii = 0; ii < gn; ++ii) {
      float v = du[ii * N + j];
      if (j == i0 + ii)
        for (int jj = 0; jj < N; ++jj) v -= du[ii * N + jj];
      acc += v;
    }
    S.ax[p] = acc;
  }
  SPLIT_SYNC(PR_SPL_ROW);  // the next group reuses the buffers
}

// The route's kernel: a block owns one molecule (molecules strided over the
// grid) and runs its receiver rows split_tc_rows at a time; stages: the ring's
// depth (split_tc_stages). Without the x-mixing (the edge_att op) the carve
// leaves room for two blocks an SM at aspirin's widths.
template <bool kEA, bool kCP, bool kRows>
__global__ void __launch_bounds__(kSplitThreads, kCP ? 1 : 2)
    split_tc_kernel(SplitArgs A, WgPlanes P, int stages) {
  extern __shared__ float4 smem4[];
  Carver cv{reinterpret_cast<float*>(smem4)};
  STc T = carve_split_tc<kEA, kCP>(cv, A.d, stages);
  const int N = A.d.N, R = A.d.R, H = A.d.H, g = split_tc_rows(N);
  if constexpr (kCP) wg_init(T.rg);
  if constexpr (kEA) {
    split_copy(T.rbf_m, A.rbf_m, R);
    split_copy(T.rbf_b, A.rbf_b, R);
    split_copy(T.w_rr, A.w_rr, H);
    split_copy(T.b0, A.b0, H);
    split_copy(T.b1, A.b1, H);
    split_copy(T.b_sem, A.b_sem, A.d.Kh);
    split_copy(T.w_sem, A.w_sem, H * A.d.Kh);
  }
  __syncthreads();
  SAKE_PROBE_START();
  const SSmem& S = T.S;
  for (int b = blockIdx.x; b < A.d.B; b += gridDim.x) {
    const size_t mol = (size_t)b * N;
    for (int q = threadIdx.x; q < 3 * N; q += blockDim.x) S.ax[q] = 0.f;
    if constexpr (kEA) {
      for (int q = threadIdx.x; q < N * R; q += blockDim.x) S.aaj[q] = 0.f;
      for (int q = threadIdx.x; q < N * H; q += blockDim.x) S.aoj[q] = 0.f;
      split_copy(T.aj, A.aj + mol * R, N * R);
      split_copy(T.oj, A.oj + mol * H, N * H);
    }
    SPLIT_SYNC(PR_SPL_LOAD);
    for (int i0 = 0; i0 < N; i0 += g)
      split_group<kEA, kCP, kRows>(A, T, P, b, i0, min(g, N - i0));
    for (int q = threadIdx.x; q < 3 * N; q += blockDim.x) A.dx[q / N][mol + q % N] = S.ax[q];
    if constexpr (kEA) {
      for (int q = threadIdx.x; q < N * R; q += blockDim.x) A.d_aj[mol * R + q] = S.aaj[q];
      for (int q = threadIdx.x; q < N * H; q += blockDim.x) A.d_oj[mol * H + q] = S.aoj[q];
    }
    SPLIT_SYNC(PR_SPL_ROW);
  }
}

// Launch on the route, with the deepest ring that fits; an invalid value where
// the shape is not the route's (split_tc_route) or the op mixes x and a plane is
// missing.
template <bool kEA, bool kCP, bool kRows>
int launch_split_tc(const SplitArgs& A, const WgPlanes& P, void* stream) {
  const int stages = split_tc_stages<kEA, kCP>(A.d);
  if (!split_tc_dims(A.d, kCP) || stages < 0 || (kCP && (!P.fwd || !P.bwd)))
    return (int)cudaErrorInvalidValue;
  const long long smem = split_tc_smem_bytes<kEA, kCP>(A.d, stages);
  auto kern = split_tc_kernel<kEA, kCP, kRows>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (A.d.B > 0)
    kern<<<(unsigned)A.d.B, kSplitThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, P,
                                                                                     stages);
  return (int)cudaGetLastError();
}

// ---- the tensor-core forward route (split_tc_fwd_kernel) ---------------------

// A forward block strides over the groups (b, i0) of all molecules, a_j and o_j
// read from device memory. The ops that mix x run one block an SM, which leaves
// a thread the registers for the x-mixing's 128 accumulators (two blocks of 256
// threads get 128 registers a thread).

// The row stride of an operand of mm_tc_small with k columns: k rounded up to
// 8, with 8 added where that is a multiple of 16, so that a warp's fragment
// loads (8 rows by 4 k) meet two-way bank conflicts at most (64 floats a row
// would put all 8 rows on the same banks: eight-way).
__host__ __device__ inline int split_ld(int k) { return ((k + 7) & ~7) | 8; }

// The forward route's shared memory, for g rows of N edges (M = g N): (kEA) r
// and t, the group's a_i and o_i, filtered (o_f's operand) with h_e over it
// (the edge_att op: o1 writes h_e after o_f has read filtered; where the op
// mixes x, h_e lies in the first H columns of X's rows), silu(e0) (o1's
// operand), sem_pre and att, the weights' vectors; (kCP) u_k = d_k inv_r, the
// ring's barriers, the product tile X and the ring of B stages. filtered and
// silu(e0) have rows
// split_ld apart. Nothing lies over the ring, so its copies may start whenever
// it is free (wg_prefill).
struct SFwd {
  float *r, *t, *u;                                      // M, M (kEA); 3M (kCP)
  float *ai, *oi;                                        // g*R, g*H (kEA)
  float *df, *he, *se, *sem, *att;                       // M*ld(R) (h_e M*H), M*ld(H), M*Kh x 2
  float *rbf_m, *rbf_b, *w_rr, *b0, *b1, *b_sem, *w_sem;  // R, R, H, H, H, Kh, H*Kh
  float* x;
  WgRing rg;
};

template <bool kEA, bool kCP>
__host__ __device__ inline SFwd carve_split_fwd(Carver& cv, const SDims& d, int stages) {
  const long long N = d.N, R = d.R, H = d.H, Kh = d.Kh;
  const long long g = split_tc_rows(d.N), M = g * N;
  SFwd F{};
  if (kEA) {
    F.r = cv.take(M);
    F.t = cv.take(M);
    F.ai = cv.take(g * R);
    F.oi = cv.take(g * H);
    const long long ldf = split_ld(d.R);
    F.df = cv.take(M * (kCP || ldf > H ? ldf : H));
    F.he = kCP ? nullptr : F.df;
    F.se = cv.take(M * split_ld(d.H));
    F.sem = cv.take(M * Kh);
    F.att = cv.take(M * Kh);
    F.rbf_m = cv.take(R);
    F.rbf_b = cv.take(R);
    F.w_rr = cv.take(H);
    F.b0 = cv.take(H);
    F.b1 = cv.take(H);
    F.b_sem = cv.take(Kh);
    F.w_sem = cv.take(H * Kh);
  }
  if (kCP) {
    F.u = cv.take(3 * M);
    F.rg.full = reinterpret_cast<unsigned long long*>(cv.take(4LL * stages));
    F.rg.empty = F.rg.full ? F.rg.full + stages : nullptr;
    F.rg.stages = stages;
    F.x = cv.take((long long)kWgRows * (kWgCols + kWgXPad));
    F.rg.ring = cv.take((long long)stages * kWgStage);
  }
  return F;
}

template <bool kEA, bool kCP>
inline long long split_fwd_smem_bytes(const SDims& d, int stages) {
  Carver cv{nullptr};
  carve_split_fwd<kEA, kCP>(cv, d, stages);
  return cv.off * (long long)sizeof(float);
}

// The forward's ring: the deepest (kWgMaxStages ... kWgMinStages) whose carve
// fits its blocks an SM (the edge_att op has no ring: 0), or -1 where none does.
template <bool kEA, bool kCP>
inline int split_fwd_stages(const SDims& d) {
  if (!kCP) return split_fwd_smem_bytes<kEA, kCP>(d, 0) <= kSplitSmemLimit ? 0 : -1;
  for (int s = kWgMaxStages; s >= kWgMinStages; --s)
    if (split_fwd_smem_bytes<kEA, kCP>(d, s) <= kSplitSmemLimit) return s;
  return -1;
}

// The forward's route: the pullback's widths (split_tc_dims) and a carve that
// fits, else the CUDA cores (split_kernel, a row a block).
inline bool split_fwd_tc(int op, const SDims& d) {
#ifdef SAKE_SPLIT_CUDA_CORES  // tools/probe_split.py's probe build of the CUDA-core route
  return false;
#endif
  switch (op) {
    case OP_EDGE_ATT: return split_tc_dims(d, false) && split_fwd_stages<true, false>(d) >= 0;
    case OP_COEFF_POOL: return split_tc_dims(d, true) && split_fwd_stages<false, true>(d) >= 0;
    default: return split_tc_dims(d, true) && split_fwd_stages<true, true>(d) >= 0;
  }
}

// Rows i0 ... i0 + gn - 1 of molecule b, their M = gn N edges stacked as in
// split_group: the forward of the JAX bodies on M edges at once, the sums over
// an edge's wide rows by a warp each, the sums over senders in sender order.
// aj, oj: the molecule's a_j and o_j (kEA); prefill: the block has a next
// group, whose x-mixing's ring may start to fill once this one's is done.
template <bool kEA, bool kCP>
__device__ void split_group_fwd(const SplitArgs& A, const SFwd& F, WgRing& rg,
                                const WgPlanes& P, const float* aj, const float* oj, int b,
                                int i0, int gn, bool prefill) {
  const SDims d = A.d;
  const int N = d.N, R = d.R, H = d.H, Kh = d.Kh, C = d.C, HK = H * Kh, M = gn * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
  const size_t mol = (size_t)b * N;  // the molecule's first atom
  const size_t row0 = mol + i0;      // the group's first receiver
  const size_t eb = row0 * N;        // the group's first edge (b, i0, 0)
  const FastDiv fN(N), fR(R);
  constexpr int ldx = kWgCols + kWgXPad;
  float* X = F.x;
  float* he = kCP ? X : F.he;  // h_e's rows (kEA), ldh apart
  const int ldh = kCP ? ldx : H, ldf = split_ld(R), lde = split_ld(H);

  // -- geometry: r = sqrt(relu(|d|^2) + eps) and t = exp(-r) (kEA); u_k = d_k /
  //    (r + 1e-5) (kCP)
  for (int q = tid; q < M; q += nt) {
    const int j = fN.mod(q);
    const size_t row = row0 + fN.div(q);
    float dk[3], s = 0.f;
    for (int k = 0; k < 3; ++k) {
      dk[k] = A.x[k][mol + j] - A.x[k][row];
      s += dk[k] * dk[k];
    }
    const float r = sqrtf(fmaxf(s, 0.f) + kEps);
    if constexpr (kEA) {
      F.r[q] = r;
      F.t[q] = expf(-r);
    }
    if constexpr (kCP) {
      const float ir = 1.f / (r + 1e-5f);
      for (int k = 0; k < 3; ++k) F.u[k * M + q] = dk[k] * ir;
    }
  }

  if constexpr (kEA) {
    split_copy(F.ai, A.ai + row0 * R, gn * R);
    split_copy(F.oi, A.oi + row0 * H, gn * H);
    SPLIT_SYNC(PR_SPL_LOAD);
    // -- filtered = rbf * pre, pre = a_j + a_i (b_in folded into a_i), rbf =
    //    exp(-b (t - m)^2)
    for (int q = tid; q < M * R; q += nt) {
      const int e = fR.div(q), c = q - e * R, ii = fN.div(e);
      const float pre = aj[(e - ii * N) * R + c] + F.ai[ii * R + c];
      const float tm = F.t[e] - F.rbf_m[c];
      F.df[e * ldf + c] = expf(-F.rbf_b[c] * (tm * tm)) * pre;
    }
    SPLIT_SYNC(PR_SPL_ROW);
    // -- silu(e0), e0 = o_j + o_i + filtered @ w_r + r * w_rr + b0
    mm_tc_small(M, R, H, F.df, ldf, A.w_r, [&](int e, int c, float v) {
      const int ii = fN.div(e);
      F.se[e * lde + c] =
          siluf_(oj[(e - ii * N) * H + c] + F.oi[ii * H + c] + v + F.r[e] * F.w_rr[c] + F.b0[c]);
    });
    SPLIT_SYNC(PR_SPL_MM);
    // -- h_e = silu(e0) @ w1 + b1
    mm_tc_small(M, H, H, F.se, lde, A.w1,
                [&](int e, int c, float v) { he[e * ldh + c] = v + F.b1[c]; });
    SPLIT_SYNC(PR_SPL_MM);
    // -- the edge_att op's h_e out: the group's edges are one contiguous range
    if constexpr (!kCP)
      for (int q = tid; q < M * H; q += nt) A.he_out[eb * H + q] = he[q];
    // -- sem_pre = h_e @ w_sem + b_sem, a warp an edge (w_sem's rows as float4:
    //    Kh is 4, 8 or 16)
    for (int e = warp; e < M; e += nwarp) {
      float part[kSplitMaxHeads];  // this lane's share, a head each
#pragma unroll
      for (int c = 0; c < kSplitMaxHeads; ++c) part[c] = 0.f;
      for (int k = lane; k < H; k += 32) {
        const float hv = he[e * ldh + k];
#pragma unroll
        for (int c = 0; c < kSplitMaxHeads; c += 4)
          if (c < Kh) {
            const float4 w = *reinterpret_cast<const float4*>(F.w_sem + k * Kh + c);
            part[c] += hv * w.x;
            part[c + 1] += hv * w.y;
            part[c + 2] += hv * w.z;
            part[c + 3] += hv * w.w;
          }
      }
#pragma unroll
      for (int c = 0; c < kSplitMaxHeads; ++c)
        if (c < Kh) {
          const float v = warp_sum(part[c]);
          if (lane == 0) F.sem[e * Kh + c] = v + F.b_sem[c];
        }
    }
    SPLIT_SYNC(PR_SPL_SEM);
    // -- att = softmax over j of celu2(sem_pre) - kInf * [j == i], a warp a
    //    (row, head)
    for (int p = warp; p < gn * Kh; p += nwarp) {
      const int ii = p / Kh, i = i0 + ii;
      float* at = F.att + ii * N * Kh + p % Kh;
      const float* sm = F.sem + ii * N * Kh + p % Kh;
      float mx = -INFINITY;
      for (int j = lane; j < N; j += 32) {
        const float l = celu2_(sm[j * Kh]) - (j == i ? kInf : 0.f);
        at[j * Kh] = l;
        mx = fmaxf(mx, l);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float e = expf(at[j * Kh] - mx);
        at[j * Kh] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < N; j += 32) at[j * Kh] = at[j * Kh] / sum;
    }
    SPLIT_SYNC(PR_SPL_SEM);
    if constexpr (!kCP) {
      // -- the edge_att op's att out; the next group writes none of what this reads
      //    before its first barrier
      for (int q = tid; q < M * Kh; q += nt) A.att_out[eb * Kh + q] = F.att[q];
      SAKE_PROBE(PR_SPL_POOL);
    }
  } else {
    SAKE_PROBE_BARRIER(PR_SPL_LOAD);
  }

  if constexpr (kCP) {
    // -- he_att[e, h * Kh + k] = h_e[e, h] * att[e, k] into X's row e, a warp an
    //    edge, two edges at a time: the lanes read both rows' h_e (from device
    //    memory, or in place from X's rows) and att before any lane writes, then
    //    write a lane's Kh values of each h as float4 (Kh = 256 / H is 4, 8 or 16)
    const float* hs = kEA ? X : A.he_in + eb * H;
    const int lds = kEA ? ldx : H;
    const float* as = kEA ? F.att : A.att_in + eb * Kh;
    auto ld = [](const float* p) {
      if constexpr (kEA) return *p;
      else return __ldg(p);
    };
    constexpr int kU = kTcSmallK / 32;  // h a lane
    for (int e0 = warp; e0 < M; e0 += 2 * nwarp) {
      float hv[2][kU], av[2][kSplitMaxHeads];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int e = e0 + v * nwarp;
#pragma unroll
        for (int u = 0; u < kU; ++u)
          hv[v][u] = e < M && lane + 32 * u < H ? ld(hs + e * lds + lane + 32 * u) : 0.f;
#pragma unroll
        for (int k = 0; k < kSplitMaxHeads; ++k)
          av[v][k] = e < M && k < Kh ? ld(as + e * Kh + k) : 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int e = e0 + v * nwarp;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int h = lane + 32 * u;
          if (e < M && h < H)
#pragma unroll
            for (int k = 0; k < kSplitMaxHeads; k += 4)
              if (k < Kh)
                *reinterpret_cast<float4*>(X + e * ldx + h * Kh + k) =
                    float4{hv[v][u] * av[v][k], hv[v][u] * av[v][k + 1],
                           hv[v][u] * av[v][k + 2], hv[v][u] * av[v][k + 3]};
        }
      }
    }
    SPLIT_SYNC(PR_SPL_EPI);
    // -- hatt_sum = sum_j he_att, the senders in order, before the x-mixing
    //    overwrites X
    for (int q = tid; q < gn * HK; q += nt) {
      const int ii = q / HK, p = q - ii * HK;
      const float* xc = X + ii * N * ldx + p;
      float a = 0.f;
      for (int j = 0; j < N; ++j) a += xc[j * ldx];
      A.hs[row0 * HK + q] = a;
    }
    SAKE_PROBE(PR_SPL_POOL);
    // -- coeff = tanh(he_att @ w_xmix), into X, the ring's first stages already
    //    on their way; then the next group's
    auto af = [&](int r, int k) { return X[r * ldx + k]; };
    wg_xmix<true, PR_SPL_XMIX, PR_SPL_RING>(
        M, af, P.fwd, rg, [&](int r, int c, float v) { X[r * ldx + c] = tanhf(v); });
    if (prefill) wg_prefill(rg, P.fwd);
    SPLIT_SYNC(PR_SPL_XMIX);
    // -- pooled_k = sum_j coeff * u_k, the senders in order
    for (int q = tid; q < gn * C; q += nt) {
      const int ii = q / C, c = q - ii * C;
      const float* xc = X + ii * N * ldx + c;
      const float* u = F.u + ii * N;
      float p0 = 0.f, p1 = 0.f, p2 = 0.f;
      for (int j = 0; j < N; ++j) {
        const float co = xc[j * ldx];
        p0 += co * u[j];
        p1 += co * u[M + j];
        p2 += co * u[2 * M + j];
      }
      A.pool[0][row0 * C + q] = p0;
      A.pool[1][row0 * C + q] = p1;
      A.pool[2][row0 * C + q] = p2;
    }
    SPLIT_SYNC(PR_SPL_POOL);  // the next group reuses X and u
  }
}

// The forward route's kernel: a block strides over the groups of split_tc_rows
// receiver rows; stages: the ring's depth (split_fwd_stages). The grid holds
// as many blocks as the card runs at once. The edge_att op's forward is
// latency-bound (mm_tc_small's chains, the warp-wide sums): four blocks an SM at
// 64 registers a thread, no spills at aspirin's widths.
template <bool kEA, bool kCP>
__global__ void __launch_bounds__(kSplitThreads, kCP ? 1 : 4)
    split_tc_fwd_kernel(SplitArgs A, WgPlanes P, int stages) {
  extern __shared__ float4 smem4[];
  Carver cv{reinterpret_cast<float*>(smem4)};
  SFwd F = carve_split_fwd<kEA, kCP>(cv, A.d, stages);
  const int N = A.d.N, R = A.d.R, H = A.d.H, g = split_tc_rows(N), ng = (N + g - 1) / g;
  if constexpr (kCP) wg_init(F.rg);
  if constexpr (kEA) {
    split_copy(F.rbf_m, A.rbf_m, R);
    split_copy(F.rbf_b, A.rbf_b, R);
    split_copy(F.w_rr, A.w_rr, H);
    split_copy(F.b0, A.b0, H);
    split_copy(F.b1, A.b1, H);
    split_copy(F.b_sem, A.b_sem, A.d.Kh);
    split_copy(F.w_sem, A.w_sem, H * A.d.Kh);
  }
  __syncthreads();
  SAKE_PROBE_START();
  const long long items = (long long)A.d.B * ng;
  if constexpr (kCP)
    if (blockIdx.x < items) wg_prefill(F.rg, P.fwd);
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const int b = (int)(w / ng), k = (int)(w % ng);
    const size_t mol = (size_t)b * N;
    const float* aj = kEA ? A.aj + mol * R : nullptr;
    const float* oj = kEA ? A.oj + mol * H : nullptr;
    split_group_fwd<kEA, kCP>(A, F, F.rg, P, aj, oj, b, k * g, min(g, N - k * g),
                              w + gridDim.x < items);
  }
}

// Launch on the route, with the deepest ring that fits; an invalid value where
// the shape is not the route's (split_fwd_tc) or the op mixes x and its plane is
// missing.
template <bool kEA, bool kCP>
int launch_split_tc_fwd(const SplitArgs& A, const WgPlanes& P, void* stream) {
  const int stages = split_fwd_stages<kEA, kCP>(A.d);
  if (!split_tc_dims(A.d, kCP) || stages < 0 || (kCP && !P.fwd))
    return (int)cudaErrorInvalidValue;
  const long long smem = split_fwd_smem_bytes<kEA, kCP>(A.d, stages);
  auto kern = split_tc_fwd_kernel<kEA, kCP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kSplitThreads,
                                                           (size_t)smem)) != cudaSuccess)
    return (int)err;
  const int g = split_tc_rows(A.d.N);
  const long long items = (long long)A.d.B * ((A.d.N + g - 1) / g);
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long grid = items < full ? items : full;
  if (grid > 0)
    kern<<<(unsigned)grid, kSplitThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, P,
                                                                                    stages);
  return (int)cudaGetLastError();
}

// The shared memory of the pullback's kernel at d: the route's carve at its
// ring's depth where it takes d, else split_kernel's.
inline long long split_bwd_smem(int op, const SDims& d) {
  const bool tc = split_bwd_tc(op, d);
  switch (op) {
    case OP_EDGE_ATT:
      return tc ? split_tc_smem_bytes<true, false>(d, 0) : split_smem_bytes<true, false, true>(d);
    case OP_COEFF_POOL:
      return tc ? split_tc_smem_bytes<false, true>(d, split_tc_stages<false, true>(d))
                : split_smem_bytes<false, true, true>(d);
    default:
      return tc ? split_tc_smem_bytes<true, true>(d, split_tc_stages<true, true>(d))
                : split_smem_bytes<true, true, true>(d);
  }
}

// The shared memory of the op's forward (pull false) or pullback kernel at d: the
// kernel its route launches.
inline long long split_smem(int op, bool pull, const SDims& d) {
  if (pull) return split_bwd_smem(op, d);
  const bool tc = split_fwd_tc(op, d);
  switch (op) {
    case OP_EDGE_ATT:
      return tc ? split_fwd_smem_bytes<true, false>(d, 0) : split_smem_bytes<true, false, false>(d);
    case OP_COEFF_POOL:
      return tc ? split_fwd_smem_bytes<false, true>(d, split_fwd_stages<false, true>(d))
                : split_smem_bytes<false, true, false>(d);
    default:
      return tc ? split_fwd_smem_bytes<true, true>(d, split_fwd_stages<true, true>(d))
                : split_smem_bytes<true, true, false>(d);
  }
}

// in: x0, x1, x2, a_j, a_i, o_j, o_i, h_e, att (null where the op takes none);
// w: the kSplitWPtrs weights and transposes.
inline SplitArgs split_args(const void* const* in, const void* const* w, int B, int N, int R,
                            int H, int Kh, int C) {
  SplitArgs A{};
  A.d = SDims{B, N, R, H, Kh, C};
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  for (int k = 0; k < 3; ++k) A.x[k] = f(in[k]);
  A.aj = f(in[3]);
  A.ai = f(in[4]);
  A.oj = f(in[5]);
  A.oi = f(in[6]);
  A.he_in = f(in[7]);
  A.att_in = f(in[8]);
  A.rbf_m = f(w[0]);
  A.rbf_b = f(w[1]);
  A.w_r = f(w[2]);
  A.w_rr = f(w[3]);
  A.b0 = f(w[4]);
  A.w1 = f(w[5]);
  A.b1 = f(w[6]);
  A.w_sem = f(w[7]);
  A.b_sem = f(w[8]);
  A.w_xmix = f(w[9]);
  A.t_r = f(w[10]);
  A.t_1 = f(w[11]);
  A.t_sem = f(w[12]);
  A.t_xmix = f(w[13]);
  return A;
}

}  // namespace sake
