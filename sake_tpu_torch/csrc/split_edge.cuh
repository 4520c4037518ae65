// The O(N^2) middle of a dense SAKE layer as the split ops compute it, one
// receiver row at a time, and its hand-written pullback: the body of the
// split kernels #25-#28 (split_fwd.cu, split_bwd.cu).
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
// With kPull the row runs its forward again and then the pullback of the
// cotangents of its outputs; with kRows it also writes the per-edge
// cotangent rows (SplitRow) whose contraction over all edges is the weight
// cotangent (sparse_contract.cu sums them in a fixed order).
//
// Everything forward is local to a receiver row i, so a forward block owns
// one row. The pullback is not: x_j, a_j and o_j get cotangents from every
// receiver. A pullback block owns a whole molecule, runs its N rows in
// order and adds the sender-side cotangents into shared memory (N * (R + H
// + 3) floats) one thread per element, so results do not vary from run to
// run (no atomics). The products reuse the sparse edge chain's helpers
// (sparse_edge.cuh): mm_wide stages kWTile rows of a weight (w_xmix is 256
// KB) in shared memory, mmT streams narrow ones from L2. The head
// expansion he_att[j, h * Kh + k] = h_e[j, h] * att[j, k] runs in chunks of
// at most 16 senders. The softmax's cotangent row sums run in f64: they
// cancel.
#pragma once

#include "sparse_edge.cuh"

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
  __syncthreads();

  if constexpr (kEA) {
    // -- pre = a_j + a_i (b_in folded into a_i); rbf = exp(-b (t - m)^2)
    for (int q = tid; q < N * R; q += nt) {
      const int j = q / R, c = q % R;
      S.pre[q] = A.aj[(mol + j) * R + c] + S.ai[c];
      const float tm = S.t[j] - A.rbf_m[c];
      S.rbf[q] = expf(-A.rbf_b[c] * (tm * tm));
    }
    __syncthreads();
    // -- e0 = o_j + o_i + (rbf * pre) @ w_r + r * w_rr + b0
    mmT<float>(N, R, H, [&](int r, int k) { return S.rbf[r * R + k] * S.pre[r * R + k]; }, A.w_r,
               [&](int r, int c, float v) {
                 S.e0[r * H + c] = A.oj[(mol + r) * H + c] + S.oi[c] + v + S.r[r] * A.w_rr[c] +
                                   A.b0[c];
               });
    __syncthreads();
    for (int q = tid; q < N * H; q += nt) S.se[q] = siluf_(S.e0[q]);
    __syncthreads();
    // -- h_e = silu(e0) @ w1 + b1
    mm_wide<float>(N, H, H, S.se, H, A.w1, S.ws,
                   [&](int r, int c, float v) { S.he[r * H + c] = v + A.b1[c]; });
    __syncthreads();
    // -- sem_pre = h_e @ w_sem + b_sem
    mmT<float, 1>(N, H, Kh, [&](int r, int k) { return S.he[r * H + k]; }, A.w_sem,
                  [&](int r, int c, float v) { S.sem[r * Kh + c] = v + A.b_sem[c]; });
    __syncthreads();
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
    __syncthreads();
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
      __syncthreads();
      // coeff = tanh(he_att @ w_xmix)
      mm_wide<float>(n, HK, C, S.wa, HK, A.w_xmix, S.ws,
                     [&](int r, int c, float v) { S.wb[r * C + c] = tanhf(v); });
      __syncthreads();
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
        __syncthreads();
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
        __syncthreads();
        if constexpr (kRows)
          for (int q = tid; q < n * C; q += nt) A.rows[SR_D_XM][(eb + c0) * C + q] = S.wb[q];
        // d_he_att = d_xm @ w_xmix^T + g_hatt_sum
        mm_wide<float>(n, C, HK, S.wb, C, A.t_xmix, S.ws,
                       [&](int r, int c, float v) { S.wa[r * HK + c] = v + S.ghs[c]; });
        __syncthreads();
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
      __syncthreads();
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
    __syncthreads();
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
    __syncthreads();
    if constexpr (kRows)
      for (int q = tid; q < N * H; q += nt) A.rows[SR_D_H_E][eb * H + q] = S.ghe[q];
    // -- d_e0 = (d_h_e @ w1^T) * silu'(e0), in place of e0
    mm_wide<float>(N, H, H, S.ghe, H, A.t_1, S.ws,
                   [&](int r, int c, float v) { S.e0[r * H + c] = v * dsiluf_(S.e0[r * H + c]); });
    __syncthreads();
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
    __syncthreads();
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
    __syncthreads();
    // -- d_pre = d_filtered * rbf; d_a_i = sum_j d_pre; the senders' d_a_j += d_pre
    for (int q = tid; q < N * R; q += nt) S.df[q] *= S.rbf[q];
    __syncthreads();
    for (int c = tid; c < R; c += nt) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += S.df[j * R + c];
      A.d_ai[row * R + c] = acc;
    }
    for (int q = tid; q < N * R; q += nt) S.aaj[q] += S.df[q];
  }

  if constexpr (kPull) {
    __syncthreads();
    // -- d_d = d_u inv_r + 2 d d_s, with d_r -= inv_r^2 (d_u . d) and d_s =
    //    d_r * 0.5 / r where |d|^2 > 0 (the relu), into du
    for (int j = tid; j < N; j += nt) {
      const float ir = S.ir[j];
      const float dir = S.du[j] * S.d[j] + S.du[N + j] * S.d[N + j] + S.du[2 * N + j] * S.d[2 * N + j];
      const float dr = S.dr[j] - (ir * ir) * dir;
      const float ds = S.s[j] > 0.f ? dr * (0.5f / S.r[j]) : 0.f;
      for (int k = 0; k < 3; ++k) S.du[k * N + j] = S.du[k * N + j] * ir + 2.f * S.d[k * N + j] * ds;
    }
    __syncthreads();
    // -- d = x_j - x_i: the sender x_j gets d_d, the receiver x_i minus the row's sum
    for (int q = tid; q < 3 * N; q += nt) {
      const int k = q / N, j = q % N;
      float v = S.du[q];
      if (j == i)
        for (int jj = 0; jj < N; ++jj) v -= S.du[k * N + jj];
      S.ax[q] += v;
    }
  }
  __syncthreads();  // the next row reuses the buffers
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
      __syncthreads();
      for (int i = 0; i < N; ++i) split_row<kEA, kCP, true, kRows>(A, S, b, i, kc);
      for (int q = threadIdx.x; q < 3 * N; q += blockDim.x) A.dx[q / N][mol + q % N] = S.ax[q];
      if constexpr (kEA) {
        for (int q = threadIdx.x; q < N * R; q += blockDim.x) A.d_aj[mol * R + q] = S.aaj[q];
        for (int q = threadIdx.x; q < N * H; q += blockDim.x) A.d_oj[mol * H + q] = S.aoj[q];
      }
      __syncthreads();
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

inline long long split_smem(int op, bool pull, const SDims& d) {
  switch (op) {
    case OP_EDGE_ATT:
      return pull ? split_smem_bytes<true, false, true>(d) : split_smem_bytes<true, false, false>(d);
    case OP_COEFF_POOL:
      return pull ? split_smem_bytes<false, true, true>(d) : split_smem_bytes<false, true, false>(d);
    default:
      return pull ? split_smem_bytes<true, true, true>(d) : split_smem_bytes<true, true, false>(d);
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
