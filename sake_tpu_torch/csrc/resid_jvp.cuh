// The tangent forward's per-layer body: layer_jvp_resid of one molecule and
// one layer on saved residuals, for a whole thread block. resid_jvp.cu runs
// it over depth (#9); fused_bwd.cu runs it as phase 1 of the fused training
// backward (#12). See resid_jvp.cu for the design and what bounds it. Its
// kTc instantiation (#12) runs the x-mixing product on the tensor cores
// (mma_tf32x3.cuh); its kE16 instantiation (#12 in resid_ef's bf16 tier,
// fused_bwd16.cu) is the tangent forward of that tier.
#pragma once

#include "mma_tf32x3.cuh"
#include "resid_common.cuh"

namespace sake {

constexpr int kJvpTileCols = 4;      // columns per tile in mm_tiled
constexpr int kJvpTiledMinCols = 16; // narrowest tiled product

template <bool kRoundA = false, class ST>
__device__ __forceinline__ void mm_jvp(int n, int kd, int m, const float* A, int lda,
                                       const float* __restrict__ W, ST st) {
  mm_smem<kJvpTileCols, kJvpTiledMinCols, kRoundA>(n, kd, m, A, lda, W, st);
}

// Shared-memory buffers of the tangent forward, in floats: the tangent state and the layer's
// primal inputs, node projections, per-row buffers, and a node scratch the
// node phase carves from the row buffers once all rows are done.
struct JvpSmem {
  float *sth, *stx, *stv, *sh, *sx, *sv, *saj, *sai, *staj, *stai, *stoj, *stoi, *sthatt,
      *stdel;
  float *sd, *std_, *sgeo, *sfilt, *se, *she, *stl, *satt, *stat, *shea, *scf;
};

// kTc: the carve of the kTc body (t_he_att's rows padded, tc_ld).
template <bool kTc = false>
__host__ __device__ inline JvpSmem carve_jvp(Carver& cv, const Dims& d) {
  const long long N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  JvpSmem s;
  s.sth = cv.take(N * F);         // tangent h (state)
  s.stx = cv.take(3 * N);         // tangent x planes
  s.stv = cv.take(3 * N);         // tangent v planes
  s.sh = cv.take(N * F);          // primal h entering the layer
  s.sx = cv.take(3 * N);
  s.sv = cv.take(3 * N);
  s.saj = cv.take(N * R);         // h @ w_in_j + b_in
  s.sai = cv.take(N * R);         // h @ w_in_i
  s.staj = cv.take(N * R);        // th @ w_in_j
  s.stai = cv.take(N * R);
  s.stoj = cv.take(N * H);        // th @ w_o_j
  s.stoi = cv.take(N * H);
  s.sthatt = cv.take(N * H * K);  // sum_j t_he_att
  s.stdel = cv.take(3 * N);       // t_pooled_k @ w_vmix
  s.sd = cv.take(3 * N);          // row: d_k[j] = x_k[j] - x_k[i]
  s.std_ = cv.take(3 * N);        // row: its tangent
  s.sgeo = cv.take(5 * N);        // row: r, 1 / (r + 1e-5), t_r, t_inv_r, t_t
  s.sfilt = cv.take(N * R);       // row: t_filtered
  s.se = cv.take(N * H);          // row: dsilu(e0) * t_e0; node: dsilu(ps0) * t_ps0
  s.she = cv.take(N * H);         // row: t_h_e; node: dsilu(ps1) * t_ps1
  s.stl = cv.take(N * K);         // row: t_sem_pre
  s.satt = cv.take(N * K);        // row: att
  s.stat = cv.take(N * K);        // row: t_att
  // row: t_he_att; node: t_node_pre, t_uv, t_g0, t_g1
  if constexpr (kTc) {
    const long long hk = tc_ld(d, H * K);
    s.shea = cv.take((hk > 2 * H + F + 1 ? hk : 2 * H + F + 1) * N);
  } else {
    s.shea = cv.take((H * K > 2 * H + F + 1 ? H * K : 2 * H + F + 1) * N);
  }
  s.scf = cv.take(N * C);         // row: t_coeff; node: t_pool_sq
  return s;
}

template <bool kTc = false>
__host__ __device__ inline long long jvp_smem_floats(const Dims& d) {
  Carver cv{nullptr};
  carve_jvp<kTc>(cv, d);
  return cv.off;
}

// The tangent seed (0, tx0, 0) of molecule m of a batch of B (tx0 in the
// (3, B, N) layout) into S.sth, S.stx, S.stv.
__device__ __forceinline__ void jvp_begin(const Dims& d, const JvpSmem& S, int B, int m,
                                          const float* __restrict__ tx0) {
  const int N = d.N, F = d.F, tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < N * F; e += nt) S.sth[e] = 0.f;
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    S.stx[e] = tx0[((size_t)k * B + m) * N + i];
    S.stv[e] = 0.f;
  }
  __syncthreads();
}

// Layer l of the tangent forward on the tangent state in S. Reads the
// primal boundary states and residuals (bh, bx, bv, RS) and writes the
// tangent ones (tbh, tbx, tbv, TR) at molecule slot b of d.B, layer l. With
// bh null the primal state entering the layer is already in S.sh, S.sx,
// S.sv (a kernel that has just computed the residuals in this launch); with
// tbh null no tangent boundary is written. kTc: the x-mixing and edge products
// on the tensor cores in 3xTF32 (S from carve_jvp<true>, ring: tc_ring_floats)
// where tc_dims allows; without it every product runs on the CUDA cores.
// kE16: resid_ef's bf16 tier (layer_jvp_resid with JAX's mm_edge in bf16):
// the primal streams RS and the tangent streams TR are Resids16 (bf16 but r
// and t; read widened by get_res, written rounded by put_res); the tangent
// edge products t_o_f, t_h_e, t_sem_pre and the x-mixing round both operands
// (L holds w_o_f, w_o1, w_sem, w_xmix rounded; the activation is rounded as
// it is read), one pass on the tensor cores; t_he_att forms from bf16(t_h_e),
// bf16(att), bf16(h_e) and bf16(t_att) (att and h_e are bf16 values already),
// and t_hatt sums it unrounded. The row loop goes on with the f32 tangents it
// stores rounded; its tangent pooled vectors also go, in f32, to slot b of a
// one-layer (3, d.B, N, C) scratch tpool16, which the node phase reads (the
// stream holds them rounded). kLowRes (default kE16): whether RS and TR are
// the bf16 streams; kE16 without it (#18 in the tier: JAX's jax.jvp of
// layer_fwd_resid, which rounds the residuals only as it stores them) reads
// the primal's f32 residuals, rounds att and h_e where t_he_att takes them,
// writes every tangent stream in f32 and reads its tangent pooled vectors
// back from TR (tpool16 unused).
template <bool kTc = false, bool kE16 = false, bool kLowRes = kE16>
__device__ __forceinline__ void jvp_layer(const Dims& d, const JvpSmem& S, int b, int l,
                                          float u, const Leaves& L,
                                          const float* __restrict__ bh,
                                          const float* __restrict__ bx,
                                          const float* __restrict__ bv,
                                          const ResidsOf<kLowRes>& RS, float* tbh, float* tbx,
                                          float* tbv, const ResidsOf<kLowRes>& TR,
                                          float* ring = nullptr, float* tpool16 = nullptr) {
  static_assert(kE16 || !kLowRes, "bf16 streams belong to the bf16 tier");
  constexpr int kPasses = kE16 ? 1 : 3;  // of the tensor-core products
  const int B = d.B, N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  const int HK = H * K, NN = N * N;
  [[maybe_unused]] const int ldx = kTc ? tc_ld(d, HK) : HK;  // kTc: shea's row stride
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
  const float n_eff = (float)N;
  float *sth = S.sth, *stx = S.stx, *stv = S.stv, *sh = S.sh, *sx = S.sx, *sv = S.sv,
        *saj = S.saj, *sai = S.sai, *staj = S.staj, *stai = S.stai, *stoj = S.stoj,
        *stoi = S.stoi, *sthatt = S.sthatt, *stdel = S.stdel, *sd = S.sd, *std_ = S.std_,
        *sfilt = S.sfilt, *se = S.se, *she = S.she, *stl = S.stl, *satt = S.satt,
        *stat = S.stat, *shea = S.shea, *scf = S.scf;
  float *sr = S.sgeo, *sir = sr + N, *str = sir + N, *stir = str + N, *stt = stir + N;
  float* stnp = shea;             // node: (N, H) t_node_pre -> dsilu * t_node_pre
  float* stuv = stnp + N * H;     // node: (N, F) t_uv
  float* stg0 = stuv + N * F;     // node: (N, H) dsilu(g0) * t_g0
  float* stg1 = stg0 + N * H;     // node: (N) t_g1

  const size_t lb = (size_t)l * B + b;
  auto W = [&](int leaf) { return L.at(leaf, l); };
  const float* b_in = W(B_IN);
  const float* rbf_m = W(RBF_M);
  const float* rbf_b = W(RBF_B);
  const float* w_o_r = W(W_O_R);
  // this layer's node stream r (width ch) of molecule b, atom 0
  auto node = [&](const auto& Q, int r, int ch) { return Q.p[r] + lb * N * ch; };

  // tangent boundary state out, primal boundary state in
  for (int e = tid; e < N * F; e += nt) {
    if (tbh) tbh[lb * N * F + e] = sth[e];
    if (bh) sh[e] = bh[lb * N * F + e];
  }
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    const size_t at = (((size_t)l * 3 + k) * B + b) * N + i;
    if (tbh) {
      tbx[at] = stx[e];
      tbv[at] = stv[e];
    }
    if (bh) {
      sx[e] = bx[at];
      sv[e] = bv[at];
    }
  }
  __syncthreads();

  // node projections: a_j, a_i (recomputed) and the tangents of a_j, a_i, o_j, o_i
  mm_jvp(N, F, R, sh, F, W(W_IN_J), [&](int r, int c, float a) { saj[r * R + c] = a + b_in[c]; });
  mm_jvp(N, F, R, sh, F, W(W_IN_I), [&](int r, int c, float a) { sai[r * R + c] = a; });
  mm_jvp(N, F, R, sth, F, W(W_IN_J), [&](int r, int c, float a) { staj[r * R + c] = a; });
  mm_jvp(N, F, R, sth, F, W(W_IN_I), [&](int r, int c, float a) { stai[r * R + c] = a; });
  mm_jvp(N, F, H, sth, F, W(W_O_J), [&](int r, int c, float a) { stoj[r * H + c] = a; });
  mm_jvp(N, F, H, sth, F, W(W_O_I), [&](int r, int c, float a) { stoi[r * H + c] = a; });
  __syncthreads();
  SAKE_PROBE(PR_JVP_PRE);

  for (int i = 0; i < N; ++i) {
    // edge stream r (width ch) of this molecule and layer at edge (i, 0)
    auto edge = [&](const auto& Q, int r, int ch) {
      return Q.p[r] + (lb * NN + (size_t)i * N) * ch;
    };
    // the f32 streams r and t at edge (i, 0)
    [[maybe_unused]] const size_t eo = lb * NN + (size_t)i * N;

    // geometry: r = sqrt(relu(|d|^2) + eps), t = exp(-r), and their tangents
    for (int j = tid; j < N; j += nt) {
      float r, t;
      if constexpr (kE16) {
        r = res_r(RS)[eo + j];
        t = res_t(RS)[eo + j];
      } else {
        r = edge(RS, RS_R, 1)[j];
        t = edge(RS, RS_T, 1)[j];
      }
      float ts = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float dk = sx[k * N + j] - sx[k * N + i];
        const float tdk = stx[k * N + j] - stx[k * N + i];
        sd[k * N + j] = dk;
        std_[k * N + j] = tdk;
        ts += dk * tdk;
      }
      const float tr = (0.5f / r) * (r * r > kEps ? 1.f : 0.f) * (2.f * ts);
      const float ir = 1.f / (r + 1e-5f);
      sr[j] = r;
      sir[j] = ir;
      str[j] = tr;
      stir[j] = -(ir * ir) * tr;
      stt[j] = -t * tr;
      if constexpr (kE16) {
        res_r(TR)[eo + j] = tr;
        res_t(TR)[eo + j] = -t * tr;
      } else {
        edge(TR, RS_R, 1)[j] = tr;
        edge(TR, RS_T, 1)[j] = -t * tr;
      }
    }
    __syncthreads();

    // rbf = exp(-b (t - m)^2): t_rbf; t_filtered = t_rbf * pre + rbf * t_pre
    {
      const auto* rbf = edge(RS, RS_RBF, R);
      const float* tt;
      if constexpr (kE16) tt = res_t(RS) + eo;
      else tt = edge(RS, RS_T, 1);
      auto* trbf = edge(TR, RS_RBF, R);
      for (int e = tid; e < N * R; e += nt) {
        const int j = e / R, c = e % R;
        if constexpr (kE16) {
          const float v = get_res(rbf, e) * (-2.f * rbf_b[c] * (tt[j] - rbf_m[c])) * stt[j];
          put_res(trbf, e, v);
          sfilt[e] = v * (saj[e] + sai[i * R + c]) + get_res(rbf, e) * (staj[e] + stai[i * R + c]);
        } else {
          const float v = rbf[e] * (-2.f * rbf_b[c] * (tt[j] - rbf_m[c])) * stt[j];
          trbf[e] = v;
          sfilt[e] = v * (saj[e] + sai[i * R + c]) + rbf[e] * (staj[e] + stai[i * R + c]);
        }
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_JVP_ROW);

    // t_e0 = t_o_j[j] + t_o_i[i] + t_filtered @ w_o_f + t_r * w_o_r; se = dsilu(e0) * t_e0
    {
      const auto* e0 = edge(RS, RS_E0, H);
      auto* te0 = edge(TR, RS_E0, H);
      auto st_te0 = [&](int r, int c, float a) {
        const float v = stoj[r * H + c] + stoi[i * H + c] + a + str[r] * w_o_r[c];
        if constexpr (kE16) {
          put_res(te0, r * H + c, v);
          se[r * H + c] = dsiluf_(get_res(e0, r * H + c)) * v;
        } else {
          te0[r * H + c] = v;
          se[r * H + c] = dsiluf_(e0[r * H + c]) * v;
        }
      };
      if constexpr (kTc) {
        if (tc_dims(d)) mm_tc_small<kPasses>(N, R, H, sfilt, R, W(W_O_F), st_te0);
        else mm_jvp<kE16>(N, R, H, sfilt, R, W(W_O_F), st_te0);
      } else {
        mm_jvp<kE16>(N, R, H, sfilt, R, W(W_O_F), st_te0);
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_JVP_MM);

    // t_h_e = (dsilu(e0) * t_e0) @ w_o1
    {
      auto* the = edge(TR, RS_H_E, H);
      auto st_the = [&](int r, int c, float a) {
        she[r * H + c] = a;
        if constexpr (kE16) put_res(the, r * H + c, a);
        else the[r * H + c] = a;
      };
      if constexpr (kTc) {
        if (tc_dims(d)) mm_tc_small<kPasses>(N, H, H, se, H, W(W_O1), st_the);
        else mm_jvp<kE16>(N, H, H, se, H, W(W_O1), st_the);
      } else {
        mm_jvp<kE16>(N, H, H, se, H, W(W_O1), st_the);
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_JVP_MM);

    // t_sem_pre = t_h_e @ w_sem
    {
      auto* tsem = edge(TR, RS_SEM_PRE, K);
      mm_jvp<kE16>(N, H, K, she, H, W(W_SEM), [&](int r, int c, float a) {
        stl[r * K + c] = a;
        if constexpr (kE16) put_res(tsem, r * K + c, a);
        else tsem[r * K + c] = a;
      });
    }
    __syncthreads();
    SAKE_PROBE(PR_JVP_MM);

    // softmax over senders, jvp on the saved raw softmax: t_logits =
    // dcelu(sem_pre) * t_sem_pre (the additive masks are constant),
    // t_att = att * (t_logits - sum_j att * t_logits); one warp per head
    {
      const auto* att = edge(RS, RS_ATT, K);
      const auto* sem = edge(RS, RS_SEM_PRE, K);
      auto* tatt = edge(TR, RS_ATT, K);
      for (int k = warp; k < K; k += nwarp) {
        float s = 0.f;
        for (int j = lane; j < N; j += 32) {
          if constexpr (kE16) {
            const float sp = get_res(sem, j * K + k);
            const float tl = (sp > 0.f ? 1.f : expf(sp / 2.f)) * stl[j * K + k];
            stl[j * K + k] = tl;
            s += get_res(att, j * K + k) * tl;
          } else {
            const float sp = sem[j * K + k];
            const float tl = (sp > 0.f ? 1.f : expf(sp / 2.f)) * stl[j * K + k];
            stl[j * K + k] = tl;
            s += att[j * K + k] * tl;
          }
        }
        s = warp_sum(s);
        for (int j = lane; j < N; j += 32) {
          float a;
          if constexpr (kE16) a = get_res(att, j * K + k);
          else a = att[j * K + k];
          const float v = a * (stl[j * K + k] - s);
          satt[j * K + k] = a;
          stat[j * K + k] = v;
          if constexpr (kE16) put_res(tatt, j * K + k, v);
          else tatt[j * K + k] = v;
        }
      }
    }
    __syncthreads();

    // t_he_att[j, h*K + k] = t_h_e[j, h] * att[j, k] + h_e[j, h] * t_att[j, k]
    {
      const auto* h_e = edge(RS, RS_H_E, H);
      for (int e = tid; e < N * HK; e += nt) {
        const int j = e / HK, q = e % HK, h = q / K, k = q % K;
        if constexpr (kLowRes)  // att and h_e are bf16 values: both products exact
          shea[j * ldx + q] = bf16r(she[j * H + h]) * satt[j * K + k] +
                              get_res(h_e, j * H + h) * bf16r(stat[j * K + k]);
        else if constexpr (kE16)  // the f32 att and h_e rounded as JAX's heE and attE
          shea[j * ldx + q] = bf16r(she[j * H + h]) * bf16r(satt[j * K + k]) +
                              bf16r(h_e[j * H + h]) * bf16r(stat[j * K + k]);
        else if constexpr (kTc)
          shea[j * ldx + q] = she[j * H + h] * satt[j * K + k] + h_e[j * H + h] * stat[j * K + k];
        else
          shea[e] = she[j * H + h] * satt[j * K + k] + h_e[j * H + h] * stat[j * K + k];
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_JVP_ROW);

    // t_hatt_sum[i] = sum_j t_he_att[j]; t_coeff = (1 - coeff^2) * (t_he_att @ w_xmix)
    for (int q = tid; q < HK; q += nt) {
      float s = 0.f;
      if constexpr (kTc)
        for (int j = 0; j < N; ++j) s += shea[j * ldx + q];
      else
        for (int j = 0; j < N; ++j) s += shea[j * HK + q];
      sthatt[i * HK + q] = s;
    }
    {
      const auto* cf = edge(RS, RS_COEFF, C);
      auto* tcf = edge(TR, RS_COEFF, C);
      auto st_tcoeff = [&](int r, int c, float a) {
        float f;
        if constexpr (kE16) f = get_res(cf, r * C + c);
        else f = cf[r * C + c];
        const float v = (1.f - f * f) * a;
        scf[r * C + c] = v;
        if constexpr (kE16) put_res(tcf, r * C + c, v);
        else tcf[r * C + c] = v;
      };
      if constexpr (kTc) {
        if (tc_dims(d)) mm_tc<3, kPasses>(N, shea, ldx, W(W_XMIX), ring, st_tcoeff);
        else mm_jvp<kE16>(N, HK, C, shea, ldx, W(W_XMIX), st_tcoeff);
      } else {
        mm_jvp<kE16>(N, HK, C, shea, HK, W(W_XMIX), st_tcoeff);
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_JVP_XMIX);

    // t_pooled_k[i] = sum_j t_coeff * u_k + coeff * t_u_k, u_k = d_k / (r + 1e-5)
    {
      const auto* cf = edge(RS, RS_COEFF, C);
      for (int c = tid; c < C; c += nt) {
        float p[3] = {0.f, 0.f, 0.f};
        for (int j = 0; j < N; ++j) {
          float tc, f;
          if constexpr (kE16) {
            tc = scf[j * C + c];
            f = get_res(cf, j * C + c);
          } else {
            tc = scf[j * C + c], f = cf[j * C + c];
          }
          const float ir = sir[j], tir = stir[j];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            p[k] += tc * (sd[k * N + j] * ir) + f * (std_[k * N + j] * ir + sd[k * N + j] * tir);
        }
        if constexpr (kLowRes) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            put_res(node(TR, RS_POOL0 + k, C), i * C + c, p[k]);
            tpool16[((size_t)k * B + b) * N * C + i * C + c] = p[k];
          }
        } else {
          node(TR, RS_POOL0, C)[i * C + c] = p[0];
          node(TR, RS_POOL1, C)[i * C + c] = p[1];
          node(TR, RS_POOL2, C)[i * C + c] = p[2];
        }
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_JVP_ROW);
  }

  // ---- node phase ------------------------------------------------------
  const ResOf<kLowRes>* pool[3] = {node(RS, RS_POOL0, C), node(RS, RS_POOL1, C),
                                   node(RS, RS_POOL2, C)};
  const float* tpool[3];
  if constexpr (kLowRes) {  // the f32 tangent pooled vectors of the scratch
#pragma unroll
    for (int k = 0; k < 3; ++k) tpool[k] = tpool16 + ((size_t)k * B + b) * N * C;
  } else {
    tpool[0] = node(TR, RS_POOL0, C);
    tpool[1] = node(TR, RS_POOL1, C);
    tpool[2] = node(TR, RS_POOL2, C);
  }
  for (int e = tid; e < N * C; e += nt) {  // t_pool_sq = sum_k 2 (p_k / n)(t_p_k / n)
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if constexpr (kE16) s += 2.f * (get_res(pool[k], e) / n_eff) * (tpool[k][e] / n_eff);
      else s += 2.f * (pool[k][e] / n_eff) * (tpool[k][e] / n_eff);
    }
    scf[e] = s;
  }
  {
    const float* wv = W(W_VMIX);
    for (int q = warp; q < 3 * N; q += nwarp) {
      const int k = q / N, i = q % N;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += tpool[k][i * C + c] * wv[c];
      s = warp_sum(s);
      if (lane == 0) stdel[q] = s;
    }
  }
  __syncthreads();

  {
    const auto* ps0 = node(RS, RS_PS0, H);
    auto* tps0 = node(TR, RS_PS0, H);
    mm_jvp(N, C, H, scf, C, W(W_POST0), [&](int r, int c, float a) {
      if constexpr (kE16) {
        put_res(tps0, r * H + c, a);
        se[r * H + c] = dsiluf_(get_res(ps0, r * H + c)) * a;
      } else {
        tps0[r * H + c] = a;
        se[r * H + c] = dsiluf_(ps0[r * H + c]) * a;
      }
    });
  }
  __syncthreads();
  {
    const auto* ps1 = node(RS, RS_PS1, H);
    auto* tps1 = node(TR, RS_PS1, H);
    mm_jvp(N, H, H, se, H, W(W_POST1), [&](int r, int c, float a) {
      if constexpr (kE16) {
        put_res(tps1, r * H + c, a);
        she[r * H + c] = dsiluf_(get_res(ps1, r * H + c)) * a;  // t_h_comb
      } else {
        tps1[r * H + c] = a;
        she[r * H + c] = dsiluf_(ps1[r * H + c]) * a;  // t_h_comb
      }
    });
  }
  __syncthreads();

  // t_node_pre = th @ w_node_h + t_hatt_sum @ w_node_agg + t_h_comb @ w_node_comb
  mm_jvp(N, F, H, sth, F, W(W_NODE_H), [&](int r, int c, float a) { stnp[r * H + c] = a; });
  __syncthreads();
  mm_jvp(N, HK, H, sthatt, HK, W(W_NODE_AGG),
         [&](int r, int c, float a) { stnp[r * H + c] += a; });
  __syncthreads();
  mm_jvp(N, H, H, she, H, W(W_NODE_COMB), [&](int r, int c, float a) { stnp[r * H + c] += a; });
  __syncthreads();
  {
    const auto* np = node(RS, RS_NODE_PRE, H);
    auto* tnp = node(TR, RS_NODE_PRE, H);
    for (int e = tid; e < N * H; e += nt) {
      if constexpr (kE16) {
        put_res(tnp, e, stnp[e]);
        stnp[e] = dsiluf_(get_res(np, e)) * stnp[e];
      } else {
        tnp[e] = stnp[e];
        stnp[e] = dsiluf_(np[e]) * stnp[e];
      }
    }
  }
  __syncthreads();
  {
    auto* tuv = node(TR, RS_UV, F);
    mm_jvp(N, H, F, stnp, H, W(W_NODE1), [&](int r, int c, float a) {
      if constexpr (kE16) put_res(tuv, r * F + c, a);
      else tuv[r * F + c] = a;
      stuv[r * F + c] = a;
    });
  }
  __syncthreads();
  {  // t_h_out = th + dsilu(uv) * t_uv
    const auto* uv = node(RS, RS_UV, F);
    for (int e = tid; e < N * F; e += nt) {
      if constexpr (kE16) sth[e] += dsiluf_(get_res(uv, e)) * stuv[e];
      else sth[e] += dsiluf_(uv[e]) * stuv[e];
    }
  }
  __syncthreads();

  // velocity gate: t_g0 = t_h_out @ w_vel0, t_g1 = (dsilu(g0) * t_g0) @ w_vel1
  {
    const auto* g0 = node(RS, RS_G0, H);
    auto* tg0 = node(TR, RS_G0, H);
    mm_jvp(N, F, H, sth, F, W(W_VEL0), [&](int r, int c, float a) {
      if constexpr (kE16) {
        put_res(tg0, r * H + c, a);
        stg0[r * H + c] = dsiluf_(get_res(g0, r * H + c)) * a;
      } else {
        tg0[r * H + c] = a;
        stg0[r * H + c] = dsiluf_(g0[r * H + c]) * a;
      }
    });
  }
  __syncthreads();
  {
    const float* wv1 = W(W_VEL1);
    auto* tg1 = node(TR, RS_G1, 1);
    for (int i = warp; i < N; i += nwarp) {
      float s = 0.f;
      for (int h = lane; h < H; h += 32) s += stg0[i * H + h] * wv1[h];
      s = warp_sum(s);
      if (lane == 0) {
        stg1[i] = s;
        if constexpr (kE16) put_res(tg1, i, s);
        else tg1[i] = s;
      }
    }
  }
  __syncthreads();
  {
    const auto* g1 = node(RS, RS_G1, 1);
    for (int i = tid; i < N; i += nt) {
      float sg;
      if constexpr (kE16) sg = sigmoidf_(get_res(g1, i));
      else sg = sigmoidf_(g1[i]);
      const float gate = 2.f * sg, tgate = 2.f * sg * (1.f - sg) * stg1[i];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float tvn = tgate * sv[k * N + i] + gate * stv[k * N + i] + stdel[k * N + i] / n_eff;
        stx[k * N + i] += u * tvn;
        stv[k * N + i] += u * (tvn - stv[k * N + i]);
      }
    }
  }
  __syncthreads();
  SAKE_PROBE(PR_JVP_NODE);
}

namespace {

// #9's kernel (resid_jvp.cu): one block per molecule runs jvp_layer over depth
// from the tangent seed (0, tx0, 0) and writes the final tangent state. kE16:
// #9 in resid_ef's bf16 tier (resid_jvp16.cu): jvp_layer's kE16 on the bf16
// streams RS and TR, with its f32 tangent pooled scratch, the one argument in
// Pool.
template <bool kE16 = false, class... Pool>
__global__ void __launch_bounds__(256)
resid_jvp_kernel(Dims d, const float* __restrict__ bh, const float* __restrict__ bx,
                 const float* __restrict__ bv, const float* __restrict__ upd, Leaves L,
                 ResidsOf<kE16> RS, const float* __restrict__ tx0, float* tbh, float* tbx,
                 float* tbv, float* th_fin, float* tx_fin, float* tv_fin, ResidsOf<kE16> TR,
                 Pool... tpool16) {
  static_assert(sizeof...(Pool) == (kE16 ? 1 : 0), "the tier's pooled scratch");
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;

  Carver cv{reinterpret_cast<float*>(smem4)};
  const JvpSmem S = carve_jvp(cv, d);
  jvp_begin(d, S, B, b, tx0);
  for (int l = 0; l < d.depth; ++l)
    jvp_layer<false, kE16>(d, S, b, l, upd[l], L, bh, bx, bv, RS, tbh, tbx, tbv, TR, nullptr,
                           tpool16...);

  for (int e = tid; e < N * F; e += nt) th_fin[(size_t)b * N * F + e] = S.sth[e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    tx_fin[((size_t)k * B + b) * N + i] = S.stx[e];
    tv_fin[((size_t)k * B + b) * N + i] = S.stv[e];
  }
}

// The arguments of sake_resid_jvp (and, with kE16, the tier's pooled scratch).
template <bool kE16, class... Pool>
int launch_jvp(const float* bh, const float* bx, const float* bv, const float* upd,
               const void* const* leaf_ptrs, const long long* leaf_strides,
               void* const* resid_ptrs, const float* tx0, float* tbh, float* tbx, float* tbv,
               float* th_fin, float* tx_fin, float* tv_fin, void* const* tresid_ptrs,
               const Dims& d, void* stream, Pool... tpool16) {
  const Leaves L = leaves_of(leaf_ptrs, leaf_strides);
  const ResidsOf<kE16> RS = resids_as<kE16>(resid_ptrs), TR = resids_as<kE16>(tresid_ptrs);
  const size_t smem = jvp_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(resid_jvp_kernel<kE16, Pool...>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  resid_jvp_kernel<kE16, Pool...><<<d.B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      d, bh, bx, bv, upd, L, RS, tx0, tbh, tbx, tbv, th_fin, tx_fin, tv_fin, TR, tpool16...);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sake
