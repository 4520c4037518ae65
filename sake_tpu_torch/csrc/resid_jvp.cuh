// The tangent forward's per-layer body: layer_jvp_resid of one molecule and
// one layer on saved residuals, for a whole thread block. resid_jvp.cu runs
// it over depth (#9); fused_bwd.cu runs it as phase 1 of the fused training
// backward (#12). See resid_jvp.cu for the design and what bounds it.
#pragma once

#include "resid_common.cuh"

namespace sake {

constexpr int kJvpTileCols = 4;      // columns per tile in mm_tiled
constexpr int kJvpTiledMinCols = 16; // narrowest tiled product

template <class ST>
__device__ __forceinline__ void mm_jvp(int n, int kd, int m, const float* A, int lda,
                                       const float* __restrict__ W, ST st) {
  mm_smem<kJvpTileCols, kJvpTiledMinCols>(n, kd, m, A, lda, W, st);
}

// Shared-memory buffers of the tangent forward, in floats: the tangent state and the layer's
// primal inputs, node projections, per-row buffers, and a node scratch the
// node phase carves from the row buffers once all rows are done.
struct JvpSmem {
  float *sth, *stx, *stv, *sh, *sx, *sv, *saj, *sai, *staj, *stai, *stoj, *stoi, *sthatt,
      *stdel;
  float *sd, *std_, *sgeo, *sfilt, *se, *she, *stl, *satt, *stat, *shea, *scf;
};

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
  s.shea = cv.take((H * K > 2 * H + F + 1 ? H * K : 2 * H + F + 1) * N);
  s.scf = cv.take(N * C);         // row: t_coeff; node: t_pool_sq
  return s;
}

__host__ __device__ inline long long jvp_smem_floats(const Dims& d) {
  Carver cv{nullptr};
  carve_jvp(cv, d);
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
// tangent ones (tbh, tbx, tbv, TR) at molecule slot b of d.B, layer l.
__device__ __forceinline__ void jvp_layer(const Dims& d, const JvpSmem& S, int b, int l,
                                          float u, const Leaves& L,
                                          const float* __restrict__ bh,
                                          const float* __restrict__ bx,
                                          const float* __restrict__ bv, const Resids& RS,
                                          float* tbh, float* tbx, float* tbv,
                                          const Resids& TR) {
  const int B = d.B, N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  const int HK = H * K, NN = N * N;
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
  auto node = [&](const Resids& Q, int r, int ch) { return Q.p[r] + lb * N * ch; };

  // tangent boundary state out, primal boundary state in
  for (int e = tid; e < N * F; e += nt) {
    tbh[lb * N * F + e] = sth[e];
    sh[e] = bh[lb * N * F + e];
  }
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    const size_t at = (((size_t)l * 3 + k) * B + b) * N + i;
    tbx[at] = stx[e];
    tbv[at] = stv[e];
    sx[e] = bx[at];
    sv[e] = bv[at];
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

  for (int i = 0; i < N; ++i) {
    // edge stream r (width ch) of this molecule and layer at edge (i, 0)
    auto edge = [&](const Resids& Q, int r, int ch) {
      return Q.p[r] + (lb * NN + (size_t)i * N) * ch;
    };

    // geometry: r = sqrt(relu(|d|^2) + eps), t = exp(-r), and their tangents
    for (int j = tid; j < N; j += nt) {
      const float r = edge(RS, RS_R, 1)[j];
      const float t = edge(RS, RS_T, 1)[j];
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
      edge(TR, RS_R, 1)[j] = tr;
      edge(TR, RS_T, 1)[j] = -t * tr;
    }
    __syncthreads();

    // rbf = exp(-b (t - m)^2): t_rbf; t_filtered = t_rbf * pre + rbf * t_pre
    {
      const float* rbf = edge(RS, RS_RBF, R);
      const float* tt = edge(RS, RS_T, 1);
      float* trbf = edge(TR, RS_RBF, R);
      for (int e = tid; e < N * R; e += nt) {
        const int j = e / R, c = e % R;
        const float v = rbf[e] * (-2.f * rbf_b[c] * (tt[j] - rbf_m[c])) * stt[j];
        trbf[e] = v;
        sfilt[e] = v * (saj[e] + sai[i * R + c]) + rbf[e] * (staj[e] + stai[i * R + c]);
      }
    }
    __syncthreads();

    // t_e0 = t_o_j[j] + t_o_i[i] + t_filtered @ w_o_f + t_r * w_o_r; se = dsilu(e0) * t_e0
    {
      const float* e0 = edge(RS, RS_E0, H);
      float* te0 = edge(TR, RS_E0, H);
      mm_jvp(N, R, H, sfilt, R, W(W_O_F), [&](int r, int c, float a) {
        const float v = stoj[r * H + c] + stoi[i * H + c] + a + str[r] * w_o_r[c];
        te0[r * H + c] = v;
        se[r * H + c] = dsiluf_(e0[r * H + c]) * v;
      });
    }
    __syncthreads();

    // t_h_e = (dsilu(e0) * t_e0) @ w_o1
    {
      float* the = edge(TR, RS_H_E, H);
      mm_jvp(N, H, H, se, H, W(W_O1), [&](int r, int c, float a) {
        she[r * H + c] = a;
        the[r * H + c] = a;
      });
    }
    __syncthreads();

    // t_sem_pre = t_h_e @ w_sem
    {
      float* tsem = edge(TR, RS_SEM_PRE, K);
      mm_jvp(N, H, K, she, H, W(W_SEM), [&](int r, int c, float a) {
        stl[r * K + c] = a;
        tsem[r * K + c] = a;
      });
    }
    __syncthreads();

    // softmax over senders, jvp on the saved raw softmax: t_logits =
    // dcelu(sem_pre) * t_sem_pre (the additive masks are constant),
    // t_att = att * (t_logits - sum_j att * t_logits); one warp per head
    {
      const float* att = edge(RS, RS_ATT, K);
      const float* sem = edge(RS, RS_SEM_PRE, K);
      float* tatt = edge(TR, RS_ATT, K);
      for (int k = warp; k < K; k += nwarp) {
        float s = 0.f;
        for (int j = lane; j < N; j += 32) {
          const float sp = sem[j * K + k];
          const float tl = (sp > 0.f ? 1.f : expf(sp / 2.f)) * stl[j * K + k];
          stl[j * K + k] = tl;
          s += att[j * K + k] * tl;
        }
        s = warp_sum(s);
        for (int j = lane; j < N; j += 32) {
          const float a = att[j * K + k];
          const float v = a * (stl[j * K + k] - s);
          satt[j * K + k] = a;
          stat[j * K + k] = v;
          tatt[j * K + k] = v;
        }
      }
    }
    __syncthreads();

    // t_he_att[j, h*K + k] = t_h_e[j, h] * att[j, k] + h_e[j, h] * t_att[j, k]
    {
      const float* h_e = edge(RS, RS_H_E, H);
      for (int e = tid; e < N * HK; e += nt) {
        const int j = e / HK, q = e % HK, h = q / K, k = q % K;
        shea[e] = she[j * H + h] * satt[j * K + k] + h_e[j * H + h] * stat[j * K + k];
      }
    }
    __syncthreads();

    // t_hatt_sum[i] = sum_j t_he_att[j]; t_coeff = (1 - coeff^2) * (t_he_att @ w_xmix)
    for (int q = tid; q < HK; q += nt) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) s += shea[j * HK + q];
      sthatt[i * HK + q] = s;
    }
    {
      const float* cf = edge(RS, RS_COEFF, C);
      float* tcf = edge(TR, RS_COEFF, C);
      mm_jvp(N, HK, C, shea, HK, W(W_XMIX), [&](int r, int c, float a) {
        const float f = cf[r * C + c];
        const float v = (1.f - f * f) * a;
        scf[r * C + c] = v;
        tcf[r * C + c] = v;
      });
    }
    __syncthreads();

    // t_pooled_k[i] = sum_j t_coeff * u_k + coeff * t_u_k, u_k = d_k / (r + 1e-5)
    {
      const float* cf = edge(RS, RS_COEFF, C);
      for (int c = tid; c < C; c += nt) {
        float p[3] = {0.f, 0.f, 0.f};
        for (int j = 0; j < N; ++j) {
          const float tc = scf[j * C + c], f = cf[j * C + c];
          const float ir = sir[j], tir = stir[j];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            p[k] += tc * (sd[k * N + j] * ir) + f * (std_[k * N + j] * ir + sd[k * N + j] * tir);
        }
        node(TR, RS_POOL0, C)[i * C + c] = p[0];
        node(TR, RS_POOL1, C)[i * C + c] = p[1];
        node(TR, RS_POOL2, C)[i * C + c] = p[2];
      }
    }
    __syncthreads();
  }

  // ---- node phase ------------------------------------------------------
  const float* pool[3] = {node(RS, RS_POOL0, C), node(RS, RS_POOL1, C), node(RS, RS_POOL2, C)};
  const float* tpool[3] = {node(TR, RS_POOL0, C), node(TR, RS_POOL1, C), node(TR, RS_POOL2, C)};
  for (int e = tid; e < N * C; e += nt) {  // t_pool_sq = sum_k 2 (p_k / n)(t_p_k / n)
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) s += 2.f * (pool[k][e] / n_eff) * (tpool[k][e] / n_eff);
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
    const float* ps0 = node(RS, RS_PS0, H);
    float* tps0 = node(TR, RS_PS0, H);
    mm_jvp(N, C, H, scf, C, W(W_POST0), [&](int r, int c, float a) {
      tps0[r * H + c] = a;
      se[r * H + c] = dsiluf_(ps0[r * H + c]) * a;
    });
  }
  __syncthreads();
  {
    const float* ps1 = node(RS, RS_PS1, H);
    float* tps1 = node(TR, RS_PS1, H);
    mm_jvp(N, H, H, se, H, W(W_POST1), [&](int r, int c, float a) {
      tps1[r * H + c] = a;
      she[r * H + c] = dsiluf_(ps1[r * H + c]) * a;  // t_h_comb
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
    const float* np = node(RS, RS_NODE_PRE, H);
    float* tnp = node(TR, RS_NODE_PRE, H);
    for (int e = tid; e < N * H; e += nt) {
      tnp[e] = stnp[e];
      stnp[e] = dsiluf_(np[e]) * stnp[e];
    }
  }
  __syncthreads();
  {
    float* tuv = node(TR, RS_UV, F);
    mm_jvp(N, H, F, stnp, H, W(W_NODE1), [&](int r, int c, float a) {
      tuv[r * F + c] = a;
      stuv[r * F + c] = a;
    });
  }
  __syncthreads();
  {  // t_h_out = th + dsilu(uv) * t_uv
    const float* uv = node(RS, RS_UV, F);
    for (int e = tid; e < N * F; e += nt) sth[e] += dsiluf_(uv[e]) * stuv[e];
  }
  __syncthreads();

  // velocity gate: t_g0 = t_h_out @ w_vel0, t_g1 = (dsilu(g0) * t_g0) @ w_vel1
  {
    const float* g0 = node(RS, RS_G0, H);
    float* tg0 = node(TR, RS_G0, H);
    mm_jvp(N, F, H, sth, F, W(W_VEL0), [&](int r, int c, float a) {
      tg0[r * H + c] = a;
      stg0[r * H + c] = dsiluf_(g0[r * H + c]) * a;
    });
  }
  __syncthreads();
  {
    const float* wv1 = W(W_VEL1);
    float* tg1 = node(TR, RS_G1, 1);
    for (int i = warp; i < N; i += nwarp) {
      float s = 0.f;
      for (int h = lane; h < H; h += 32) s += stg0[i * H + h] * wv1[h];
      s = warp_sum(s);
      if (lane == 0) {
        stg1[i] = s;
        tg1[i] = s;
      }
    }
  }
  __syncthreads();
  {
    const float* g1 = node(RS, RS_G1, 1);
    for (int i = tid; i < N; i += nt) {
      const float sg = sigmoidf_(g1[i]);
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
}

}  // namespace sake
