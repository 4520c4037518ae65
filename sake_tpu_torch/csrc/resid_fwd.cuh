// K1's per-layer body: layer_fwd_resid of one molecule and one layer, for a
// whole thread block. resid_fwd.cu runs it over depth; fused_ef.cu runs it
// as the forward phase of the fused primal (#11) and of one_ef (#3). See
// resid_fwd.cu for the design and what bounds it.
#pragma once

#include "resid_common.cuh"

namespace sake {

constexpr int kFwdTileCols = 4;  // columns per tile in mm_tiled
constexpr int kFwdTiledMinCols = 16;  // narrowest tiled product

// This body's block products (see mm_smem).
template <class ST>
__device__ __forceinline__ void mm_fwd(int n, int kd, int m, const float* A, int lda,
                                       const float* __restrict__ W, ST st) {
  mm_smem<kFwdTileCols, kFwdTiledMinCols>(n, kd, m, A, lda, W, st);
}

// Shared-memory buffers of K1, in floats. Node-level state lives across
// the row loop; row buffers are rebuilt for every receiver row i; the
// node phase reuses the row buffers once all rows are done.
struct FwdSmem {
  float *sh, *sx, *sv, *saj, *sai, *soj, *soi, *shatt, *sdel, *scnt;  // node level
  float *sd, *sr, *sir, *smk, *srbf, *se0, *she, *ssem, *satt, *shea, *scf;  // row
};

__host__ __device__ inline FwdSmem carve_fwd(Carver& cv, const Dims& d) {
  const long long N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  FwdSmem s;
  s.sh = cv.take(N * F);        // h
  s.sx = cv.take(3 * N);        // x planes
  s.sv = cv.take(3 * N);        // v planes
  s.saj = cv.take(N * R);       // h @ w_in_j + b_in
  s.sai = cv.take(N * R);       // h @ w_in_i
  s.soj = cv.take(N * H);
  s.soi = cv.take(N * H);
  s.shatt = cv.take(N * H * K); // sum_j h_e (x) att
  s.sdel = cv.take(3 * N);      // pooled_k @ w_vmix
  s.scnt = cv.take(N);          // senders per receiver (masked)
  s.sd = cv.take(3 * N);        // row: d_k[j] = x_k[j] - x_k[i]
  s.sr = cv.take(N);            // row: r
  s.sir = cv.take(2 * N);       // row: 1 / (r + 1e-5), then t = exp(-r)
  s.smk = cv.take(N);           // row: m[i, j], 1 without a mask
  s.srbf = cv.take(N * R);
  s.se0 = cv.take(N * H);       // row: e0 -> silu(e0); node: ps0
  s.she = cv.take(N * H);       // row: h_e; node: ps1 -> h_comb
  s.ssem = cv.take(N * K);
  s.satt = cv.take(N * K);
  s.shea = cv.take(N * H * K);  // row: h_e (x) att, column h*K + k
  // row: coeff; node: pool_sq, then node_pre, uv, g0, g1 (below)
  s.scf = cv.take((C > 2 * H + F + 1 ? C : 2 * H + F + 1) * N);
  return s;
}

__host__ __device__ inline long long fwd_smem_floats(const Dims& d) {
  Carver cv{nullptr};
  carve_fwd(cv, d);
  return cv.off;
}

// The state (h, x, v) of molecule m of a batch of B in (B, N, F) and
// (3, B, N) layouts into S.sh, S.sx, S.sv (v0 null: zeros), and the sender
// counts of its mask rows mb (null: no mask).
__device__ __forceinline__ void fwd_begin(const Dims& d, const FwdSmem& S, int B, int m,
                                          const float* __restrict__ h0,
                                          const float* __restrict__ xs,
                                          const float* __restrict__ v0,
                                          const float* __restrict__ mb) {
  const int N = d.N, F = d.F, tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < N * F; e += nt) S.sh[e] = h0[(size_t)m * N * F + e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    S.sx[e] = xs[((size_t)k * B + m) * N + i];
    S.sv[e] = v0 ? v0[((size_t)k * B + m) * N + i] : 0.f;
  }
  sender_counts(mb, N, S.scnt);
  __syncthreads();
}

// Layer l of the forward on the state in S. u: the layer's update gate;
// mb: this molecule's (N, N) edge mask or null. Streams (bh, bx, bv and the
// residuals RS, kStream) are written at molecule slot b of d.B, layer l;
// without kStream only the pooled vectors go to RS, at slot b of a one-layer
// (3, d.B, N, C) scratch.
template <bool kStream>
__device__ __forceinline__ void fwd_layer(const Dims& d, const FwdSmem& S, int b, int l,
                                          float u, const float* __restrict__ mb,
                                          const Leaves& L, float* bh, float* bx, float* bv,
                                          const Resids& RS) {
  const int B = d.B, N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  const int HK = H * K, NN = N * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
  const float n_eff = (float)N;
  const bool masked = mb != nullptr;
  float *sh = S.sh, *sx = S.sx, *sv = S.sv, *saj = S.saj, *sai = S.sai, *soj = S.soj,
        *soi = S.soi, *shatt = S.shatt, *sdel = S.sdel, *scnt = S.scnt, *sd = S.sd,
        *sr = S.sr, *sir = S.sir, *smk = S.smk, *srbf = S.srbf, *se0 = S.se0,
        *she = S.she, *ssem = S.ssem, *satt = S.satt, *shea = S.shea, *scf = S.scf;
  float* snp = scf;             // node: (N, H) node_pre -> silu
  float* suv = snp + N * H;     // node: (N, F) uv
  float* sg0 = suv + N * F;     // node: (N, H) g0 -> silu
  float* sg1 = sg0 + N * H;     // node: (N) g1

  const size_t lb = (size_t)l * B + b;
  // without kStream the pooled vectors go to a one-layer scratch
  const size_t lp = kStream ? lb : (size_t)b;
  auto W = [&](int leaf) { return L.at(leaf, l); };
  const float* b_in = W(B_IN);
  const float* rbf_m = W(RBF_M);
  const float* rbf_b = W(RBF_B);
  const float* w_o_r = W(W_O_R);
  const float* b_o0 = W(B_O0);
  const float* b_o1 = W(B_O1);
  const float* b_sem = W(B_SEM);

  // boundary state in
  if constexpr (kStream) {
    for (int e = tid; e < N * F; e += nt) bh[lb * N * F + e] = sh[e];
    for (int e = tid; e < 3 * N; e += nt) {
      const int k = e / N, i = e % N;
      bx[(((size_t)l * 3 + k) * B + b) * N + i] = sx[e];
      bv[(((size_t)l * 3 + k) * B + b) * N + i] = sv[e];
    }
  }

  // node projections
  mm_fwd(N, F, R, sh, F, W(W_IN_J),
         [&](int r, int c, float a) { saj[r * R + c] = a + b_in[c]; });
  mm_fwd(N, F, R, sh, F, W(W_IN_I),
         [&](int r, int c, float a) { sai[r * R + c] = a; });
  mm_fwd(N, F, H, sh, F, W(W_O_J),
         [&](int r, int c, float a) { soj[r * H + c] = a; });
  mm_fwd(N, F, H, sh, F, W(W_O_I),
         [&](int r, int c, float a) { soi[r * H + c] = a; });
  __syncthreads();

  for (int i = 0; i < N; ++i) {
    const size_t erow = lb * NN + (size_t)i * N;  // edge (i, 0)

    // geometry
    for (int j = tid; j < N; j += nt) {
      float s = 0.f;
      float dk[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dk[k] = sx[k * N + j] - sx[k * N + i];
        sd[k * N + j] = dk[k];
      }
      s = dk[0] * dk[0] + dk[1] * dk[1] + dk[2] * dk[2];
      const float r = sqrtf(fmaxf(s, 0.f) + kEps);
      sr[j] = r;
      sir[j] = 1.f / (r + 1e-5f);
      sir[N + j] = expf(-r);  // t
      smk[j] = masked ? mb[i * N + j] : 1.f;
      if constexpr (kStream) {
        RS.p[RS_R][erow + j] = r;
        RS.p[RS_T][erow + j] = sir[N + j];
      }
    }
    __syncthreads();

    // rbf filter; srbf keeps filtered = rbf * (a_j[j] + a_i[i])
    for (int e = tid; e < N * R; e += nt) {
      const int j = e / R, c = e % R;
      const float z = sir[N + j] - rbf_m[c];
      const float v = expf(-rbf_b[c] * (z * z));
      if constexpr (kStream) RS.p[RS_RBF][erow * R + e] = v;
      srbf[e] = v * (saj[e] + sai[i * R + c]);
    }
    __syncthreads();

    // e0 = o_j[j] + o_i[i] + filtered @ w_o_f + r * w_o_r + b_o0
    mm_fwd(N, R, H, srbf, R, W(W_O_F), [&](int r, int c, float a) {
      const float v = soj[r * H + c] + soi[i * H + c] + a + sr[r] * w_o_r[c] + b_o0[c];
      se0[r * H + c] = v;
      if constexpr (kStream) RS.p[RS_E0][(erow + r) * H + c] = v;
    });
    __syncthreads();
    for (int e = tid; e < N * H; e += nt) se0[e] = siluf_(se0[e]);
    __syncthreads();

    // h_e = silu(e0) @ w_o1 + b_o1
    mm_fwd(N, H, H, se0, H, W(W_O1),
           [&](int r, int c, float a) {
             const float v = a + b_o1[c];
             she[r * H + c] = v;
             if constexpr (kStream) RS.p[RS_H_E][(erow + r) * H + c] = v;
           });
    __syncthreads();

    // semantic logits
    mm_fwd(N, H, K, she, H, W(W_SEM),
           [&](int r, int c, float a) {
             const float v = a + b_sem[c];
             ssem[r * K + c] = v;
             if constexpr (kStream) RS.p[RS_SEM_PRE][(erow + r) * K + c] = v;
           });
    __syncthreads();

    // softmax over senders j, one warp per head; the raw softmax is the
    // residual, the renormalized one (masked) feeds the products
    for (int k = warp; k < K; k += nwarp) {
      float mx = -3.4e38f;
      for (int j = lane; j < N; j += 32) {
        const float s = ssem[j * K + k];
        float lg = s > 0.f ? s : 2.f * (expf(s / 2.f) - 1.f);
        if (j == i) lg -= kInf;
        lg -= kInf * (1.f - smk[j]);
        satt[j * K + k] = lg;
        mx = fmaxf(mx, lg);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float ex = expf(satt[j * K + k] - mx);
        satt[j * K + k] = ex;
        sum += ex;
      }
      sum = warp_sum(sum);
      float live = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float a = satt[j * K + k] / sum;
        satt[j * K + k] = a;
        live += a * smk[j];
        if constexpr (kStream) RS.p[RS_ATT][(erow + j) * K + k] = a;
      }
      if (masked) {
        live = warp_sum(live);
        const float dg = live == 0.f ? 1.f : live;
        for (int j = lane; j < N; j += 32) satt[j * K + k] = satt[j * K + k] * smk[j] / dg;
      }
    }
    __syncthreads();

    // attended edges h_e (x) att, hidden-major / head-minor: column h*K + k
    for (int e = tid; e < N * HK; e += nt) {
      const int j = e / HK, q = e % HK;
      shea[e] = she[j * H + q / K] * satt[j * K + q % K];
    }
    __syncthreads();
    // hatt_sum[i] = sum_j he_att[j]; coeff = tanh(he_att @ w_xmix) * m
    for (int q = tid; q < HK; q += nt) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) s += shea[j * HK + q];
      shatt[i * HK + q] = s;
    }
    mm_fwd(N, HK, C, shea, HK, W(W_XMIX), [&](int r, int c, float a) {
      const float v = tanhf(a) * smk[r];
      scf[r * C + c] = v;
      if constexpr (kStream) RS.p[RS_COEFF][(erow + r) * C + c] = v;
    });
    __syncthreads();

    // pooled_k[i] = sum_j coeff[j] * d_k[j] / (r_j + 1e-5)
    for (int c = tid; c < C; c += nt) {
      float p[3] = {0.f, 0.f, 0.f};
      for (int j = 0; j < N; ++j) {
        const float cf = scf[j * C + c];
#pragma unroll
        for (int k = 0; k < 3; ++k) p[k] += cf * (sd[k * N + j] * sir[j]);
      }
      RS.p[RS_POOL0][(lp * N + i) * C + c] = p[0];
      RS.p[RS_POOL1][(lp * N + i) * C + c] = p[1];
      RS.p[RS_POOL2][(lp * N + i) * C + c] = p[2];
    }
    __syncthreads();
  }

  // ---- node phase -----------------------------------------------------
  const float* pool[3] = {RS.p[RS_POOL0] + lp * N * C, RS.p[RS_POOL1] + lp * N * C,
                          RS.p[RS_POOL2] + lp * N * C};
  for (int e = tid; e < N * C; e += nt) {
    const float pd = pool_denom(masked, scnt[e / C], n_eff);
    const float n0 = pool[0][e] / pd, n1 = pool[1][e] / pd, n2 = pool[2][e] / pd;
    scf[e] = n0 * n0 + n1 * n1 + n2 * n2;  // pool_sq
  }
  {
    const float* wv = W(W_VMIX);
    for (int q = warp; q < 3 * N; q += nwarp) {
      const int k = q / N, i = q % N;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += pool[k][i * C + c] * wv[c];
      s = warp_sum(s);
      if (lane == 0) sdel[q] = s;
    }
  }
  __syncthreads();

  const float* b_post0 = W(B_POST0);
  mm_fwd(N, C, H, scf, C, W(W_POST0),
         [&](int r, int c, float a) {
           const float v = a + b_post0[c];
           se0[r * H + c] = v;
           if constexpr (kStream) RS.p[RS_PS0][(lb * N + r) * H + c] = v;
         });
  __syncthreads();
  for (int e = tid; e < N * H; e += nt) se0[e] = siluf_(se0[e]);
  __syncthreads();
  const float* b_post1 = W(B_POST1);
  mm_fwd(N, H, H, se0, H, W(W_POST1),
         [&](int r, int c, float a) {
           const float v = a + b_post1[c];
           she[r * H + c] = v;
           if constexpr (kStream) RS.p[RS_PS1][(lb * N + r) * H + c] = v;
         });
  __syncthreads();
  for (int e = tid; e < N * H; e += nt) she[e] = siluf_(she[e]);  // h_comb

  // node_pre = h @ w_node_h + hatt @ w_node_agg + h_comb @ w_node_comb + b
  const float* b_node0 = W(B_NODE0);
  mm_fwd(N, F, H, sh, F, W(W_NODE_H),
         [&](int r, int c, float a) { snp[r * H + c] = a + b_node0[c]; });
  __syncthreads();
  mm_fwd(N, HK, H, shatt, HK, W(W_NODE_AGG),
         [&](int r, int c, float a) { snp[r * H + c] += a; });
  __syncthreads();
  mm_fwd(N, H, H, she, H, W(W_NODE_COMB),
         [&](int r, int c, float a) { snp[r * H + c] += a; });
  __syncthreads();
  for (int e = tid; e < N * H; e += nt) {
    if constexpr (kStream) RS.p[RS_NODE_PRE][lb * N * H + e] = snp[e];
    snp[e] = siluf_(snp[e]);
  }
  __syncthreads();
  const float* b_node1 = W(B_NODE1);
  mm_fwd(N, H, F, snp, H, W(W_NODE1),
         [&](int r, int c, float a) {
           const float v = a + b_node1[c];
           suv[r * F + c] = v;
           if constexpr (kStream) RS.p[RS_UV][(lb * N + r) * F + c] = v;
         });
  __syncthreads();
  for (int e = tid; e < N * F; e += nt) sh[e] = sh[e] + siluf_(suv[e]);  // h_out
  __syncthreads();

  // velocity gate and x/v update
  const float* b_vel0 = W(B_VEL0);
  mm_fwd(N, F, H, sh, F, W(W_VEL0), [&](int r, int c, float a) {
    const float v = a + b_vel0[c];
    if constexpr (kStream) RS.p[RS_G0][(lb * N + r) * H + c] = v;
    sg0[r * H + c] = siluf_(v);
  });
  __syncthreads();
  {
    const float* wv1 = W(W_VEL1);
    for (int i = warp; i < N; i += nwarp) {
      float s = 0.f;
      for (int h = lane; h < H; h += 32) s += sg0[i * H + h] * wv1[h];
      s = warp_sum(s);
      if (lane == 0) {
        sg1[i] = s;
        if constexpr (kStream) RS.p[RS_G1][lb * N + i] = s;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N; i += nt) {
    const float gate = 2.f * sigmoidf_(sg1[i]);
    const float dvd = dv_denom(masked, scnt[i], n_eff);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float xv = sx[k * N + i], vv = sv[k * N + i];
      const float v_new = gate * vv + sdel[k * N + i] / dvd;
      const float x_new = xv + v_new;
      sx[k * N + i] = xv + u * (x_new - xv);
      sv[k * N + i] = vv + u * (v_new - vv);
    }
  }
  __syncthreads();
}

}  // namespace sake
