// K2's per-layer body: layer_bwd_resid of one molecule and one layer (with
// kRows also its cotangent rows), for a whole thread block. resid_bwd.cu
// runs it over depth in reverse; fused_ef.cu runs it as the backward phase of
// the fused primal (#11) and of one_ef (#3), fused_bwd.cu as the primal
// cotangent chain of the fused training backward (#12). See resid_bwd.cu for
// the design and what bounds it.
#pragma once

#include "resid_common.cuh"

namespace sake {

constexpr int kBwdTileCols = 2;  // columns per tile in mm_tiled
constexpr int kBwdTiledMinCols = 128;  // narrowest tiled product

// This body's block products (see mm_smem).
template <class ST>
__device__ __forceinline__ void mm_bwd(int n, int kd, int m, const float* A, int lda,
                                   const float* __restrict__ W, ST st) {
  mm_smem<kBwdTileCols, kBwdTiledMinCols>(n, kd, m, A, lda, W, st);
}

// Shared-memory buffers of K2, in floats: the cotangent state, the
// layer's inputs and sender-sum accumulators, per-row buffers, and one
// scratch region the node phase and the row loop take turns to use.
struct BwdSmem {
  float *sdh, *sdx, *sdv, *sh, *sx, *sv, *saj, *sai, *sdaj, *sdai, *sdoj, *sdoi,
      *sdhatt, *sdpsq, *sdvn, *sdvo, *sdxs, *sdxr, *scnt;
  float *sdp, *sd, *sr, *st, *sir, *sdr, *sdd, *smk, *she, *sdhe, *satt, *satt2, *sdsum,
      *ssem, *sdat, *se0, *srbf, *sdrbf, *sdpre, *scr;
};

__host__ __device__ inline BwdSmem carve_bwd(Carver& cv, const Dims& d) {
  const long long N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  BwdSmem s;
  s.sdh = cv.take(N * F);         // cotangent of h (state / accumulator)
  s.sdx = cv.take(3 * N);
  s.sdv = cv.take(3 * N);
  s.sh = cv.take(N * F);          // h_in
  s.sx = cv.take(3 * N);
  s.sv = cv.take(3 * N);
  s.saj = cv.take(N * R);         // recomputed h @ w_in_j + b_in
  s.sai = cv.take(N * R);
  s.sdaj = cv.take(N * R);        // sum over receivers
  s.sdai = cv.take(N * R);
  s.sdoj = cv.take(N * H);        // sum over receivers
  s.sdoi = cv.take(N * H);
  s.sdhatt = cv.take(N * H * K);
  s.sdpsq = cv.take(N * C);
  s.sdvn = cv.take(3 * N);        // d_v_new
  s.sdvo = cv.take(3 * N);        // d_v_in
  s.sdxs = cv.take(3 * N);        // + d_d0 at sender
  s.sdxr = cv.take(3 * N);        // - d_d0 at receiver
  s.scnt = cv.take(N);            // senders per receiver (masked)
  s.sdp = cv.take(3 * C);         // row: d_pooled
  s.sd = cv.take(3 * N);          // row: d0
  s.sr = cv.take(N);
  s.st = cv.take(N);
  s.sir = cv.take(N);
  s.sdr = cv.take(N);             // row: d_r
  s.sdd = cv.take(3 * N);         // row: d_d0
  s.smk = cv.take(N);             // row: m[i, j], 1 without a mask
  s.she = cv.take(N * H);
  s.sdhe = cv.take(N * H);
  s.satt = cv.take(N * K);        // row: raw softmax
  s.satt2 = cv.take(N * K);       // row: renormalized (masked) softmax
  s.sdsum = cv.take(K);           // row: sum_j att * m per head
  s.ssem = cv.take(N * K);
  s.sdat = cv.take(N * K);        // row: d_att -> d_sem_pre
  s.se0 = cv.take(N * H);         // row: e0 -> d_e0
  s.srbf = cv.take(N * R);
  s.sdrbf = cv.take(N * R);
  s.sdpre = cv.take(N * R);
  const long long rows = N * C + N * H * K, node = N * (4 * H + F + 1);
  s.scr = cv.take(rows > node ? rows : node);
  return s;
}

__host__ __device__ inline long long bwd_smem_floats(const Dims& d) {
  Carver cv{nullptr};
  carve_bwd(cv, d);
  return cv.off;
}

// The cotangent state (dh, dx, dv) of molecule m of a batch of B in (B, N,
// F) and (3, B, N) layouts into S.sdh, S.sdx, S.sdv, and the sender counts of
// its mask rows mb (null: no mask).
__device__ __forceinline__ void bwd_begin(const Dims& d, const BwdSmem& S, int B, int m,
                                          const float* __restrict__ dh_fin,
                                          const float* __restrict__ dx_fin,
                                          const float* __restrict__ dv_fin,
                                          const float* __restrict__ mb) {
  const int N = d.N, F = d.F, tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < N * F; e += nt) S.sdh[e] = dh_fin[(size_t)m * N * F + e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    S.sdx[e] = dx_fin[((size_t)k * B + m) * N + i];
    S.sdv[e] = dv_fin[((size_t)k * B + m) * N + i];
  }
  sender_counts(mb, N, S.scnt);
  __syncthreads();
}

// Layer l of the pullback on the cotangent state in S (it leaves the
// cotangents of the layer's input there). u: the layer's update gate; mb:
// this molecule's (N, N) edge mask or null. Reads the boundary states and
// residuals at molecule slot b of d.B, layer l, and with kRows writes the
// layer's rows (RW) there. add_h (depth, d.B, N, F), add_x, add_v (depth, 3,
// d.B, N): null, or added to the cotangents leaving the layer.
template <bool kRows>
__device__ __forceinline__ void bwd_layer(const Dims& d, const BwdSmem& S, int b, int l,
                                          float u, const float* __restrict__ mb,
                                          const Leaves& L, const Leaves& LT,
                                          const float* __restrict__ bh,
                                          const float* __restrict__ bx,
                                          const float* __restrict__ bv, const Resids& RS,
                                          const Rows& RW, const float* __restrict__ add_h,
                                          const float* __restrict__ add_x,
                                          const float* __restrict__ add_v) {
  const int B = d.B, N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  const int HK = H * K, NN = N * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
  const float n_eff = (float)N;
  const bool masked = mb != nullptr;
  float *sdh = S.sdh, *sdx = S.sdx, *sdv = S.sdv, *sh = S.sh, *sx = S.sx, *sv = S.sv,
        *saj = S.saj, *sai = S.sai, *sdaj = S.sdaj, *sdai = S.sdai, *sdoj = S.sdoj,
        *sdoi = S.sdoi, *sdhatt = S.sdhatt, *sdpsq = S.sdpsq, *sdvn = S.sdvn,
        *sdvo = S.sdvo, *sdxs = S.sdxs, *sdxr = S.sdxr, *scnt = S.scnt, *sdp = S.sdp,
        *sd = S.sd, *sr = S.sr, *st = S.st, *sir = S.sir, *sdr = S.sdr, *sdd = S.sdd,
        *smk = S.smk, *she = S.she, *sdhe = S.sdhe, *satt = S.satt, *satt2 = S.satt2,
        *sdsum = S.sdsum, *ssem = S.ssem, *sdat = S.sdat, *se0 = S.se0, *srbf = S.srbf,
        *sdrbf = S.sdrbf, *sdpre = S.sdpre, *scr = S.scr;
  float* scf = scr;               // row: (N, C) coeff -> d_xm
  float* sdha = scr + N * C;      // row: (N, HK) d_he_att
  float* sdg0 = scr;              // node: (N, H)
  float* sduv = sdg0 + N * H;     // node: (N, F)
  float* sdnp = sduv + N * F;     // node: (N, H)
  float* sdps1 = sdnp + N * H;    // node: (N, H)
  float* sdps0 = sdps1 + N * H;   // node: (N, H)
  float* sdg1 = sdps0 + N * H;    // node: (N)

  const size_t lb = (size_t)l * B + b;
  auto W = [&](int leaf) { return L.at(leaf, l); };
  auto WT = [&](int leaf) { return LT.at(leaf, l); };
  // node row (atom i of this molecule and layer) of a node stream of width ch
  auto node_row = [&](int row, int i, int ch) { return RW.p[row] + (lb * N + i) * ch; };

  // layer inputs
  for (int e = tid; e < N * F; e += nt) sh[e] = bh[lb * N * F + e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    sx[e] = bx[(((size_t)l * 3 + k) * B + b) * N + i];
    sv[e] = bv[(((size_t)l * 3 + k) * B + b) * N + i];
    sdxs[e] = 0.f;
    sdxr[e] = 0.f;
  }
  for (int e = tid; e < N * R; e += nt) sdaj[e] = 0.f;
  for (int e = tid; e < N * H; e += nt) sdoj[e] = 0.f;
  __syncthreads();

  // a_j, a_i recomputed from h_in (pre = a_j[j] + a_i[i])
  const float* b_in = W(B_IN);
  mm_bwd(N, F, R, sh, F, W(W_IN_J),
          [&](int r, int c, float a) { saj[r * R + c] = a + b_in[c]; });
  mm_bwd(N, F, R, sh, F, W(W_IN_I),
          [&](int r, int c, float a) { sai[r * R + c] = a; });

  // position/velocity gates: x_out = x + u*v_new, v_out = v + u*(v_new - v)
  const float* g1 = RS.p[RS_G1] + lb * N;
  for (int i = tid; i < N; i += nt) {
    const float sg = sigmoidf_(g1[i]);
    const float gate = 2.f * sg;
    float d_gate = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float dvn = u * (sdx[k * N + i] + sdv[k * N + i]);
      sdvn[k * N + i] = dvn;
      d_gate += dvn * sv[k * N + i];
      sdvo[k * N + i] = gate * dvn + (1.f - u) * sdv[k * N + i];
    }
    sdg1[i] = d_gate * 2.f * sg * (1.f - sg);
  }
  __syncthreads();

  // gate MLP: g1 = silu(g0) @ w_vel1, g0 = h_out @ w_vel0 + b_vel0
  {
    const float* wv1 = W(W_VEL1);
    const float* g0 = RS.p[RS_G0] + lb * N * H;
    for (int e = tid; e < N * H; e += nt) {
      const int i = e / H, h = e % H;
      sdg0[e] = (sdg1[i] * wv1[h]) * dsiluf_(g0[e]);
    }
  }
  __syncthreads();
  mm_bwd(N, H, F, sdg0, H, WT(W_VEL0),
          [&](int r, int c, float a) { sdh[r * F + c] += a; });  // dho
  __syncthreads();

  // h_out = h_in + silu(uv), uv = silu(node_pre) @ w_node1 + b_node1
  {
    const float* uv = RS.p[RS_UV] + lb * N * F;
    for (int e = tid; e < N * F; e += nt) sduv[e] = sdh[e] * dsiluf_(uv[e]);
  }
  __syncthreads();
  {
    const float* np = RS.p[RS_NODE_PRE] + lb * N * H;
    mm_bwd(N, F, H, sduv, F, WT(W_NODE1),
            [&](int r, int c, float a) { sdnp[r * H + c] = a * dsiluf_(np[r * H + c]); });
  }
  __syncthreads();

  // node_pre = h @ w_node_h + hatt @ w_node_agg + h_comb @ w_node_comb + b
  mm_bwd(N, H, F, sdnp, H, WT(W_NODE_H), [&](int r, int c, float a) { sdh[r * F + c] += a; });
  mm_bwd(N, H, HK, sdnp, H, WT(W_NODE_AGG),
          [&](int r, int c, float a) { sdhatt[r * HK + c] = a; });
  {
    const float* ps1 = RS.p[RS_PS1] + lb * N * H;
    mm_bwd(N, H, H, sdnp, H, WT(W_NODE_COMB),
            [&](int r, int c, float a) { sdps1[r * H + c] = a * dsiluf_(ps1[r * H + c]); });
  }
  __syncthreads();
  {
    const float* ps0 = RS.p[RS_PS0] + lb * N * H;
    mm_bwd(N, H, H, sdps1, H, WT(W_POST1),
            [&](int r, int c, float a) { sdps0[r * H + c] = a * dsiluf_(ps0[r * H + c]); });
  }
  __syncthreads();
  mm_bwd(N, H, C, sdps0, H, WT(W_POST0),
          [&](int r, int c, float a) { sdpsq[r * C + c] = a; });

  const float* wvmix = W(W_VMIX);
  const float* w_o_r = W(W_O_R);
  const float* rbf_m = W(RBF_M);
  const float* rbf_b = W(RBF_B);
  const float* pool[3] = {RS.p[RS_POOL0] + lb * N * C, RS.p[RS_POOL1] + lb * N * C,
                          RS.p[RS_POOL2] + lb * N * C};

  // the node rows, before the row loop reuses their scratch
  if constexpr (kRows) {
    for (int e = tid; e < N * H; e += nt) {
      const int i = e / H, h = e % H;
      node_row(RW_DG0, i, H)[h] = sdg0[e];
      node_row(RW_DNP, i, H)[h] = sdnp[e];
      node_row(RW_DPS1, i, H)[h] = sdps1[e];
      node_row(RW_DPS0, i, H)[h] = sdps0[e];
    }
    for (int e = tid; e < N * F; e += nt) node_row(RW_DUV, e / F, F)[e % F] = sduv[e];
    for (int i = tid; i < N; i += nt) {
      node_row(RW_DG1, i, 1)[0] = sdg1[i];
      const float dvd = dv_denom(masked, scnt[i], n_eff);
#pragma unroll
      for (int k = 0; k < 3; ++k) node_row(RW_DDEL, i, 3)[k] = sdvn[k * N + i] / dvd;
    }
    for (int e = tid; e < N * C; e += nt) {
      const float pd = pool_denom(masked, scnt[e / C], n_eff);
      const float n0 = pool[0][e] / pd, n1 = pool[1][e] / pd, n2 = pool[2][e] / pd;
      node_row(RW_PSQ, e / C, C)[e % C] = n0 * n0 + n1 * n1 + n2 * n2;
    }
  }
  __syncthreads();

  for (int i = 0; i < N; ++i) {
    const size_t erow = lb * NN + (size_t)i * N;
    // edge row (i, j) of an edge stream of width ch
    auto edge_row = [&](int row, int ch) { return RW.p[row] + erow * ch; };
    const float pd = pool_denom(masked, scnt[i], n_eff);
    const float dvd = dv_denom(masked, scnt[i], n_eff);

    // d_pooled for row i; stage the row's residuals
    for (int c = tid; c < C; c += nt) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        sdp[k * C + c] = sdvn[k * N + i] * wvmix[c] / dvd +
                         2.f * pool[k][i * C + c] * sdpsq[i * C + c] / (pd * pd);
    }
    for (int j = tid; j < N; j += nt) {
      const float r = RS.p[RS_R][erow + j];
      sr[j] = r;
      st[j] = RS.p[RS_T][erow + j];
      sir[j] = 1.f / (r + 1e-5f);
      smk[j] = masked ? mb[i * N + j] : 1.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) sd[k * N + j] = sx[k * N + j] - sx[k * N + i];
    }
    load_smem(scf, RS.p[RS_COEFF] + erow * C, N * C);
    load_smem(she, RS.p[RS_H_E] + erow * H, N * H);
    load_smem(se0, RS.p[RS_E0] + erow * H, N * H);
    load_smem(satt, RS.p[RS_ATT] + erow * K, N * K);
    load_smem(ssem, RS.p[RS_SEM_PRE] + erow * K, N * K);
    load_smem(srbf, RS.p[RS_RBF] + erow * R, N * R);
    __syncthreads();

    // pooled_k = sum_j coeff * u_k: d_u_k[j] = coeff[j] . d_pooled_k
    for (int j = warp; j < N; j += nwarp) {
      float du[3] = {0.f, 0.f, 0.f};
      for (int c = lane; c < C; c += 32) {
        const float cf = scf[j * C + c];
#pragma unroll
        for (int k = 0; k < 3; ++k) du[k] += cf * sdp[k * C + c];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) du[k] = warp_sum(du[k]);
      if (lane == 0) {
        const float ir = sir[j];
        float d_ir = 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          sdd[k * N + j] = du[k] * ir;
          d_ir += du[k] * sd[k * N + j];
        }
        sdr[j] = -(ir * ir) * d_ir;
      }
    }
    // the attention the products saw: att2 = att * m / sum_j att * m
    // (a zero sum read as 1), the raw softmax without a mask
    for (int k = warp; k < K; k += nwarp) {
      float s = 0.f;
      if (masked) {
        for (int j = lane; j < N; j += 32) s += satt[j * K + k] * smk[j];
        s = warp_sum(s);
      }
      const float dg = s == 0.f ? 1.f : s;
      for (int j = lane; j < N; j += 32)
        satt2[j * K + k] = masked ? satt[j * K + k] * smk[j] / dg : satt[j * K + k];
      if (lane == 0) sdsum[k] = s;
    }
    __syncthreads();

    // coeff = tanh(xm) * m: d_xm = d_coeff * (1 - coeff^2) * m, in place
    for (int e = tid; e < N * C; e += nt) {
      const int j = e / C, c = e % C;
      const float ir = sir[j];
      const float dc = sdp[c] * (sd[j] * ir) + sdp[C + c] * (sd[N + j] * ir) +
                       sdp[2 * C + c] * (sd[2 * N + j] * ir);
      const float cf = scf[e];
      const float v = dc * (1.f - cf * cf) * smk[j];
      scf[e] = v;
      if constexpr (kRows) edge_row(RW_DXM, C)[e] = v;
    }
    if constexpr (kRows) {
      // hatt[i] = sum_j h_e[j] (x) att2[j]; the row's att2
      for (int q = tid; q < HK; q += nt) {
        float s = 0.f;
        for (int j = 0; j < N; ++j) s += she[j * H + q / K] * satt2[j * K + q % K];
        node_row(RW_HATT, i, HK)[q] = s;
      }
      for (int e = tid; e < N * K; e += nt) edge_row(RW_ATT2, K)[e] = satt2[e];
    }
    __syncthreads();

    // d_he_att = d_xm @ w_xmix^T + d_hatt[i] (hatt sums he_att over senders)
    mm_bwd(N, C, HK, scf, C, WT(W_XMIX),
            [&](int r, int c, float a) { sdha[r * HK + c] = a + sdhatt[i * HK + c]; });
    __syncthreads();

    // he_att[j, h*K + k] = h_e[j, h] * att2[j, k]
    for (int e = tid; e < N * H; e += nt) {
      const int j = e / H, h = e % H;
      float s = 0.f;
      for (int k = 0; k < K; ++k) s += sdha[j * HK + h * K + k] * satt2[j * K + k];
      sdhe[e] = s;
    }
    for (int e = tid; e < N * K; e += nt) {
      const int j = e / K, k = e % K;
      float s = 0.f;
      for (int h = 0; h < H; ++h) s += sdha[j * HK + h * K + k] * she[j * H + h];
      sdat[e] = s;
    }
    __syncthreads();

    // masked renormalization, softmax over senders, then celu2: one warp
    // per head
    for (int k = warp; k < K; k += nwarp) {
      if (masked) {
        const float den = sdsum[k];
        const float dg = den == 0.f ? 1.f : den;
        const float live = den != 0.f ? 1.f : 0.f;
        float s2 = 0.f;
        for (int j = lane; j < N; j += 32) s2 += sdat[j * K + k] * (satt[j * K + k] * smk[j]);
        s2 = warp_sum(s2);
        for (int j = lane; j < N; j += 32)
          sdat[j * K + k] = (sdat[j * K + k] / dg - live * s2 / (dg * dg)) * smk[j];
      }
      float s = 0.f;
      for (int j = lane; j < N; j += 32) s += sdat[j * K + k] * satt[j * K + k];
      s = warp_sum(s);
      for (int j = lane; j < N; j += 32) {
        const float a = satt[j * K + k];
        const float dl = a * (sdat[j * K + k] - s);
        const float sp = ssem[j * K + k];
        const float v = dl * (sp > 0.f ? 1.f : expf(sp / 2.f));
        sdat[j * K + k] = v;
        if constexpr (kRows) edge_row(RW_DSEM, K)[j * K + k] = v;
      }
    }
    __syncthreads();
    mm_bwd(N, K, H, sdat, K, WT(W_SEM),
            [&](int r, int c, float a) { sdhe[r * H + c] += a; });
    __syncthreads();

    // h_e = silu(e0) @ w_o1 + b_o1: d_e0 in place of e0
    mm_bwd(N, H, H, sdhe, H, WT(W_O1),
            [&](int r, int c, float a) { se0[r * H + c] = a * dsiluf_(se0[r * H + c]); });
    if constexpr (kRows)
      for (int e = tid; e < N * H; e += nt) edge_row(RW_DHE, H)[e] = sdhe[e];
    __syncthreads();

    // e0 = o_j[j] + o_i[i] + o_f + r * w_o_r + b_o0
    for (int e = tid; e < N * H; e += nt) {
      sdoj[e] += se0[e];
      if constexpr (kRows) edge_row(RW_DE0, H)[e] = se0[e];
    }
    for (int h = tid; h < H; h += nt) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) s += se0[j * H + h];
      sdoi[i * H + h] = s;
    }
    for (int j = warp; j < N; j += nwarp) {
      float s = 0.f;
      for (int h = lane; h < H; h += 32) s += se0[j * H + h] * w_o_r[h];
      s = warp_sum(s);
      if (lane == 0) sdr[j] += s;
    }
    // o_f = (rbf * pre) @ w_o_f
    mm_bwd(N, H, R, se0, H, WT(W_O_F),
            [&](int r, int c, float a) {
              const float pre = saj[r * R + c] + sai[i * R + c];
              sdrbf[r * R + c] = a * pre;
              sdpre[r * R + c] = a * srbf[r * R + c];
              if constexpr (kRows) {
                edge_row(RW_DRBF, R)[r * R + c] = a * pre;
                edge_row(RW_FILT, R)[r * R + c] = srbf[r * R + c] * pre;
              }
            });
    __syncthreads();

    for (int e = tid; e < N * R; e += nt) sdaj[e] += sdpre[e];
    for (int c = tid; c < R; c += nt) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) s += sdpre[j * R + c];
      sdai[i * R + c] = s;
    }
    // rbf = exp(-b (t - m)^2), t = exp(-r)
    for (int j = warp; j < N; j += nwarp) {
      const float t = st[j];
      float s = 0.f;
      for (int c = lane; c < R; c += 32)
        s += sdrbf[j * R + c] * srbf[j * R + c] * (-2.f * rbf_b[c] * (t - rbf_m[c]));
      s = warp_sum(s);
      if (lane == 0) sdr[j] += (-t) * s;
    }
    __syncthreads();

    // r = sqrt(relu(s) + eps), s = |d0|^2, d0 = x[j] - x[i]
    for (int j = tid; j < N; j += nt) {
      const float r = sr[j];
      const float ds = sdr[j] * (0.5f / r) * (r * r > kEps ? 1.f : 0.f);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float v = sdd[k * N + j] + 2.f * sd[k * N + j] * ds;
        sdd[k * N + j] = v;
        sdxs[k * N + j] += v;
      }
    }
    __syncthreads();
    if (tid < 3) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) s += sdd[tid * N + j];
      sdxr[tid * N + i] += s;
    }
    __syncthreads();
  }

  // the sender / receiver sums are complete: their rows
  if constexpr (kRows) {
    for (int e = tid; e < N * R; e += nt) {
      node_row(RW_DAJ, e / R, R)[e % R] = sdaj[e];
      node_row(RW_DAI, e / R, R)[e % R] = sdai[e];
    }
    for (int e = tid; e < N * H; e += nt) {
      node_row(RW_DOJ, e / H, H)[e % H] = sdoj[e];
      node_row(RW_DOI, e / H, H)[e % H] = sdoi[e];
    }
  }

  // node projections: d_h += d_a_j w_in_j^T + d_a_i w_in_i^T + d_o_j w_o_j^T + d_o_i w_o_i^T
  mm_bwd(N, R, F, sdaj, R, WT(W_IN_J),
          [&](int r, int c, float a) { sdh[r * F + c] += a; });
  __syncthreads();
  mm_bwd(N, R, F, sdai, R, WT(W_IN_I),
          [&](int r, int c, float a) { sdh[r * F + c] += a; });
  __syncthreads();
  mm_bwd(N, H, F, sdoj, H, WT(W_O_J),
          [&](int r, int c, float a) { sdh[r * F + c] += a; });
  __syncthreads();
  mm_bwd(N, H, F, sdoi, H, WT(W_O_I),
          [&](int r, int c, float a) { sdh[r * F + c] += a; });
  for (int e = tid; e < 3 * N; e += nt) {
    sdx[e] = sdx[e] + sdxs[e] - sdxr[e];
    sdv[e] = sdvo[e];
  }
  __syncthreads();
  if (add_h) {  // this layer's addend (depth-stacked like bh, bx, bv)
    for (int e = tid; e < N * F; e += nt) sdh[e] += add_h[lb * N * F + e];
    for (int e = tid; e < 3 * N; e += nt) {
      const size_t at = (((size_t)l * 3 + e / N) * B + b) * N + e % N;
      sdx[e] += add_x[at];
      sdv[e] += add_v[at];
    }
    __syncthreads();
  }
}

}  // namespace sake
