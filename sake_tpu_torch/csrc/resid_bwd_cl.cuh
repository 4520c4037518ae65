// #5's cluster body: bwd_layer (resid_bwd.cuh) with rows for one CTA of a
// two-CTA cluster (cluster.cuh) that takes half of a molecule's receivers. The
// CTA holds the cotangent state of its own nodes, the receivers [i0, i1) of
// cl_rows, runs the node part and the row loop for them, and sums its partial
// sender sums (d_a_j, d_o_j, +d_d0) with the other CTA's for its own senders
// through distributed shared memory. Every row goes where bwd_layer<true>'s
// goes. f32, no addend; the x-mixing pullback and the edge products in 3xTF32
// up to N = 32 (tc_dims_of<true>, four n8 tiles of mm_tc), on the CUDA cores
// (mm_bwd) above.
//
// A body of its own, not a parameter of bwd_layer: with the cluster as a
// template parameter of bwd_layer, K2, #3 and #11 no longer compiled to their
// parent's SASS though the parameter was off there (tools/tc_ab.py), while the
// forward's (fwd_layer's kCl) did. The two bodies share every piece that is
// not per row: the carve's buffers, the products, bwd_begin.
#pragma once

#include "cluster.cuh"
#include "resid_bwd.cuh"

namespace sake {

// The cluster body's carve: carve_bwd's buffers, the receiver-indexed ones
// (sdai, sdoi, sdhatt, sdpsq, sdvn, sdvo, sdxr and the node scratch) for
// cl_span(N) rows; d_xm's rows padded (tc_ld_of<true>).
__host__ __device__ inline BwdSmem carve_bwd_cl(Carver& cv, const Dims& d) {
  const long long N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  const long long NR = cl_span(d.N);  // receiver rows of this CTA, at most
  BwdSmem s;
  s.sdh = cv.take(N * F);
  s.sdx = cv.take(3 * N);
  s.sdv = cv.take(3 * N);
  s.sh = cv.take(N * F);
  s.sx = cv.take(3 * N);
  s.sv = cv.take(3 * N);
  s.saj = cv.take(N * R);
  s.sai = cv.take(N * R);
  s.sdaj = cv.take(N * R);        // this CTA's part of the sum over receivers
  s.sdai = cv.take(NR * R);
  s.sdoj = cv.take(N * H);        // this CTA's part of the sum over receivers
  s.sdoi = cv.take(NR * H);
  s.sdhatt = cv.take(NR * H * K);
  s.sdpsq = cv.take(NR * C);
  s.sdvn = cv.take(3 * NR);
  s.sdvo = cv.take(3 * NR);
  s.sdxs = cv.take(3 * N);        // this CTA's part of + d_d0 at sender
  s.sdxr = cv.take(3 * NR);
  s.scnt = cv.take(N);
  s.sdp = cv.take(3 * C);
  s.sd = cv.take(3 * N);
  s.sr = cv.take(N);
  s.st = cv.take(N);
  s.sir = cv.take(N);
  s.sdr = cv.take(N);
  s.sdd = cv.take(3 * N);
  s.smk = cv.take(N);
  s.she = cv.take(N * H);
  s.sdhe = cv.take(N * H);
  s.satt = cv.take(N * K);
  s.satt2 = cv.take(N * K);
  s.sdsum = cv.take(K);
  s.ssem = cv.take(N * K);
  s.sdat = cv.take(N * K);
  s.se0 = cv.take(N * H);
  s.srbf = cv.take(N * R);
  s.sdrbf = cv.take(N * R);
  s.sdpre = cv.take(N * R);
  const long long rows = N * tc_ld_of<true>(d, C) + N * H * K,
                  node = NR * (4 * H + F + 1);
  s.scr = cv.take(rows > node ? rows : node);
  return s;
}

__host__ __device__ inline long long bwd_cl_floats(const Dims& d) {
  Carver cv{nullptr};
  carve_bwd_cl(cv, d);
  return cv.off;
}

// Layer l of the cluster pullback, as bwd_layer<true, false, true> (see there)
// for this CTA's receivers. S from carve_bwd_cl; ring: the W ring of the
// tensor-core products. The caller arrives at the cluster barrier once before
// the first layer and waits once after the last: each layer waits before it
// zeroes the sums the other CTA read last, and arrives once it has read the
// other's. kE16: resid_ef's bf16 tier, as bwd_layer's kE16 (see there).
template <bool kE16 = false>
__device__ __forceinline__ void bwd_layer_cl(const Dims& d, const BwdSmem& S, int b, int l,
                                             float u, const float* __restrict__ mb,
                                             const Leaves& L, const Leaves& LT,
                                             const float* __restrict__ bh,
                                             const float* __restrict__ bx,
                                             const float* __restrict__ bv,
                                             const ResidsOf<kE16>& RS, const Rows& RW,
                                             float* ring) {
  const int B = d.B, N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  const int HK = H * K, NN = N * N;
  const int ldc = tc_ld_of<true>(d, C);  // coeff's, d_xm's row stride
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
  const int rank = cl_rank();
  int i0, i1;  // this CTA's receivers, nn of them, at r = i - i0 in its buffers
  cl_rows(N, rank, i0, i1);
  const int nn = i1 - i0;
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
  float* scf = scr;               // row: (N, C) coeff -> d_xm (row stride ldc)
  float* sdha = scr + N * ldc;    // row: (N, HK) d_he_att
  float* sdg0 = scr;              // node: (nn, H)
  float* sduv = sdg0 + nn * H;    // node: (nn, F)
  float* sdnp = sduv + nn * F;    // node: (nn, H)
  float* sdps1 = sdnp + nn * H;   // node: (nn, H)
  float* sdps0 = sdps1 + nn * H;  // node: (nn, H)
  float* sdg1 = sdps0 + nn * H;   // node: (nn)
  float* sdhi = sdh + i0 * F;     // this CTA's rows of dh

  const size_t lb = (size_t)l * B + b;
  const size_t ln = lb * N + i0;  // node rows of this layer, molecule and CTA
  auto W = [&](int leaf) { return L.at(leaf, l); };
  auto WT = [&](int leaf) { return LT.at(leaf, l); };
  // node row (atom i of this molecule and layer) of a node stream of width ch
  auto node_row = [&](int row, int i, int ch) { return RW.p[row] + (lb * N + i) * ch; };

  // layer inputs, once the other CTA has read this CTA's last sums
  cl_wait();
  for (int e = tid; e < N * F; e += nt) sh[e] = bh[lb * N * F + e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    sx[e] = bx[(((size_t)l * 3 + k) * B + b) * N + i];
    sv[e] = bv[(((size_t)l * 3 + k) * B + b) * N + i];
    sdxs[e] = 0.f;
  }
  for (int e = tid; e < 3 * nn; e += nt) sdxr[e] = 0.f;
  for (int e = tid; e < N * R; e += nt) sdaj[e] = 0.f;
  for (int e = tid; e < N * H; e += nt) sdoj[e] = 0.f;
  __syncthreads();

  // a_j, a_i recomputed from h_in (pre = a_j[j] + a_i[i])
  const float* b_in = W(B_IN);
  mm_bwd(N, F, R, sh, F, W(W_IN_J), [&](int r, int c, float a) { saj[r * R + c] = a + b_in[c]; });
  mm_bwd(N, F, R, sh, F, W(W_IN_I), [&](int r, int c, float a) { sai[r * R + c] = a; });

  // position/velocity gates: x_out = x + u*v_new, v_out = v + u*(v_new - v)
  const ResOf<kE16>* g1 = RS.p[RS_G1] + ln;
  for (int r = tid; r < nn; r += nt) {
    const int i = i0 + r;
    const float sg = sigmoidf_(get_res(g1, r));
    const float gate = 2.f * sg;
    float d_gate = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float dvn = u * (sdx[k * N + i] + sdv[k * N + i]);
      sdvn[k * nn + r] = dvn;
      d_gate += dvn * sv[k * N + i];
      sdvo[k * nn + r] = gate * dvn + (1.f - u) * sdv[k * N + i];
    }
    sdg1[r] = d_gate * 2.f * sg * (1.f - sg);
  }
  __syncthreads();

  // gate MLP: g1 = silu(g0) @ w_vel1, g0 = h_out @ w_vel0 + b_vel0
  {
    const float* wv1 = W(W_VEL1);
    const ResOf<kE16>* g0 = RS.p[RS_G0] + ln * H;
    for (int e = tid; e < nn * H; e += nt)
      sdg0[e] = sdg1[e / H] * wv1[e % H] * dsiluf_(get_res(g0, e));
  }
  __syncthreads();
  mm_bwd(nn, H, F, sdg0, H, WT(W_VEL0),
         [&](int r, int c, float a) { sdhi[r * F + c] += a; });  // dho
  __syncthreads();

  // h_out = h_in + silu(uv), uv = silu(node_pre) @ w_node1 + b_node1
  {
    const ResOf<kE16>* uv = RS.p[RS_UV] + ln * F;
    for (int e = tid; e < nn * F; e += nt) sduv[e] = sdhi[e] * dsiluf_(get_res(uv, e));
  }
  __syncthreads();
  {
    const ResOf<kE16>* np = RS.p[RS_NODE_PRE] + ln * H;
    mm_bwd(nn, F, H, sduv, F, WT(W_NODE1), [&](int r, int c, float a) {
      sdnp[r * H + c] = a * dsiluf_(get_res(np, r * H + c));
    });
  }
  __syncthreads();

  // node_pre = h @ w_node_h + hatt @ w_node_agg + h_comb @ w_node_comb + b
  mm_bwd(nn, H, F, sdnp, H, WT(W_NODE_H), [&](int r, int c, float a) { sdhi[r * F + c] += a; });
  mm_bwd(nn, H, HK, sdnp, H, WT(W_NODE_AGG),
         [&](int r, int c, float a) { sdhatt[r * HK + c] = a; });
  {
    const ResOf<kE16>* ps1 = RS.p[RS_PS1] + ln * H;
    mm_bwd(nn, H, H, sdnp, H, WT(W_NODE_COMB), [&](int r, int c, float a) {
      sdps1[r * H + c] = a * dsiluf_(get_res(ps1, r * H + c));
    });
  }
  __syncthreads();
  {
    const ResOf<kE16>* ps0 = RS.p[RS_PS0] + ln * H;
    mm_bwd(nn, H, H, sdps1, H, WT(W_POST1), [&](int r, int c, float a) {
      sdps0[r * H + c] = a * dsiluf_(get_res(ps0, r * H + c));
    });
  }
  __syncthreads();
  mm_bwd(nn, H, C, sdps0, H, WT(W_POST0), [&](int r, int c, float a) { sdpsq[r * C + c] = a; });

  const float* wvmix = W(W_VMIX);
  const float* w_o_r = W(W_O_R);
  const float* rbf_m = W(RBF_M);
  const float* rbf_b = W(RBF_B);
  const ResOf<kE16>* pool[3] = {RS.p[RS_POOL0] + lb * N * C, RS.p[RS_POOL1] + lb * N * C,
                                RS.p[RS_POOL2] + lb * N * C};

  // the node rows, before the row loop reuses their scratch
  SAKE_PROBE_BARRIER(PR_BWD_PRE);
  for (int e = tid; e < nn * H; e += nt) {
    const int i = i0 + e / H, h = e % H;
    node_row(RW_DG0, i, H)[h] = sdg0[e];
    node_row(RW_DNP, i, H)[h] = sdnp[e];
    node_row(RW_DPS1, i, H)[h] = sdps1[e];
    node_row(RW_DPS0, i, H)[h] = sdps0[e];
  }
  for (int e = tid; e < nn * F; e += nt) node_row(RW_DUV, i0 + e / F, F)[e % F] = sduv[e];
  for (int r = tid; r < nn; r += nt) {
    const int i = i0 + r;
    node_row(RW_DG1, i, 1)[0] = sdg1[r];
    const float dvd = dv_denom(masked, scnt[i], n_eff);
#pragma unroll
    for (int k = 0; k < 3; ++k) node_row(RW_DDEL, i, 3)[k] = sdvn[k * nn + r] / dvd;
  }
  for (int e = tid; e < nn * C; e += nt) {
    const int i = i0 + e / C, c = e % C;
    const float pd = pool_denom(masked, scnt[i], n_eff);
    const float n0 = get_res(pool[0], i * C + c) / pd,
                n1 = get_res(pool[1], i * C + c) / pd,
                n2 = get_res(pool[2], i * C + c) / pd;
    node_row(RW_PSQ, i, C)[c] = n0 * n0 + n1 * n1 + n2 * n2;
  }
  __syncthreads();
  SAKE_PROBE(PR_BWD_ROWS);

  for (int i = i0; i < i1; ++i) {
    const int ri = i - i0;
    const size_t erow = lb * NN + (size_t)i * N;
    // edge row (i, j) of an edge stream of width ch
    auto edge_row = [&](int row, int ch) { return RW.p[row] + erow * ch; };
    const float pd = pool_denom(masked, scnt[i], n_eff);
    const float dvd = dv_denom(masked, scnt[i], n_eff);

    // d_pooled for row i; stage the row's residuals
    for (int c = tid; c < C; c += nt) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        sdp[k * C + c] = sdvn[k * nn + ri] * wvmix[c] / dvd +
                         2.f * get_res(pool[k], i * C + c) * sdpsq[ri * C + c] / (pd * pd);
    }
    for (int j = tid; j < N; j += nt) {
      const float r = res_r(RS)[erow + j];
      sr[j] = r;
      st[j] = res_t(RS)[erow + j];
      sir[j] = 1.f / (r + 1e-5f);
      smk[j] = masked ? mb[i * N + j] : 1.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) sd[k * N + j] = sx[k * N + j] - sx[k * N + i];
    }
    if constexpr (kE16) {  // the bf16 streams, widened as they are read
      for (int e = tid; e < N * C; e += nt)
        scf[(e / C) * ldc + e % C] = get_res(RS.p[RS_COEFF], erow * C + e);
      load_low(she, RS.p[RS_H_E] + erow * H, N * H);
      load_low(se0, RS.p[RS_E0] + erow * H, N * H);
      load_low(satt, RS.p[RS_ATT] + erow * K, N * K);
      load_low(ssem, RS.p[RS_SEM_PRE] + erow * K, N * K);
      load_low(srbf, RS.p[RS_RBF] + erow * R, N * R);
    } else {
      if (ldc == C) {
        load_smem(scf, RS.p[RS_COEFF] + erow * C, N * C);
      } else {  // row by row into the padded rows, in float4 (C is 256 here)
        const float4* cf = reinterpret_cast<const float4*>(RS.p[RS_COEFF] + erow * C);
        for (int e = tid; e < N * C / 4; e += nt)
          reinterpret_cast<float4*>(scf + (e / (C / 4)) * ldc)[e % (C / 4)] = cf[e];
      }
      load_smem(she, RS.p[RS_H_E] + erow * H, N * H);
      load_smem(se0, RS.p[RS_E0] + erow * H, N * H);
      load_smem(satt, RS.p[RS_ATT] + erow * K, N * K);
      load_smem(ssem, RS.p[RS_SEM_PRE] + erow * K, N * K);
      load_smem(srbf, RS.p[RS_RBF] + erow * R, N * R);
    }
    __syncthreads();
    SAKE_PROBE(PR_BWD_LOAD);

    // pooled_k = sum_j coeff * u_k: d_u_k[j] = coeff[j] . d_pooled_k
    for (int j = warp; j < N; j += nwarp) {
      float du[3] = {0.f, 0.f, 0.f};
      for (int c = lane; c < C; c += 32) {
        const float cf = scf[j * ldc + c];
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
      float* x = scf + j * ldc + c;
      const float cf = *x;
      const float v = dc * (1.f - cf * cf) * smk[j];
      *x = v;
      edge_row(RW_DXM, C)[e] = v;
    }
    // hatt[i] = sum_j h_e[j] (x) att2[j]; the row's att2
    for (int q = tid; q < HK; q += nt) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) s += she[j * H + q / K] * rd<kE16>(satt2[j * K + q % K]);
      node_row(RW_HATT, i, HK)[q] = s;
    }
    for (int e = tid; e < N * K; e += nt) edge_row(RW_ATT2, K)[e] = rd<kE16>(satt2[e]);
    __syncthreads();
    SAKE_PROBE(PR_BWD_ROW);

    // d_he_att = d_xm @ w_xmix^T + d_hatt[i] (hatt sums he_att over senders)
    auto st_dha = [&](int r, int c, float a) { sdha[r * HK + c] = a + sdhatt[ri * HK + c]; };
    if (tc_dims_of<true>(d))
      mm_tc<tc_tiles<true>(), kE16 ? 1 : 3>(N, scf, ldc, WT(W_XMIX), ring, st_dha);
    else mm_bwd<kE16>(N, C, HK, scf, ldc, WT(W_XMIX), st_dha);
    __syncthreads();
    SAKE_PROBE(PR_BWD_XMIX);

    // he_att[j, h*K + k] = h_e[j, h] * att2[j, k]
    for (int e = tid; e < N * H; e += nt) {
      const int j = e / H, h = e % H;
      float s = 0.f;
      for (int k = 0; k < K; ++k) {
        if constexpr (kE16) s += bf16r(sdha[j * HK + h * K + k] * bf16r(satt2[j * K + k]));
        else s += sdha[j * HK + h * K + k] * satt2[j * K + k];
      }
      sdhe[e] = s;
    }
    for (int e = tid; e < N * K; e += nt) {
      const int j = e / K, k = e % K;
      float s = 0.f;
      for (int h = 0; h < H; ++h) {
        if constexpr (kE16) s += bf16r(sdha[j * HK + h * K + k] * she[j * H + h]);
        else s += sdha[j * HK + h * K + k] * she[j * H + h];
      }
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
        edge_row(RW_DSEM, K)[j * K + k] = v;
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_BWD_ROW);
    mm_bwd<kE16>(N, K, H, sdat, K, WT(W_SEM),
                 [&](int r, int c, float a) { sdhe[r * H + c] += a; });
    __syncthreads();
    SAKE_PROBE(PR_BWD_MM);

    // h_e = silu(e0) @ w_o1 + b_o1: d_e0 in place of e0
    auto st_de0 = [&](int r, int c, float a) { se0[r * H + c] = a * dsiluf_(se0[r * H + c]); };
    if (tc_dims_of<true>(d)) mm_tc_small<kE16 ? 1 : 3>(N, H, H, sdhe, H, WT(W_O1), st_de0);
    else mm_bwd<kE16>(N, H, H, sdhe, H, WT(W_O1), st_de0);
    for (int e = tid; e < N * H; e += nt) edge_row(RW_DHE, H)[e] = sdhe[e];
    __syncthreads();
    SAKE_PROBE(PR_BWD_O1_MM);

    // e0 = o_j[j] + o_i[i] + o_f + r * w_o_r + b_o0
    for (int e = tid; e < N * H; e += nt) {
      sdoj[e] += se0[e];
      edge_row(RW_DE0, H)[e] = se0[e];
    }
    for (int h = tid; h < H; h += nt) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) s += se0[j * H + h];
      sdoi[ri * H + h] = s;
    }
    for (int j = warp; j < N; j += nwarp) {
      float s = 0.f;
      for (int h = lane; h < H; h += 32) s += se0[j * H + h] * w_o_r[h];
      s = warp_sum(s);
      if (lane == 0) sdr[j] += s;
    }
    // o_f = (rbf * pre) @ w_o_f
    auto st_dfilt = [&](int r, int c, float a) {
      const float pre = saj[r * R + c] + sai[i * R + c];
      sdrbf[r * R + c] = a * pre;
      sdpre[r * R + c] = a * srbf[r * R + c];
      edge_row(RW_DRBF, R)[r * R + c] = a * pre;
      edge_row(RW_FILT, R)[r * R + c] = srbf[r * R + c] * pre;
    };
    if (tc_dims_of<true>(d)) mm_tc_small<kE16 ? 1 : 3>(N, H, R, se0, H, WT(W_O_F), st_dfilt);
    else mm_bwd<kE16>(N, H, R, se0, H, WT(W_O_F), st_dfilt);
    __syncthreads();
    SAKE_PROBE(PR_BWD_OF_MM);

    for (int e = tid; e < N * R; e += nt) sdaj[e] += sdpre[e];
    for (int c = tid; c < R; c += nt) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) s += sdpre[j * R + c];
      sdai[ri * R + c] = s;
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
      sdxr[tid * nn + ri] += s;
    }
    __syncthreads();
    SAKE_PROBE(PR_BWD_ROW);
  }

  // This CTA's sender sums cover its own receivers. Once both CTAs' are
  // complete, each adds the other's part of its own senders' sums to its own
  // (rank 0's + rank 1's, as both CTAs order them), then arrives: the other
  // reads them no more this layer.
  cl_sync();
  const float *qaj = cl_map(sdaj, rank ^ 1), *qoj = cl_map(sdoj, rank ^ 1),
              *qxs = cl_map(sdxs, rank ^ 1);
  auto sum2 = [&](float mine, float other) { return rank == 0 ? mine + other : other + mine; };
  for (int e = i0 * R + tid; e < i1 * R; e += nt) sdaj[e] = sum2(sdaj[e], qaj[e]);
  for (int e = i0 * H + tid; e < i1 * H; e += nt) sdoj[e] = sum2(sdoj[e], qoj[e]);
  for (int e = tid; e < 3 * nn; e += nt) {
    const int q = (e / nn) * N + i0 + e % nn;
    sdxs[q] = sum2(sdxs[q], qxs[q]);
  }
  cl_arrive();
  __syncthreads();
  SAKE_PROBE(PR_BWD_CL);

  // the sender / receiver sums of this CTA's nodes are complete: their rows
  for (int e = tid; e < nn * R; e += nt) {
    node_row(RW_DAJ, i0 + e / R, R)[e % R] = sdaj[i0 * R + e];
    node_row(RW_DAI, i0 + e / R, R)[e % R] = sdai[e];
  }
  for (int e = tid; e < nn * H; e += nt) {
    node_row(RW_DOJ, i0 + e / H, H)[e % H] = sdoj[i0 * H + e];
    node_row(RW_DOI, i0 + e / H, H)[e % H] = sdoi[e];
  }

  // node projections: d_h += d_a_j w_in_j^T + d_a_i w_in_i^T + d_o_j w_o_j^T + d_o_i w_o_i^T
  mm_bwd(nn, R, F, sdaj + i0 * R, R, WT(W_IN_J),
         [&](int r, int c, float a) { sdhi[r * F + c] += a; });
  __syncthreads();
  mm_bwd(nn, R, F, sdai, R, WT(W_IN_I), [&](int r, int c, float a) { sdhi[r * F + c] += a; });
  __syncthreads();
  mm_bwd(nn, H, F, sdoj + i0 * H, H, WT(W_O_J),
         [&](int r, int c, float a) { sdhi[r * F + c] += a; });
  __syncthreads();
  mm_bwd(nn, H, F, sdoi, H, WT(W_O_I), [&](int r, int c, float a) { sdhi[r * F + c] += a; });
  for (int e = tid; e < 3 * nn; e += nt) {
    const int q = (e / nn) * N + i0 + e % nn;
    sdx[q] = sdx[q] + sdxs[q] - sdxr[e];
    sdv[q] = sdvo[e];
  }
  __syncthreads();
  SAKE_PROBE(PR_BWD_NODE);
}

}  // namespace sake
