// K2's per-layer body: layer_bwd_resid of one molecule and one layer (with
// kRows also its cotangent rows), for a whole thread block. resid_bwd.cu
// runs it over depth in reverse; fused_ef.cu runs it as the backward phase of
// the fused primal (#11) and of one_ef (#3), fused_bwd.cu as the primal
// cotangent chain of the fused training backward (#12). See resid_bwd.cu for
// the design and what bounds it. Its kBf16 instantiation (fused_remat_ef.cu,
// #20) pulls back through the bf16 products; its kTc instantiation (#11, #12,
// #20 in both tiers) runs the x-mixing pullback on the tensor cores
// (mma_tf32x3.cuh). #5's cluster kernel runs a body of its own, bwd_layer_cl
// (resid_bwd_cl.cuh).
#pragma once

#include "mma_tf32x3.cuh"
#include "resid_common.cuh"

namespace sake {

constexpr int kBwdTileCols = 2;  // columns per tile in mm_tiled
constexpr int kBwdTiledMinCols = 128;  // narrowest tiled product

// This body's block products (see mm_smem).
template <bool kRoundA = false, class ST>
__device__ __forceinline__ void mm_bwd(int n, int kd, int m, const float* A, int lda,
                                   const float* __restrict__ W, ST st) {
  mm_smem<kBwdTileCols, kBwdTiledMinCols, kRoundA>(n, kd, m, A, lda, W, st);
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

// kTc: the carve of the kTc body (d_xm's rows padded, tc_ld).
template <bool kTc = false>
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
  if constexpr (kTc) {
    const long long rows = N * tc_ld(d, C) + N * H * K, node = N * (4 * H + F + 1);
    s.scr = cv.take(rows > node ? rows : node);
  } else {
    const long long rows = N * C + N * H * K, node = N * (4 * H + F + 1);
    s.scr = cv.take(rows > node ? rows : node);
  }
  return s;
}

template <bool kTc = false>
__host__ __device__ inline long long bwd_smem_floats(const Dims& d) {
  Carver cv{nullptr};
  carve_bwd<kTc>(cv, d);
  return cv.off;
}

// Floats of the cotangent state (sdh, sdx, sdv) that carve_bwd takes first: a
// kernel that runs another body between layers carves that body's buffers
// after them, so the state outlives it.
__host__ __device__ inline long long bwd_state_floats(const Dims& d) {
  Carver cv{nullptr};
  cv.take((long long)d.N * d.F);
  cv.take(3LL * d.N);
  cv.take(3LL * d.N);
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
// d.B, N): null, or added to the cotangents leaving the layer. kBf16: the
// pullback of fwd_layer's kBf16 instantiation (L, LT hold the rounded
// weights), as JAX differentiates a bf16 product mm(a, w): d_a = bf16(g @
// w^T), g not rounded, each product's term rounded before it joins a sum.
// Its x-mixing pullback is the per-head form's: with P = d_xm @ w_xmix^T,
// d_h_e = sum_k bf16(att_k P_k), d_att_k = P_k . bf16(h_e) (plus the
// attended sum's terms, f32). kTc: the x-mixing pullback d_xm @ w_xmix^T and
// the edge products on the tensor cores in 3xTF32 (S from carve_bwd<true>,
// ring: tc_ring_floats) where tc_dims allows, the CUDA-core products
// elsewhere; with kBf16 on two passes (tc_passes: g split, the bf16 weight
// exact). Without kTc every product runs on the CUDA cores. kE16: the pullback
// of fwd_layer's kE16 (resid_ef's bf16 tier, JAX's mm_edge in bf16): the
// residual streams but r and t read as bf16 (get_res), each edge product's
// cotangent (d_xm, d_sem_pre, d_h_e, d_e0) rounded as it is read against the
// rounded weight (LT holds w_o_f, w_o1, w_sem, w_xmix rounded), one pass on the
// tensor cores; the head expansion's terms bf16(d_he_att bf16(att2)) and
// bf16(d_he_att h_e) rounded before their sums; node products f32. With
// kRows (only #12's primal chain in that tier, fused_bwd16.cu) its rows are
// those of layer_bwd_resid(bf16=True): att2 rounded, hatt summing h_e (a bf16
// value) times att2 rounded, psq from the rounded pooled vectors.
template <bool kRows, bool kBf16 = false, bool kTc = false, bool kE16 = false>
__device__ __forceinline__ void bwd_layer(const Dims& d, const BwdSmem& S, int b, int l,
                                          float u, const float* __restrict__ mb,
                                          const Leaves& L, const Leaves& LT,
                                          const float* __restrict__ bh,
                                          const float* __restrict__ bx,
                                          const float* __restrict__ bv,
                                          const ResidsOf<kE16>& RS, const Rows& RW,
                                          const float* __restrict__ add_h,
                                          const float* __restrict__ add_x,
                                          const float* __restrict__ add_v, float* ring = nullptr) {
  static_assert(!(kE16 && kBf16), "one bf16 tier");
  constexpr int kXmixPasses = kE16 ? 1 : tc_passes<kBf16>();  // on the tensor cores
  const int B = d.B, N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  const int HK = H * K, NN = N * N;
  [[maybe_unused]] const int ldc = kTc ? tc_ld(d, C) : C;  // kTc: coeff's, d_xm's row stride
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
  float* scf = scr;               // row: (N, C) coeff -> d_xm (row stride ldc)
  float* sdha = scr + N * (kTc ? ldc : C);  // row: (N, HK) d_he_att
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
  mm_bwd<kBf16>(N, F, R, sh, F, W(W_IN_J),
          [&](int r, int c, float a) { saj[r * R + c] = a + b_in[c]; });
  mm_bwd<kBf16>(N, F, R, sh, F, W(W_IN_I),
          [&](int r, int c, float a) { sai[r * R + c] = a; });

  // position/velocity gates: x_out = x + u*v_new, v_out = v + u*(v_new - v)
  const ResOf<kE16>* g1 = RS.p[RS_G1] + lb * N;
  for (int i = tid; i < N; i += nt) {
    const float sg = sigmoidf_(get_res(g1, i));
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
    const ResOf<kE16>* g0 = RS.p[RS_G0] + lb * N * H;
    for (int e = tid; e < N * H; e += nt) {
      const int i = e / H, h = e % H;
      sdg0[e] = rd<kBf16>(sdg1[i] * wv1[h]) * dsiluf_(get_res(g0, e));
    }
  }
  __syncthreads();
  mm_bwd(N, H, F, sdg0, H, WT(W_VEL0),
          [&](int r, int c, float a) { sdh[r * F + c] += rd<kBf16>(a); });  // dho
  __syncthreads();

  // h_out = h_in + silu(uv), uv = silu(node_pre) @ w_node1 + b_node1
  {
    const ResOf<kE16>* uv = RS.p[RS_UV] + lb * N * F;
    for (int e = tid; e < N * F; e += nt) sduv[e] = sdh[e] * dsiluf_(get_res(uv, e));
  }
  __syncthreads();
  {
    const ResOf<kE16>* np = RS.p[RS_NODE_PRE] + lb * N * H;
    mm_bwd(N, F, H, sduv, F, WT(W_NODE1),
            [&](int r, int c, float a) {
              sdnp[r * H + c] = rd<kBf16>(a) * dsiluf_(get_res(np, r * H + c));
            });
  }
  __syncthreads();

  // node_pre = h @ w_node_h + hatt @ w_node_agg + h_comb @ w_node_comb + b
  mm_bwd(N, H, F, sdnp, H, WT(W_NODE_H),
         [&](int r, int c, float a) { sdh[r * F + c] += rd<kBf16>(a); });
  mm_bwd(N, H, HK, sdnp, H, WT(W_NODE_AGG),
          [&](int r, int c, float a) { sdhatt[r * HK + c] = rd<kBf16>(a); });
  {
    const ResOf<kE16>* ps1 = RS.p[RS_PS1] + lb * N * H;
    mm_bwd(N, H, H, sdnp, H, WT(W_NODE_COMB),
            [&](int r, int c, float a) {
              sdps1[r * H + c] = rd<kBf16>(a) * dsiluf_(get_res(ps1, r * H + c));
            });
  }
  __syncthreads();
  {
    const ResOf<kE16>* ps0 = RS.p[RS_PS0] + lb * N * H;
    mm_bwd(N, H, H, sdps1, H, WT(W_POST1),
            [&](int r, int c, float a) {
              sdps0[r * H + c] = rd<kBf16>(a) * dsiluf_(get_res(ps0, r * H + c));
            });
  }
  __syncthreads();
  mm_bwd(N, H, C, sdps0, H, WT(W_POST0),
          [&](int r, int c, float a) { sdpsq[r * C + c] = rd<kBf16>(a); });

  const float* wvmix = W(W_VMIX);
  const float* w_o_r = W(W_O_R);
  const float* rbf_m = W(RBF_M);
  const float* rbf_b = W(RBF_B);
  const ResOf<kE16>* pool[3] = {RS.p[RS_POOL0] + lb * N * C, RS.p[RS_POOL1] + lb * N * C,
                                RS.p[RS_POOL2] + lb * N * C};

  // the node rows, before the row loop reuses their scratch
  SAKE_PROBE_BARRIER(PR_BWD_PRE);
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
      if constexpr (kE16) {
        const float n0 = get_res(pool[0], e) / pd, n1 = get_res(pool[1], e) / pd,
                    n2 = get_res(pool[2], e) / pd;
        node_row(RW_PSQ, e / C, C)[e % C] = n0 * n0 + n1 * n1 + n2 * n2;
      } else {
        const float n0 = pool[0][e] / pd, n1 = pool[1][e] / pd, n2 = pool[2][e] / pd;
        node_row(RW_PSQ, e / C, C)[e % C] = n0 * n0 + n1 * n1 + n2 * n2;
      }
    }
  }
  __syncthreads();
  SAKE_PROBE(PR_BWD_ROWS);

  for (int i = 0; i < N; ++i) {
    const size_t erow = lb * NN + (size_t)i * N;
    // edge row (i, j) of an edge stream of width ch
    auto edge_row = [&](int row, int ch) { return RW.p[row] + erow * ch; };
    const float pd = pool_denom(masked, scnt[i], n_eff);
    const float dvd = dv_denom(masked, scnt[i], n_eff);

    // d_pooled for row i; stage the row's residuals
    for (int c = tid; c < C; c += nt) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if constexpr (kBf16)
          sdp[k * C + c] = bf16r(sdvn[k * N + i] / dvd * wvmix[c]) +
                           2.f * pool[k][i * C + c] * sdpsq[i * C + c] / (pd * pd);
        else if constexpr (kE16)
          sdp[k * C + c] = sdvn[k * N + i] * wvmix[c] / dvd +
                           2.f * get_res(pool[k], i * C + c) * sdpsq[i * C + c] / (pd * pd);
        else
          sdp[k * C + c] = sdvn[k * N + i] * wvmix[c] / dvd +
                           2.f * pool[k][i * C + c] * sdpsq[i * C + c] / (pd * pd);
      }
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
      if constexpr (kTc) {
        if (ldc == C) {
          load_smem(scf, RS.p[RS_COEFF] + erow * C, N * C);
        } else {  // row by row into the padded rows, in float4 (C is 256 here)
          const float4* cf = reinterpret_cast<const float4*>(RS.p[RS_COEFF] + erow * C);
          for (int e = tid; e < N * C / 4; e += nt)
            reinterpret_cast<float4*>(scf + (e / (C / 4)) * ldc)[e % (C / 4)] = cf[e];
        }
      } else {
        load_smem(scf, RS.p[RS_COEFF] + erow * C, N * C);
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
        const float cf = kTc ? scf[j * ldc + c] : scf[j * C + c];
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
      float* x = scf + e;
      if constexpr (kTc) x = scf + j * ldc + c;
      const float cf = *x;
      const float v = dc * (1.f - cf * cf) * smk[j];
      *x = v;
      if constexpr (kRows) edge_row(RW_DXM, C)[e] = v;
    }
    if constexpr (kRows) {
      // hatt[i] = sum_j h_e[j] (x) att2[j]; the row's att2
      for (int q = tid; q < HK; q += nt) {
        float s = 0.f;
        for (int j = 0; j < N; ++j) {
          if constexpr (kE16) s += she[j * H + q / K] * bf16r(satt2[j * K + q % K]);
          else s += she[j * H + q / K] * satt2[j * K + q % K];
        }
        node_row(RW_HATT, i, HK)[q] = s;
      }
      for (int e = tid; e < N * K; e += nt) {
        if constexpr (kE16) edge_row(RW_ATT2, K)[e] = bf16r(satt2[e]);
        else edge_row(RW_ATT2, K)[e] = satt2[e];
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_BWD_ROW);

    // d_he_att = d_xm @ w_xmix^T + d_hatt[i] (hatt sums he_att over senders);
    // kBf16 keeps the product P alone (see above)
    auto st_dha = [&](int r, int c, float a) {
      if constexpr (kBf16) sdha[r * HK + c] = a;
      else sdha[r * HK + c] = a + sdhatt[i * HK + c];
    };
    if constexpr (kTc) {
      if (tc_dims(d)) mm_tc<3, kXmixPasses>(N, scf, ldc, WT(W_XMIX), ring, st_dha);
      else mm_bwd<kE16>(N, C, HK, scf, ldc, WT(W_XMIX), st_dha);
    } else {
      mm_bwd<kE16>(N, C, HK, scf, C, WT(W_XMIX), st_dha);
    }
    __syncthreads();
    SAKE_PROBE(PR_BWD_XMIX);

    // he_att[j, h*K + k] = h_e[j, h] * att2[j, k]
    for (int e = tid; e < N * H; e += nt) {
      const int j = e / H, h = e % H;
      float s = 0.f;
      for (int k = 0; k < K; ++k) {
        if constexpr (kBf16) {
          const float a2 = satt2[j * K + k];
          s += bf16r(a2 * sdha[j * HK + h * K + k]) + sdhatt[i * HK + h * K + k] * a2;
        } else if constexpr (kE16) {
          s += bf16r(sdha[j * HK + h * K + k] * bf16r(satt2[j * K + k]));
        } else {
          s += sdha[j * HK + h * K + k] * satt2[j * K + k];
        }
      }
      sdhe[e] = s;
    }
    for (int e = tid; e < N * K; e += nt) {
      const int j = e / K, k = e % K;
      float s = 0.f;
      for (int h = 0; h < H; ++h) {
        if constexpr (kBf16) {
          const float he = she[j * H + h];
          s += sdha[j * HK + h * K + k] * bf16r(he) + sdhatt[i * HK + h * K + k] * he;
        } else if constexpr (kE16) {
          s += bf16r(sdha[j * HK + h * K + k] * she[j * H + h]);
        } else {
          s += sdha[j * HK + h * K + k] * she[j * H + h];
        }
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
        if constexpr (kRows) edge_row(RW_DSEM, K)[j * K + k] = v;
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_BWD_ROW);
    mm_bwd<kE16>(N, K, H, sdat, K, WT(W_SEM),
                 [&](int r, int c, float a) { sdhe[r * H + c] += rd<kBf16>(a); });
    __syncthreads();
    SAKE_PROBE(PR_BWD_MM);

    // h_e = silu(e0) @ w_o1 + b_o1: d_e0 in place of e0
    auto st_de0 = [&](int r, int c, float a) {
      se0[r * H + c] = rd<kBf16>(a) * dsiluf_(se0[r * H + c]);
    };
    if constexpr (kTc) {
      if (tc_dims(d)) mm_tc_small<kXmixPasses>(N, H, H, sdhe, H, WT(W_O1), st_de0);
      else mm_bwd<kE16>(N, H, H, sdhe, H, WT(W_O1), st_de0);
    } else {
      mm_bwd<kE16>(N, H, H, sdhe, H, WT(W_O1), st_de0);
    }
    if constexpr (kRows)
      for (int e = tid; e < N * H; e += nt) edge_row(RW_DHE, H)[e] = sdhe[e];
    __syncthreads();
    SAKE_PROBE(PR_BWD_O1_MM);

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
    auto st_dfilt = [&](int r, int c, float g) {
      const float a = rd<kBf16>(g);
      const float pre = saj[r * R + c] + sai[i * R + c];
      sdrbf[r * R + c] = a * pre;
      sdpre[r * R + c] = a * srbf[r * R + c];
      if constexpr (kRows) {
        edge_row(RW_DRBF, R)[r * R + c] = a * pre;
        edge_row(RW_FILT, R)[r * R + c] = srbf[r * R + c] * pre;
      }
    };
    if constexpr (kTc) {
      if (tc_dims(d)) mm_tc_small<kXmixPasses>(N, H, R, se0, H, WT(W_O_F), st_dfilt);
      else mm_bwd<kE16>(N, H, R, se0, H, WT(W_O_F), st_dfilt);
    } else {
      mm_bwd<kE16>(N, H, R, se0, H, WT(W_O_F), st_dfilt);
    }
    __syncthreads();
    SAKE_PROBE(PR_BWD_OF_MM);

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
    SAKE_PROBE(PR_BWD_ROW);
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
          [&](int r, int c, float a) { sdh[r * F + c] += rd<kBf16>(a); });
  __syncthreads();
  mm_bwd(N, R, F, sdai, R, WT(W_IN_I),
          [&](int r, int c, float a) { sdh[r * F + c] += rd<kBf16>(a); });
  __syncthreads();
  mm_bwd(N, H, F, sdoj, H, WT(W_O_J),
          [&](int r, int c, float a) { sdh[r * F + c] += rd<kBf16>(a); });
  __syncthreads();
  mm_bwd(N, H, F, sdoi, H, WT(W_O_I),
          [&](int r, int c, float a) { sdh[r * F + c] += rd<kBf16>(a); });
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
  SAKE_PROBE(PR_BWD_NODE);
}

}  // namespace sake
