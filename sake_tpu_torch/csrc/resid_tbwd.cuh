// The tangent pullback's per-layer body: the jvp of layer_bwd_resid (with
// its cotangent rows) of one molecule and one layer, for a whole thread
// block. resid_tbwd.cu runs it over depth in reverse (#10's tangent chain);
// fused_bwd.cu runs it in phase 2 of the fused training backward (#12). See
// resid_tbwd.cu for the design and what bounds it. Its kTc instantiation
// (#12) runs the x-mixing pullback on the tensor cores (mma_tf32x3.cuh); its
// kE16 instantiation (#12 in resid_ef's bf16 tier, fused_bwd16.cu) is the
// tangent pullback of that tier.
#pragma once

#include "mma_tf32x3.cuh"
#include "resid_common.cuh"

namespace sake {

constexpr int kTbTileCols = 2;        // columns per tile in mm_tiled
constexpr int kTbTiledMinCols = 128;  // narrowest tiled product

template <bool kRoundA = false, class ST>
__device__ __forceinline__ void mm_tb(int n, int kd, int m, const float* A, int lda,
                                      const float* __restrict__ W, ST st) {
  mm_smem<kTbTileCols, kTbTiledMinCols, kRoundA>(n, kd, m, A, lda, W, st);
}

// element i of a dual buffer whose tangents start n floats after its values
__device__ __forceinline__ Dl ld(const float* p, size_t n, size_t i) { return {p[i], p[n + i]}; }
__device__ __forceinline__ void st2(float* p, size_t n, size_t i, Dl x) {
  p[i] = x.v;
  p[n + i] = x.t;
}

// Shared-memory buffers of the tangent pullback, in floats. Dual buffers hold 2x their rows.
struct TbSmem {
  float *sdh, *sdx, *sdv, *sdxs, *sdxr, *sdvo, *sdvn, *sh, *sx, *sv, *saj, *sai, *sdaj, *sdai,
      *sdoj, *sdoi;
  float *sdp, *sgeo, *sdd, *satt, *sdat, *sX, *sY;
};

// kTc: the carve of the kTc body (d_xm's rows padded, tc_ld).
template <bool kTc = false>
__host__ __device__ inline TbSmem carve_tb(Carver& cv, const Dims& d) {
  const long long N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  TbSmem s;
  s.sdh = cv.take(2 * N * F);   // d_h: the chain's state (values) and this layer's tangent
  s.sdx = cv.take(3 * N);       // the chain's state
  s.sdv = cv.take(3 * N);
  s.sdxs = cv.take(6 * N);      // dual: + d_d0 summed at the sender
  s.sdxr = cv.take(6 * N);      // dual: - d_d0 summed at the receiver
  s.sdvo = cv.take(6 * N);      // dual: d_v_in
  s.sdvn = cv.take(3 * N);      // d_v_new (no tangent)
  s.sh = cv.take(2 * N * F);    // dual: h_in
  s.sx = cv.take(6 * N);        // dual: x planes
  s.sv = cv.take(6 * N);        // dual: v planes
  s.saj = cv.take(2 * N * R);   // dual: h @ w_in_j + b_in
  s.sai = cv.take(2 * N * R);
  s.sdaj = cv.take(2 * N * R);  // dual: sums over receivers
  s.sdai = cv.take(2 * N * R);
  s.sdoj = cv.take(2 * N * H);
  s.sdoi = cv.take(2 * N * H);
  s.sdp = cv.take(6 * C);       // row, dual: d_pooled (3 planes of C)
  s.sgeo = cv.take(14 * N);     // row, dual: r, t, 1 / (r + 1e-5), d_r, d0 (3 planes)
  s.sdd = cv.take(6 * N);       // row, dual: d_d0
  s.satt = cv.take(2 * N * K);  // row, dual: att
  s.sdat = cv.take(2 * N * K);  // row, dual: d_att -> d_sem_pre
  // row: d_xm, then d_h_e, then d_filtered -> d_rbf (dual)
  if constexpr (kTc) {
    const long long xm = 2 * N * tc_ld(d, C);
    s.sX = cv.take(xm > 2 * N * H && xm > 2 * N * R ? xm
                   : (2 * N * H > 2 * N * R ? 2 * N * H : 2 * N * R));
  } else {
    s.sX = cv.take(2 * N * C > 2 * N * H && 2 * N * C > 2 * N * R ? 2 * N * C
                   : (2 * N * H > 2 * N * R ? 2 * N * H : 2 * N * R));
  }
  // row: d_he_att, then d_e0, then d_pre (dual); the node phase uses sX and sY
  // as one region (they are carved back to back). d_pre takes 2N x R: wider
  // than d_he_att when R > H*K
  const long long hk = H * K, y = 2 * N * (hk > R ? hk : R), node = 2 * N * (4 * H + F + 1);
  s.sY = cv.take(y > node ? y : node);
  return s;
}

template <bool kTc = false>
__host__ __device__ inline long long tb_smem_floats(const Dims& d) {
  Carver cv{nullptr};
  carve_tb<kTc>(cv, d);
  return cv.off;
}

// The chain's cotangent (dh, dx, dv) of molecule m of a batch of B into the
// values of S.sdh, and S.sdx, S.sdv.
__device__ __forceinline__ void tbwd_begin(const Dims& d, const TbSmem& S, int B, int m,
                                           const float* __restrict__ dh_fin,
                                           const float* __restrict__ dx_fin,
                                           const float* __restrict__ dv_fin) {
  const int N = d.N, F = d.F, tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < N * F; e += nt) S.sdh[e] = dh_fin[(size_t)m * N * F + e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    S.sdx[e] = dx_fin[((size_t)k * B + m) * N + i];
    S.sdv[e] = dv_fin[((size_t)k * B + m) * N + i];
  }
  __syncthreads();
}

// Layer l of the tangent pullback on the chain's cotangent state in S (the
// values of S.sdh, S.sdx, S.sdv; it leaves the cotangents of the layer's
// input there). Reads the primal and tangent boundary states and residuals
// at molecule slot b of d.B, layer l, and writes the layer's rows (RW) and
// their tangents (TW) there. It leaves the layer's Hessian terms in the
// tangent halves of S.sdh, S.sdxs - S.sdxr and S.sdvo, and also writes them
// to add_h (depth, d.B, N, F), add_x, add_v (depth, 3, d.B, N) unless add_h is
// null. gscratch: this molecule's 2N * (H*K + C) floats of device memory.
// kTc: the x-mixing pullback (2N rows) and the edge products on the tensor
// cores in 3xTF32 (S from carve_tb<true>, ring: tc_ring_floats) where tc_dims
// allows; without it every product runs on the CUDA cores. kE16: the jvp of
// bwd_layer's kE16 (resid_ef's bf16 tier): RS and TR are Resids16, read
// widened (get_res); each edge product rounds its value rows and its tangent
// rows apart (JAX's jvp of a rounding rounds the tangent), one pass on the
// tensor cores (LT holds the four edge weights rounded); the head expansion's
// terms bf16(d_he_att att) and bf16(d_he_att h_e) are rounded value and
// tangent apart before their sums (att, h_e and their tangents are bf16
// values); the rows stay f32.
template <bool kTc = false, bool kE16 = false>
__device__ __forceinline__ void tbwd_layer(const Dims& d, const TbSmem& S, int b, int l,
                                           float u, const Leaves& L, const Leaves& LT,
                                           const float* __restrict__ bh,
                                           const float* __restrict__ bx,
                                           const float* __restrict__ bv,
                                           const float* __restrict__ tbh,
                                           const float* __restrict__ tbx,
                                           const float* __restrict__ tbv,
                                           const ResidsOf<kE16>& RS, const ResidsOf<kE16>& TR,
                                           const Rows& RW, const Rows& TW, float* gscratch,
                                           float* add_h, float* add_x, float* add_v,
                                           float* ring = nullptr) {
  constexpr int kPasses = kE16 ? 1 : 3;  // of the tensor-core products
  const int B = d.B, N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  const int HK = H * K, NN = N * N;
  [[maybe_unused]] const int ldc = kTc ? tc_ld(d, C) : C;  // kTc: d_xm's row stride
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
  const float n_eff = (float)N;
  float *sdh = S.sdh, *sdx = S.sdx, *sdv = S.sdv, *sdxs = S.sdxs, *sdxr = S.sdxr,
        *sdvo = S.sdvo, *sdvn = S.sdvn, *sh = S.sh, *sx = S.sx, *sv = S.sv, *saj = S.saj,
        *sai = S.sai, *sdaj = S.sdaj, *sdai = S.sdai, *sdoj = S.sdoj, *sdoi = S.sdoi,
        *sdp = S.sdp, *sdd = S.sdd, *satt = S.satt, *sdat = S.sdat, *sX = S.sX, *sY = S.sY;
  // row, dual per-sender vectors: value j, tangent N + j
  float *sr = S.sgeo, *st = sr + 2 * N, *sir = st + 2 * N, *sdr = sir + 2 * N;
  float* sd = sdr + 2 * N;  // dual d0: value k*N + j, tangent 3N + k*N + j
  // node phase, dual (N, .) buffers in the sX + sY region
  float* sdg0 = sX;                 // (2N, H)
  float* sduv = sdg0 + 2 * N * H;   // (2N, F)
  float* sdnp = sduv + 2 * N * F;   // (2N, H)
  float* sdps1 = sdnp + 2 * N * H;  // (2N, H)
  float* sdps0 = sdps1 + 2 * N * H; // (2N, H)
  float* sdg1 = sdps0 + 2 * N * H;  // (2N)
  // device scratch of this molecule: dual d_hatt (2N, HK) and d_pool_sq (2N, C)
  float* ghatt = gscratch;
  float* gpsq = ghatt + (size_t)2 * N * HK;
  const size_t NF = (size_t)N * F, NH = (size_t)N * H, NR = (size_t)N * R, NK = (size_t)N * K;

  const size_t lb = (size_t)l * B + b;
  auto W = [&](int leaf) { return L.at(leaf, l); };
  auto WT = [&](int leaf) { return LT.at(leaf, l); };
  // dual element of a node residual stream r of width ch (atom i, column c)
  auto nres = [&](int r, int ch, size_t at) {
    if constexpr (kE16)
      return Dl{get_res(RS.p[r], lb * N * ch + at), get_res(TR.p[r], lb * N * ch + at)};
    else
      return Dl{RS.p[r][lb * N * ch + at], TR.p[r][lb * N * ch + at]};
  };
  // a node row (atom i) of width ch: its value and tangent rows
  auto node_row = [&](int row, int i, int ch) { return RW.p[row] + (lb * N + i) * ch; };
  auto node_trow = [&](int row, int i, int ch) { return TW.p[row] + (lb * N + i) * ch; };

  // layer inputs and their tangents; this layer's tangents start at zero
  for (int e = tid; e < N * F; e += nt) {
    sh[e] = bh[lb * N * F + e];
    sh[NF + e] = tbh[lb * N * F + e];
    sdh[NF + e] = 0.f;
  }
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    const size_t at = (((size_t)l * 3 + k) * B + b) * N + i;
    sx[e] = bx[at];
    sx[3 * N + e] = tbx[at];
    sv[e] = bv[at];
    sv[3 * N + e] = tbv[at];
  }
  for (int e = tid; e < 6 * N; e += nt) sdxs[e] = sdxr[e] = 0.f;
  for (int e = tid; e < 2 * N * R; e += nt) sdaj[e] = 0.f;
  for (int e = tid; e < 2 * N * H; e += nt) sdoj[e] = 0.f;
  __syncthreads();

  // a_j, a_i recomputed from h_in, with their tangents (2N rows)
  const float* b_in = W(B_IN);
  mm_tb(2 * N, F, R, sh, F, W(W_IN_J),
        [&](int r, int c, float a) { saj[r * R + c] = a + (r < N ? b_in[c] : 0.f); });
  mm_tb(2 * N, F, R, sh, F, W(W_IN_I), [&](int r, int c, float a) { sai[r * R + c] = a; });

  // position/velocity gates: x_out = x + u v_new, v_out = v + u (v_new - v)
  for (int i = tid; i < N; i += nt) {
    const Dl sg = sigmoid_d(nres(RS_G1, 1, i));
    const Dl gate = 2.f * sg;
    Dl d_gate{0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float dvn = u * (sdx[k * N + i] + sdv[k * N + i]);
      sdvn[k * N + i] = dvn;
      d_gate += dvn * ld(sv, 3 * N, k * N + i);
      st2(sdvo, 3 * N, k * N + i, Dl{gate.v * dvn + (1.f - u) * sdv[k * N + i], gate.t * dvn});
    }
    st2(sdg1, N, i, d_gate * (2.f * sg) * (Dl{1.f, 0.f} - sg));
  }
  __syncthreads();

  // gate MLP: g1 = silu(g0) @ w_vel1, g0 = h_out @ w_vel0 + b_vel0
  {
    const float* wv1 = W(W_VEL1);
    for (int e = tid; e < N * H; e += nt) {
      const int i = e / H, h = e % H;
      st2(sdg0, NH, e, (ld(sdg1, N, i) * wv1[h]) * dsilu_d(nres(RS_G0, H, e)));
    }
  }
  __syncthreads();
  mm_tb(2 * N, H, F, sdg0, H, WT(W_VEL0), [&](int r, int c, float a) { sdh[r * F + c] += a; });
  __syncthreads();

  // h_out = h_in + silu(uv), uv = silu(node_pre) @ w_node1 + b_node1
  for (int e = tid; e < N * F; e += nt)
    st2(sduv, NF, e, ld(sdh, NF, e) * dsilu_d(nres(RS_UV, F, e)));
  __syncthreads();
  mm_tb(2 * N, F, H, sduv, F, WT(W_NODE1), [&](int r, int c, float a) { sdnp[r * H + c] = a; });
  __syncthreads();
  for (int e = tid; e < N * H; e += nt)
    st2(sdnp, NH, e, ld(sdnp, NH, e) * dsilu_d(nres(RS_NODE_PRE, H, e)));
  __syncthreads();

  // node_pre = h @ w_node_h + hatt @ w_node_agg + h_comb @ w_node_comb + b
  mm_tb(2 * N, H, F, sdnp, H, WT(W_NODE_H), [&](int r, int c, float a) { sdh[r * F + c] += a; });
  mm_tb(2 * N, H, HK, sdnp, H, WT(W_NODE_AGG),
        [&](int r, int c, float a) { ghatt[(size_t)r * HK + c] = a; });
  mm_tb(2 * N, H, H, sdnp, H, WT(W_NODE_COMB),
        [&](int r, int c, float a) { sdps1[r * H + c] = a; });
  __syncthreads();
  for (int e = tid; e < N * H; e += nt)
    st2(sdps1, NH, e, ld(sdps1, NH, e) * dsilu_d(nres(RS_PS1, H, e)));
  __syncthreads();
  mm_tb(2 * N, H, H, sdps1, H, WT(W_POST1), [&](int r, int c, float a) { sdps0[r * H + c] = a; });
  __syncthreads();
  for (int e = tid; e < N * H; e += nt)
    st2(sdps0, NH, e, ld(sdps0, NH, e) * dsilu_d(nres(RS_PS0, H, e)));
  __syncthreads();
  mm_tb(2 * N, H, C, sdps0, H, WT(W_POST0),
        [&](int r, int c, float a) { gpsq[(size_t)r * C + c] = a; });

  const float* wvmix = W(W_VMIX);
  const float* w_o_r = W(W_O_R);
  const float* rbf_m = W(RBF_M);
  const float* rbf_b = W(RBF_B);
  const size_t pl = lb * N * C;  // this molecule and layer's pooled planes
  auto pool = [&](int k, size_t at) {
    if constexpr (kE16)
      return Dl{get_res(RS.p[RS_POOL0 + k], pl + at), get_res(TR.p[RS_POOL0 + k], pl + at)};
    else
      return Dl{RS.p[RS_POOL0 + k][pl + at], TR.p[RS_POOL0 + k][pl + at]};
  };

  // the node rows and their tangents
  for (int e = tid; e < N * H; e += nt) {
    const int i = e / H, h = e % H;
    node_row(RW_DG0, i, H)[h] = sdg0[e];
    node_trow(RW_DG0, i, H)[h] = sdg0[NH + e];
    node_row(RW_DNP, i, H)[h] = sdnp[e];
    node_trow(RW_DNP, i, H)[h] = sdnp[NH + e];
    node_row(RW_DPS1, i, H)[h] = sdps1[e];
    node_trow(RW_DPS1, i, H)[h] = sdps1[NH + e];
    node_row(RW_DPS0, i, H)[h] = sdps0[e];
    node_trow(RW_DPS0, i, H)[h] = sdps0[NH + e];
  }
  for (int e = tid; e < N * F; e += nt) {
    node_row(RW_DUV, e / F, F)[e % F] = sduv[e];
    node_trow(RW_DUV, e / F, F)[e % F] = sduv[NF + e];
  }
  for (int i = tid; i < N; i += nt) {
    node_row(RW_DG1, i, 1)[0] = sdg1[i];
    node_trow(RW_DG1, i, 1)[0] = sdg1[N + i];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      node_row(RW_DDEL, i, 3)[k] = sdvn[k * N + i] / n_eff;
      node_trow(RW_DDEL, i, 3)[k] = 0.f;
    }
  }
  for (int e = tid; e < N * C; e += nt) {
    Dl s{0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const Dl p = pool(k, e) * (1.f / n_eff);
      s += p * p;
    }
    node_row(RW_PSQ, e / C, C)[e % C] = s.v;
    node_trow(RW_PSQ, e / C, C)[e % C] = s.t;
  }
  __syncthreads();
  SAKE_PROBE(PR_TB_PRE);

  for (int i = 0; i < N; ++i) {
    const size_t erow = lb * NN + (size_t)i * N;
    // dual element of an edge residual stream r of width ch at sender j
    auto eres = [&](int r, int ch, size_t at) {
      if constexpr (kE16) {  // r and t: the f32 streams (ch 1)
        if (r == RS_R) return Dl{res_r(RS)[erow + at], res_r(TR)[erow + at]};
        if (r == RS_T) return Dl{res_t(RS)[erow + at], res_t(TR)[erow + at]};
        return Dl{get_res(RS.p[r], erow * ch + at), get_res(TR.p[r], erow * ch + at)};
      } else {
        return Dl{RS.p[r][erow * ch + at], TR.p[r][erow * ch + at]};
      }
    };
    auto edge_row = [&](int row, int ch) { return RW.p[row] + erow * ch; };
    auto edge_trow = [&](int row, int ch) { return TW.p[row] + erow * ch; };

    // d_pooled for row i (the v_mix term has no tangent)
    for (int c = tid; c < C; c += nt) {
      const Dl dq = ld(gpsq, (size_t)N * C, (size_t)i * C + c);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const Dl v = Dl{sdvn[k * N + i] * wvmix[c] / n_eff, 0.f} +
                     (2.f / (n_eff * n_eff)) * (pool(k, (size_t)i * C + c) * dq);
        st2(sdp, 3 * C, k * C + c, v);
      }
    }
    for (int j = tid; j < N; j += nt) {
      const Dl r = eres(RS_R, 1, j);
      st2(sr, N, j, r);
      st2(st, N, j, eres(RS_T, 1, j));
      const float ir = 1.f / (r.v + 1e-5f);
      st2(sir, N, j, Dl{ir, -(ir * ir) * r.t});
#pragma unroll
      for (int k = 0; k < 3; ++k)
        st2(sd, 3 * N, k * N + j, ld(sx, 3 * N, k * N + j) - ld(sx, 3 * N, k * N + i));
    }
    for (int e = tid; e < N * K; e += nt) st2(satt, NK, e, eres(RS_ATT, K, e));
    __syncthreads();
    SAKE_PROBE(PR_TB_LOAD);

    // pooled_k = sum_j coeff * u_k: d_u_k[j] = coeff[j] . d_pooled_k
    for (int j = warp; j < N; j += nwarp) {
      Dl du[3] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      for (int c = lane; c < C; c += 32) {
        const Dl cf = eres(RS_COEFF, C, (size_t)j * C + c);
#pragma unroll
        for (int k = 0; k < 3; ++k) du[k] += cf * ld(sdp, 3 * C, k * C + c);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) du[k] = Dl{warp_sum(du[k].v), warp_sum(du[k].t)};
      if (lane == 0) {
        const Dl ir = ld(sir, N, j);
        Dl d_ir{0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          st2(sdd, 3 * N, k * N + j, du[k] * ir);
          d_ir += du[k] * ld(sd, 3 * N, k * N + j);
        }
        st2(sdr, N, j, (-1.f * (ir * ir)) * d_ir);
      }
    }
    __syncthreads();

    // coeff = tanh(xm): d_xm = d_coeff * (1 - coeff^2)
    for (int e = tid; e < N * C; e += nt) {
      const int j = e / C, c = e % C;
      const Dl ir = ld(sir, N, j);
      Dl dc{0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 3; ++k) dc += ld(sdp, 3 * C, k * C + c) * (ld(sd, 3 * N, k * N + j) * ir);
      const Dl cf = eres(RS_COEFF, C, e);
      const Dl v = dc * Dl{1.f - cf.v * cf.v, -2.f * cf.v * cf.t};
      if constexpr (kTc) st2(sX, (size_t)N * ldc, (size_t)j * ldc + c, v);
      else st2(sX, (size_t)N * C, e, v);
      edge_row(RW_DXM, C)[e] = v.v;
      edge_trow(RW_DXM, C)[e] = v.t;
    }
    // hatt[i] = sum_j h_e[j] (x) att[j], and the row's att (no mask: att2 = att)
    for (int q = tid; q < HK; q += nt) {
      Dl s{0.f, 0.f};
      for (int j = 0; j < N; ++j) s += eres(RS_H_E, H, (size_t)j * H + q / K) * ld(satt, NK, j * K + q % K);
      node_row(RW_HATT, i, HK)[q] = s.v;
      node_trow(RW_HATT, i, HK)[q] = s.t;
    }
    for (int e = tid; e < N * K; e += nt) {
      edge_row(RW_ATT2, K)[e] = satt[e];
      edge_trow(RW_ATT2, K)[e] = satt[NK + e];
    }
    __syncthreads();
    SAKE_PROBE(PR_TB_ROW);

    // d_he_att = d_xm @ w_xmix^T + d_hatt[i] (2N rows)
    auto st_dha = [&](int r, int c, float a) {
      sY[r * HK + c] = a + ghatt[(size_t)(r < N ? i : N + i) * HK + c];
    };
    if constexpr (kTc) {
      if (tc_dims(d)) {  // the values' rows, then the tangents' (three n8 tiles each)
        mm_tc<3, kPasses>(N, sX, ldc, WT(W_XMIX), ring, st_dha);
        mm_tc<3, kPasses>(N, sX + (size_t)N * ldc, ldc, WT(W_XMIX), ring,
                          [&](int r, int c, float a) { st_dha(N + r, c, a); });
      } else {
        mm_tb<kE16>(2 * N, C, HK, sX, ldc, WT(W_XMIX), st_dha);
      }
    } else {
      mm_tb<kE16>(2 * N, C, HK, sX, C, WT(W_XMIX), st_dha);
    }
    __syncthreads();
    SAKE_PROBE(PR_TB_XMIX);

    // he_att[j, h*K + k] = h_e[j, h] * att[j, k]: d_h_e (into sX) and d_att
    const size_t NHK = (size_t)N * HK;
    for (int e = tid; e < N * H; e += nt) {
      const int j = e / H, h = e % H;
      Dl s{0.f, 0.f};
      for (int k = 0; k < K; ++k) {
        if constexpr (kE16) {
          const Dl q = ld(sY, NHK, j * HK + h * K + k) * ld(satt, NK, j * K + k);
          s += Dl{bf16r(q.v), bf16r(q.t)};
        } else {
          s += ld(sY, NHK, j * HK + h * K + k) * ld(satt, NK, j * K + k);
        }
      }
      st2(sX, NH, e, s);
    }
    for (int e = tid; e < N * K; e += nt) {
      const int j = e / K, k = e % K;
      Dl s{0.f, 0.f};
      for (int h = 0; h < H; ++h) {
        if constexpr (kE16) {
          const Dl q = ld(sY, NHK, j * HK + h * K + k) * eres(RS_H_E, H, (size_t)j * H + h);
          s += Dl{bf16r(q.v), bf16r(q.t)};
        } else {
          s += ld(sY, NHK, j * HK + h * K + k) * eres(RS_H_E, H, (size_t)j * H + h);
        }
      }
      st2(sdat, NK, e, s);
    }
    __syncthreads();

    // softmax over senders, then celu2: one warp per head
    for (int k = warp; k < K; k += nwarp) {
      Dl s{0.f, 0.f};
      for (int j = lane; j < N; j += 32) s += ld(sdat, NK, j * K + k) * ld(satt, NK, j * K + k);
      s = Dl{warp_sum(s.v), warp_sum(s.t)};
      for (int j = lane; j < N; j += 32) {
        const Dl a = ld(satt, NK, j * K + k);
        const Dl dl = a * (ld(sdat, NK, j * K + k) - s);
        const Dl sp = eres(RS_SEM_PRE, K, (size_t)j * K + k);
        const float ex = expf(sp.v / 2.f);
        const Dl dcel = sp.v > 0.f ? Dl{1.f, 0.f} : Dl{ex, 0.5f * ex * sp.t};
        const Dl v = dl * dcel;
        st2(sdat, NK, j * K + k, v);
        edge_row(RW_DSEM, K)[j * K + k] = v.v;
        edge_trow(RW_DSEM, K)[j * K + k] = v.t;
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_TB_ROW);
    mm_tb<kE16>(2 * N, K, H, sdat, K, WT(W_SEM),
                [&](int r, int c, float a) { sX[r * H + c] += a; });
    __syncthreads();
    SAKE_PROBE(PR_TB_MM);

    // h_e = silu(e0) @ w_o1 + b_o1: d_e0 (into sY)
    for (int e = tid; e < N * H; e += nt) {
      edge_row(RW_DHE, H)[e] = sX[e];
      edge_trow(RW_DHE, H)[e] = sX[NH + e];
    }
    auto st_de0 = [&](int r, int c, float a) { sY[r * H + c] = a; };
    if constexpr (kTc) {
      if (tc_dims(d)) mm_tc_small<kPasses>(2 * N, H, H, sX, H, WT(W_O1), st_de0);
      else mm_tb<kE16>(2 * N, H, H, sX, H, WT(W_O1), st_de0);
    } else {
      mm_tb<kE16>(2 * N, H, H, sX, H, WT(W_O1), st_de0);
    }
    __syncthreads();
    SAKE_PROBE(PR_TB_MM);
    for (int e = tid; e < N * H; e += nt) {
      const Dl v = ld(sY, NH, e) * dsilu_d(eres(RS_E0, H, e));
      st2(sY, NH, e, v);
      edge_row(RW_DE0, H)[e] = v.v;
      edge_trow(RW_DE0, H)[e] = v.t;
    }
    __syncthreads();
    SAKE_PROBE(PR_TB_ROW);

    // e0 = o_j[j] + o_i[i] + o_f + r * w_o_r + b_o0 (sums are linear: both halves)
    for (int e = tid; e < 2 * N * H; e += nt) sdoj[e] += sY[e];
    for (int q = tid; q < 2 * H; q += nt) {
      const int half = q / H, h = q % H;
      float s = 0.f;
      for (int j = 0; j < N; ++j) s += sY[(half * N + j) * H + h];
      sdoi[(half * N + i) * H + h] = s;
    }
    for (int j = warp; j < 2 * N; j += nwarp) {  // value rows, then tangent rows
      float s = 0.f;
      for (int h = lane; h < H; h += 32) s += sY[j * H + h] * w_o_r[h];
      s = warp_sum(s);
      if (lane == 0) sdr[j] += s;
    }
    // o_f = (rbf * pre) @ w_o_f: d_filtered (into sX)
    auto st_dfilt = [&](int r, int c, float a) { sX[r * R + c] = a; };
    if constexpr (kTc) {
      if (tc_dims(d)) mm_tc_small<kPasses>(2 * N, H, R, sY, H, WT(W_O_F), st_dfilt);
      else mm_tb<kE16>(2 * N, H, R, sY, H, WT(W_O_F), st_dfilt);
    } else {
      mm_tb<kE16>(2 * N, H, R, sY, H, WT(W_O_F), st_dfilt);
    }
    __syncthreads();
    SAKE_PROBE(PR_TB_MM);

    // d_rbf = d_filt * pre (in sX), d_pre = d_filt * rbf (into sY)
    for (int e = tid; e < N * R; e += nt) {
      const int c = e % R;
      const Dl df = ld(sX, NR, e);
      const Dl pre = ld(saj, NR, e) + ld(sai, NR, (size_t)i * R + c);
      const Dl rbf = eres(RS_RBF, R, e);
      const Dl drbf = df * pre, dpre = df * rbf, filt = rbf * pre;
      st2(sX, NR, e, drbf);
      st2(sY, NR, e, dpre);
      sdaj[e] += dpre.v;
      sdaj[NR + e] += dpre.t;
      edge_row(RW_DRBF, R)[e] = drbf.v;
      edge_trow(RW_DRBF, R)[e] = drbf.t;
      edge_row(RW_FILT, R)[e] = filt.v;
      edge_trow(RW_FILT, R)[e] = filt.t;
    }
    __syncthreads();
    for (int q = tid; q < 2 * R; q += nt) {
      const int half = q / R, c = q % R;
      float s = 0.f;
      for (int j = 0; j < N; ++j) s += sY[(half * N + j) * R + c];
      sdai[(half * N + i) * R + c] = s;
    }
    // rbf = exp(-b (t - m)^2), t = exp(-r): d_r += -t * sum_c d_rbf rbf (-2 b (t - m))
    for (int j = warp; j < N; j += nwarp) {
      const Dl t = ld(st, N, j);
      Dl s{0.f, 0.f};
      for (int c = lane; c < R; c += 32)
        s += (ld(sX, NR, (size_t)j * R + c) * eres(RS_RBF, R, (size_t)j * R + c)) *
             (-2.f * rbf_b[c] * (t - Dl{rbf_m[c], 0.f}));
      s = Dl{warp_sum(s.v), warp_sum(s.t)};
      if (lane == 0) st2(sdr, N, j, ld(sdr, N, j) + (-1.f * t) * s);
    }
    __syncthreads();

    // r = sqrt(relu(s) + eps), s = |d0|^2, d0 = x[j] - x[i]
    for (int j = tid; j < N; j += nt) {
      const Dl r = ld(sr, N, j);
      const float step = r.v * r.v > kEps ? 1.f : 0.f;
      const Dl half_r = Dl{0.5f / r.v, -0.5f * r.t / (r.v * r.v)};
      const Dl ds = ld(sdr, N, j) * half_r * step;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const Dl v = ld(sdd, 3 * N, k * N + j) + 2.f * (ld(sd, 3 * N, k * N + j) * ds);
        st2(sdd, 3 * N, k * N + j, v);
        st2(sdxs, 3 * N, k * N + j, ld(sdxs, 3 * N, k * N + j) + v);
      }
    }
    __syncthreads();
    if (tid < 6) {  // value planes, then tangent planes
      float s = 0.f;
      for (int j = 0; j < N; ++j) s += sdd[tid * N + j];
      sdxr[tid * N + i] += s;
    }
    __syncthreads();
    SAKE_PROBE(PR_TB_ROW);
  }

  // the sender / receiver sums are complete: their rows
  for (int e = tid; e < N * R; e += nt) {
    node_row(RW_DAJ, e / R, R)[e % R] = sdaj[e];
    node_trow(RW_DAJ, e / R, R)[e % R] = sdaj[NR + e];
    node_row(RW_DAI, e / R, R)[e % R] = sdai[e];
    node_trow(RW_DAI, e / R, R)[e % R] = sdai[NR + e];
  }
  for (int e = tid; e < N * H; e += nt) {
    node_row(RW_DOJ, e / H, H)[e % H] = sdoj[e];
    node_trow(RW_DOJ, e / H, H)[e % H] = sdoj[NH + e];
    node_row(RW_DOI, e / H, H)[e % H] = sdoi[e];
    node_trow(RW_DOI, e / H, H)[e % H] = sdoi[NH + e];
  }

  // node projections: d_h += d_a_j w_in_j^T + d_a_i w_in_i^T + d_o_j w_o_j^T + d_o_i w_o_i^T
  mm_tb(2 * N, R, F, sdaj, R, WT(W_IN_J), [&](int r, int c, float a) { sdh[r * F + c] += a; });
  __syncthreads();
  mm_tb(2 * N, R, F, sdai, R, WT(W_IN_I), [&](int r, int c, float a) { sdh[r * F + c] += a; });
  __syncthreads();
  mm_tb(2 * N, H, F, sdoj, H, WT(W_O_J), [&](int r, int c, float a) { sdh[r * F + c] += a; });
  __syncthreads();
  mm_tb(2 * N, H, F, sdoi, H, WT(W_O_I), [&](int r, int c, float a) { sdh[r * F + c] += a; });
  __syncthreads();

  // this layer's Hessian terms out; the chain's state moves on
  if (add_h)
    for (int e = tid; e < N * F; e += nt) add_h[lb * N * F + e] = sdh[NF + e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    const size_t at = (((size_t)l * 3 + k) * B + b) * N + i;
    if (add_h) {
      add_x[at] = sdxs[3 * N + e] - sdxr[3 * N + e];
      add_v[at] = sdvo[3 * N + e];
    }
    sdx[e] = sdx[e] + sdxs[e] - sdxr[e];
    sdv[e] = sdvo[e];
  }
  __syncthreads();
  SAKE_PROBE(PR_TB_NODE);
}

}  // namespace sake
