// K1's per-layer body: layer_fwd_resid of one molecule and one layer, for a
// whole thread block. resid_fwd.cu runs it over depth; fused_ef.cu runs it
// as the forward phase of the fused primal (#11) and of one_ef (#3). See
// resid_fwd.cu for the design and what bounds it. Its kBf16 instantiation
// (fused_remat_ef.cu, #20) rounds each product's activation operand to bf16;
// its kTc instantiation (#11, #20 in both tiers) runs the x-mixing product on
// the tensor cores (mma_tf32x3.cuh); its kCl instantiation (#4's cluster
// kernel) takes half of a molecule's receiver rows in each CTA of a two-CTA
// cluster (cluster.cuh).
#pragma once

#include "cluster.cuh"
#include "mma_tf32x3.cuh"
#include "resid_common.cuh"

namespace sake {

constexpr int kFwdTileCols = 4;  // columns per tile in mm_tiled
constexpr int kFwdTiledMinCols = 16;  // narrowest tiled product

// This body's block products (see mm_smem).
template <bool kRoundA = false, class ST>
__device__ __forceinline__ void mm_fwd(int n, int kd, int m, const float* A, int lda,
                                       const float* __restrict__ W, ST st) {
  mm_smem<kFwdTileCols, kFwdTiledMinCols, kRoundA>(n, kd, m, A, lda, W, st);
}

// Shared-memory buffers of K1, in floats. Node-level state lives across
// the row loop; row buffers are rebuilt for every receiver row i; the
// node phase reuses the row buffers once all rows are done.
struct FwdSmem {
  float *sh, *sx, *sv, *saj, *sai, *soj, *soi, *shatt, *sdel, *scnt;  // node level
  float *sd, *sr, *sir, *smk, *srbf, *se0, *she, *ssem, *satt, *shea, *scf;  // row
};

// kTc: the carve of the kTc body (shea's rows padded, tc_ld). kCl: of the
// cluster body, whose receiver-indexed buffers (shatt, sdel) hold the CTA's
// own rows only, cl_span(N) of them.
template <bool kTc = false, bool kCl = false>
__host__ __device__ inline FwdSmem carve_fwd(Carver& cv, const Dims& d) {
  const long long N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  const long long NR = kCl ? cl_span(d.N) : N;  // receiver rows of this CTA, at most
  FwdSmem s;
  s.sh = cv.take(N * F);        // h
  s.sx = cv.take(3 * N);        // x planes
  s.sv = cv.take(3 * N);        // v planes
  s.saj = cv.take(N * R);       // h @ w_in_j + b_in
  s.sai = cv.take(N * R);       // h @ w_in_i
  s.soj = cv.take(N * H);
  s.soi = cv.take(N * H);
  s.shatt = cv.take(NR * H * K);  // sum_j h_e (x) att
  s.sdel = cv.take(3 * NR);     // pooled_k @ w_vmix
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
  if constexpr (kTc) s.shea = cv.take(N * tc_ld_of<kCl>(d, H * K));
  else s.shea = cv.take(N * H * K);  // row: h_e (x) att, column h*K + k
  // row: coeff; node: pool_sq, then node_pre, uv, g0, g1 (below)
  s.scf = cv.take((C > 2 * H + F + 1 ? C : 2 * H + F + 1) * N);
  return s;
}

template <bool kTc = false, bool kCl = false>
__host__ __device__ inline long long fwd_smem_floats(const Dims& d) {
  Carver cv{nullptr};
  carve_fwd<kTc, kCl>(cv, d);
  return cv.off;
}

// K1's tensor-core kernel (resid_fwd.cu): its shared memory in floats, the
// 8-warp W ring and then the kTc carve.
__host__ __device__ inline long long fwd_tc_smem_floats(const Dims& d) {
  return tc_ring_floats<kTcFwdWarps>(d) + fwd_smem_floats<true>(d);
}
// An H100 SM's shared memory and what the runtime reserves of it per block.
constexpr long long kSmemPerSm = 233472, kSmemReservedPerBlock = 1024;
// Whether K1 takes its tensor-core kernel at d: the products' widths (tc_dims)
// and two blocks an SM.
__host__ __device__ inline bool fwd_tc_route(const Dims& d) {
  return tc_dims(d) &&
         2 * (fwd_tc_smem_floats(d) * (long long)sizeof(float) + kSmemReservedPerBlock) <=
             kSmemPerSm;
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
// mb: this molecule's (N, N) edge mask or null. Two switches pick the
// streams, written at molecule slot b of d.B, layer l: kBound the boundary
// state entering the layer (bh, bx, bv), kResid the 17 residuals (RS).
// Without kResid only the pooled vectors go to RS, at slot b of a one-layer
// (3, d.B, N, C) scratch. kBf16: the JAX bf16 products (functional.py's
// _make_mm): every product's activation operand rounded to bf16 (L holds
// the weights already rounded), f32 sums; the x-mixing product takes
// bf16(h_e) (x) att, the per-head form's sum over heads, and the attended
// sum hatt stays f32 until its own product rounds it. kTc: the x-mixing
// product he_att @ w_xmix and the edge products o_f, o1 on the tensor cores in
// 3xTF32 (S from carve_fwd<true>, ring: tc_ring_floats) where tc_dims allows,
// the CUDA-core products elsewhere; with kBf16 on fewer passes (tc_passes: o_f
// and o1 one, the x-mixing, whose operand bf16(h_e) att is no bf16 value, two).
// Without kTc the body is the CUDA-core one. kCl: this CTA of a two-CTA cluster
// (cluster.cuh) takes the receiver rows [i0, i1) of cl_rows (S from
// carve_fwd<kTc, true>; its receiver-indexed buffers, shatt and sdel, by row -
// i0), writes their residuals, boundary and node rows, and, once both CTAs are
// past their row loops, stores its nodes' new (h, x, v) into both CTAs' state,
// so that each holds every node's state again before the next layer; with kTc
// its products take the tensor cores up to N = 32 (tc_dims_of, four n8 tiles).
// kTcW: the warps of mm_tc's ring (tc_ring_floats<kTcW>): kTcWarps in the
// 512-thread kernels, kTcFwdWarps in K1's 256-thread tensor-core kernel.
// kE16: resid_ef's bf16 tier (JAX's edge_matmul_dtype and resid_dtype bf16):
// both operands of each edge product (o_f, o1, the semantic logits, the
// x-mixing) rounded to bf16 (L holds those four weights already rounded; the
// activation is rounded as it is read), f32 sums, on the tensor cores in one
// pass; the x-mixing's operand is bf16(bf16(h_e) bf16(att)) and hatt sums the
// unrounded products; node products stay f32. Every residual stream but r and
// t is written as bf16 (put_res; RS a Resids16 with kResid), while the body
// goes on with the f32 values:
// its pooled vectors also go, in f32, to slot b of a one-layer (3, d.B, N, C)
// scratch pool16 (with kResid), which its node phase reads. kLowRes (default
// kE16): whether the streams are bf16; kE16 without it (#18's and #16's bodies in
// the tier, whose tangent JAX computes from the f32 values) writes every stream
// in f32 (RS a Resids) and reads its pooled vectors back from it.
template <bool kResid, bool kBound, bool kBf16 = false, bool kTc = false, bool kCl = false,
          int kTcW = kTcWarps, bool kE16 = false, bool kLowRes = kE16>
__device__ __forceinline__ void fwd_layer(const Dims& d, const FwdSmem& S, int b, int l,
                                          float u, const float* __restrict__ mb,
                                          const Leaves& L, float* bh, float* bx, float* bv,
                                          const ResidsOf<kLowRes && kResid>& RS,
                                          float* ring = nullptr, float* pool16 = nullptr) {
  static_assert(!(kE16 && kBf16), "one bf16 tier");
  static_assert(kE16 || !kLowRes, "bf16 streams belong to the bf16 tier");
  const int B = d.B, N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  const int HK = H * K, NN = N * N;
  [[maybe_unused]] const int ldx = kTc ? tc_ld_of<kCl>(d, HK) : HK;  // kTc: shea's row stride
  // the edge products' passes on the tensor cores: o_f and o1, the x-mixing
  constexpr int kEdgePasses = kE16 ? 1 : tc_passes<kBf16, true>();
  constexpr int kXmixPasses = kE16 ? 1 : tc_passes<kBf16>();
  constexpr bool kRoundEdge = kBf16 || kE16;  // the edge products round their activation
  const int tid = threadIdx.x, nt = blockDim.x;
  // this CTA's receiver rows [i0, i1), nn of them: all N without kCl
  int i0 = 0, i1 = N;
  if constexpr (kCl) cl_rows(N, cl_rank(), i0, i1);
  const int nn = i1 - i0;
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
  // without kResid the pooled vectors go to a one-layer scratch
  const size_t lp = kResid ? lb : (size_t)b;
  auto W = [&](int leaf) { return L.at(leaf, l); };
  const float* b_in = W(B_IN);
  const float* rbf_m = W(RBF_M);
  const float* rbf_b = W(RBF_B);
  const float* w_o_r = W(W_O_R);
  const float* b_o0 = W(B_O0);
  const float* b_o1 = W(B_O1);
  const float* b_sem = W(B_SEM);

  // boundary state in (kCl: this CTA's rows)
  if constexpr (kBound) {
    for (int e = tid; e < nn * F; e += nt) bh[lb * N * F + i0 * F + e] = sh[i0 * F + e];
    for (int e = tid; e < 3 * nn; e += nt) {
      const int k = e / nn, i = i0 + e % nn, q = kCl ? k * N + i : e;
      bx[(((size_t)l * 3 + k) * B + b) * N + i] = sx[q];
      bv[(((size_t)l * 3 + k) * B + b) * N + i] = sv[q];
    }
  }

  // node projections
  mm_fwd<kBf16>(N, F, R, sh, F, W(W_IN_J),
         [&](int r, int c, float a) { saj[r * R + c] = a + b_in[c]; });
  mm_fwd<kBf16>(N, F, R, sh, F, W(W_IN_I),
         [&](int r, int c, float a) { sai[r * R + c] = a; });
  mm_fwd<kBf16>(N, F, H, sh, F, W(W_O_J),
         [&](int r, int c, float a) { soj[r * H + c] = a; });
  mm_fwd<kBf16>(N, F, H, sh, F, W(W_O_I),
         [&](int r, int c, float a) { soi[r * H + c] = a; });
  __syncthreads();
  SAKE_PROBE(PR_FWD_PRE);

  for (int i = i0; i < i1; ++i) {
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
      if constexpr (kResid) {
        res_r(RS)[erow + j] = r;
        res_t(RS)[erow + j] = sir[N + j];
      }
    }
    __syncthreads();

    // rbf filter; srbf keeps filtered = rbf * (a_j[j] + a_i[i])
    for (int e = tid; e < N * R; e += nt) {
      const int j = e / R, c = e % R;
      const float z = sir[N + j] - rbf_m[c];
      const float v = expf(-rbf_b[c] * (z * z));
      if constexpr (kResid) put_res(RS.p[RS_RBF], erow * R + e, v);
      srbf[e] = v * (saj[e] + sai[i * R + c]);
    }
    __syncthreads();
    SAKE_PROBE(PR_FWD_ROW);

    // e0 = o_j[j] + o_i[i] + filtered @ w_o_f + r * w_o_r + b_o0
    auto st_e0 = [&](int r, int c, float a) {
      const float v = soj[r * H + c] + soi[i * H + c] + a + sr[r] * w_o_r[c] + b_o0[c];
      se0[r * H + c] = v;
      if constexpr (kResid) put_res(RS.p[RS_E0], (erow + r) * H + c, v);
    };
    if constexpr (kTc) {
      if (tc_dims_of<kCl>(d)) mm_tc_small<kEdgePasses>(N, R, H, srbf, R, W(W_O_F), st_e0);
      else mm_fwd<kRoundEdge>(N, R, H, srbf, R, W(W_O_F), st_e0);
    } else {
      mm_fwd<kRoundEdge>(N, R, H, srbf, R, W(W_O_F), st_e0);
    }
    __syncthreads();
    SAKE_PROBE(PR_FWD_OF_MM);
    for (int e = tid; e < N * H; e += nt) se0[e] = siluf_(se0[e]);
    __syncthreads();
    SAKE_PROBE(PR_FWD_ROW);

    // h_e = silu(e0) @ w_o1 + b_o1
    auto st_he = [&](int r, int c, float a) {
      const float v = a + b_o1[c];
      she[r * H + c] = v;
      if constexpr (kResid) put_res(RS.p[RS_H_E], (erow + r) * H + c, v);
    };
    if constexpr (kTc) {
      if (tc_dims_of<kCl>(d)) mm_tc_small<kEdgePasses>(N, H, H, se0, H, W(W_O1), st_he);
      else mm_fwd<kRoundEdge>(N, H, H, se0, H, W(W_O1), st_he);
    } else {
      mm_fwd<kRoundEdge>(N, H, H, se0, H, W(W_O1), st_he);
    }
    __syncthreads();
    SAKE_PROBE(PR_FWD_O1_MM);

    // semantic logits
    mm_fwd<kRoundEdge>(N, H, K, she, H, W(W_SEM),
           [&](int r, int c, float a) {
             const float v = a + b_sem[c];
             ssem[r * K + c] = v;
             if constexpr (kResid) put_res(RS.p[RS_SEM_PRE], (erow + r) * K + c, v);
           });
    __syncthreads();
    SAKE_PROBE(PR_FWD_MM);

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
        if constexpr (kResid) put_res(RS.p[RS_ATT], (erow + j) * K + k, a);
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
      if constexpr (kTc)
        shea[j * ldx + q] = rd<kRoundEdge>(she[j * H + q / K]) * rd<kE16>(satt[j * K + q % K]);
      else shea[e] = rd<kRoundEdge>(she[j * H + q / K]) * rd<kE16>(satt[j * K + q % K]);
    }
    __syncthreads();
    SAKE_PROBE(PR_FWD_ROW);
    // hatt_sum[i] = sum_j he_att[j]; coeff = tanh(he_att @ w_xmix) * m
    for (int q = tid; q < HK; q += nt) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) {
        if constexpr (kBf16) s += she[j * H + q / K] * satt[j * K + q % K];
        else if constexpr (kTc) s += shea[j * ldx + q];
        else s += shea[j * HK + q];
      }
      shatt[(i - i0) * HK + q] = s;
    }
    auto st_coeff = [&](int r, int c, float a) {
      const float v = tanhf(a) * smk[r];
      scf[r * C + c] = v;
      if constexpr (kResid) put_res(RS.p[RS_COEFF], (erow + r) * C + c, v);
    };
    if constexpr (kTc) {
      if (tc_dims_of<kCl>(d))
        mm_tc<tc_tiles<kCl>(), kXmixPasses, kTcW>(N, shea, ldx, W(W_XMIX), ring, st_coeff);
      else mm_fwd<kE16>(N, HK, C, shea, ldx, W(W_XMIX), st_coeff);
    } else {
      mm_fwd<kE16>(N, HK, C, shea, HK, W(W_XMIX), st_coeff);
    }
    __syncthreads();
    SAKE_PROBE(PR_FWD_XMIX);

    // pooled_k[i] = sum_j coeff[j] * d_k[j] / (r_j + 1e-5)
    for (int c = tid; c < C; c += nt) {
      float p[3] = {0.f, 0.f, 0.f};
      for (int j = 0; j < N; ++j) {
        const float cf = scf[j * C + c];
#pragma unroll
        for (int k = 0; k < 3; ++k) p[k] += cf * (sd[k * N + j] * sir[j]);
      }
      if constexpr (kLowRes && kResid) {
        const size_t plane = (size_t)B * N * C;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          put_res(RS.p[RS_POOL0 + k], (lp * N + i) * C + c, p[k]);
          pool16[k * plane + ((size_t)b * N + i) * C + c] = p[k];
        }
      } else {
        RS.p[RS_POOL0][(lp * N + i) * C + c] = p[0];
        RS.p[RS_POOL1][(lp * N + i) * C + c] = p[1];
        RS.p[RS_POOL2][(lp * N + i) * C + c] = p[2];
      }
    }
    __syncthreads();
    SAKE_PROBE(PR_FWD_ROW);
  }

  // kCl: this CTA's copies of the other CTA's nodes are read no more this layer
  if constexpr (kCl) cl_arrive();

  // ---- node phase: this CTA's receivers, r = i - i0 < nn -------------------
  // (scf, se0, she, snp, suv, sg0, sg1 and sdel by r, the state by i)
  const float* pool[3];
  if constexpr (kLowRes && kResid) {  // the f32 pooled vectors of the scratch
#pragma unroll
    for (int k = 0; k < 3; ++k) pool[k] = pool16 + ((size_t)k * B + b) * N * C + i0 * C;
  } else {
    pool[0] = RS.p[RS_POOL0] + lp * N * C + i0 * C;
    pool[1] = RS.p[RS_POOL1] + lp * N * C + i0 * C;
    pool[2] = RS.p[RS_POOL2] + lp * N * C + i0 * C;
  }
  for (int e = tid; e < nn * C; e += nt) {
    const float pd = pool_denom(masked, scnt[i0 + e / C], n_eff);
    const float n0 = pool[0][e] / pd, n1 = pool[1][e] / pd, n2 = pool[2][e] / pd;
    scf[e] = n0 * n0 + n1 * n1 + n2 * n2;  // pool_sq
  }
  {
    const float* wv = W(W_VMIX);
    for (int q = warp; q < 3 * nn; q += nwarp) {
      const int k = q / nn, r = q % nn;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += rd<kBf16>(pool[k][r * C + c]) * wv[c];
      s = warp_sum(s);
      if (lane == 0) sdel[q] = s;
    }
  }
  __syncthreads();

  const size_t ln = lb * N + i0;  // node rows of this layer, molecule and CTA
  const float* b_post0 = W(B_POST0);
  mm_fwd<kBf16>(nn, C, H, scf, C, W(W_POST0),
         [&](int r, int c, float a) {
           const float v = a + b_post0[c];
           se0[r * H + c] = v;
           if constexpr (kResid) put_res(RS.p[RS_PS0], (ln + r) * H + c, v);
         });
  __syncthreads();
  for (int e = tid; e < nn * H; e += nt) se0[e] = siluf_(se0[e]);
  __syncthreads();
  const float* b_post1 = W(B_POST1);
  mm_fwd<kBf16>(nn, H, H, se0, H, W(W_POST1),
         [&](int r, int c, float a) {
           const float v = a + b_post1[c];
           she[r * H + c] = v;
           if constexpr (kResid) put_res(RS.p[RS_PS1], (ln + r) * H + c, v);
         });
  __syncthreads();
  for (int e = tid; e < nn * H; e += nt) she[e] = siluf_(she[e]);  // h_comb

  // node_pre = h @ w_node_h + hatt @ w_node_agg + h_comb @ w_node_comb + b
  float* shi = sh + i0 * F;  // this CTA's rows of h
  const float* b_node0 = W(B_NODE0);
  mm_fwd<kBf16>(nn, F, H, shi, F, W(W_NODE_H),
         [&](int r, int c, float a) { snp[r * H + c] = a + b_node0[c]; });
  __syncthreads();
  mm_fwd<kBf16>(nn, HK, H, shatt, HK, W(W_NODE_AGG),
         [&](int r, int c, float a) { snp[r * H + c] += a; });
  __syncthreads();
  mm_fwd<kBf16>(nn, H, H, she, H, W(W_NODE_COMB),
         [&](int r, int c, float a) { snp[r * H + c] += a; });
  __syncthreads();
  for (int e = tid; e < nn * H; e += nt) {
    if constexpr (kResid) put_res(RS.p[RS_NODE_PRE], ln * H + e, snp[e]);
    snp[e] = siluf_(snp[e]);
  }
  __syncthreads();
  const float* b_node1 = W(B_NODE1);
  mm_fwd<kBf16>(nn, H, F, snp, H, W(W_NODE1),
         [&](int r, int c, float a) {
           const float v = a + b_node1[c];
           suv[r * F + c] = v;
           if constexpr (kResid) put_res(RS.p[RS_UV], (ln + r) * F + c, v);
         });
  __syncthreads();
  for (int e = tid; e < nn * F; e += nt) shi[e] = shi[e] + siluf_(suv[e]);  // h_out
  __syncthreads();

  // velocity gate and x/v update
  const float* b_vel0 = W(B_VEL0);
  mm_fwd<kBf16>(nn, F, H, shi, F, W(W_VEL0), [&](int r, int c, float a) {
    const float v = a + b_vel0[c];
    if constexpr (kResid) put_res(RS.p[RS_G0], (ln + r) * H + c, v);
    sg0[r * H + c] = siluf_(v);
  });
  __syncthreads();
  {
    const float* wv1 = W(W_VEL1);
    for (int r = warp; r < nn; r += nwarp) {
      float s = 0.f;
      for (int h = lane; h < H; h += 32) s += rd<kBf16>(sg0[r * H + h]) * wv1[h];
      s = warp_sum(s);
      if (lane == 0) {
        sg1[r] = s;
        if constexpr (kResid) put_res(RS.p[RS_G1], ln + r, s);
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < nn; r += nt) {
    const int i = i0 + r;
    const float gate = 2.f * sigmoidf_(sg1[r]);
    const float dvd = dv_denom(masked, scnt[i], n_eff);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float xv = sx[k * N + i], vv = sv[k * N + i];
      const float v_new = gate * vv + sdel[k * nn + r] / dvd;
      const float x_new = xv + v_new;
      sx[k * N + i] = xv + u * (x_new - xv);
      sv[k * N + i] = vv + u * (v_new - vv);
    }
  }
  __syncthreads();
  SAKE_PROBE(PR_FWD_NODE);
  if constexpr (kCl) {
    // the other CTA is past its row loop: our nodes' new state into its copy,
    // then a barrier, after which both CTAs hold every node's state
    cl_wait();
    const int peer = cl_rank() ^ 1;
    float *ph = cl_map(sh, peer), *px = cl_map(sx, peer), *pv = cl_map(sv, peer);
    for (int e = tid; e < nn * F; e += nt) ph[i0 * F + e] = shi[e];
    for (int e = tid; e < 3 * nn; e += nt) {
      const int q = (e / nn) * N + i0 + e % nn;
      px[q] = sx[q];
      pv[q] = sv[q];
    }
    cl_sync();
    SAKE_PROBE(PR_FWD_CL);
  }
}

}  // namespace sake
