// One layer of the augmented pullback of the training backward, for a whole
// thread block: the tangent pullback of the tangent chain c_t
// (resid_tbwd.cuh), then K2's rows body on the primal chain c_p
// (resid_bwd.cuh), then the layer's Hessian terms added to c_p. fused_bwd.cu
// (#12) runs it over depth in reverse on the primal's streams; retrace_bwd.cu
// (#17) runs it on one re-forwarded layer. Both chains, and the Hessian terms
// between the two bodies, ride in a shared-memory region of their own (the
// Carry); the bodies take turns on the rest.
#pragma once

#include "resid_bwd.cuh"
#include "resid_tbwd.cuh"

namespace sake {

// The two chains' state and the Hessian terms: the tangent chain's dual dh
// (values: its state; tangents: the layer's Hessian term of h), dx, dv and
// the dual sender / receiver sums and d_v_in whose tangents are the Hessian
// terms of x and v; the primal chain's dh, dx, dv.
struct Carry {
  float *ct_dh, *ct_dx, *ct_dv, *ct_dxs, *ct_dxr, *ct_dvo, *cp_dh, *cp_dx, *cp_dv;
};

__host__ __device__ inline Carry carve_carry(Carver& cv, const Dims& d) {
  const long long N = d.N, F = d.F;
  Carry c;
  c.ct_dh = cv.take(2 * N * F);
  c.ct_dx = cv.take(3 * N);
  c.ct_dv = cv.take(3 * N);
  c.ct_dxs = cv.take(6 * N);
  c.ct_dxr = cv.take(6 * N);
  c.ct_dvo = cv.take(6 * N);
  c.cp_dh = cv.take(N * F);
  c.cp_dx = cv.take(3 * N);
  c.cp_dv = cv.take(3 * N);
  return c;
}

__host__ __device__ inline long long carry_floats(const Dims& d) {
  Carver cv{nullptr};
  carve_carry(cv, d);
  return cv.off;
}

// Floats of the work region the two bodies share (kTc: their kTc carves).
template <bool kTc = false>
__host__ __device__ inline long long aug_pullback_floats(const Dims& d) {
  const long long tb = tb_smem_floats<kTc>(d), bw = bwd_smem_floats<kTc>(d);
  return tb > bw ? tb : bw;
}

// Layer l of both chains of molecule slot b, on the chains' state in P:
// reads the primal and tangent boundary states and residuals (bh ... tbv,
// RS, TR) at slot b, layer l; writes the primal chain's rows (RW), the
// tangent chain's rows (TRW) and their tangents (TTW) there. gscratch: this
// molecule's 2N * (H*K + C) floats of device memory. kTc: both bodies' x-mixing
// and edge products on the tensor cores (mma_tf32x3.cuh; ring: tc_ring_floats
// of shared memory outside work). kE16: both bodies in resid_ef's bf16 tier
// (RS and TR Resids16; L and LT with the four edge weights rounded), the rows
// f32.
template <bool kTc = false, bool kE16 = false>
__device__ __forceinline__ void aug_pullback_layer(
    const Dims& d, const Carry& P, float* work, int b, int l, float u, const Leaves& L,
    const Leaves& LT, const float* __restrict__ bh, const float* __restrict__ bx,
    const float* __restrict__ bv, const float* __restrict__ tbh, const float* __restrict__ tbx,
    const float* __restrict__ tbv, const ResidsOf<kE16>& RS, const ResidsOf<kE16>& TR,
    const Rows& RW, const Rows& TRW, const Rows& TTW, float* gscratch, float* ring = nullptr) {
  const int N = d.N, F = d.F, tid = threadIdx.x, nt = blockDim.x;
  Carver ct{work};
  TbSmem ST = carve_tb<kTc>(ct, d);
  ST.sdh = P.ct_dh;
  ST.sdx = P.ct_dx;
  ST.sdv = P.ct_dv;
  ST.sdxs = P.ct_dxs;
  ST.sdxr = P.ct_dxr;
  ST.sdvo = P.ct_dvo;
  tbwd_layer<kTc, kE16>(d, ST, b, l, u, L, LT, bh, bx, bv, tbh, tbx, tbv, RS, TR, TRW, TTW,
                        gscratch, nullptr, nullptr, nullptr, ring);
  Carver cb{work};
  BwdSmem SB = carve_bwd<kTc>(cb, d);
  SB.sdh = P.cp_dh;
  SB.sdx = P.cp_dx;
  SB.sdv = P.cp_dv;
  bwd_layer<true, false, kTc, kE16>(d, SB, b, l, u, nullptr, L, LT, bh, bx, bv, RS, RW,
                                    nullptr, nullptr, nullptr, ring);
  // the layer's Hessian terms, the tangents the tangent pullback left
  for (int e = tid; e < N * F; e += nt) P.cp_dh[e] += P.ct_dh[N * F + e];
  for (int e = tid; e < 3 * N; e += nt) {
    P.cp_dx[e] += P.ct_dxs[3 * N + e] - P.ct_dxr[3 * N + e];
    P.cp_dv[e] += P.ct_dvo[3 * N + e];
  }
  __syncthreads();
  SAKE_PROBE(PR_OTHER);
}

}  // namespace sake
