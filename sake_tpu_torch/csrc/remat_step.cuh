// One layer of the remat pullback: re-run the layer of one molecule from its
// boundary state into a one-layer residual scratch (K1's body), then pull the
// cotangent state back through it on those residuals (K2's body). remat_ef.cu
// runs it in #22 and #24. On an H100 the one-layer slots of a grid go through
// HBM all the same, so the re-forward saves no traffic: #20 (fused_remat_ef.cu)
// keeps every layer's residuals instead, and #22 and #24 could too.
#pragma once

#include "resid_bwd.cuh"
#include "resid_fwd.cuh"

namespace sake {

// Floats of shared memory for the pullback with its re-forward: the cotangent
// state (sdh, sdx, sdv) first, then one work region that the re-forward's and
// the pullback's buffers take in turn (remat_carves).
__host__ __device__ inline long long remat_bwd_smem_floats(const Dims& d) {
  const long long b = bwd_smem_floats(d), f = bwd_state_floats(d) + fwd_smem_floats(d);
  return b > f ? b : f;
}

// The two carves over one base: SB from the base (its cotangent state is the
// carry), SF after that state; returns the floats SF ends at.
__device__ __forceinline__ long long remat_carves(float* base, const Dims& d, BwdSmem* SB,
                                                  FwdSmem* SF) {
  Carver cb{base};
  *SB = carve_bwd(cb, d);
  Carver cf{base + bwd_state_floats(d)};
  *SF = carve_fwd(cf, d);
  return bwd_state_floats(d) + cf.off;
}

// Layer l of the pullback of molecule slot b of d.B: the cotangents of the
// state leaving the layer, in SB's state, become those of the state entering
// it. bh (depth, d.B, N, F), bx, bv (depth, 3, d.B, N): the boundary states;
// RS: the one-layer residual scratch (d.B, ...). fwd_begin's and fwd_layer's
// closing __syncthreads order the re-forward's writes before the pullback,
// which reads RS through plain pointers.
__device__ __forceinline__ void remat_layer(const Dims& d, const FwdSmem& SF, const BwdSmem& SB,
                                            int b, int l, float u, const Leaves& L,
                                            const Leaves& LT, const float* bh, const float* bx,
                                            const float* bv, const Resids& RS) {
  const Leaves Ll = layer_of(L, l), LTl = layer_of(LT, l);
  const size_t bo = (size_t)l * d.B * d.N * d.F, xo = (size_t)l * 3 * d.B * d.N;
  fwd_begin(d, SF, d.B, b, bh + bo, bx + xo, bv + xo, nullptr);
  fwd_layer<true, false>(d, SF, b, 0, u, nullptr, Ll, nullptr, nullptr, nullptr, RS);
  bwd_layer<false>(d, SB, b, 0, u, nullptr, Ll, LTl, bh + bo, bx + xo, bv + xo, RS, Rows{},
                   nullptr, nullptr, nullptr);
}

}  // namespace sake
