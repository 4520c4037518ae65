// One layer of the remat pullback: re-run the layer of one molecule from its
// boundary into a one-layer residual scratch (K1's body), then pull the
// cotangent state back through it on those residuals (K2's body), both in their
// kTc instantiations: the x-mixing product, its transpose and the edge products
// o_f and o1 on the tensor cores in 3xTF32 (mma_tf32x3.cuh) where tc_dims takes
// the shape (aspirin's widths), the CUDA-core products elsewhere. remat_ef.cu
// runs it in #22 and #24. The re-forward is these paths' point: their memory is
// the boundaries (about 35 KB an aspirin molecule at depth 6) and the scratch of
// one layer, where keeping every layer's residuals, as K1 + K2 and #20
// (fused_remat_ef.cu) do, takes about 5.3 MB a molecule.
#pragma once

#include "resid_bwd.cuh"
#include "resid_fwd.cuh"

namespace sake {

// Floats of shared memory for the pullback with its re-forward: the W ring of
// the tensor-core products (none where tc_dims does not take them), the
// cotangent state (sdh, sdx, sdv), then one work region that the re-forward's
// and the pullback's buffers take in turn (remat_carves), as #20 carves
// (fused_remat_smem_floats).
__host__ __device__ inline long long remat_bwd_smem_floats(const Dims& d) {
  const long long b = bwd_smem_floats<true>(d);
  const long long f = bwd_state_floats(d) + fwd_smem_floats<true>(d);
  return tc_ring_floats(d) + (b > f ? b : f);
}

// The two carves over one base, after the ring: SB from the base (its
// cotangent state is the carry), SF after that state.
__device__ __forceinline__ void remat_carves(float* base, const Dims& d, BwdSmem* SB,
                                             FwdSmem* SF) {
  Carver cb{base};
  *SB = carve_bwd<true>(cb, d);
  Carver cf{base + bwd_state_floats(d)};
  *SF = carve_fwd<true>(cf, d);
}

// Layer l of the pullback of molecule slot b of d.B: the cotangents of the
// state leaving the layer, in SB's state, become those of the state entering
// it. bh (depth, d.B, N, F), bx, bv (depth, 3, d.B, N): the boundary states;
// RS: the one-layer residual scratch (d.B, ...); ring: mm_tc's W ring, the
// tc_ring_floats before remat_carves' base. fwd_begin's and fwd_layer's closing
// __syncthreads order the re-forward's writes before the pullback, which reads RS
// through plain pointers.
__device__ __forceinline__ void remat_layer(const Dims& d, const FwdSmem& SF, const BwdSmem& SB,
                                            int b, int l, float u, const Leaves& L,
                                            const Leaves& LT, const float* bh, const float* bx,
                                            const float* bv, const Resids& RS, float* ring) {
  const Leaves Ll = layer_of(L, l), LTl = layer_of(LT, l);
  const size_t bo = (size_t)l * d.B * d.N * d.F, xo = (size_t)l * 3 * d.B * d.N;
  fwd_begin(d, SF, d.B, b, bh + bo, bx + xo, bv + xo, nullptr);
  fwd_layer<true, false, false, true>(d, SF, b, 0, u, nullptr, Ll, nullptr, nullptr, nullptr, RS,
                                      ring);
  bwd_layer<false, false, true>(d, SB, b, 0, u, nullptr, Ll, LTl, bh + bo, bx + xo, bv + xo, RS,
                                Rows{}, nullptr, nullptr, nullptr, ring);
}

}  // namespace sake
