// #9: tangent-only forward of the layer stack on saved residuals, f32.
//
// Replaces the TPU kernel sake_tpu/kernels/train2_ef.py -> tfwd_kernel (the
// pallas_call at :1447, body :1397) of the shared-mode training backward,
// which runs layer_jvp_resid (resid_ef.py:791-975) over depth: it pushes
// the tangent state (th, tx, tv) through each layer's map using the primal
// residuals and boundary states K1 (resid_fwd.cu) saved. The seed is
// (0, tx0, 0), tx0 the force cotangent. It writes the tangent boundary
// states, the final tangent state and the 17 tangent residuals, which the
// augmented pullback (resid_tbwd.cu, param_grads.cu) reads. Like the MD17
// training path it serves, it takes no edge mask (layer_jvp_resid's masked
// renormalization tangent stays in the plain version).
//
// The per-layer body is jvp_layer and the kernel resid_jvp_kernel
// (resid_jvp.cuh); fused_bwd.cu (#12) shares the body, resid_jvp16.cu runs the
// kernel in resid_ef's bf16 tier.
//
// Design: K1's, with every primal value read from the residual streams
// instead of recomputed. One thread block per molecule loops over depth with
// the tangent state in shared memory. Per layer the node projections of h
// (a_j, a_i, recomputed for pre = a_j[j] + a_i[i], as in the pullback) and
// of th (their tangents and those of o_j, o_i) go to shared memory; then
// each receiver row i builds its N sender edges' tangents (t_r, t_rbf, the
// filter, t_e0, t_h_e, the softmax jvp over senders, t_he_att = t_h_e (x)
// att + h_e (x) t_att, t_coeff) and pools them into the row's tangent
// pooled vectors and t_hatt_sum; the node MLP's tangents and the x/v
// update follow. Nothing expensive of the primal is recomputed: no exp,
// tanh or wide product of the primal, only elementwise derivatives of
// saved pre-activations.
//
// What bounds it on an H100: as K1, f32 FMA issue and per-row
// synchronisation. Its products are K1's (the x_mixing contraction
// (N x HK) @ (HK x C) per row is most of the FLOPs) plus the two tangent
// node projections, so it costs about one forward. It reads the primal
// residuals (about 0.87 MB per aspirin molecule and layer) and writes as
// many tangent residuals, coalesced row blocks. Tensor cores are a later
// change.

#include "resid_jvp.cuh"

extern "C" long long sake_resid_jvp_smem_bytes(int B, int N, int F, int H, int R, int K, int C,
                                               int depth) {
  return sake::jvp_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}) *
         (long long)sizeof(float);
}

// bh (depth, B, N, F), bx, bv (depth, 3, B, N) and resid_ptrs: K1's boundary
// states and residuals; tx0 (3, B, N): the tangent seed of x. Writes the
// tangent boundaries tbh, tbx, tbv, the final tangent state and the tangent
// residuals (tresid_ptrs, in RESIDS order, K1's shapes).
extern "C" int sake_resid_jvp(const float* bh, const float* bx, const float* bv,
                              const float* upd, const void* const* leaf_ptrs,
                              const long long* leaf_strides, void* const* resid_ptrs,
                              const float* tx0, float* tbh, float* tbx, float* tbv,
                              float* th_fin, float* tx_fin, float* tv_fin,
                              void* const* tresid_ptrs, int B, int N, int F, int H, int R, int K,
                              int C, int depth, void* stream) {
  return sake::launch_jvp<false>(bh, bx, bv, upd, leaf_ptrs, leaf_strides, resid_ptrs, tx0, tbh,
                                 tbx, tbv, th_fin, tx_fin, tv_fin, tresid_ptrs,
                                 sake::Dims{B, N, F, H, R, K, C, depth}, stream);
}
