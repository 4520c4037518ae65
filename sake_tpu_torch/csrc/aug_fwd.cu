// #18 and #16: the augmented forward of make_ef_train2's resid and retrace
// modes, f32: jax.jvp of the layer stack from the primal (h0, x0, v = 0)
// along the tangent seed (0, tx0, 0), tx0 the force cotangent.
//
// Replaces two TPU kernels of sake_tpu/kernels/train2_ef.py:
// - _aug_grad_resid._pipe -> fwd_kernel (#18, the pallas_call at :668, body
//   :584-658), the resid-mode forward: jax.jvp of layer_fwd_resid over depth,
//   streaming the 14 boundary planes of the augmented state (h, x, v and
//   their tangents) entering each layer, both residual sets (primal and
//   tangent, 17 each) and h_fin, th_fin. sake_aug_fwd: kStream.
// - _aug_grad -> fwd_kernel (#16, :330, body :270-326), the retrace-mode
//   forward: the same layers writing only the boundary planes and the final
//   states; its backward (retrace_bwd.cu) re-forwards each layer from them.
//   sake_retrace_fwd: without kStream, the running layer's residuals go to a
//   one-layer, per-molecule device scratch that the next layer overwrites.
// JAX's retrace kernel differentiates depthgrid_ef.layer_forward_wide; it is
// the same layer as layer_fwd_resid (the wide head expansion is the
// hidden-major / head-minor product both kernels index as h*K + k), so both
// run the same bodies. The final x and v of both states are written too.
//
// The kernel and its carve are aug_fwd.cuh's; aug_fwd16.cu runs them in
// resid_ef's bf16 tier.
//
// Design: one thread block per molecule walks the layers with the primal
// and tangent states in shared memory. Per layer it runs K1's body
// (fwd_layer, resid_fwd.cuh), which writes the primal boundary and the
// layer's residuals to device memory, then the tangent forward's body
// (jvp_layer, resid_jvp.cuh) on those residuals, which writes the tangent
// boundary and residuals. One layer's residuals (about 0.87 MB per aspirin
// molecule) do not fit in shared memory, so they pass through device memory
// (L2) between the two bodies, as they do between K1 and #9 in shared mode.
// The primal state entering the layer is copied aside for the tangent body
// (the forward updates its state in place), so the tangent body never reads
// back a boundary this launch wrote. The bodies take turns on one work
// region of shared memory: about 139 KB at aspirin's N = 21.
//
// What bounds it on an H100: the two bodies' f32 FMA issue and per-row
// synchronisation (K1's and #9's), the x_mixing products (N x HK) @ (HK x C)
// per receiver row most of the FLOPs. #18 writes two residual streams (about
// 10.5 MB per aspirin molecule at depth 6); #16 only its scratch, which
// stays in L2 at moderate batch. One 256-thread block per SM (the work
// region is over half the shared memory). Tensor cores are a later change.

#include "aug_fwd.cuh"

extern "C" long long sake_aug_fwd_smem_bytes(int B, int N, int F, int H, int R, int K, int C,
                                             int depth) {
  return sake::aug_fwd_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}) *
         (long long)sizeof(float);
}

// h0 (B, N, F), xs and tx0 (3, B, N): the embedded input, the positions and
// the tangent seed. Writes the primal's bh (depth, B, N, F), bx, bv (depth,
// 3, B, N), h_fin (B, N, F), x_fin, v_fin (3, B, N), then the tangent's six
// in the same layouts, and the residuals (resid_ptrs, RESIDS order, K1's
// shapes (depth, B, ...)) and their tangents (tresid_ptrs).
extern "C" int sake_aug_fwd(const float* h0, const float* xs, const float* tx0, const float* upd,
                            const void* const* leaf_ptrs, const long long* leaf_strides,
                            float* bh, float* bx, float* bv, float* h_fin, float* x_fin,
                            float* v_fin, float* tbh, float* tbx, float* tbv, float* th_fin,
                            float* tx_fin, float* tv_fin, void* const* resid_ptrs,
                            void* const* tresid_ptrs, int B, int N, int F, int H, int R, int K,
                            int C, int depth, void* stream) {
  float* const outs[12] = {bh, bx, bv, h_fin, x_fin, v_fin, tbh, tbx, tbv, th_fin, tx_fin, tv_fin};
  return sake::launch_aug<true>(sake::Dims{B, N, F, H, R, K, C, depth}, h0, xs, tx0, upd,
                                leaf_ptrs, leaf_strides, outs, resid_ptrs, tresid_ptrs, stream);
}

// As sake_aug_fwd, but resid_ptrs and tresid_ptrs are one layer's scratch
// (B, ...), which every layer overwrites.
extern "C" int sake_retrace_fwd(const float* h0, const float* xs, const float* tx0,
                                const float* upd, const void* const* leaf_ptrs,
                                const long long* leaf_strides, float* bh, float* bx, float* bv,
                                float* h_fin, float* x_fin, float* v_fin, float* tbh, float* tbx,
                                float* tbv, float* th_fin, float* tx_fin, float* tv_fin,
                                void* const* resid_ptrs, void* const* tresid_ptrs, int B, int N,
                                int F, int H, int R, int K, int C, int depth, void* stream) {
  float* const outs[12] = {bh, bx, bv, h_fin, x_fin, v_fin, tbh, tbx, tbv, th_fin, tx_fin, tv_fin};
  return sake::launch_aug<false>(sake::Dims{B, N, F, H, R, K, C, depth}, h0, xs, tx0, upd,
                                 leaf_ptrs, leaf_strides, outs, resid_ptrs, tresid_ptrs, stream);
}
