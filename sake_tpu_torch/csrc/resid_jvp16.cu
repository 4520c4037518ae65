// #9 in resid_ef's bf16 tier: the entry of resid_jvp.cuh's kernel with kE16,
// the tangent-only forward of make_ef_train2's shared mode with bf16 edge
// products and bf16 residual streams, JAX's production setting.
//
// Replaces the TPU kernel sake_tpu/kernels/train2_ef.py -> tfwd_kernel (the
// pallas_call at :1447, body :1397) built with edge_matmul_dtype=bfloat16 and
// resid_dtype=bfloat16: layer_jvp_resid with mm_edge in bf16 on the primal's
// bf16 streams (K1's in the tier), its tangent residuals stored in bf16 but r
// and t (:1456). A translation unit of its own, so that the f32 kernels keep
// their code and their build. The body is #12's phase 1 on the CUDA cores
// (jvp_layer<false, true>): each tangent edge product takes both operands in
// bf16, exact products summed in f32; its tangent pooled vectors also go to
// an f32 scratch that its node phase reads, since JAX rounds them only on
// store.

#include "resid_jvp.cuh"

// #9 in the bf16 tier: the arguments of sake_resid_jvp (its shared memory is
// sake_resid_jvp_smem_bytes), with L's four edge weights rounded to bf16, the
// primal's (resid_ptrs) and the tangent's (tresid_ptrs) residual streams bf16
// tensors but r and t, and tpool16 a (3, B, N, C) f32 scratch.
extern "C" int sake_resid_jvp16(const float* bh, const float* bx, const float* bv,
                                const float* upd, const void* const* leaf_ptrs,
                                const long long* leaf_strides, void* const* resid_ptrs,
                                const float* tx0, float* tbh, float* tbx, float* tbv,
                                float* th_fin, float* tx_fin, float* tv_fin,
                                void* const* tresid_ptrs, float* tpool16, int B, int N, int F,
                                int H, int R, int K, int C, int depth, void* stream) {
  return sake::launch_jvp<true>(bh, bx, bv, upd, leaf_ptrs, leaf_strides, resid_ptrs, tx0, tbh,
                                tbx, tbv, th_fin, tx_fin, tv_fin, tresid_ptrs,
                                sake::Dims{B, N, F, H, R, K, C, depth}, stream, tpool16);
}
