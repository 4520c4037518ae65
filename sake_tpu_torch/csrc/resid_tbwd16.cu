// #10's tangent chain in resid_ef's bf16 tier: the entry of resid_tbwd.cuh's
// kernel with kE16, for make_ef_train2's shared and resid modes with bf16 edge
// products and bf16 residual streams, JAX's production setting.
//
// Replaces the jax.jvp of layer_bwd_resid inside the TPU kernel
// sake_tpu/kernels/train2_ef.py -> bwd_kernel (the pallas_call at :1632, body
// :1507; the jvp at :1585-1598) and inside _pipe's bwd_kernel (#19, :837, body
// :723), each built with edge_matmul_dtype=bfloat16 and resid_dtype=bfloat16:
// layer_bwd_resid with mm_edge and mm_edge_t in bf16 and its tangent, on the
// primal's and the tangent's bf16 streams. A translation unit of its own, so
// that the f32 kernels keep their code and their build. The body is #12's
// tangent pullback on the CUDA cores (tbwd_layer<false, true>): each edge
// product rounds its value operand and its tangent operand apart, exact
// products summed in f32; the rows and the Hessian terms stay f32.

#include "resid_tbwd.cuh"

// #10's tangent chain in the bf16 tier: the arguments of sake_resid_tbwd (its
// shared memory is sake_resid_tbwd_smem_bytes), with L's and LT's four edge
// weights rounded to bf16 and the primal's (resid_ptrs) and the tangent's
// (tresid_ptrs) residual streams bf16 tensors but r and t.
extern "C" int sake_resid_tbwd16(const float* bh, const float* bx, const float* bv,
                                 const float* tbh, const float* tbx, const float* tbv,
                                 const float* upd, const void* const* leaf_ptrs,
                                 const void* const* leaf_t_ptrs, const long long* leaf_strides,
                                 void* const* resid_ptrs, void* const* tresid_ptrs,
                                 const float* dh_fin, const float* dx_fin, const float* dv_fin,
                                 float* dh_out, float* dx_out, float* dv_out, float* add_h,
                                 float* add_x, float* add_v, void* const* row_ptrs,
                                 void* const* trow_ptrs, float* scratch, int B, int N, int F,
                                 int H, int R, int K, int C, int depth, void* stream) {
  return sake::launch_tbwd<true>(bh, bx, bv, tbh, tbx, tbv, upd, leaf_ptrs, leaf_t_ptrs,
                                 leaf_strides, resid_ptrs, tresid_ptrs, dh_fin, dx_fin, dv_fin,
                                 dh_out, dx_out, dv_out, add_h, add_x, add_v, row_ptrs,
                                 trow_ptrs, scratch, sake::Dims{B, N, F, H, R, K, C, depth},
                                 stream);
}
