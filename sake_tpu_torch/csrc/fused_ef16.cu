// #11 in resid_ef's bf16 tier: the entries of fused_ef.cuh's kernel with
// kE16, the fused primal of make_ef_train2's fused mode with bf16 edge
// products and bf16 residual streams, JAX's production setting.
//
// Replaces the TPU kernel sake_tpu/kernels/train2_ef.py -> _fused_primal's
// kernel (the pallas_call at :1320, body :1239) built with
// edge_matmul_dtype=bfloat16 and resid_dtype=bfloat16. A translation unit of
// its own, so that the f32 kernels keep their code and their build.

#include "fused_ef.cuh"

extern "C" long long sake_fused_primal16_smem_bytes(int B, int N, int F, int H, int R, int K,
                                                    int C, int depth, int F0) {
  return sake::fused_ef_smem_floats<true>(sake::Dims{B, N, F, H, R, K, C, depth}, F0) *
         (long long)sizeof(float);
}

// #11 in the bf16 tier: the arguments of sake_fused_primal, with L's and LT's
// four edge weights (w_o_f, w_o1, w_sem, w_xmix) rounded to bf16, the residual
// streams (resid_ptrs) bf16 tensors but r and t, and pool16 a (3, B, N, C) f32
// scratch.
extern "C" int sake_fused_primal16(const float* h0, const float* xs, const float* upd,
                                   const void* const* leaf_ptrs, const void* const* leaf_t_ptrs,
                                   const long long* leaf_strides, const float* w0,
                                   const float* b0, const float* w1, const float* b1,
                                   const float* w0t, float* bh, float* bx, float* bv,
                                   void* const* resid_ptrs, float* h_fin, float* x_fin,
                                   float* v_fin, float* e_out, float* dx_out, float* pool16,
                                   int B, int N, int F, int H, int R, int K, int C, int depth,
                                   int F0, int O, void* stream) {
  using namespace sake;
  return launch<false, true>(Dims{B, N, F, H, R, K, C, depth}, B, h0, xs, upd, nullptr,
                             leaf_ptrs, leaf_t_ptrs, leaf_strides,
                             Readout{w0, b0, w1, b1, w0t, F0, O}, bh, bx, bv, resid_ptrs, h_fin,
                             x_fin, v_fin, e_out, dx_out, pool16, stream);
}
