// #12's block in resid_ef's bf16 tier: the entry of fused_bwd.cuh's kernel
// with kE16, the fused training backward of make_ef_train2's fused mode with
// bf16 edge products and bf16 residual streams, JAX's production setting.
//
// Replaces the TPU kernel sake_tpu/kernels/train2_ef.py -> _fused_bwd_chunk's
// kernel (the pallas_call at :1908, body :1750) built with
// edge_matmul_dtype=bfloat16 and resid_dtype=bfloat16. A translation unit of
// its own, so that the f32 kernels keep their code and their build. The
// parameter gradients are then one launch of param_grads.cu's augmented
// contraction in the tier (sake_param_grads_aug16).

#include "fused_bwd.cuh"

extern "C" long long sake_fused_bwd16_smem_bytes(int B, int N, int F, int H, int R, int K,
                                                 int C, int depth, int F0) {
  return sake::fused_bwd_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}, F0) *
         (long long)sizeof(float);
}

// #12's block in the bf16 tier: the arguments of sake_fused_bwd, with L's and
// LT's four edge weights rounded to bf16, the primal's (resid_ptrs) and the
// tangent's (tresid_ptrs) residual streams bf16 tensors but r and t, and
// tpool16 a (3, B, N, C) f32 scratch.
extern "C" int sake_fused_bwd16(const float* bh, const float* bx, const float* bv,
                                const float* upd, const void* const* leaf_ptrs,
                                const void* const* leaf_t_ptrs, const long long* leaf_strides,
                                void* const* resid_ptrs, const float* h_fin, const float* tx0,
                                const float* g_e, const float* w0, const float* b0,
                                const float* w1, const float* b1, const float* w0t, float* tbh,
                                float* tbx, float* tbv, void* const* tresid_ptrs,
                                void* const* row_ptrs, void* const* trow_ptrs,
                                void* const* ttrow_ptrs, float* scratch, float* dh0, float* dx0,
                                float* ro_part, float* tpool16, int B, int N, int F, int H, int R,
                                int K, int C, int depth, int F0, int O, void* stream) {
  using namespace sake;
  return launch_fused_bwd<true>(bh, bx, bv, upd, leaf_ptrs, leaf_t_ptrs, leaf_strides,
                                resid_ptrs, h_fin, tx0, g_e, Readout{w0, b0, w1, b1, w0t, F0, O},
                                tbh, tbx, tbv, tresid_ptrs, row_ptrs, trow_ptrs, ttrow_ptrs,
                                scratch, dh0, dx0, ro_part, tpool16,
                                Dims{B, N, F, H, R, K, C, depth}, stream);
}
