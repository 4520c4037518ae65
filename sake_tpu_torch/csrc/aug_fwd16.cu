// #18 and #16 in resid_ef's bf16 tier: the entries of aug_fwd.cuh's kernel with
// kE16, the augmented forwards of make_ef_train2's resid and retrace modes with
// bf16 edge products (and, in resid mode, bf16 residual streams), JAX's
// production setting.
//
// Replaces the TPU kernel sake_tpu/kernels/train2_ef.py -> _aug_grad_resid ->
// _pipe -> fwd_kernel (the pallas_call at :668, body :584-658) built with
// edge_matmul_dtype=bfloat16 and resid_dtype=bfloat16: jax.jvp of
// layer_fwd_resid with mm_edge in bf16, which rounds the primal's and the
// tangent's residuals to bf16 (but r and t) only as it stores them (:632-635,
// :664). So the tangent takes the primal's f32 values, unlike #9 (shared mode),
// whose tangent reads the primal's bf16 streams. A translation unit of its
// own, so that the f32 kernels keep their code and their build.
//
// Design: the f32 kernel's (aug_fwd.cu), with both bodies' kE16 products on
// the CUDA cores (each edge product's operands in bf16, exact products summed
// in f32) and their residuals in one-layer f32 scratches (slot b of B, as
// #16's); after each layer the block stores its molecule's slices of both
// scratches into the depth streams, rounded. The scratches add 2 x 0.87 MB
// of f32 traffic per aspirin molecule and layer, written and read once.

#include "aug_fwd.cuh"

// #18 in the bf16 tier: the arguments of sake_aug_fwd (its shared memory is
// sake_aug_fwd_smem_bytes), with L's four edge weights rounded to bf16;
// scratch_ptrs and tscratch_ptrs one layer's f32 residuals (B, ...), in
// RESIDS order, and resid_ptrs and tresid_ptrs the depth streams (depth, B,
// ...), bf16 tensors but r and t.
extern "C" int sake_aug_fwd16(const float* h0, const float* xs, const float* tx0,
                              const float* upd, const void* const* leaf_ptrs,
                              const long long* leaf_strides, float* bh, float* bx, float* bv,
                              float* h_fin, float* x_fin, float* v_fin, float* tbh, float* tbx,
                              float* tbv, float* th_fin, float* tx_fin, float* tv_fin,
                              void* const* scratch_ptrs, void* const* tscratch_ptrs,
                              void* const* resid_ptrs, void* const* tresid_ptrs, int B, int N,
                              int F, int H, int R, int K, int C, int depth, void* stream) {
  float* const outs[12] = {bh, bx, bv, h_fin, x_fin, v_fin, tbh, tbx, tbv, th_fin, tx_fin, tv_fin};
  return sake::launch_aug<true, true>(sake::Dims{B, N, F, H, R, K, C, depth}, h0, xs, tx0, upd,
                                      leaf_ptrs, leaf_strides, outs, scratch_ptrs, tscratch_ptrs,
                                      stream, sake::resids16_of(resid_ptrs),
                                      sake::resids16_of(tresid_ptrs));
}

// #16 in the bf16 tier (JAX's retrace-mode fwd_kernel, the pallas_call at :330,
// body :270-326, with mm_edge in bf16: the jvp of layer_forward_wide, every
// intermediate f32): the arguments of sake_retrace_fwd, with L's four edge
// weights rounded to bf16; resid_ptrs and tresid_ptrs one layer's f32 scratch.
extern "C" int sake_retrace_fwd16(const float* h0, const float* xs, const float* tx0,
                                  const float* upd, const void* const* leaf_ptrs,
                                  const long long* leaf_strides, float* bh, float* bx, float* bv,
                                  float* h_fin, float* x_fin, float* v_fin, float* tbh,
                                  float* tbx, float* tbv, float* th_fin, float* tx_fin,
                                  float* tv_fin, void* const* resid_ptrs,
                                  void* const* tresid_ptrs, int B, int N, int F, int H, int R,
                                  int K, int C, int depth, void* stream) {
  float* const outs[12] = {bh, bx, bv, h_fin, x_fin, v_fin, tbh, tbx, tbv, th_fin, tx_fin, tv_fin};
  return sake::launch_aug<false, true>(sake::Dims{B, N, F, H, R, K, C, depth}, h0, xs, tx0, upd,
                                       leaf_ptrs, leaf_strides, outs, resid_ptrs, tresid_ptrs,
                                       stream);
}
