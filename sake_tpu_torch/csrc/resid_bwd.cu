// K2: hand-derived pullback of the layer stack, f32; with kRows it also
// writes the cotangent rows the parameter gradients contract.
//
// Replaces two TPU kernels of sake_tpu/kernels/resid_ef.py, which run
// layer_bwd_resid over the layers in reverse, reading the residuals of
// K1 (resid_fwd.cu):
// - resid_energy_forces -> bwd_kernel (the pallas_call at :1272), the E + F
//   pullback: input cotangents only (forces are -dx);
// - make_hidden_fn -> bwd_kernel (:1680, body :1598), the training pullback
//   with parameter gradients: this kernel with kRows writes, per layer,
//   the cotangent rows (ROWS in resid_ef.py: d_e0, d_h_e, d_sem_pre, d_xm,
//   att2, filtered, d_rbf per edge; d_a_j, d_a_i, d_o_j, d_o_i, d_ps0,
//   d_ps1, d_node_pre, d_uv, d_g0, d_g1, d_delta, hatt, pool_sq per atom),
//   and param_grads.cu contracts them into every leaf's gradient.
// - train2_ef.py -> the shared-mode training backward bwd_kernel (:1632,
//   body :1507), its primal cotangent chain: this kernel with kRows and an
//   addend (add_h, add_x, add_v), the Hessian term resid_tbwd.cu computes
//   per layer, added to the cotangents leaving each layer.
// Given the cotangents of the final (h, x, v) it returns those of the
// initial (h, x, v). An edge mask (B, N, N) gives the masked pullback:
// the renormalized attention's backward with its live term, d_xm * m and
// the count divisors.
//
// The per-layer body is bwd_layer (resid_bwd.cuh), which the fused kernels
// of fused_ef.cu (#11, #3) and fused_bwd.cu (#12) share.
//
// Design: one thread block per molecule walks the layers in reverse; the
// cotangent state (dh, dx, dv) stays in shared memory. Per layer the node
// part (gate MLP, node MLP, post-norm MLP) runs first and leaves
// d_pool_sq and d_hatt in shared memory; then one receiver row i at a
// time pulls back its N sender edges. Sender-side cotangents are column
// sums over receivers (d_o_j, d_a_j and the +d_d0 term of dx), so they are
// accumulated in shared memory across the row loop; receiver-side ones
// (d_o_i, d_a_i, -d_d0) are row sums. The self pair is kept: its r is the
// regularized sqrt(relu(r^2) + 1e-5) and its logit was pushed down by
// 1e5, exactly as in the forward. The TPU kernel summed the weight
// gradients over its sequential grid in resident VMEM blocks; blocks here
// run in parallel and in no order, so the rows go to device memory (about
// 1.6 MB per molecule and layer at QM9's N = 29) and a second kernel sums
// them, deterministically.
//
// What bounds it on an H100: as K1, f32 FMA issue and per-row
// synchronisation; the transposed x_mixing product d_xm @ w_xmix^T is the
// widest, register-tiled like K1's. Weights are read transposed from
// copies the wrapper makes, so every product reads W row-major and
// coalesced. The residual reads (about 0.87 MB per molecule and layer for
// aspirin) and the row writes are coalesced row blocks. At N = 29 the
// block needs 221 KB of the 227 KB of shared memory a block may have, so
// N = 32 does not fit: the kernels take N as it comes, unpadded.
//
// The tensor-core kernel (resid_bwd_tc_kernel, K2 on MD17 serving's route at
// aspirin's widths, tc_dims): the same design on the body's kTc instantiation,
// so the x-mixing pullback d_xm @ w_xmix^T and the edge products' pullbacks
// through o_f and o1 run in 3xTF32 on mma.sync (mma_tf32x3.cuh), w_xmix^T
// through mm_tc's 16-warp W ring carved ahead of the body's buffers; one
// 512-thread block an SM, as resid_bwd_kernel (177,728 bytes at aspirin's N =
// 21). Elsewhere (the narrow models, N > 22) K2 stays on resid_bwd_kernel, and
// the rows instantiation (#5's one-block route, #10's, #19's) keeps its
// CUDA-core products.
//
// resid_ef's bf16 tier (bwd_layer's kE16: the bf16 residual streams, the edge
// products with both operands in bf16) runs K2 and the rows instantiation in
// kernels of their own (resid_bwd16.cu). The f32 kernels are untouched by it.
//
// #5's cluster kernel (one molecule per two-CTA cluster) is resid_bwd_cl.cu's.

#include "resid_bwd.cuh"

namespace sake {

template <bool kRows>
__global__ void __launch_bounds__(512)
resid_bwd_kernel(Dims d, const float* __restrict__ bh, const float* __restrict__ bx,
                 const float* __restrict__ bv, const float* __restrict__ upd,
                 const float* __restrict__ mask, Leaves L, Leaves LT, Resids RS,
                 const float* __restrict__ dh_fin, const float* __restrict__ dx_fin,
                 const float* __restrict__ dv_fin, float* dh_out, float* dx_out,
                 float* dv_out, Rows RW, const float* __restrict__ add_h,
                 const float* __restrict__ add_x, const float* __restrict__ add_v) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* mb = mask ? mask + (size_t)b * N * N : nullptr;  // this molecule's (N, N)

  Carver cv{reinterpret_cast<float*>(smem4)};
  const BwdSmem S = carve_bwd(cv, d);
  SAKE_PROBE_START();
  bwd_begin(d, S, B, b, dh_fin, dx_fin, dv_fin, mb);
  for (int l = d.depth - 1; l >= 0; --l)
    bwd_layer<kRows>(d, S, b, l, upd[l], mb, L, LT, bh, bx, bv, RS, RW, add_h, add_x, add_v);

  for (int e = tid; e < N * F; e += nt) dh_out[(size_t)b * N * F + e] = S.sdh[e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    dx_out[((size_t)k * B + b) * N + i] = S.sdx[e];
    dv_out[((size_t)k * B + b) * N + i] = S.sdv[e];
  }
}

__global__ void __launch_bounds__(512, 1)
resid_bwd_tc_kernel(Dims d, const float* __restrict__ bh, const float* __restrict__ bx,
                    const float* __restrict__ bv, const float* __restrict__ upd,
                    const float* __restrict__ mask, Leaves L, Leaves LT, Resids RS,
                    const float* __restrict__ dh_fin, const float* __restrict__ dx_fin,
                    const float* __restrict__ dv_fin, float* dh_out, float* dx_out,
                    float* dv_out) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* mb = mask ? mask + (size_t)b * N * N : nullptr;

  Carver cv{reinterpret_cast<float*>(smem4)};
  float* ring = cv.take(tc_ring_floats(d));
  const BwdSmem S = carve_bwd<true>(cv, d);
  SAKE_PROBE_START();
  bwd_begin(d, S, B, b, dh_fin, dx_fin, dv_fin, mb);
  for (int l = d.depth - 1; l >= 0; --l)
    bwd_layer<false, false, true>(d, S, b, l, upd[l], mb, L, LT, bh, bx, bv, RS, Rows{},
                                  nullptr, nullptr, nullptr, ring);

  for (int e = tid; e < N * F; e += nt) dh_out[(size_t)b * N * F + e] = S.sdh[e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    dx_out[((size_t)k * B + b) * N + i] = S.sdx[e];
    dv_out[((size_t)k * B + b) * N + i] = S.sdv[e];
  }
}

template <bool kRows>
int launch_bwd(const Dims& d, const float* bh, const float* bx, const float* bv,
               const float* upd, const float* mask, const void* const* leaf_ptrs,
               const void* const* leaf_t_ptrs, const long long* leaf_strides,
               void* const* resid_ptrs, const float* dh_fin, const float* dx_fin,
               const float* dv_fin, float* dh_out, float* dx_out, float* dv_out,
               const Rows& RW, const float* add_h, const float* add_x, const float* add_v,
               void* stream) {
  const Leaves L = leaves_of(leaf_ptrs, leaf_strides), LT = leaves_of(leaf_t_ptrs, leaf_strides);
  const Resids RS = resids_of(resid_ptrs);
  const size_t smem = bwd_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      resid_bwd_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  resid_bwd_kernel<kRows><<<d.B, 512, smem, static_cast<cudaStream_t>(stream)>>>(
      d, bh, bx, bv, upd, mask, L, LT, RS, dh_fin, dx_fin, dv_fin, dh_out, dx_out, dv_out,
      RW, add_h, add_x, add_v);
  return (int)cudaGetLastError();
}

}  // namespace sake

extern "C" long long sake_resid_bwd_smem_bytes(int B, int N, int F, int H, int R, int K,
                                               int C, int depth) {
  sake::Dims d{B, N, F, H, R, K, C, depth};
  return sake::bwd_smem_floats(d) * (long long)sizeof(float);
}

// mask: (B, N, N) f32 or null.
extern "C" int sake_resid_bwd(const float* bh, const float* bx, const float* bv,
                              const float* upd, const float* mask,
                              const void* const* leaf_ptrs, const void* const* leaf_t_ptrs,
                              const long long* leaf_strides, void* const* resid_ptrs,
                              const float* dh_fin, const float* dx_fin, const float* dv_fin,
                              float* dh_out, float* dx_out, float* dv_out, int B, int N,
                              int F, int H, int R, int K, int C, int depth, void* stream) {
  return sake::launch_bwd<false>(sake::Dims{B, N, F, H, R, K, C, depth}, bh, bx, bv, upd,
                                 mask, leaf_ptrs, leaf_t_ptrs, leaf_strides, resid_ptrs,
                                 dh_fin, dx_fin, dv_fin, dh_out, dx_out, dv_out,
                                 sake::Rows{}, nullptr, nullptr, nullptr, stream);
}

// Whether K2 takes its tensor-core kernel at these widths and N (tc_dims), 1,
// or resid_bwd_kernel, 0.
extern "C" int sake_resid_bwd_tc_route(int B, int N, int F, int H, int R, int K, int C,
                                       int depth) {
  return sake::tc_dims(sake::Dims{B, N, F, H, R, K, C, depth}) ? 1 : 0;
}

extern "C" long long sake_resid_bwd_tc_smem_bytes(int B, int N, int F, int H, int R, int K,
                                                  int C, int depth) {
  sake::Dims d{B, N, F, H, R, K, C, depth};
  return sake::bwd_tc_smem_floats(d) * (long long)sizeof(float);
}

// K2 on its tensor-core kernel, the arguments of sake_resid_bwd; a shape off
// that route (tc_dims) is refused with cudaErrorInvalidValue.
extern "C" int sake_resid_bwd_tc(const float* bh, const float* bx, const float* bv,
                                 const float* upd, const float* mask,
                                 const void* const* leaf_ptrs, const void* const* leaf_t_ptrs,
                                 const long long* leaf_strides, void* const* resid_ptrs,
                                 const float* dh_fin, const float* dx_fin, const float* dv_fin,
                                 float* dh_out, float* dx_out, float* dv_out, int B, int N,
                                 int F, int H, int R, int K, int C, int depth, void* stream) {
  using namespace sake;
  const Dims d{B, N, F, H, R, K, C, depth};
  if (!tc_dims(d)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_tc_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(resid_bwd_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  resid_bwd_tc_kernel<<<B, 512, smem, static_cast<cudaStream_t>(stream)>>>(
      d, bh, bx, bv, upd, mask, leaves_of(leaf_ptrs, leaf_strides),
      leaves_of(leaf_t_ptrs, leaf_strides), resids_of(resid_ptrs), dh_fin, dx_fin, dv_fin,
      dh_out, dx_out, dv_out);
  return (int)cudaGetLastError();
}

// As sake_resid_bwd, also writing the cotangent rows (row_ptrs in ROWS order).
// add_h (depth, B, N, F), add_x, add_v (depth, 3, B, N): null, or added to the
// cotangents leaving each layer.
extern "C" int sake_resid_bwd_rows(const float* bh, const float* bx, const float* bv,
                                   const float* upd, const float* mask,
                                   const void* const* leaf_ptrs,
                                   const void* const* leaf_t_ptrs,
                                   const long long* leaf_strides, void* const* resid_ptrs,
                                   const float* dh_fin, const float* dx_fin,
                                   const float* dv_fin, float* dh_out, float* dx_out,
                                   float* dv_out, void* const* row_ptrs, const float* add_h,
                                   const float* add_x, const float* add_v, int B, int N,
                                   int F, int H, int R, int K, int C, int depth,
                                   void* stream) {
  return sake::launch_bwd<true>(sake::Dims{B, N, F, H, R, K, C, depth}, bh, bx, bv, upd,
                                mask, leaf_ptrs, leaf_t_ptrs, leaf_strides, resid_ptrs,
                                dh_fin, dx_fin, dv_fin, dh_out, dx_out, dv_out,
                                sake::rows_of(row_ptrs), add_h, add_x, add_v, stream);
}

// The clock probe's slots (probe.cuh) of this source's kernels.
extern "C" int sake_resid_bwd_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}
