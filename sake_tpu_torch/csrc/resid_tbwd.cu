// #10, its tangent cotangent chain: the pullback of the layer stack with
// tangents (the jvp of layer_bwd_resid), f32.
//
// Replaces the jax.jvp of layer_bwd_resid inside the TPU kernel
// sake_tpu/kernels/train2_ef.py -> bwd_kernel (the pallas_call at :1632,
// body :1507; the jvp at :1585-1598) of the shared-mode training backward.
// Per layer in reverse, that kernel pulls the tangent chain's cotangent
// c_t back through layer_bwd_resid and takes the tangent of the result
// along the tangent forward (tresid, th, tx, tv) of resid_jvp.cu: the
// primal output J^T c_t continues the chain, the tangent output (hc, xc,
// vc) is the Hessian-vector term the primal chain adds (resid_bwd.cu with
// an addend), and the tangents of the cotangent rows feed the second-order
// half of the parameter gradients (param_grads.cu, augmented). This kernel
// writes, per layer, the Hessian terms (add_h, add_x, add_v), the c_t rows
// and their tangents, and returns the chain's cotangents of the initial
// state. No edge mask, as the MD17 training path it serves.
//
// The per-layer body is tbwd_layer (resid_tbwd.cuh), which fused_bwd.cu
// (#12) shares.
//
// Design: K2's (one block per molecule walking the layers in reverse, node
// phase then one receiver row at a time, sender sums accumulated in shared
// memory), with every quantity a dual number (value, tangent): forward-mode
// differentiation of K2's body. The cotangent state carries no tangent (c_t
// is constant under the jvp), so each layer starts its tangents at zero.
// A dual buffer of n rows is stored as 2n rows, the values then the
// tangents, so one block product over 2n rows gives both against the same
// weights (the weights carry no tangent); elementwise steps apply the
// product rule, including the second derivatives of silu, sigmoid and
// celu. Residuals and their tangents are read from device memory where
// they are used instead of staged in shared memory, and d_hatt and
// d_pool_sq (read one row per receiver) go to a device-memory scratch:
// dual buffers everywhere would need about 320 KB of shared memory at
// aspirin's N = 21, over the 227 KB a block may have; this layout carves
// 186 KB there (N = 29 would need 255 KB, so QM9's padded molecules do not
// fit: the wrapper raises).
//
// What bounds it on an H100: as K2, f32 FMA issue and per-row
// synchronisation, with every product done twice (value and tangent): the
// transposed x_mixing product d_xm @ w_xmix^T over 2N rows is the widest.
// Its residual reads are both streams (about 1.7 MB per aspirin molecule
// and layer) and it writes two sets of rows (about 1.7 MB), coalesced.

#include "resid_tbwd.cuh"

namespace sake {
namespace {

__global__ void __launch_bounds__(512)
resid_tbwd_kernel(Dims d, const float* __restrict__ bh, const float* __restrict__ bx,
                  const float* __restrict__ bv, const float* __restrict__ tbh,
                  const float* __restrict__ tbx, const float* __restrict__ tbv,
                  const float* __restrict__ upd, Leaves L, Leaves LT, Resids RS, Resids TR,
                  const float* __restrict__ dh_fin, const float* __restrict__ dx_fin,
                  const float* __restrict__ dv_fin, float* dh_out, float* dx_out,
                  float* dv_out, float* add_h, float* add_x, float* add_v, Rows RW, Rows TW,
                  float* scratch) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F, HK = d.H * d.K, C = d.C;
  const int tid = threadIdx.x, nt = blockDim.x;

  Carver cv{reinterpret_cast<float*>(smem4)};
  const TbSmem S = carve_tb(cv, d);
  float* gscratch = scratch + (size_t)b * 2 * N * (HK + C);
  tbwd_begin(d, S, B, b, dh_fin, dx_fin, dv_fin);
  for (int l = d.depth - 1; l >= 0; --l)
    tbwd_layer(d, S, b, l, upd[l], L, LT, bh, bx, bv, tbh, tbx, tbv, RS, TR, RW, TW, gscratch,
               add_h, add_x, add_v);

  for (int e = tid; e < N * F; e += nt) dh_out[(size_t)b * N * F + e] = S.sdh[e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    dx_out[((size_t)k * B + b) * N + i] = S.sdx[e];
    dv_out[((size_t)k * B + b) * N + i] = S.sdv[e];
  }
}

}  // namespace
}  // namespace sake

extern "C" long long sake_resid_tbwd_smem_bytes(int B, int N, int F, int H, int R, int K, int C,
                                                int depth) {
  return sake::tb_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}) *
         (long long)sizeof(float);
}

// bh, bx, bv / tbh, tbx, tbv: K1's boundary states and their tangents
// (resid_jvp.cu); resid_ptrs / tresid_ptrs: the residuals and their tangents;
// dh_fin (B, N, F), dx_fin, dv_fin (3, B, N): the chain's cotangent of the
// final state. Writes the cotangents of the initial state, per layer the
// Hessian terms add_h (depth, B, N, F), add_x, add_v (depth, 3, B, N), the
// rows (row_ptrs) and their tangents (trow_ptrs) in ROWS order; scratch:
// B * 2N * (H*K + C) floats.
extern "C" int sake_resid_tbwd(const float* bh, const float* bx, const float* bv,
                               const float* tbh, const float* tbx, const float* tbv,
                               const float* upd, const void* const* leaf_ptrs,
                               const void* const* leaf_t_ptrs, const long long* leaf_strides,
                               void* const* resid_ptrs, void* const* tresid_ptrs,
                               const float* dh_fin, const float* dx_fin, const float* dv_fin,
                               float* dh_out, float* dx_out, float* dv_out, float* add_h,
                               float* add_x, float* add_v, void* const* row_ptrs,
                               void* const* trow_ptrs, float* scratch, int B, int N, int F,
                               int H, int R, int K, int C, int depth, void* stream) {
  using namespace sake;
  const Dims d{B, N, F, H, R, K, C, depth};
  Leaves L, LT;
  for (int i = 0; i < kLeaves; ++i) {
    L.p[i] = static_cast<const float*>(leaf_ptrs[i]);
    LT.p[i] = static_cast<const float*>(leaf_t_ptrs[i]);
    L.stride[i] = LT.stride[i] = leaf_strides[i];
  }
  Resids RS, TR;
  for (int i = 0; i < kResids; ++i) {
    RS.p[i] = static_cast<float*>(resid_ptrs[i]);
    TR.p[i] = static_cast<float*>(tresid_ptrs[i]);
  }
  Rows RW, TW;
  for (int i = 0; i < kRows; ++i) {
    RW.p[i] = static_cast<float*>(row_ptrs[i]);
    TW.p[i] = static_cast<float*>(trow_ptrs[i]);
  }
  const size_t smem = tb_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(resid_tbwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  resid_tbwd_kernel<<<B, 512, smem, static_cast<cudaStream_t>(stream)>>>(
      d, bh, bx, bv, tbh, tbx, tbv, upd, L, LT, RS, TR, dh_fin, dx_fin, dv_fin, dh_out, dx_out,
      dv_out, add_h, add_x, add_v, RW, TW, scratch);
  return (int)cudaGetLastError();
}
