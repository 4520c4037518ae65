// K2 and its rows instantiation in resid_ef's bf16 tier (bwd_layer's kE16):
// the pullback of the layer stack on the tier's bf16 residual streams, with
// both operands of every edge product in bf16, JAX's production setting.
//
// Replaces, built with edge_matmul_dtype=bfloat16 and resid_dtype=bfloat16,
// the TPU kernels of sake_tpu/kernels/resid_ef.py -> resid_energy_forces's
// force backward (K2; the pallas_call at :1155 of train2_ef.py for #8, the
// shared primal's) and the layer_bwd_resid half of the training backwards of
// sake_tpu/kernels/train2_ef.py -> bwd_kernel (#10's primal chain, the
// pallas_call at :1632, body :1507) and _pipe's bwd_kernel (#19, :837, body
// :723): the primal chain c_p with its cotangent rows and, after each layer,
// the Hessian term of the tangent chain (resid_tbwd16.cu) added. A
// translation unit of its own, so that the f32 kernels of resid_bwd.cu keep
// their code and their build.
//
// Design: resid_bwd.cu's kernels on bwd_layer<kRows, false, kTc, true>. K2
// takes its two routes (the CUDA cores, and the tensor cores at tc_dims, one
// pass: both operands are bf16 values); the rows kernel, as the f32 one, the
// CUDA cores (exact products of bf16 operands summed in f32), its rows those
// of layer_bwd_resid(bf16=True) and f32.

#include "resid_bwd.cuh"

namespace sake {
namespace {

// kRows: the rows instantiation (RW, and the addend add_h, add_x, add_v or
// null); kTc: K2's tensor-core route, else the CUDA cores.
template <bool kRows, bool kTc>
__global__ void __launch_bounds__(512)
resid_bwd16_kernel(Dims d, const float* __restrict__ bh, const float* __restrict__ bx,
                   const float* __restrict__ bv, const float* __restrict__ upd,
                   const float* __restrict__ mask, Leaves L, Leaves LT, Resids16 RS,
                   const float* __restrict__ dh_fin, const float* __restrict__ dx_fin,
                   const float* __restrict__ dv_fin, float* dh_out, float* dx_out,
                   float* dv_out, Rows RW, const float* __restrict__ add_h,
                   const float* __restrict__ add_x, const float* __restrict__ add_v) {
  static_assert(!(kRows && kTc), "the rows kernel takes the CUDA cores");
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* mb = mask ? mask + (size_t)b * N * N : nullptr;

  Carver cv{reinterpret_cast<float*>(smem4)};
  float* ring = kTc ? cv.take(tc_ring_floats(d)) : nullptr;
  const BwdSmem S = carve_bwd<kTc>(cv, d);
  SAKE_PROBE_START();
  bwd_begin(d, S, B, b, dh_fin, dx_fin, dv_fin, mb);
  for (int l = d.depth - 1; l >= 0; --l)
    bwd_layer<kRows, false, kTc, true>(d, S, b, l, upd[l], mb, L, LT, bh, bx, bv, RS, RW, add_h,
                                       add_x, add_v, ring);

  for (int e = tid; e < N * F; e += nt) dh_out[(size_t)b * N * F + e] = S.sdh[e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    dx_out[((size_t)k * B + b) * N + i] = S.sdx[e];
    dv_out[((size_t)k * B + b) * N + i] = S.sdv[e];
  }
}

template <bool kRows, bool kTc>
int launch_bwd16(const Dims& d, const float* bh, const float* bx, const float* bv,
                 const float* upd, const float* mask, const void* const* leaf_ptrs,
                 const void* const* leaf_t_ptrs, const long long* leaf_strides,
                 void* const* resid_ptrs, const float* dh_fin, const float* dx_fin,
                 const float* dv_fin, float* dh_out, float* dx_out, float* dv_out,
                 const Rows& RW, const float* add_h, const float* add_x, const float* add_v,
                 void* stream) {
  if (kTc && !tc_dims(d)) return (int)cudaErrorInvalidValue;
  const Leaves L = leaves_of(leaf_ptrs, leaf_strides), LT = leaves_of(leaf_t_ptrs, leaf_strides);
  const size_t smem = (kTc ? bwd_tc_smem_floats(d) : bwd_smem_floats(d)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(resid_bwd16_kernel<kRows, kTc>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  resid_bwd16_kernel<kRows, kTc><<<d.B, 512, smem, static_cast<cudaStream_t>(stream)>>>(
      d, bh, bx, bv, upd, mask, L, LT, resids16_of(resid_ptrs), dh_fin, dx_fin, dv_fin, dh_out,
      dx_out, dv_out, RW, add_h, add_x, add_v);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sake

// The bf16 tier's K2: the arguments of sake_resid_bwd, the low-precision
// residual streams bf16 tensors (all but r and t), L's and LT's four edge
// weights (w_o_f, w_o1, w_sem, w_xmix) rounded to bf16. route: 0 the CUDA
// cores, 1 the tensor cores (tc_dims, else refused).
extern "C" int sake_resid_bwd16(int route, const float* bh, const float* bx, const float* bv,
                                const float* upd, const float* mask,
                                const void* const* leaf_ptrs, const void* const* leaf_t_ptrs,
                                const long long* leaf_strides, void* const* resid_ptrs,
                                const float* dh_fin, const float* dx_fin, const float* dv_fin,
                                float* dh_out, float* dx_out, float* dv_out, int B, int N, int F,
                                int H, int R, int K, int C, int depth, void* stream) {
  using namespace sake;
  const Dims d{B, N, F, H, R, K, C, depth};
  switch (route) {
    case 0: return launch_bwd16<false, false>(d, bh, bx, bv, upd, mask, leaf_ptrs, leaf_t_ptrs,
                                              leaf_strides, resid_ptrs, dh_fin, dx_fin, dv_fin,
                                              dh_out, dx_out, dv_out, Rows{}, nullptr, nullptr,
                                              nullptr, stream);
    case 1: return launch_bwd16<false, true>(d, bh, bx, bv, upd, mask, leaf_ptrs, leaf_t_ptrs,
                                             leaf_strides, resid_ptrs, dh_fin, dx_fin, dv_fin,
                                             dh_out, dx_out, dv_out, Rows{}, nullptr, nullptr,
                                             nullptr, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 tier's one-block rows kernel: the arguments of sake_resid_bwd_rows
// (its shared memory is sake_resid_bwd_smem_bytes), the streams and weights as
// sake_resid_bwd16's; the rows and the addend f32.
extern "C" int sake_resid_bwd_rows16(const float* bh, const float* bx, const float* bv,
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
  return sake::launch_bwd16<true, false>(sake::Dims{B, N, F, H, R, K, C, depth}, bh, bx, bv,
                                         upd, mask, leaf_ptrs, leaf_t_ptrs, leaf_strides,
                                         resid_ptrs, dh_fin, dx_fin, dv_fin, dh_out, dx_out,
                                         dv_out, sake::rows_of(row_ptrs), add_h, add_x, add_v,
                                         stream);
}
