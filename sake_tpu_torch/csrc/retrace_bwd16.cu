// #17 in resid_ef's bf16 tier: one layer of the retrace-mode augmented
// backward of make_ef_train2 with bf16 edge products, JAX's production
// setting; its contraction is param_grads.cu's sake_retrace_grads16.
//
// Replaces the TPU kernel sake_tpu/kernels/train2_ef.py -> _aug_grad ->
// bwd_kernel (the pallas_call at :464, body :379-456) built with
// edge_matmul_dtype=bfloat16 and resid_dtype=bfloat16. That kernel is
// jax.vjp of jax.jvp of layer_forward_wide with mm_edge in bf16: it stores
// nothing in bf16, every intermediate is f32, and only the edge products
// (o_f, o1, the semantic logits, the x-mixing, and the head expansions'
// bf16(h_e), bf16(att)) round, their operands and, by JAX's transpose of a
// rounding, every cotangent that flows into a rounded operand, after its sum.
// An edge weight's gradient is that of its two products per batch tile: the
// primal's bf16(bf16(a)^T P) and the tangent's bf16(bf16(t_a)^T c_t), added
// in f32 (XLA keeps the add of two bf16 values at f32), the tiles' sums added
// in f32. A translation unit of its own, so that the f32 kernels keep their
// code and their build.
//
// Design: as the f32 kernel (retrace_bwd.cu), one block per molecule
// re-forwards the layer (fwd_layer) and its tangent (jvp_layer), in their
// bf16-product instantiations without bf16 storage, into one-layer f32
// scratches; then one pullback body does what the f32 kernel does with two:
// the tangent pullback (tbwd_layer's kAd instantiation) with the tangents of
// its cotangents started at the primal chain's. Its values are then the
// tangent chain c_t and its tangents the primal chain (the pullback is linear
// in them, and the Hessian terms are its tangents' own part), so at each
// rounded operand the primal chain's whole cotangent meets its rounding, as
// in JAX. Its rows (c_t's) and their tangents (the primal chain's) feed the
// contraction (sake_retrace_grads16): param_grads.cu's f32 augmented one for
// the 25 other leaves, and the four edge weights' rounded terms per batch
// tile on the same f64 tensor-core tiles.
//
// What bounds it on an H100: as the f32 kernel, minus the primal chain's
// body (one pullback instead of two); its edge products are CUDA-core f32
// FMAs on bf16 values.

#include "resid_fwd.cuh"
#include "resid_jvp.cuh"
#include "aug_pullback.cuh"

namespace sake {
namespace {

constexpr int kRetrace16Threads = 512;

__host__ __device__ inline long long retrace16_smem_floats(const Dims& d) {
  long long work = tb_smem_floats<false, true>(d);
  work = work > fwd_smem_floats(d) ? work : fwd_smem_floats(d);
  work = work > jvp_smem_floats(d) ? work : jvp_smem_floats(d);
  return carry_floats(d) + work;
}

// Layer l of molecule b, as retrace_bwd.cu's kernel: bh ... tbv at layer l of
// #16's boundary streams, L and LT at layer l's leaves (LT's four edge
// weights rounded), RS and TR the one-layer f32 scratch, RW and TW one
// layer's rows: the tangent chain's and, as their tangents, the primal
// chain's; cp_* and ct_* the chains' cotangents, read and overwritten.
__global__ void __launch_bounds__(kRetrace16Threads, 1)
retrace_bwd16_kernel(Dims d, const float* __restrict__ bh, const float* __restrict__ bx,
                     const float* __restrict__ bv, const float* __restrict__ tbh,
                     const float* __restrict__ tbx, const float* __restrict__ tbv,
                     const float* __restrict__ upd, int l, Leaves L, Leaves LT, Resids RS,
                     Resids TR, Rows RW, Rows TW, float* scratch, float* cp_dh, float* cp_dx,
                     float* cp_dv, float* ct_dh, float* ct_dx, float* ct_dv) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F, HK = d.H * d.K, C = d.C;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float u = upd[l];
  Carver cc{base};
  const Carry P = carve_carry(cc, d);
  float* work = base + cc.off;
  float* gscratch = scratch + (size_t)b * 2 * N * (HK + C);

  // the chains' cotangents of the layer's output: the tangent chain's as the
  // dual state's values, the primal chain's as its tangents
  for (int e = tid; e < N * F; e += nt) {
    P.ct_dh[e] = ct_dh[(size_t)b * N * F + e];
    P.ct_dh[N * F + e] = cp_dh[(size_t)b * N * F + e];
  }
  for (int e = tid; e < 3 * N; e += nt) {
    const size_t at = ((size_t)(e / N) * B + b) * N + e % N;
    P.cp_dx[e] = cp_dx[at];
    P.cp_dv[e] = cp_dv[at];
    P.ct_dx[e] = ct_dx[at];
    P.ct_dv[e] = ct_dv[at];
  }

  // re-forward the layer and its tangent with the tier's products, in f32
  Carver cf{work};
  const FwdSmem SF = carve_fwd(cf, d);
  fwd_begin(d, SF, B, b, bh, bx, bv, nullptr);
  fwd_layer<true, false, false, false, false, kTcWarps, true, false>(
      d, SF, b, 0, u, nullptr, L, nullptr, nullptr, nullptr, RS);
  Carver cj{work};
  const JvpSmem SJ = carve_jvp(cj, d);
  for (int e = tid; e < N * F; e += nt) SJ.sth[e] = tbh[(size_t)b * N * F + e];
  for (int e = tid; e < 3 * N; e += nt) {
    const size_t at = ((size_t)(e / N) * B + b) * N + e % N;
    SJ.stx[e] = tbx[at];
    SJ.stv[e] = tbv[at];
  }
  __syncthreads();
  jvp_layer<false, true, false>(d, SJ, b, 0, u, L, bh, bx, bv, RS, nullptr, nullptr, nullptr,
                                TR);

  // both chains through one pullback body
  Carver ct{work};
  TbSmem ST = carve_tb<false, true>(ct, d);
  ST.sdh = P.ct_dh;
  ST.sdx = P.ct_dx;
  ST.sdv = P.ct_dv;
  ST.sdx_t = P.cp_dx;
  ST.sdv_t = P.cp_dv;
  tbwd_layer<false, true, false, true>(d, ST, b, 0, u, L, LT, bh, bx, bv, tbh, tbx, tbv, RS,
                                       TR, RW, TW, gscratch, nullptr, nullptr, nullptr);

  for (int e = tid; e < N * F; e += nt) {
    ct_dh[(size_t)b * N * F + e] = P.ct_dh[e];
    cp_dh[(size_t)b * N * F + e] = P.ct_dh[N * F + e];
  }
  for (int e = tid; e < 3 * N; e += nt) {
    const size_t at = ((size_t)(e / N) * B + b) * N + e % N;
    cp_dx[at] = P.cp_dx[e];
    cp_dv[at] = P.cp_dv[e];
    ct_dx[at] = P.ct_dx[e];
    ct_dv[at] = P.ct_dv[e];
  }
}

}  // namespace
}  // namespace sake

extern "C" long long sake_retrace_bwd16_smem_bytes(int B, int N, int F, int H, int R, int K,
                                                   int C, int depth) {
  return sake::retrace16_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}) *
         (long long)sizeof(float);
}

// #17 in the bf16 tier, layer l: the arguments of sake_retrace_bwd without its
// third row set, with L's and LT's four edge weights rounded to bf16;
// resid_ptrs and tresid_ptrs one layer's f32 residual scratch (B, ...);
// row_ptrs the tangent chain's rows and trow_ptrs their tangents, the primal
// chain's rows (B, ...); cp_* and ct_* the chains' cotangents, updated in
// place.
extern "C" int sake_retrace_bwd16(int l, const float* bh, const float* bx, const float* bv,
                                  const float* tbh, const float* tbx, const float* tbv,
                                  const float* upd, const void* const* leaf_ptrs,
                                  const void* const* leaf_t_ptrs, const long long* leaf_strides,
                                  void* const* resid_ptrs, void* const* tresid_ptrs,
                                  void* const* row_ptrs, void* const* trow_ptrs, float* scratch,
                                  float* cp_dh, float* cp_dx, float* cp_dv, float* ct_dh,
                                  float* ct_dx, float* ct_dv, int B, int N, int F, int H, int R,
                                  int K, int C, int depth, void* stream) {
  using namespace sake;
  const Dims d{B, N, F, H, R, K, C, depth};
  const Leaves L = layer_of(leaves_of(leaf_ptrs, leaf_strides), l);
  const Leaves LT = layer_of(leaves_of(leaf_t_ptrs, leaf_strides), l);
  const size_t bo = (size_t)l * B * N * F, xo = (size_t)l * 3 * B * N;
  const size_t smem = retrace16_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(retrace_bwd16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  retrace_bwd16_kernel<<<B, kRetrace16Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      d, bh + bo, bx + xo, bv + xo, tbh + bo, tbx + xo, tbv + xo, upd, l, L, LT,
      resids_of(resid_ptrs), resids_of(tresid_ptrs), rows_of(row_ptrs), rows_of(trow_ptrs),
      scratch, cp_dh, cp_dx, cp_dv, ct_dh, ct_dx, ct_dv);
  return (int)cudaGetLastError();
}
