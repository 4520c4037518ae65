// #17: one layer of the retrace-mode augmented backward of make_ef_train2,
// f32.
//
// Replaces the TPU kernel sake_tpu/kernels/train2_ef.py -> _aug_grad ->
// bwd_kernel (the pallas_call at :464, body :379-456). Per layer in reverse
// that kernel re-traces jax.vjp(jvp(layer)) from the layer's saved
// augmented boundary state (#16's outputs, aug_fwd.cu), pulls the
// cotangents of the augmented state back and sums the parameter gradients
// over its sequential grid. The mathematics of that pullback is #10's (the
// resid mode's comment at :1506 says so): the primal chain c_p through
// layer_bwd_resid, the tangent chain c_t through the jvp of
// layer_bwd_resid, whose tangent (the Hessian term) adds into c_p. So one
// launch of this kernel handles layer l of every molecule:
// - re-forward the layer from its primal boundary (K1's body, fwd_layer,
//   resid_fwd.cuh) into a one-layer, per-molecule residual scratch;
// - the tangent forward of the layer from its tangent boundary (jvp_layer,
//   resid_jvp.cuh) into a second scratch;
// - both chains' pullback on those residuals (aug_pullback_layer:
//   tbwd_layer, bwd_layer with rows, the Hessian terms), carrying c_p and
//   c_t in device memory from one launch to the next (in place: each block
//   reads and writes only its molecule's slot);
// and writes the layer's rows, which the augmented contraction of
// param_grads.cu then sums into the layer's leaf gradients, in order and
// without atomics, before the next launch overwrites scratch and rows. Only
// one layer's residuals are ever alive, which is the point of retrace mode.
//
// Design: one 512-thread block per molecule (the pullback bodies' size;
// the forward bodies loop over the block). The four bodies take turns on
// one work region of shared memory beside the chains' carry, as in
// fused_bwd.cu: about 205 KB at aspirin's N = 21. The residuals pass
// between the bodies through device memory (L2), as between #18 and #19.
//
// What bounds it on an H100: f32 FMA issue and per-row synchronisation of
// the four bodies, one block per SM: a re-forward (K1's products), a
// tangent forward (#9's) and #10's pullback (the tangent pullback's
// products twice, on values and tangents), so about 5 forward-equivalents
// per layer; depth launches plus depth contractions per chunk.

#include "aug_pullback.cuh"
#include "resid_fwd.cuh"
#include "resid_jvp.cuh"

namespace sake {
namespace {

constexpr int kRetraceThreads = 512;

__host__ __device__ inline long long retrace_smem_floats(const Dims& d) {
  long long work = aug_pullback_floats(d);
  work = work > fwd_smem_floats(d) ? work : fwd_smem_floats(d);
  work = work > jvp_smem_floats(d) ? work : jvp_smem_floats(d);
  return carry_floats(d) + work;
}

// Layer l of molecule b; bh ... tbv point at layer l of #16's boundary
// streams, L and LT at layer l's leaves, RS and TR at the one-layer scratch,
// RW, TRW, TTW at one layer's rows; cp_* and ct_* the chains' cotangents
// (B, N, F) and (3, B, N), read and overwritten.
__global__ void __launch_bounds__(kRetraceThreads, 1)
retrace_bwd_kernel(Dims d, const float* __restrict__ bh, const float* __restrict__ bx,
                   const float* __restrict__ bv, const float* __restrict__ tbh,
                   const float* __restrict__ tbx, const float* __restrict__ tbv,
                   const float* __restrict__ upd, int l, Leaves L, Leaves LT, Resids RS,
                   Resids TR, Rows RW, Rows TRW, Rows TTW, float* scratch, float* cp_dh,
                   float* cp_dx, float* cp_dv, float* ct_dh, float* ct_dx, float* ct_dv) {
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

  // the chains' cotangents of the layer's output
  for (int e = tid; e < N * F; e += nt) {
    P.cp_dh[e] = cp_dh[(size_t)b * N * F + e];
    P.ct_dh[e] = ct_dh[(size_t)b * N * F + e];
  }
  for (int e = tid; e < 3 * N; e += nt) {
    const size_t at = ((size_t)(e / N) * B + b) * N + e % N;
    P.cp_dx[e] = cp_dx[at];
    P.cp_dv[e] = cp_dv[at];
    P.ct_dx[e] = ct_dx[at];
    P.ct_dv[e] = ct_dv[at];
  }

  // re-forward the layer from its primal boundary: its residuals
  Carver cf{work};
  const FwdSmem SF = carve_fwd(cf, d);
  fwd_begin(d, SF, B, b, bh, bx, bv, nullptr);
  fwd_layer<true, false>(d, SF, b, 0, u, nullptr, L, nullptr, nullptr, nullptr, RS);

  // its tangent forward from the tangent boundary: their tangents
  Carver cj{work};
  const JvpSmem SJ = carve_jvp(cj, d);
  for (int e = tid; e < N * F; e += nt) SJ.sth[e] = tbh[(size_t)b * N * F + e];
  for (int e = tid; e < 3 * N; e += nt) {
    const size_t at = ((size_t)(e / N) * B + b) * N + e % N;
    SJ.stx[e] = tbx[at];
    SJ.stv[e] = tbv[at];
  }
  __syncthreads();
  jvp_layer(d, SJ, b, 0, u, L, bh, bx, bv, RS, nullptr, nullptr, nullptr, TR);

  // both chains' pullback through the layer, with its rows
  aug_pullback_layer(d, P, work, b, 0, u, L, LT, bh, bx, bv, tbh, tbx, tbv, RS, TR, RW, TRW, TTW,
                     gscratch);

  for (int e = tid; e < N * F; e += nt) {
    cp_dh[(size_t)b * N * F + e] = P.cp_dh[e];
    ct_dh[(size_t)b * N * F + e] = P.ct_dh[e];
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

extern "C" long long sake_retrace_bwd_smem_bytes(int B, int N, int F, int H, int R, int K, int C,
                                                 int depth) {
  return sake::retrace_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}) *
         (long long)sizeof(float);
}

// Layer l: bh, bx, bv, tbh, tbx, tbv are #16's boundary streams (depth, B,
// N, F) and (depth, 3, B, N); resid_ptrs, tresid_ptrs one layer's residual
// scratch (B, ...); row_ptrs, trow_ptrs, ttrow_ptrs one layer's rows (B,
// ...) of the primal chain, of the tangent chain and their tangents; scratch
// B * 2N * (H*K + C) floats; cp_dh (B, N, F), cp_dx, cp_dv (3, B, N) the
// primal chain's cotangents and ct_* the tangent chain's, updated in place.
extern "C" int sake_retrace_bwd(int l, const float* bh, const float* bx, const float* bv,
                                const float* tbh, const float* tbx, const float* tbv,
                                const float* upd, const void* const* leaf_ptrs,
                                const void* const* leaf_t_ptrs, const long long* leaf_strides,
                                void* const* resid_ptrs, void* const* tresid_ptrs,
                                void* const* row_ptrs, void* const* trow_ptrs,
                                void* const* ttrow_ptrs, float* scratch, float* cp_dh,
                                float* cp_dx, float* cp_dv, float* ct_dh, float* ct_dx,
                                float* ct_dv, int B, int N, int F, int H, int R, int K, int C,
                                int depth, void* stream) {
  using namespace sake;
  const Dims d{B, N, F, H, R, K, C, depth};
  const Leaves L = layer_of(leaves_of(leaf_ptrs, leaf_strides), l);
  const Leaves LT = layer_of(leaves_of(leaf_t_ptrs, leaf_strides), l);
  const size_t bo = (size_t)l * B * N * F, xo = (size_t)l * 3 * B * N;
  const size_t smem = retrace_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(retrace_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  retrace_bwd_kernel<<<B, kRetraceThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      d, bh + bo, bx + xo, bv + xo, tbh + bo, tbx + xo, tbv + xo, upd, l, L, LT,
      resids_of(resid_ptrs), resids_of(tresid_ptrs), rows_of(row_ptrs), rows_of(trow_ptrs),
      rows_of(ttrow_ptrs), scratch, cp_dh, cp_dx, cp_dv, ct_dh, ct_dx, ct_dv);
  return (int)cudaGetLastError();
}
