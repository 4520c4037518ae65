// #12: the fused training backward of make_ef_train2's fused mode: per
// molecule, the tangent forward, the seed head with the readout gradients,
// and the augmented pullback's two cotangent chains, in one thread block.
// fused_bwd.cu holds the f32 entry, fused_bwd16.cu the one in resid_ef's
// bf16 tier (kE16).
//
// Replaces the TPU kernel sake_tpu/kernels/train2_ef.py -> _fused_bwd_chunk's
// kernel (the pallas_call at :1908, body :1750). With the primal's
// boundary states and residuals (#11's or K1's outputs), h_fin, the force
// cotangent tx0 = g_f and the energy cotangent g_e, each block runs:
// - phase 1, layer_jvp_resid over depth from the seed (0, tx0, 0)
//   (resid_jvp.cuh), writing the tangent boundaries and residuals;
// - the seed head (readout_head.cuh): dh_fin, dth_fin and this molecule's
//   readout gradients, the gradient of S = g_e e - e_dot (:1817-1840);
// - phase 2, per layer in reverse: the tangent pullback of the tangent
//   chain c_t (resid_tbwd.cuh), then K2's rows body on the primal chain c_p
//   (resid_bwd.cuh), then the layer's Hessian terms added to c_p
//   (:1843-1901). Both chains, and the Hessian terms between the two
//   bodies, ride in a shared-memory region of their own; the bodies take
//   turns on the rest.
// It writes dh0 and dx0 (the primal chain's cotangents of the initial h
// and x), the rows of both chains and the tangents of the tangent chain's
// rows, and the readout partials. The layer leaves' gradients are then one
// launch of param_grads.cu's augmented contraction, which also sums the
// readout partials over the molecules in order.
//
// Design: the TPU kernel accumulated every parameter gradient into
// resident output blocks across its sequential grid. A CUDA grid has no
// order, and float atomics would make the cancelling row sums (b_sem) differ
// from run to run, so the contraction stays a second launch. It reads the
// tangent residuals and tangent boundary h (the operands' tangents), so the
// tangent streams are outputs for the whole chunk here, as in shared mode,
// not a per-block scratch. What the fusion removes against shared mode:
// three launches and the torch head between them per chunk, the Hessian
// terms' round trip through device memory, and the tangent chain's rows
// reaching the primal chain through a second pass.
//
// What bounds it on an H100, and the redesign of #12: the clock probe
// (tools/probe_fused.py) put the four x-mixing sites at 36% of the block's
// cycles and the edge products at 27%. All three bodies run here in their
// kTc instantiation: the x-mixing products (the tangent forward's, the
// tangent pullback's 2N rows as two products of N, the primal chain's) and
// the edge products o_f and o1 on the tensor cores in 3xTF32
// (mma_tf32x3.cuh), w_xmix through a per-warp cp.async ring. What bounds it
// now: the mma.sync TF32 rate, the tangent pullback's row work on dual
// numbers, and 128 registers with spills (one block of 512 threads per SM;
// the tangent forward's body, compiled for 256 threads in resid_jvp.cu with
// 216 registers, gets 128 here). The shared memory is nearly full (the ring
// takes two k-steps, 16 KB: 222,480 of 232,448 bytes at aspirin's widths).
// The contraction keeps param_grads.cu's CUDA-core tiles: a 3xTF32 w_xmix
// tile there did not shorten it, since what bounds that launch is forming
// its operands from the rows, element by element, for every output tile.

#pragma once

#include "aug_pullback.cuh"
#include "readout_head.cuh"
#include "resid_jvp.cuh"

namespace sake {
namespace {

constexpr int kFusedThreads = 512;

// The x-mixing and edge products of all three bodies run on the tensor cores
// (mma_tf32x3.cuh): their W ring first, then the carry and the bodies' kTc
// carves. The bf16 tier adds no shared memory.
__host__ __device__ inline long long fused_bwd_smem_floats(const Dims& d, int F0) {
  Carver cv{nullptr};
  cv.take(tc_ring_floats(d));
  carve_carry(cv, d);
  Carver head{nullptr};
  head.take((long long)d.N * d.F);  // h_fin
  long long work = jvp_smem_floats<true>(d) + head.off + train_head_floats(d.N, F0);
  work = work > aug_pullback_floats<true>(d) ? work : aug_pullback_floats<true>(d);
  return cv.off + work;
}

// kE16: resid_ef's bf16 tier, JAX's _fused_bwd_chunk built with
// edge_matmul_dtype=bfloat16 and resid_dtype=bfloat16: phase 1,
// layer_jvp_resid with mm_edge in bf16, its tangent residuals TR stored in
// bf16 but r and t (:1802-1803) and read back widened (:1855-1858), its
// tangent pooled vectors read in its node phase from the f32 scratch tpool16
// (a (3, B, N, C) scratch), since JAX rounds them only on store; the seed head
// in f32 (:1820-1840); phase 2, layer_bwd_resid with mm_edge and mm_edge_t in
// bf16 on the primal chain and its jax.jvp on the tangent chain (:1843-1901),
// every edge product rounding its value operand and its tangent operand apart.
// The primal streams RS are #11's in the tier; the rows stay f32, as JAX's
// pairs are f32 values.
template <bool kE16 = false>
__global__ void __launch_bounds__(kFusedThreads, 1)
fused_bwd_kernel(Dims d, const float* __restrict__ bh, const float* __restrict__ bx,
                 const float* __restrict__ bv, const float* __restrict__ upd, Leaves L,
                 Leaves LT, ResidsOf<kE16> RS, const float* __restrict__ h_fin,
                 const float* __restrict__ tx0, const float* __restrict__ g_e, Readout ro,
                 float* tbh, float* tbx, float* tbv, ResidsOf<kE16> TR, Rows RW, Rows TRW,
                 Rows TTW, float* scratch, float* dh0, float* dx0, float* ro_part,
                 float* tpool16) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const int B = d.B, N = d.N, F = d.F, HK = d.H * d.K, C = d.C;
  const int tid = threadIdx.x, nt = blockDim.x;
  Carver cc{base};
  float* ring = cc.take(tc_ring_floats(d));
  const Carry P = carve_carry(cc, d);
  float* work = base + cc.off;
  // the tangent pullback's device scratch: this block's d_hatt, d_pool_sq
  float* gscratch = scratch + (size_t)blockIdx.x * 2 * N * (HK + C);
  const long long ro_len = readout_grad_floats(F, ro.F0, ro.O);
  SAKE_PROBE_START();

  for (int m = blockIdx.x; m < B; m += gridDim.x) {
    // phase 1: the tangent forward
    Carver cj{work};
    const JvpSmem SJ = carve_jvp<true>(cj, d);
    jvp_begin(d, SJ, B, m, tx0);
    SAKE_PROBE(PR_OTHER);
    for (int l = 0; l < d.depth; ++l)
      jvp_layer<true, kE16>(d, SJ, m, l, upd[l], L, bh, bx, bv, RS, tbh, tbx, tbv, TR, ring,
                            tpool16);

    // the seed head: the chains' seeds and this molecule's readout partials
    float* hs = work + cj.off;
    for (int e = tid; e < N * F; e += nt) hs[e] = h_fin[(size_t)m * N * F + e];
    for (int e = tid; e < 3 * N; e += nt) P.ct_dx[e] = P.ct_dv[e] = P.cp_dx[e] = P.cp_dv[e] = 0.f;
    __syncthreads();
    SAKE_PROBE(PR_OTHER);
    readout_train_head(N, F, ro, g_e[m], hs, SJ.sth, hs + (((long long)N * F + 3) & ~3LL),
                       P.cp_dh, P.ct_dh, ro_part + (size_t)m * ro_len);
    SAKE_PROBE(PR_HEAD);

    // phase 2: both cotangent chains, layer by layer in reverse
    for (int l = d.depth - 1; l >= 0; --l)
      aug_pullback_layer<true, kE16>(d, P, work, m, l, upd[l], L, LT, bh, bx, bv, tbh, tbx, tbv,
                                     RS, TR, RW, TRW, TTW, gscratch, ring);

    for (int e = tid; e < N * F; e += nt) dh0[(size_t)m * N * F + e] = P.cp_dh[e];
    for (int e = tid; e < 3 * N; e += nt)
      dx0[((size_t)(e / N) * B + m) * N + e % N] = P.cp_dx[e];
    __syncthreads();  // the next molecule reuses the shared memory
    SAKE_PROBE(PR_OTHER);
  }
}

// The arguments of sake_fused_bwd; tpool16: kE16's scratch, else null.
template <bool kE16>
int launch_fused_bwd(const float* bh, const float* bx, const float* bv, const float* upd,
                     const void* const* leaf_ptrs, const void* const* leaf_t_ptrs,
                     const long long* leaf_strides, void* const* resid_ptrs, const float* h_fin,
                     const float* tx0, const float* g_e, const Readout& ro, float* tbh,
                     float* tbx, float* tbv, void* const* tresid_ptrs, void* const* row_ptrs,
                     void* const* trow_ptrs, void* const* ttrow_ptrs, float* scratch, float* dh0,
                     float* dx0, float* ro_part, float* tpool16, const Dims& d, void* stream) {
  const Leaves L = leaves_of(leaf_ptrs, leaf_strides), LT = leaves_of(leaf_t_ptrs, leaf_strides);
  const ResidsOf<kE16> RS = resids_as<kE16>(resid_ptrs), TR = resids_as<kE16>(tresid_ptrs);
  const Rows RW = rows_of(row_ptrs), TRW = rows_of(trow_ptrs), TTW = rows_of(ttrow_ptrs);
  const size_t smem = fused_bwd_smem_floats(d, ro.F0) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_bwd_kernel<kE16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_bwd_kernel<kE16><<<d.B, kFusedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      d, bh, bx, bv, upd, L, LT, RS, h_fin, tx0, g_e, ro, tbh, tbx, tbv, TR, RW, TRW, TTW,
      scratch, dh0, dx0, ro_part, tpool16);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sake
