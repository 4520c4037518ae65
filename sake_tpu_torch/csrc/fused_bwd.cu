// #12: the fused training backward of make_ef_train2's fused mode, f32: per
// molecule, the tangent forward, the seed head with the readout gradients,
// and the augmented pullback's two cotangent chains, in one thread block.
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
// What bounds it on an H100: as the three bodies, f32 FMA issue and per-row
// synchronisation, one block of 512 threads per SM. The tangent forward's
// body, compiled for 256 threads in resid_jvp.cu (216 registers), gets 128
// registers here.

#include "readout_head.cuh"
#include "resid_bwd.cuh"
#include "resid_jvp.cuh"
#include "resid_tbwd.cuh"

namespace sake {
namespace {

constexpr int kFusedThreads = 512;

// The two chains' state and the Hessian terms: the tangent chain's dual dh
// (values: its state; tangents: the layer's Hessian term of h), dx, dv and
// the dual sender / receiver sums and d_v_in whose tangents are the Hessian
// terms of x and v; the primal chain's dh, dx, dv.
struct Carry {
  float *ct_dh, *ct_dx, *ct_dv, *ct_dxs, *ct_dxr, *ct_dvo, *cp_dh, *cp_dx, *cp_dv;
};

__host__ __device__ inline Carry carve_carry(Carver& cv, const Dims& d) {
  const long long N = d.N, F = d.F;
  Carry c;
  c.ct_dh = cv.take(2 * N * F);
  c.ct_dx = cv.take(3 * N);
  c.ct_dv = cv.take(3 * N);
  c.ct_dxs = cv.take(6 * N);
  c.ct_dxr = cv.take(6 * N);
  c.ct_dvo = cv.take(6 * N);
  c.cp_dh = cv.take(N * F);
  c.cp_dx = cv.take(3 * N);
  c.cp_dv = cv.take(3 * N);
  return c;
}

__host__ __device__ inline long long fused_bwd_smem_floats(const Dims& d, int F0) {
  Carver cv{nullptr};
  carve_carry(cv, d);
  Carver head{nullptr};
  head.take((long long)d.N * d.F);  // h_fin
  long long work = jvp_smem_floats(d) + head.off + train_head_floats(d.N, F0);
  work = work > tb_smem_floats(d) ? work : tb_smem_floats(d);
  work = work > bwd_smem_floats(d) ? work : bwd_smem_floats(d);
  return cv.off + work;
}

__global__ void __launch_bounds__(kFusedThreads, 1)
fused_bwd_kernel(Dims d, const float* __restrict__ bh, const float* __restrict__ bx,
                 const float* __restrict__ bv, const float* __restrict__ upd, Leaves L,
                 Leaves LT, Resids RS, const float* __restrict__ h_fin,
                 const float* __restrict__ tx0, const float* __restrict__ g_e, Readout ro,
                 float* tbh, float* tbx, float* tbv, Resids TR, Rows RW, Rows TRW, Rows TTW,
                 float* scratch, float* dh0, float* dx0, float* ro_part) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const int B = d.B, N = d.N, F = d.F, HK = d.H * d.K, C = d.C;
  const int tid = threadIdx.x, nt = blockDim.x;
  Carver cc{base};
  const Carry P = carve_carry(cc, d);
  float* work = base + cc.off;
  // the tangent pullback's device scratch: this block's d_hatt, d_pool_sq
  float* gscratch = scratch + (size_t)blockIdx.x * 2 * N * (HK + C);
  const long long ro_len = readout_grad_floats(F, ro.F0, ro.O);

  for (int m = blockIdx.x; m < B; m += gridDim.x) {
    // phase 1: the tangent forward
    Carver cj{work};
    const JvpSmem SJ = carve_jvp(cj, d);
    jvp_begin(d, SJ, B, m, tx0);
    for (int l = 0; l < d.depth; ++l)
      jvp_layer(d, SJ, m, l, upd[l], L, bh, bx, bv, RS, tbh, tbx, tbv, TR);

    // the seed head: the chains' seeds and this molecule's readout partials
    float* hs = work + cj.off;
    for (int e = tid; e < N * F; e += nt) hs[e] = h_fin[(size_t)m * N * F + e];
    for (int e = tid; e < 3 * N; e += nt) P.ct_dx[e] = P.ct_dv[e] = P.cp_dx[e] = P.cp_dv[e] = 0.f;
    __syncthreads();
    readout_train_head(N, F, ro, g_e[m], hs, SJ.sth, hs + (((long long)N * F + 3) & ~3LL),
                       P.cp_dh, P.ct_dh, ro_part + (size_t)m * ro_len);

    // phase 2: both cotangent chains, layer by layer in reverse
    for (int l = d.depth - 1; l >= 0; --l) {
      Carver ct{work};
      TbSmem ST = carve_tb(ct, d);
      ST.sdh = P.ct_dh;
      ST.sdx = P.ct_dx;
      ST.sdv = P.ct_dv;
      ST.sdxs = P.ct_dxs;
      ST.sdxr = P.ct_dxr;
      ST.sdvo = P.ct_dvo;
      tbwd_layer(d, ST, m, l, upd[l], L, LT, bh, bx, bv, tbh, tbx, tbv, RS, TR, TRW, TTW,
                 gscratch, nullptr, nullptr, nullptr);
      Carver cb{work};
      BwdSmem SB = carve_bwd(cb, d);
      SB.sdh = P.cp_dh;
      SB.sdx = P.cp_dx;
      SB.sdv = P.cp_dv;
      bwd_layer<true>(d, SB, m, l, upd[l], nullptr, L, LT, bh, bx, bv, RS, RW, nullptr,
                      nullptr, nullptr);
      // the layer's Hessian terms, the tangents the tangent pullback left
      for (int e = tid; e < N * F; e += nt) P.cp_dh[e] += P.ct_dh[N * F + e];
      for (int e = tid; e < 3 * N; e += nt) {
        P.cp_dx[e] += P.ct_dxs[3 * N + e] - P.ct_dxr[3 * N + e];
        P.cp_dv[e] += P.ct_dvo[3 * N + e];
      }
      __syncthreads();
    }

    for (int e = tid; e < N * F; e += nt) dh0[(size_t)m * N * F + e] = P.cp_dh[e];
    for (int e = tid; e < 3 * N; e += nt)
      dx0[((size_t)(e / N) * B + m) * N + e % N] = P.cp_dx[e];
    __syncthreads();  // the next molecule reuses the shared memory
  }
}

}  // namespace
}  // namespace sake

extern "C" long long sake_fused_bwd_smem_bytes(int B, int N, int F, int H, int R, int K, int C,
                                               int depth, int F0) {
  return sake::fused_bwd_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}, F0) *
         (long long)sizeof(float);
}

// bh, bx, bv, resid_ptrs: the primal's boundary states and residuals; h_fin
// (B, N, F); tx0 (3, B, N) the force cotangent; g_e (B,) the energy
// cotangent; w0, b0, w1, b1, w0t the readout as in sake_fused_primal.
// Writes the tangent boundaries tbh, tbx, tbv and residuals (tresid_ptrs),
// the rows of the primal chain (row_ptrs), of the tangent chain (trow_ptrs)
// and their tangents (ttrow_ptrs), dh0 (B, N, F), dx0 (3, B, N) and ro_part
// (B, F*F0 + F0 + F0*O + O). scratch: B * 2N * (H*K + C) floats.
extern "C" int sake_fused_bwd(const float* bh, const float* bx, const float* bv,
                              const float* upd, const void* const* leaf_ptrs,
                              const void* const* leaf_t_ptrs, const long long* leaf_strides,
                              void* const* resid_ptrs, const float* h_fin, const float* tx0,
                              const float* g_e, const float* w0, const float* b0,
                              const float* w1, const float* b1, const float* w0t, float* tbh,
                              float* tbx, float* tbv, void* const* tresid_ptrs,
                              void* const* row_ptrs, void* const* trow_ptrs,
                              void* const* ttrow_ptrs, float* scratch, float* dh0, float* dx0,
                              float* ro_part, int B, int N, int F, int H, int R, int K, int C,
                              int depth, int F0, int O, void* stream) {
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
  Rows RW, TRW, TTW;
  for (int i = 0; i < kRows; ++i) {
    RW.p[i] = static_cast<float*>(row_ptrs[i]);
    TRW.p[i] = static_cast<float*>(trow_ptrs[i]);
    TTW.p[i] = static_cast<float*>(ttrow_ptrs[i]);
  }
  const Readout ro{w0, b0, w1, b1, w0t, F0, O};
  const size_t smem = fused_bwd_smem_floats(d, F0) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_bwd_kernel<<<B, kFusedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      d, bh, bx, bv, upd, L, LT, RS, h_fin, tx0, g_e, ro, tbh, tbx, tbv, TR, RW, TRW, TTW,
      scratch, dh0, dx0, ro_part);
  return (int)cudaGetLastError();
}
