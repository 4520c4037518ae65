// #9: tangent-only forward of the layer stack on saved residuals, f32.
//
// Replaces the TPU kernel sake_tpu/kernels/train2_ef.py -> tfwd_kernel (the
// pallas_call at :1447, body :1397) of the shared-mode training backward,
// which runs layer_jvp_resid (resid_ef.py:791-975) over depth: it pushes
// the tangent state (th, tx, tv) through each layer's map using the primal
// residuals and boundary states K1 (resid_fwd.cu) saved. The seed is
// (0, tx0, 0), tx0 the force cotangent. It writes the tangent boundary
// states, the final tangent state and the 17 tangent residuals, which the
// augmented pullback (resid_tbwd.cu, param_grads.cu) reads. Like the MD17
// training path it serves, it takes no edge mask (layer_jvp_resid's masked
// renormalization tangent stays in the plain version).
//
// The per-layer body is jvp_layer (resid_jvp.cuh), which fused_bwd.cu (#12)
// shares.
//
// Design: K1's, with every primal value read from the residual streams
// instead of recomputed. One thread block per molecule loops over depth with
// the tangent state in shared memory. Per layer the node projections of h
// (a_j, a_i, recomputed for pre = a_j[j] + a_i[i], as in the pullback) and
// of th (their tangents and those of o_j, o_i) go to shared memory; then
// each receiver row i builds its N sender edges' tangents (t_r, t_rbf, the
// filter, t_e0, t_h_e, the softmax jvp over senders, t_he_att = t_h_e (x)
// att + h_e (x) t_att, t_coeff) and pools them into the row's tangent
// pooled vectors and t_hatt_sum; the node MLP's tangents and the x/v
// update follow. Nothing expensive of the primal is recomputed: no exp,
// tanh or wide product of the primal, only elementwise derivatives of
// saved pre-activations.
//
// What bounds it on an H100: as K1, f32 FMA issue and per-row
// synchronisation. Its products are K1's (the x_mixing contraction
// (N x HK) @ (HK x C) per row is most of the FLOPs) plus the two tangent
// node projections, so it costs about one forward. It reads the primal
// residuals (about 0.87 MB per aspirin molecule and layer) and writes as
// many tangent residuals, coalesced row blocks. Tensor cores are a later
// change.

#include "resid_jvp.cuh"

namespace sake {
namespace {

__global__ void __launch_bounds__(256)
resid_jvp_kernel(Dims d, const float* __restrict__ bh, const float* __restrict__ bx,
                 const float* __restrict__ bv, const float* __restrict__ upd, Leaves L,
                 Resids RS, const float* __restrict__ tx0, float* tbh, float* tbx, float* tbv,
                 float* th_fin, float* tx_fin, float* tv_fin, Resids TR) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;

  Carver cv{reinterpret_cast<float*>(smem4)};
  const JvpSmem S = carve_jvp(cv, d);
  jvp_begin(d, S, B, b, tx0);
  for (int l = 0; l < d.depth; ++l)
    jvp_layer(d, S, b, l, upd[l], L, bh, bx, bv, RS, tbh, tbx, tbv, TR);

  for (int e = tid; e < N * F; e += nt) th_fin[(size_t)b * N * F + e] = S.sth[e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    tx_fin[((size_t)k * B + b) * N + i] = S.stx[e];
    tv_fin[((size_t)k * B + b) * N + i] = S.stv[e];
  }
}

}  // namespace
}  // namespace sake

extern "C" long long sake_resid_jvp_smem_bytes(int B, int N, int F, int H, int R, int K, int C,
                                               int depth) {
  return sake::jvp_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}) *
         (long long)sizeof(float);
}

// bh (depth, B, N, F), bx, bv (depth, 3, B, N) and resid_ptrs: K1's boundary
// states and residuals; tx0 (3, B, N): the tangent seed of x. Writes the
// tangent boundaries tbh, tbx, tbv, the final tangent state and the tangent
// residuals (tresid_ptrs, in RESIDS order, K1's shapes).
extern "C" int sake_resid_jvp(const float* bh, const float* bx, const float* bv,
                              const float* upd, const void* const* leaf_ptrs,
                              const long long* leaf_strides, void* const* resid_ptrs,
                              const float* tx0, float* tbh, float* tbx, float* tbv,
                              float* th_fin, float* tx_fin, float* tv_fin,
                              void* const* tresid_ptrs, int B, int N, int F, int H, int R, int K,
                              int C, int depth, void* stream) {
  using namespace sake;
  const Dims d{B, N, F, H, R, K, C, depth};
  Leaves L;
  for (int i = 0; i < kLeaves; ++i) {
    L.p[i] = static_cast<const float*>(leaf_ptrs[i]);
    L.stride[i] = leaf_strides[i];
  }
  Resids RS, TR;
  for (int i = 0; i < kResids; ++i) {
    RS.p[i] = static_cast<float*>(resid_ptrs[i]);
    TR.p[i] = static_cast<float*>(tresid_ptrs[i]);
  }
  const size_t smem = jvp_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(resid_jvp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  resid_jvp_kernel<<<B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      d, bh, bx, bv, upd, L, RS, tx0, tbh, tbx, tbv, th_fin, tx_fin, tv_fin, TR);
  return (int)cudaGetLastError();
}
