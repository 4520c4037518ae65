// #18 and #16: the augmented forward of make_ef_train2's resid and retrace
// modes, f32: jax.jvp of the layer stack from the primal (h0, x0, v = 0)
// along the tangent seed (0, tx0, 0), tx0 the force cotangent.
//
// Replaces two TPU kernels of sake_tpu/kernels/train2_ef.py:
// - _aug_grad_resid._pipe -> fwd_kernel (#18, the pallas_call at :668, body
//   :584-658), the resid-mode forward: jax.jvp of layer_fwd_resid over depth,
//   streaming the 14 boundary planes of the augmented state (h, x, v and
//   their tangents) entering each layer, both residual sets (primal and
//   tangent, 17 each) and h_fin, th_fin. sake_aug_fwd: kStream.
// - _aug_grad -> fwd_kernel (#16, :330, body :270-326), the retrace-mode
//   forward: the same layers writing only the boundary planes and the final
//   states; its backward (retrace_bwd.cu) re-forwards each layer from them.
//   sake_retrace_fwd: without kStream, the running layer's residuals go to a
//   one-layer, per-molecule device scratch that the next layer overwrites.
// JAX's retrace kernel differentiates depthgrid_ef.layer_forward_wide; it is
// the same layer as layer_fwd_resid (the wide head expansion is the
// hidden-major / head-minor product both kernels index as h*K + k), so both
// run the same bodies. The final x and v of both states are written too.
//
// Design: one thread block per molecule walks the layers with the primal
// and tangent states in shared memory. Per layer it runs K1's body
// (fwd_layer, resid_fwd.cuh), which writes the primal boundary and the
// layer's residuals to device memory, then the tangent forward's body
// (jvp_layer, resid_jvp.cuh) on those residuals, which writes the tangent
// boundary and residuals. One layer's residuals (about 0.87 MB per aspirin
// molecule) do not fit in shared memory, so they pass through device memory
// (L2) between the two bodies, as they do between K1 and #9 in shared mode.
// The primal state entering the layer is copied aside for the tangent body
// (the forward updates its state in place), so the tangent body never reads
// back a boundary this launch wrote. The bodies take turns on one work
// region of shared memory: about 139 KB at aspirin's N = 21.
//
// What bounds it on an H100: the two bodies' f32 FMA issue and per-row
// synchronisation (K1's and #9's), the x_mixing products (N x HK) @ (HK x C)
// per receiver row most of the FLOPs. #18 writes two residual streams (about
// 10.5 MB per aspirin molecule at depth 6); #16 only its scratch, which
// stays in L2 at moderate batch. One 256-thread block per SM (the work
// region is over half the shared memory). Tensor cores are a later change.

#include "resid_fwd.cuh"
#include "resid_jvp.cuh"

namespace sake {
namespace {

constexpr int kAugThreads = 256;

// The states that live across layers: the primal (h, x, v) the forward
// updates in place, its copy entering the layer (the tangent body's primal
// input), the tangent state, and the (unused, unmasked) sender counts.
struct AugState {
  float *h, *x, *v, *h_in, *x_in, *v_in, *th, *tx, *tv, *cnt;
};

__host__ __device__ inline AugState carve_aug(Carver& cv, const Dims& d) {
  const long long N = d.N, F = d.F;
  AugState s;
  s.h = cv.take(N * F);
  s.x = cv.take(3 * N);
  s.v = cv.take(3 * N);
  s.h_in = cv.take(N * F);
  s.x_in = cv.take(3 * N);
  s.v_in = cv.take(3 * N);
  s.th = cv.take(N * F);
  s.tx = cv.take(3 * N);
  s.tv = cv.take(3 * N);
  s.cnt = cv.take(N);
  return s;
}

__host__ __device__ inline long long aug_fwd_smem_floats(const Dims& d) {
  Carver cv{nullptr};
  carve_aug(cv, d);
  const long long f = fwd_smem_floats(d), j = jvp_smem_floats(d);
  return cv.off + (f > j ? f : j);
}

template <bool kStream>
__global__ void __launch_bounds__(kAugThreads, 1)
aug_fwd_kernel(Dims d, const float* __restrict__ h0, const float* __restrict__ xs,
               const float* __restrict__ tx0, const float* __restrict__ upd, Leaves L, float* bh,
               float* bx, float* bv, float* tbh, float* tbx, float* tbv, float* h_fin,
               float* x_fin, float* v_fin, float* th_fin, float* tx_fin, float* tv_fin,
               Resids RS, Resids TR) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  Carver cs{base};
  const AugState A = carve_aug(cs, d);
  float* work = base + cs.off;

  for (int e = tid; e < N * F; e += nt) {
    A.h[e] = h0[(size_t)b * N * F + e];
    A.th[e] = 0.f;
  }
  for (int e = tid; e < 3 * N; e += nt) {
    const size_t at = ((size_t)(e / N) * B + b) * N + e % N;
    A.x[e] = xs[at];
    A.tx[e] = tx0[at];
    A.v[e] = A.tv[e] = 0.f;
  }
  for (int i = tid; i < N; i += nt) A.cnt[i] = 0.f;
  __syncthreads();

  for (int l = 0; l < d.depth; ++l) {
    const Leaves Ll = layer_of(L, l);
    const Resids RSl = kStream ? layer_of(RS, d, l) : RS;
    const Resids TRl = kStream ? layer_of(TR, d, l) : TR;
    const size_t bo = (size_t)l * B * N * F, xo = (size_t)l * 3 * B * N;
    for (int e = tid; e < N * F; e += nt) A.h_in[e] = A.h[e];
    for (int e = tid; e < 3 * N; e += nt) {
      A.x_in[e] = A.x[e];
      A.v_in[e] = A.v[e];
    }
    __syncthreads();

    Carver cf{work};
    FwdSmem SF = carve_fwd(cf, d);
    SF.sh = A.h;
    SF.sx = A.x;
    SF.sv = A.v;
    SF.scnt = A.cnt;
    fwd_layer<true, true>(d, SF, b, 0, upd[l], nullptr, Ll, bh + bo, bx + xo, bv + xo, RSl);

    Carver cj{work};
    JvpSmem SJ = carve_jvp(cj, d);
    SJ.sth = A.th;
    SJ.stx = A.tx;
    SJ.stv = A.tv;
    SJ.sh = A.h_in;
    SJ.sx = A.x_in;
    SJ.sv = A.v_in;
    jvp_layer(d, SJ, b, 0, upd[l], Ll, nullptr, nullptr, nullptr, RSl, tbh + bo, tbx + xo,
              tbv + xo, TRl);
  }

  for (int e = tid; e < N * F; e += nt) {
    h_fin[(size_t)b * N * F + e] = A.h[e];
    th_fin[(size_t)b * N * F + e] = A.th[e];
  }
  for (int e = tid; e < 3 * N; e += nt) {
    const size_t at = ((size_t)(e / N) * B + b) * N + e % N;
    x_fin[at] = A.x[e];
    v_fin[at] = A.v[e];
    tx_fin[at] = A.tx[e];
    tv_fin[at] = A.tv[e];
  }
}

template <bool kStream>
int launch_aug(const Dims& d, const float* h0, const float* xs, const float* tx0,
               const float* upd, const void* const* leaf_ptrs, const long long* leaf_strides,
               float* const* outs, void* const* resid_ptrs, void* const* tresid_ptrs,
               void* stream) {
  const Leaves L = leaves_of(leaf_ptrs, leaf_strides);
  const Resids RS = resids_of(resid_ptrs), TR = resids_of(tresid_ptrs);
  const size_t smem = aug_fwd_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(aug_fwd_kernel<kStream>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  aug_fwd_kernel<kStream><<<d.B, kAugThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      d, h0, xs, tx0, upd, L, outs[0], outs[1], outs[2], outs[6], outs[7], outs[8], outs[3],
      outs[4], outs[5], outs[9], outs[10], outs[11], RS, TR);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sake

extern "C" long long sake_aug_fwd_smem_bytes(int B, int N, int F, int H, int R, int K, int C,
                                             int depth) {
  return sake::aug_fwd_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}) *
         (long long)sizeof(float);
}

// h0 (B, N, F), xs and tx0 (3, B, N): the embedded input, the positions and
// the tangent seed. Writes the primal's bh (depth, B, N, F), bx, bv (depth,
// 3, B, N), h_fin (B, N, F), x_fin, v_fin (3, B, N), then the tangent's six
// in the same layouts, and the residuals (resid_ptrs, RESIDS order, K1's
// shapes (depth, B, ...)) and their tangents (tresid_ptrs).
extern "C" int sake_aug_fwd(const float* h0, const float* xs, const float* tx0, const float* upd,
                            const void* const* leaf_ptrs, const long long* leaf_strides,
                            float* bh, float* bx, float* bv, float* h_fin, float* x_fin,
                            float* v_fin, float* tbh, float* tbx, float* tbv, float* th_fin,
                            float* tx_fin, float* tv_fin, void* const* resid_ptrs,
                            void* const* tresid_ptrs, int B, int N, int F, int H, int R, int K,
                            int C, int depth, void* stream) {
  float* const outs[12] = {bh, bx, bv, h_fin, x_fin, v_fin, tbh, tbx, tbv, th_fin, tx_fin, tv_fin};
  return sake::launch_aug<true>(sake::Dims{B, N, F, H, R, K, C, depth}, h0, xs, tx0, upd,
                                leaf_ptrs, leaf_strides, outs, resid_ptrs, tresid_ptrs, stream);
}

// As sake_aug_fwd, but resid_ptrs and tresid_ptrs are one layer's scratch
// (B, ...), which every layer overwrites.
extern "C" int sake_retrace_fwd(const float* h0, const float* xs, const float* tx0,
                                const float* upd, const void* const* leaf_ptrs,
                                const long long* leaf_strides, float* bh, float* bx, float* bv,
                                float* h_fin, float* x_fin, float* v_fin, float* tbh, float* tbx,
                                float* tbv, float* th_fin, float* tx_fin, float* tv_fin,
                                void* const* resid_ptrs, void* const* tresid_ptrs, int B, int N,
                                int F, int H, int R, int K, int C, int depth, void* stream) {
  float* const outs[12] = {bh, bx, bv, h_fin, x_fin, v_fin, tbh, tbx, tbv, th_fin, tx_fin, tv_fin};
  return sake::launch_aug<false>(sake::Dims{B, N, F, H, R, K, C, depth}, h0, xs, tx0, upd,
                                 leaf_ptrs, leaf_strides, outs, resid_ptrs, tresid_ptrs, stream);
}
