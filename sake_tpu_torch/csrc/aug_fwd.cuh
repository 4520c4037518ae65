// #18's and #16's kernel (aug_fwd.cu; the design there): the augmented forward
// of make_ef_train2's resid and retrace modes, K1's and #9's bodies per layer in
// one block per molecule. aug_fwd16.cu runs it in resid_ef's bf16 tier (kE16).
#pragma once

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

// Molecule b's slice of the one-layer f32 scratch RS (slot b of d.B) to layer
// l of the depth streams O: bf16 but r and t, rounded as JAX's astype rounds.
__device__ __forceinline__ void store_layer16(const Dims& d, int b, int l, const Resids& RS,
                                              const Resids16& O) {
  for (int r = 0; r < kResids; ++r) {
    const long long n = (long long)d.N * (r <= RS_COEFF ? d.N : 1) * resid_width(r, d);
    const float* src = RS.p[r] + (size_t)b * n;
    const size_t at = ((size_t)l * d.B + b) * n;
    if (r == RS_R || r == RS_T) {
      float* dst = (r == RS_R ? res_r(O) : res_t(O)) + at;
      for (long long e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
    } else {
      for (long long e = threadIdx.x; e < n; e += blockDim.x) put_res(O.p[r] + at, e, src[e]);
    }
  }
}

// kStream: #18, else #16 (see the top). kE16: resid_ef's bf16 tier (JAX's
// kernels built with edge_matmul_dtype and resid_dtype bf16): fwd_layer's and
// jvp_layer's kE16 products without bf16 storage (kLowRes false), so that the
// tangent body reads the primal's f32 residuals, as JAX's jax.jvp of the layer
// computes the tangent from the f32 values; RS and TR are then one-layer f32
// scratches (slot b of d.B) for #16 and for #18, and #18 stores each layer's
// residuals of both from them into its depth streams, the two Resids16 of Out.
template <bool kStream, bool kE16 = false, class... Out>
__global__ void __launch_bounds__(kAugThreads, 1)
aug_fwd_kernel(Dims d, const float* __restrict__ h0, const float* __restrict__ xs,
               const float* __restrict__ tx0, const float* __restrict__ upd, Leaves L, float* bh,
               float* bx, float* bv, float* tbh, float* tbx, float* tbv, float* h_fin,
               float* x_fin, float* v_fin, float* th_fin, float* tx_fin, float* tv_fin,
               Resids RS, Resids TR, Out... out16) {
  static_assert(sizeof...(Out) == (kE16 && kStream ? 2 : 0), "#18's bf16 streams");
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
    const Resids RSl = kStream && !kE16 ? layer_of(RS, d, l) : RS;
    const Resids TRl = kStream && !kE16 ? layer_of(TR, d, l) : TR;
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
    fwd_layer<true, true, false, false, false, kTcWarps, kE16, false>(
        d, SF, b, 0, upd[l], nullptr, Ll, bh + bo, bx + xo, bv + xo, RSl);

    Carver cj{work};
    JvpSmem SJ = carve_jvp(cj, d);
    SJ.sth = A.th;
    SJ.stx = A.tx;
    SJ.stv = A.tv;
    SJ.sh = A.h_in;
    SJ.sx = A.x_in;
    SJ.sv = A.v_in;
    jvp_layer<false, kE16, false>(d, SJ, b, 0, upd[l], Ll, nullptr, nullptr, nullptr, RSl,
                                  tbh + bo, tbx + xo, tbv + xo, TRl);
    if constexpr (sizeof...(Out) == 2) {
      const Resids16 O[2] = {out16...};
      store_layer16(d, b, l, RSl, O[0]);
      store_layer16(d, b, l, TRl, O[1]);
      __syncthreads();  // the next layer overwrites the scratch
    }
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

// outs: the primal's bh, bx, bv, h_fin, x_fin, v_fin, then the tangent's;
// resid_ptrs, tresid_ptrs: the streams, or with kE16 the one-layer scratches;
// Out: with kE16 and kStream, #18's bf16 streams (Resids16 of the primal, then
// of the tangent).
template <bool kStream, bool kE16 = false, class... Out>
int launch_aug(const Dims& d, const float* h0, const float* xs, const float* tx0,
               const float* upd, const void* const* leaf_ptrs, const long long* leaf_strides,
               float* const* outs, void* const* resid_ptrs, void* const* tresid_ptrs,
               void* stream, Out... out16) {
  const Leaves L = leaves_of(leaf_ptrs, leaf_strides);
  const Resids RS = resids_of(resid_ptrs), TR = resids_of(tresid_ptrs);
  const size_t smem = aug_fwd_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(aug_fwd_kernel<kStream, kE16, Out...>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  aug_fwd_kernel<kStream, kE16, Out...>
      <<<d.B, kAugThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          d, h0, xs, tx0, upd, L, outs[0], outs[1], outs[2], outs[6], outs[7], outs[8], outs[3],
          outs[4], outs[5], outs[9], outs[10], outs[11], RS, TR, out16...);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sake
