// The energy readout head inside the fused kernels, f32 on the CUDA cores:
// out = silu(h @ w0 + b0) @ w1 + b1 per atom, the energy e = sum over atoms
// (times the node mask, when there is one) and outputs. The JAX fused
// kernels run this head at HIGHEST precision (train2_ef.py:205-213); here
// every product is f32.
//
// - readout_seed_head (#11, #3): e and its seed dh = de/dh, the cotangent
//   that starts the force pullback (torch: resid_ef._readout_seed);
// - readout_train_head (#12): the seed head of the training backward, the
//   gradient of S = g_e e - e_dot, e_dot the tangent of e along th, w.r.t.
//   h, th and the four readout leaves (torch: train2_ef.head_grads).
#pragma once

#include "resid_common.cuh"

namespace sake {

struct Readout {
  const float *w0, *b0, *w1, *b1;  // (F, F0), (F0), (F0, O), (O)
  const float* w0t;                // (F0, F): w0 transposed, for the seeds
  int F0, O;
  // sum_o w1[c, o] and sum_o b1[o]: each atom's energy sums its outputs
  __device__ __forceinline__ float w1s(int c) const {
    float s = 0.f;
    for (int o = 0; o < O; ++o) s += w1[c * O + o];
    return s;
  }
  __device__ __forceinline__ float b1s() const {
    float s = 0.f;
    for (int o = 0; o < O; ++o) s += b1[o];
    return s;
  }
};

template <class ST>
__device__ __forceinline__ void mm_head(int n, int kd, int m, const float* A, int lda,
                                        const float* __restrict__ W, ST st) {
  mm_smem<4, 16>(n, kd, m, A, lda, W, st);
}

// Floats of shared memory readout_seed_head takes: the (N, F0) buffer and
// the block reduction's per-warp doubles.
__host__ __device__ inline long long seed_head_floats(int N, int F0) {
  Carver cv{nullptr};
  cv.take((long long)N * F0);
  cv.take(2 * 32);
  return cv.off;
}

// e (into *e_out, by thread 0) and dh = de/dh (into dh, (N, F), which may
// alias h) for one molecule whose final h (N, F) is in shared memory. mb:
// its (N, N) edge mask (the node mask is its diagonal) or null. buf: the
// seed_head_floats of shared memory. Ends with a barrier.
__device__ __forceinline__ void readout_seed_head(int N, int F, const Readout& ro,
                                                  const float* h, const float* mb, float* buf,
                                                  float* dh, float* e_out) {
  const int F0 = ro.F0, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
  float* Z = buf;
  double* red = reinterpret_cast<double*>(buf + (((long long)N * F0 + 3) & ~3LL));
  mm_head(N, F, F0, h, F, ro.w0, [&](int r, int c, float a) { Z[r * F0 + c] = a + ro.b0[c]; });
  __syncthreads();
  // e = sum_i m_i (sum_c silu(z_ic) w1s_c + b1s); dz = m_i dsilu(z_ic) w1s_c (in place)
  double acc = 0.0;
  for (int e = tid; e < N * F0; e += nt) {
    const int i = e / F0, c = e % F0;
    const float nm = mb ? mb[i * N + i] : 1.f;
    const float z = Z[e], w = ro.w1s(c);
    acc += (double)(nm * siluf_(z) * w);
    Z[e] = nm * dsiluf_(z) * w;
  }
  if (tid < N) acc += (double)((mb ? mb[tid * N + tid] : 1.f) * ro.b1s());
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < nwarp; ++w) s += red[w];
    *e_out = (float)s;
  }
  mm_head(N, F0, F, Z, F0, ro.w0t, [&](int r, int c, float a) { dh[r * F + c] = a; });
  __syncthreads();
}

// Floats of shared memory readout_train_head takes: four (N, F0) buffers.
__host__ __device__ inline long long train_head_floats(int N, int F0) {
  Carver cv{nullptr};
  for (int q = 0; q < 4; ++q) cv.take((long long)N * F0);
  return cv.off;
}

// Length of one molecule's readout-gradient partials: d_w0 (F, F0), d_b0
// (F0), d_w1 (F0, O), d_b1 (O).
__host__ __device__ inline long long readout_grad_floats(int F, int F0, int O) {
  return (long long)F * F0 + F0 + (long long)F0 * O + O;
}

// The seed head of the training backward for one molecule: h (N, F) its
// final state and th (N, F) its tangent, both in shared memory; ge its
// energy cotangent. With z = h
// w0 + b0, tz = th w0 and S = ge e - e_dot:
//   gz = dS/dz = w1s (ge silu'(z) - silu''(z) tz), gtz = dS/dtz = -w1s silu'(z),
//   dh = gz w0^T, dth = gtz w0^T (into dh, dth: shared memory),
//   d_w0 = h^T gz + th^T gtz, d_b0 = sum_i gz, d_w1[c, o] = sum_i (ge silu(z) -
//   silu'(z) tz)[i, c], d_b1[o] = ge N (into part, device memory).
// buf: train_head_floats of shared memory. Ends with a barrier.
__device__ __forceinline__ void readout_train_head(int N, int F, const Readout& ro, float ge,
                                                   const float* h, const float* th, float* buf,
                                                   float* dh, float* dth, float* part) {
  const int F0 = ro.F0, O = ro.O, tid = threadIdx.x, nt = blockDim.x;
  const long long slot = ((long long)N * F0 + 3) & ~3LL;
  float *Z = buf, *TZ = buf + slot, *A = buf + 2 * slot;
  mm_head(N, F, F0, h, F, ro.w0, [&](int r, int c, float a) { Z[r * F0 + c] = a + ro.b0[c]; });
  mm_head(N, F, F0, th, F, ro.w0, [&](int r, int c, float a) { TZ[r * F0 + c] = a; });
  __syncthreads();
  for (int e = tid; e < N * F0; e += nt) {
    const float z = Z[e], tz = TZ[e], w = ro.w1s(e % F0);
    const float s = sigmoidf_(z);
    const float d1 = s * (1.f + z * (1.f - s));                // silu'
    const float d2 = s * (1.f - s) * (2.f + z * (1.f - 2.f * s));  // silu''
    A[e] = ge * (z * s) - d1 * tz;
    Z[e] = w * (ge * d1 - d2 * tz);
    TZ[e] = -w * d1;
  }
  __syncthreads();
  mm_head(N, F0, F, Z, F0, ro.w0t, [&](int r, int c, float a) { dh[r * F + c] = a; });
  mm_head(N, F0, F, TZ, F0, ro.w0t, [&](int r, int c, float a) { dth[r * F + c] = a; });
  for (int q = tid; q < F * F0; q += nt) {
    const int r = q / F0, c = q % F0;
    float s = 0.f;
    for (int i = 0; i < N; ++i) s += h[i * F + r] * Z[i * F0 + c] + th[i * F + r] * TZ[i * F0 + c];
    part[q] = s;
  }
  float* pb0 = part + (long long)F * F0;
  float* pw1 = pb0 + F0;
  float* pb1 = pw1 + (long long)F0 * O;
  for (int c = tid; c < F0; c += nt) {
    float s = 0.f, a = 0.f;
    for (int i = 0; i < N; ++i) {
      s += Z[i * F0 + c];
      a += A[i * F0 + c];
    }
    pb0[c] = s;
    for (int o = 0; o < O; ++o) pw1[c * O + o] = a;
  }
  for (int o = tid; o < O; o += nt) pb1[o] = ge * (float)N;
  __syncthreads();
}

}  // namespace sake
