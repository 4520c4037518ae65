// #5's cluster kernel: K2 with its rows (resid_bwd.cu's kRows instantiation,
// make_hidden_fn's training pullback, sake_tpu/kernels/resid_ef.py:1680, body
// :1598) with one molecule per thread-block cluster of two CTAs.
//
// Design: at QM9's batch of 64, one block a molecule leaves 68 of an H100's
// 132 SMs idle, and a block walks its 29 receiver rows one at a time. Here a
// molecule takes a cluster of two CTAs on two SMs (cluster.cuh). Each keeps the
// cotangent state of its own nodes and runs the node part and the row loop for
// half of the receivers (bwd_layer_cl, resid_bwd_cl.cuh). Receiver rows are
// independent; only the sender-side sums (d_a_j, d_o_j, +d_d0) couple the
// halves: each CTA accumulates its receivers' part, and after a cluster barrier
// adds the other CTA's part of its own senders through distributed shared
// memory, rank 0's + rank 1's in both, so the result does not depend on
// scheduling. Halving the receiver-indexed buffers (29.7 KB each for d_hatt and
// d_pool_sq at N = 29) frees the room the tensor-core route needs: the padded
// d_xm rows and the 16 KB W ring, so the x-mixing pullback and the edge
// products run in 3xTF32 (mma_tf32x3.cuh, four n8 tiles) up to N = 32. Every
// row goes to the one-block kernel's place, so param_grads.cu and the plain
// versions read the same rows. No addend: #10's and #19's launches keep the
// one-block kernel. make_hidden_fn's calls take this kernel at every batch: on
// an H100 at N = 29 it measured 0.39-0.76x the one-block kernel's time from B =
// 64 to 256 (tools/probe_resid.py --phases sweep).

#include "resid_bwd_cl.cuh"

namespace sake {

constexpr int kClBwdThreads = 512;

// The kernel's shared memory, in floats: the W ring of the tensor-core
// products, then the cluster body's carve.
__host__ __device__ inline long long bwd_cl_smem_floats(const Dims& d) {
  return tc_ring_floats_of<true>(d) + bwd_cl_floats(d);
}

// Molecule blockIdx.x / 2, receiver rows of cluster rank blockIdx.x % 2
// (launched with clusters of kClSize along x).
__global__ void __launch_bounds__(kClBwdThreads, 1)
resid_bwd_cl_kernel(Dims d, const float* __restrict__ bh, const float* __restrict__ bx,
                    const float* __restrict__ bv, const float* __restrict__ upd,
                    const float* __restrict__ mask, Leaves L, Leaves LT, Resids RS,
                    const float* __restrict__ dh_fin, const float* __restrict__ dx_fin,
                    const float* __restrict__ dv_fin, float* dh_out, float* dx_out,
                    float* dv_out, Rows RW) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x / kClSize;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* mb = mask ? mask + (size_t)b * N * N : nullptr;

  Carver cv{reinterpret_cast<float*>(smem4)};
  float* ring = cv.take(tc_ring_floats_of<true>(d));
  const BwdSmem S = carve_bwd_cl(cv, d);
  SAKE_PROBE_START();
  bwd_begin(d, S, B, b, dh_fin, dx_fin, dv_fin, mb);
  cl_arrive();  // each layer waits before it zeroes its sender sums
  for (int l = d.depth - 1; l >= 0; --l)
    bwd_layer_cl(d, S, b, l, upd[l], mb, L, LT, bh, bx, bv, RS, RW, ring);
  cl_wait();  // the other CTA has read this one's last sums: its memory may go

  int i0, i1;  // this CTA's nodes
  cl_rows(N, cl_rank(), i0, i1);
  const int nn = i1 - i0;
  for (int e = tid; e < nn * F; e += nt)
    dh_out[((size_t)b * N + i0) * F + e] = S.sdh[i0 * F + e];
  for (int e = tid; e < 3 * nn; e += nt) {
    const int k = e / nn, i = i0 + e % nn;
    dx_out[((size_t)k * B + b) * N + i] = S.sdx[k * N + i];
    dv_out[((size_t)k * B + b) * N + i] = S.sdv[k * N + i];
  }
}

// #5's rows kernel in resid_ef's bf16 tier (bwd_layer_cl's kE16): the kernel
// above on the bf16 residual streams, LT's edge weights rounded.
__global__ void __launch_bounds__(kClBwdThreads, 1)
resid_bwd_cl16_kernel(Dims d, const float* __restrict__ bh, const float* __restrict__ bx,
                      const float* __restrict__ bv, const float* __restrict__ upd,
                      const float* __restrict__ mask, Leaves L, Leaves LT, Resids16 RS,
                      const float* __restrict__ dh_fin, const float* __restrict__ dx_fin,
                      const float* __restrict__ dv_fin, float* dh_out, float* dx_out,
                      float* dv_out, Rows RW) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x / kClSize;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* mb = mask ? mask + (size_t)b * N * N : nullptr;

  Carver cv{reinterpret_cast<float*>(smem4)};
  float* ring = cv.take(tc_ring_floats_of<true>(d));
  const BwdSmem S = carve_bwd_cl(cv, d);
  SAKE_PROBE_START();
  bwd_begin(d, S, B, b, dh_fin, dx_fin, dv_fin, mb);
  cl_arrive();
  for (int l = d.depth - 1; l >= 0; --l)
    bwd_layer_cl<true>(d, S, b, l, upd[l], mb, L, LT, bh, bx, bv, RS, RW, ring);
  cl_wait();

  int i0, i1;
  cl_rows(N, cl_rank(), i0, i1);
  const int nn = i1 - i0;
  for (int e = tid; e < nn * F; e += nt)
    dh_out[((size_t)b * N + i0) * F + e] = S.sdh[i0 * F + e];
  for (int e = tid; e < 3 * nn; e += nt) {
    const int k = e / nn, i = i0 + e % nn;
    dx_out[((size_t)k * B + b) * N + i] = S.sdx[k * N + i];
    dv_out[((size_t)k * B + b) * N + i] = S.sdv[k * N + i];
  }
}

}  // namespace sake

extern "C" long long sake_resid_bwd_cluster_smem_bytes(int B, int N, int F, int H, int R,
                                                       int K, int C, int depth) {
  sake::Dims d{B, N, F, H, R, K, C, depth};
  return sake::bwd_cl_smem_floats(d) * (long long)sizeof(float);
}

// Clusters of the kernel the card holds at once; negative: a CUDA error.
extern "C" int sake_resid_bwd_cluster_max_active(int B, int N, int F, int H, int R, int K,
                                                 int C, int depth) {
  sake::Dims d{B, N, F, H, R, K, C, depth};
  const size_t smem = sake::bwd_cl_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sake::resid_bwd_cl_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sake::cl_config(B, sake::kClBwdThreads, smem, nullptr, &attr);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, (const void*)sake::resid_bwd_cl_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// #5's cluster route with the rows: the arguments of sake_resid_bwd_rows but
// the addend. A refused launch returns its error.
extern "C" int sake_resid_bwd_rows_cluster(const float* bh, const float* bx, const float* bv,
                                           const float* upd, const float* mask,
                                           const void* const* leaf_ptrs,
                                           const void* const* leaf_t_ptrs,
                                           const long long* leaf_strides,
                                           void* const* resid_ptrs, const float* dh_fin,
                                           const float* dx_fin, const float* dv_fin,
                                           float* dh_out, float* dx_out, float* dv_out,
                                           void* const* row_ptrs, int B, int N, int F, int H,
                                           int R, int K, int C, int depth, void* stream) {
  const sake::Dims d{B, N, F, H, R, K, C, depth};
  const sake::Leaves L = sake::leaves_of(leaf_ptrs, leaf_strides),
                     LT = sake::leaves_of(leaf_t_ptrs, leaf_strides);
  const sake::Resids RS = sake::resids_of(resid_ptrs);
  const sake::Rows RW = sake::rows_of(row_ptrs);
  const size_t smem = sake::bwd_cl_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sake::resid_bwd_cl_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sake::cl_config(B, sake::kClBwdThreads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, sake::resid_bwd_cl_kernel, d, bh, bx, bv, upd, mask, L, LT, RS,
                           dh_fin, dx_fin, dv_fin, dh_out, dx_out, dv_out, RW);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The clock probe's slots (probe.cuh) of this source's kernel.
// #5's rows kernel in the bf16 tier: the arguments of sake_resid_bwd_rows_cluster,
// the low-precision residual streams bf16 tensors (all but r and t), L's and
// LT's four edge weights rounded to bf16.
extern "C" int sake_resid_bwd_rows_cluster16(
    const float* bh, const float* bx, const float* bv, const float* upd, const float* mask,
    const void* const* leaf_ptrs, const void* const* leaf_t_ptrs, const long long* leaf_strides,
    void* const* resid_ptrs, const float* dh_fin, const float* dx_fin, const float* dv_fin,
    float* dh_out, float* dx_out, float* dv_out, void* const* row_ptrs, int B, int N, int F,
    int H, int R, int K, int C, int depth, void* stream) {
  using namespace sake;
  const Dims d{B, N, F, H, R, K, C, depth};
  const size_t smem = bwd_cl_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(resid_bwd_cl16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cl_config(B, kClBwdThreads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, resid_bwd_cl16_kernel, d, bh, bx, bv, upd, mask,
                           leaves_of(leaf_ptrs, leaf_strides), leaves_of(leaf_t_ptrs, leaf_strides),
                           resids16_of(resid_ptrs), dh_fin, dx_fin, dv_fin, dh_out, dx_out, dv_out,
                           rows_of(row_ptrs));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int sake_resid_bwd_cl_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}
