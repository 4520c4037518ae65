// K1: forward of the dense SAKE layer stack with residuals, f32, and the
// same forward without residuals.
//
// Replaces three TPU kernels of sake_tpu/kernels/resid_ef.py, which all run
// layer_fwd_resid over depth:
// - resid_energy_forces -> fwd_kernel (the pallas_call at :1157), the E + F
//   serving forward: this kernel, no mask;
// - make_hidden_fn -> fwd_kernel (:1545, body :1484), the training forward
//   on padded batches: this kernel or the cluster kernel below, with an edge
//   mask (B, N, N);
// - make_hidden_fn -> infer_kernel (:1780, body :1732), the forward no
//   backward will read: the cluster kernel without kStream, which writes only
//   the final h and x.
// They write the boundary states (h, x, v) and the 17 residuals the
// hand-written backward (resid_bwd.cu) reads. The TPU kernels' velocity
// input is v0 here.
//
// Masked semantics (layer_fwd_resid with a mask): logits - 1e5 * (1 - m),
// the raw softmax saved, attention renormalized over live senders
// (att2 = att * m / sum_j att * m, a zero sum read as 1), coefficients
// times m, pooled sums over the sender count + 1e-8 and the velocity
// update over the count + 1e-10.
//
// The per-layer body is fwd_layer (resid_fwd.cuh), which the fused kernels
// of fused_ef.cu (#11, #3) share.
//
// Design: one thread block per molecule, looping over depth inside the
// block, so the molecule's (h, x, v) state stays in shared memory between
// layers (the TPU kernel's VMEM scratch sh/sx/sv). Per layer, the node
// projections a_j, a_i, o_j, o_i go to shared memory; then each receiver
// row i builds its N sender edges there (rbf, e0, h_e, logits, the softmax
// over senders, coefficients), pools them into pool0-2 and hatt_sum, and
// streams the row's edge residuals out; the node MLP, velocity gate and
// x/v update follow once all rows are done. Weights (about 2 MB for the
// depth-6 model) are read from device memory and stay in L2. The pooled
// vectors go to device memory: with the residuals, and without them (the
// cluster kernel without kStream) to a (3, B, N, C) scratch the wrapper reuses
// layer after layer: at N = 29 shared memory cannot hold them beside the row
// buffers.
//
// What bounds it on an H100: f32 FMA issue, and the synchronisation of a
// block that works on one receiver row (N edges) at a time. The widest
// product, the x_mixing contraction (N x HK) @ (HK x C) per row, is about
// 90% of the FLOPs. The wide products run register-tiled (mm_tiled: 7
// rows x 4 columns per thread, float4 loads), so one shared-memory load
// feeds 16 FMAs; with one load per FMA the shared-memory pipe was the
// limit. Narrower products take one output per thread or one warp per row
// (mm_smem picks by width), since 7 x 4 tiles would leave the block idle. Residual writes (about
// 0.87 MB per molecule and layer for aspirin) are coalesced row blocks,
// well below HBM bandwidth at the rates this reaches. At QM9's N = 29 the
// block needs 146 KB of shared memory, so one block fits an SM where the
// launch bounds ask for two.
//
// The cluster kernel (resid_fwd_cl_kernel, #4 and #6 on QM9's batches): at B = 64
// one block a molecule leaves 68 of an H100's 132 SMs idle, so a molecule
// takes a cluster of two CTAs on two SMs. Each holds the whole state,
// computes the node projections of every sender, and runs the row loop and
// the node phase for half of the receivers (fwd_layer's kCl; receiver rows are
// independent: row i writes only receiver-side state). After each layer each
// CTA stores its nodes' new (h, x, v) into the other's shared memory
// (distributed shared memory) and the two cross a cluster barrier. Every
// residual, boundary and final row goes to the same place as the one-block
// kernel's, so the pullback and the plain versions read the same tensors. Its
// x-mixing and edge products run on the tensor cores in 3xTF32 up to N = 32
// (mma_tf32x3.cuh, four n8 tiles). make_hidden_fn's calls take this route at
// every batch, with the streams (#4) and without them (#6, its evaluation):
// on an H100 at N = 29 #4 measured 0.33-0.64x the one-block kernel's time
// from B = 64 to 256 (tools/probe_resid.py --phases sweep). Without the
// streams only the pooled vectors leave the CTA, to its own rows of a
// one-layer scratch that stays in L2.
//
// The tensor-core kernel (resid_fwd_tc_kernel, K1 on MD17 serving's route at
// aspirin's widths): the same one-block-a-molecule design, but the body's kTc
// instantiation, so the x-mixing product and the edge products o_f and o1 run
// in 3xTF32 on mma.sync (mma_tf32x3.cuh). It keeps K1's 256 threads and two
// blocks a SM: mm_tc's W ring is carved for 8 warps (8 KB), each warp taking
// two of the 16 column strips in turn, where the 512-thread kernels carve 16
// (16 KB). The route (fwd_tc_route) is tc_dims and two such blocks fitting an
// SM's shared memory: at hidden 64, 4 heads, R 50 that is N <= 21, aspirin's
// size and the largest MD17 molecule; elsewhere K1 stays on resid_fwd_kernel.
//
// resid_ef's bf16 tier (the JAX package's production setting: edge products
// with both operands in bf16, every residual stream but r and t stored as bf16)
// runs the same bodies with fwd_layer's kE16 in kernels of their own
// (resid_fwd16_kernel, K1 on either route; resid_fwd_cl16_kernel, #4 and #6),
// each with a one-layer f32 scratch of the pooled vectors, which the body's node
// phase reads where the f32 kernels read their pooled streams back. The f32
// kernels above and below are untouched by it.

#include "resid_fwd.cuh"

namespace sake {

// Two blocks per SM (<= 128 registers) measured faster than one with
// more registers at aspirin's N = 21.
__global__ void __launch_bounds__(256, 2)
resid_fwd_kernel(Dims d, const float* __restrict__ h0,
                 const float* __restrict__ xs, const float* __restrict__ v0,
                 const float* __restrict__ upd, const float* __restrict__ mask, Leaves L,
                 float* bh, float* bx, float* bv, float* h_fin, float* x_fin,
                 float* v_fin, Resids RS) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* mb = mask ? mask + (size_t)b * N * N : nullptr;  // this molecule's (N, N)

  Carver cv{reinterpret_cast<float*>(smem4)};
  const FwdSmem S = carve_fwd(cv, d);
  SAKE_PROBE_START();
  fwd_begin(d, S, B, b, h0, xs, v0, mb);
  for (int l = 0; l < d.depth; ++l)
    fwd_layer<true, true>(d, S, b, l, upd[l], mb, L, bh, bx, bv, RS);

  for (int e = tid; e < N * F; e += nt) h_fin[(size_t)b * N * F + e] = S.sh[e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    x_fin[((size_t)k * B + b) * N + i] = S.sx[e];
    v_fin[((size_t)k * B + b) * N + i] = S.sv[e];
  }
}

// K1's tensor-core kernel (see the top; its carve and route: resid_fwd.cuh).
constexpr int kFwdTcThreads = 32 * kTcFwdWarps;

__global__ void __launch_bounds__(kFwdTcThreads, 2)
resid_fwd_tc_kernel(Dims d, const float* __restrict__ h0, const float* __restrict__ xs,
                    const float* __restrict__ v0, const float* __restrict__ upd,
                    const float* __restrict__ mask, Leaves L, float* bh, float* bx, float* bv,
                    float* h_fin, float* x_fin, float* v_fin, Resids RS) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* mb = mask ? mask + (size_t)b * N * N : nullptr;

  Carver cv{reinterpret_cast<float*>(smem4)};
  float* ring = cv.take(tc_ring_floats<kTcFwdWarps>(d));
  const FwdSmem S = carve_fwd<true>(cv, d);
  SAKE_PROBE_START();
  fwd_begin(d, S, B, b, h0, xs, v0, mb);
  for (int l = 0; l < d.depth; ++l)
    fwd_layer<true, true, false, true, false, kTcFwdWarps>(d, S, b, l, upd[l], mb, L, bh, bx,
                                                           bv, RS, ring);

  for (int e = tid; e < N * F; e += nt) h_fin[(size_t)b * N * F + e] = S.sh[e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    x_fin[((size_t)k * B + b) * N + i] = S.sx[e];
    v_fin[((size_t)k * B + b) * N + i] = S.sv[e];
  }
}

// One tensor-core product of K1's or K2's route alone, in one block of kWarps
// warps as the bodies call it: out (n, m) = A (n, kd) @ W (kd, m) in 3xTF32.
// kd = m = 256: mm_tc (the x-mixing product and its transpose; n at most 24, A
// at tc_ld's padded stride); kd, m at most 64: mm_tc_small (o_f, o1 and their
// pullbacks).
template <int kWarps>
__global__ void __launch_bounds__(32 * kWarps, 1)
resid_tc_product_kernel(int n, int kd, int m, const float* __restrict__ A,
                  const float* __restrict__ W, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* sa = ring + kWarps * kTcStages * kTcStage;
  const bool wide = kd == kTcK;
  const int lda = wide ? kd + kTcPad : kd;
  for (int e = threadIdx.x; e < n * kd; e += blockDim.x) sa[(e / kd) * lda + e % kd] = A[e];
  __syncthreads();
  auto st = [&](int r, int c, float v) { out[(size_t)r * m + c] = v; };
  if (wide) mm_tc<3, 3, kWarps>(n, sa, lda, W, ring, st);
  else mm_tc_small<3>(n, kd, m, sa, lda, W, st);
}

// K1 in the bf16 tier (see the top): kTc the tensor-core kernel's carve, ring
// and products, else resid_fwd_kernel's. pool16: a (3, B, N, C) f32 scratch.
template <bool kTc>
__global__ void __launch_bounds__(256, 2)
resid_fwd16_kernel(Dims d, const float* __restrict__ h0, const float* __restrict__ xs,
                   const float* __restrict__ v0, const float* __restrict__ upd,
                   const float* __restrict__ mask, Leaves L, float* bh, float* bx, float* bv,
                   float* h_fin, float* x_fin, float* v_fin, Resids16 RS, float* pool16) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* mb = mask ? mask + (size_t)b * N * N : nullptr;

  Carver cv{reinterpret_cast<float*>(smem4)};
  float* ring = kTc ? cv.take(tc_ring_floats<kTcFwdWarps>(d)) : nullptr;
  const FwdSmem S = carve_fwd<kTc>(cv, d);
  SAKE_PROBE_START();
  fwd_begin(d, S, B, b, h0, xs, v0, mb);
  for (int l = 0; l < d.depth; ++l)
    fwd_layer<true, true, false, kTc, false, kTcFwdWarps, true>(d, S, b, l, upd[l], mb, L, bh,
                                                                bx, bv, RS, ring, pool16);

  for (int e = tid; e < N * F; e += nt) h_fin[(size_t)b * N * F + e] = S.sh[e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    x_fin[((size_t)k * B + b) * N + i] = S.sx[e];
    v_fin[((size_t)k * B + b) * N + i] = S.sv[e];
  }
}

int launch_fwd(const sake::Dims& d, const float* h0, const float* xs, const float* v0,
               const float* upd, const float* mask, const void* const* leaf_ptrs,
               const long long* leaf_strides, float* bh, float* bx, float* bv, float* h_fin,
               float* x_fin, float* v_fin, const Resids& RS, void* stream) {
  const Leaves L = leaves_of(leaf_ptrs, leaf_strides);
  const size_t smem = fwd_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      resid_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  resid_fwd_kernel<<<d.B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      d, h0, xs, v0, upd, mask, L, bh, bx, bv, h_fin, x_fin, v_fin, RS);
  return (int)cudaGetLastError();
}

// The cluster kernel's block: 512 threads (128 registers, 356 B spilled)
// measured 2-5% faster than 256 (240 registers, no spill) on an H100 at QM9's
// (64, 29).
constexpr int kClFwdThreads = 512;

// The cluster kernel's shared memory, in floats: the W ring of the
// tensor-core products, then the kCl carve.
__host__ __device__ inline long long fwd_cl_smem_floats(const Dims& d) {
  return tc_ring_floats_of<true>(d) + fwd_smem_floats<true, true>(d);
}

// The cluster kernel: molecule blockIdx.x / 2, receiver rows of cluster rank
// blockIdx.x % 2 (launched with clusters of kClSize along x). kStream: #4's
// kernel, which writes the boundaries, the 17 residuals and the final (h, x,
// v); without it #6's, which writes only the final h and x, its pooled
// vectors to slot b of a one-layer (3, B, N, C) scratch (RS_POOL0-2).
template <bool kStream>
__global__ void __launch_bounds__(kClFwdThreads, 1)
resid_fwd_cl_kernel(Dims d, const float* __restrict__ h0, const float* __restrict__ xs,
                    const float* __restrict__ v0, const float* __restrict__ upd,
                    const float* __restrict__ mask, Leaves L, float* bh, float* bx, float* bv,
                    float* h_fin, float* x_fin, float* v_fin, Resids RS) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x / kClSize;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* mb = mask ? mask + (size_t)b * N * N : nullptr;

  Carver cv{reinterpret_cast<float*>(smem4)};
  float* ring = cv.take(tc_ring_floats_of<true>(d));
  const FwdSmem S = carve_fwd<true, true>(cv, d);
  SAKE_PROBE_START();
  fwd_begin(d, S, B, b, h0, xs, v0, mb);
  for (int l = 0; l < d.depth; ++l)
    fwd_layer<kStream, kStream, false, true, true>(d, S, b, l, upd[l], mb, L, bh, bx, bv, RS,
                                                   ring);

  int i0, i1;  // this CTA's nodes
  cl_rows(N, cl_rank(), i0, i1);
  const int nn = i1 - i0;
  for (int e = tid; e < nn * F; e += nt) h_fin[((size_t)b * N + i0) * F + e] = S.sh[i0 * F + e];
  for (int e = tid; e < 3 * nn; e += nt) {
    const int k = e / nn, i = i0 + e % nn;
    x_fin[((size_t)k * B + b) * N + i] = S.sx[k * N + i];
    if constexpr (kStream) v_fin[((size_t)k * B + b) * N + i] = S.sv[k * N + i];
  }
}

// The cluster kernel in the bf16 tier (see the top): #4 (kStream: RS the bf16
// streams, pool16 a (3, B, N, C) f32 scratch) or #6 (RS its f32 pooled scratch,
// pool16 unused).
template <bool kStream>
__global__ void __launch_bounds__(kClFwdThreads, 1)
resid_fwd_cl16_kernel(Dims d, const float* __restrict__ h0, const float* __restrict__ xs,
                      const float* __restrict__ v0, const float* __restrict__ upd,
                      const float* __restrict__ mask, Leaves L, float* bh, float* bx,
                      float* bv, float* h_fin, float* x_fin, float* v_fin,
                      ResidsOf<kStream> RS, float* pool16) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x / kClSize;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* mb = mask ? mask + (size_t)b * N * N : nullptr;

  Carver cv{reinterpret_cast<float*>(smem4)};
  float* ring = cv.take(tc_ring_floats_of<true>(d));
  const FwdSmem S = carve_fwd<true, true>(cv, d);
  SAKE_PROBE_START();
  fwd_begin(d, S, B, b, h0, xs, v0, mb);
  for (int l = 0; l < d.depth; ++l)
    fwd_layer<kStream, kStream, false, true, true, kTcWarps, true>(d, S, b, l, upd[l], mb, L, bh,
                                                                   bx, bv, RS, ring, pool16);

  int i0, i1;  // this CTA's nodes
  cl_rows(N, cl_rank(), i0, i1);
  const int nn = i1 - i0;
  for (int e = tid; e < nn * F; e += nt) h_fin[((size_t)b * N + i0) * F + e] = S.sh[i0 * F + e];
  for (int e = tid; e < 3 * nn; e += nt) {
    const int k = e / nn, i = i0 + e % nn;
    x_fin[((size_t)k * B + b) * N + i] = S.sx[k * N + i];
    if constexpr (kStream) v_fin[((size_t)k * B + b) * N + i] = S.sv[k * N + i];
  }
}

// The cluster kernel over B molecules (one cluster of two CTAs each) on
// `stream`; a refused launch returns its error.
template <bool kStream>
int launch_fwd_cl(const Dims& d, const float* h0, const float* xs, const float* v0,
                  const float* upd, const float* mask, const Leaves& L, float* bh, float* bx,
                  float* bv, float* h_fin, float* x_fin, float* v_fin, const Resids& RS,
                  void* stream) {
  const size_t smem = fwd_cl_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(resid_fwd_cl_kernel<kStream>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cl_config(d.B, kClFwdThreads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, resid_fwd_cl_kernel<kStream>, d, h0, xs, v0, upd, mask, L, bh,
                           bx, bv, h_fin, x_fin, v_fin, RS);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K1 (route: "tensor cores" when kTc), #4 (kCl, kStream) or #6 (kCl) in the
// bf16 tier; a refused launch returns its error.
template <bool kTc, bool kCl, bool kStream>
int launch_fwd16(const Dims& d, const float* h0, const float* xs, const float* v0,
                 const float* upd, const float* mask, const Leaves& L, float* bh, float* bx,
                 float* bv, float* h_fin, float* x_fin, float* v_fin,
                 const ResidsOf<kStream>& RS, float* pool16, void* stream) {
  cudaError_t err;
  if constexpr (kCl) {
    const size_t smem = fwd_cl_smem_floats(d) * sizeof(float);
    err = cudaFuncSetAttribute(resid_fwd_cl16_kernel<kStream>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cl_config(d.B, kClFwdThreads, smem, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, resid_fwd_cl16_kernel<kStream>, d, h0, xs, v0, upd, mask, L,
                             bh, bx, bv, h_fin, x_fin, v_fin, RS, pool16);
  } else {
    if (kTc && !fwd_tc_route(d)) return (int)cudaErrorInvalidValue;
    const size_t smem = (kTc ? fwd_tc_smem_floats(d) : fwd_smem_floats(d)) * sizeof(float);
    err = cudaFuncSetAttribute(resid_fwd16_kernel<kTc>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    resid_fwd16_kernel<kTc><<<d.B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
        d, h0, xs, v0, upd, mask, L, bh, bx, bv, h_fin, x_fin, v_fin, RS, pool16);
    err = cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace sake

extern "C" long long sake_resid_fwd_smem_bytes(int B, int N, int F, int H, int R, int K,
                                               int C, int depth) {
  sake::Dims d{B, N, F, H, R, K, C, depth};
  return sake::fwd_smem_floats(d) * (long long)sizeof(float);
}

extern "C" long long sake_resid_fwd_cluster_smem_bytes(int B, int N, int F, int H, int R,
                                                       int K, int C, int depth) {
  sake::Dims d{B, N, F, H, R, K, C, depth};
  return sake::fwd_cl_smem_floats(d) * (long long)sizeof(float);
}

// Clusters of the cluster kernel the card holds at once; negative: a CUDA error.
extern "C" int sake_resid_fwd_cluster_max_active(int B, int N, int F, int H, int R, int K,
                                                 int C, int depth) {
  sake::Dims d{B, N, F, H, R, K, C, depth};
  const size_t smem = sake::fwd_cl_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sake::resid_fwd_cl_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sake::cl_config(B, sake::kClFwdThreads, smem, nullptr, &attr);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, (const void*)sake::resid_fwd_cl_kernel<true>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// mask: (B, N, N) f32 or null.
extern "C" int sake_resid_fwd(const float* h0, const float* xs, const float* v0,
                              const float* upd, const float* mask,
                              const void* const* leaf_ptrs, const long long* leaf_strides,
                              float* bh, float* bx, float* bv, float* h_fin, float* x_fin,
                              float* v_fin, void* const* resid_ptrs, int B, int N, int F,
                              int H, int R, int K, int C, int depth, void* stream) {
  return sake::launch_fwd(sake::Dims{B, N, F, H, R, K, C, depth}, h0, xs, v0, upd, mask,
                          leaf_ptrs, leaf_strides, bh, bx, bv, h_fin, x_fin, v_fin,
                          sake::resids_of(resid_ptrs), stream);
}

// Whether K1 takes its tensor-core kernel at these widths and N, 1, or
// resid_fwd_kernel, 0 (fwd_tc_route).
extern "C" int sake_resid_fwd_tc_route(int B, int N, int F, int H, int R, int K, int C,
                                       int depth) {
  return sake::fwd_tc_route(sake::Dims{B, N, F, H, R, K, C, depth}) ? 1 : 0;
}

extern "C" long long sake_resid_fwd_tc_smem_bytes(int B, int N, int F, int H, int R, int K,
                                                  int C, int depth) {
  sake::Dims d{B, N, F, H, R, K, C, depth};
  return sake::fwd_tc_smem_floats(d) * (long long)sizeof(float);
}

// Blocks of K1's tensor-core kernel an SM holds at once (two by design); negative: a
// CUDA error.
extern "C" int sake_resid_fwd_tc_occupancy(int B, int N, int F, int H, int R, int K, int C,
                                           int depth) {
  sake::Dims d{B, N, F, H, R, K, C, depth};
  const size_t smem = sake::fwd_tc_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sake::resid_fwd_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sake::resid_fwd_tc_kernel,
                                                        sake::kFwdTcThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// K1 on its tensor-core kernel, the arguments of sake_resid_fwd; a shape off
// that route (fwd_tc_route) is refused with cudaErrorInvalidValue.
extern "C" int sake_resid_fwd_tc(const float* h0, const float* xs, const float* v0,
                                 const float* upd, const float* mask,
                                 const void* const* leaf_ptrs, const long long* leaf_strides,
                                 float* bh, float* bx, float* bv, float* h_fin, float* x_fin,
                                 float* v_fin, void* const* resid_ptrs, int B, int N, int F,
                                 int H, int R, int K, int C, int depth, void* stream) {
  using namespace sake;
  const Dims d{B, N, F, H, R, K, C, depth};
  if (!fwd_tc_route(d)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_tc_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(resid_fwd_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  resid_fwd_tc_kernel<<<B, kFwdTcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      d, h0, xs, v0, upd, mask, leaves_of(leaf_ptrs, leaf_strides), bh, bx, bv, h_fin, x_fin,
      v_fin, resids_of(resid_ptrs));
  return (int)cudaGetLastError();
}

// resid_tc_product_kernel (see there) in a block of `warps` warps: 8 (K1's route) or
// 16 (K2's); 0, or cudaErrorInvalidValue for a shape no product of theirs takes.
extern "C" int sake_resid_tc_product(int warps, const float* A, const float* W, float* out,
                                     int n, int kd, int m, void* stream) {
  using namespace sake;
  const bool wide = kd == kTcK && m == kTcK && n >= 1 && n <= 8 * tc_tiles<false>();
  const bool small = kd >= 1 && kd <= kTcSmallK && m >= 1 && m <= kTcSmallK && n >= 1;
  if ((!wide && !small) || (warps != kTcFwdWarps && warps != kTcWarps))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)warps * kTcStages * kTcStage + (size_t)n * (wide ? kd + kTcPad : kd)) *
      sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warps == kTcFwdWarps)
    resid_tc_product_kernel<kTcFwdWarps><<<1, 32 * kTcFwdWarps, smem, s>>>(n, kd, m, A, W, out);
  else
    resid_tc_product_kernel<kTcWarps><<<1, 32 * kTcWarps, smem, s>>>(n, kd, m, A, W, out);
  return (int)cudaGetLastError();
}

// #4's cluster route, the arguments of sake_resid_fwd: one molecule per cluster
// of two CTAs. A refused launch returns its error.
extern "C" int sake_resid_fwd_cluster(const float* h0, const float* xs, const float* v0,
                                      const float* upd, const float* mask,
                                      const void* const* leaf_ptrs,
                                      const long long* leaf_strides, float* bh, float* bx,
                                      float* bv, float* h_fin, float* x_fin, float* v_fin,
                                      void* const* resid_ptrs, int B, int N, int F, int H,
                                      int R, int K, int C, int depth, void* stream) {
  return sake::launch_fwd_cl<true>(sake::Dims{B, N, F, H, R, K, C, depth}, h0, xs, v0, upd,
                                   mask, sake::leaves_of(leaf_ptrs, leaf_strides), bh, bx, bv,
                                   h_fin, x_fin, v_fin, sake::resids_of(resid_ptrs), stream);
}

// #6: the forward without residuals on the cluster kernel, one molecule per
// cluster of two CTAs, each writing the final h and x of its receivers; pool is
// a (3, B, N, C) scratch for one layer's pooled vectors. A refused launch
// returns its error.
extern "C" int sake_resid_infer_cluster(const float* h0, const float* xs, const float* v0,
                                        const float* upd, const float* mask,
                                        const void* const* leaf_ptrs,
                                        const long long* leaf_strides, float* h_fin,
                                        float* x_fin, float* pool, int B, int N, int F, int H,
                                        int R, int K, int C, int depth, void* stream) {
  const sake::Dims d{B, N, F, H, R, K, C, depth};
  return sake::launch_fwd_cl<false>(d, h0, xs, v0, upd, mask,
                                    sake::leaves_of(leaf_ptrs, leaf_strides), nullptr, nullptr,
                                    nullptr, h_fin, x_fin, nullptr, sake::pool_resids(pool, d),
                                    stream);
}

// The bf16 tier's entries (resid_ef's edge_matmul_dtype and resid_dtype bf16):
// the arguments of their f32 counterparts above, the low-precision residual
// streams bf16 tensors (all but r and t), L's four edge weights (w_o_f, w_o1,
// w_sem, w_xmix) rounded to bf16, and pool16 a (3, B, N, C) f32 scratch.
// route: 0 K1's CUDA-core kernel, 1 its tensor-core kernel (fwd_tc_route, else
// refused), 2 #4's cluster kernel.
extern "C" int sake_resid_fwd16(int route, const float* h0, const float* xs, const float* v0,
                                const float* upd, const float* mask,
                                const void* const* leaf_ptrs, const long long* leaf_strides,
                                float* bh, float* bx, float* bv, float* h_fin, float* x_fin,
                                float* v_fin, void* const* resid_ptrs, float* pool16, int B,
                                int N, int F, int H, int R, int K, int C, int depth,
                                void* stream) {
  using namespace sake;
  const Dims d{B, N, F, H, R, K, C, depth};
  const Leaves L = leaves_of(leaf_ptrs, leaf_strides);
  const Resids16 RS = resids16_of(resid_ptrs);
  switch (route) {
    case 0: return launch_fwd16<false, false, true>(d, h0, xs, v0, upd, mask, L, bh, bx, bv,
                                                    h_fin, x_fin, v_fin, RS, pool16, stream);
    case 1: return launch_fwd16<true, false, true>(d, h0, xs, v0, upd, mask, L, bh, bx, bv,
                                                   h_fin, x_fin, v_fin, RS, pool16, stream);
    case 2: return launch_fwd16<true, true, true>(d, h0, xs, v0, upd, mask, L, bh, bx, bv, h_fin,
                                                  x_fin, v_fin, RS, pool16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// #6 in the bf16 tier: the arguments of sake_resid_infer_cluster, L's edge
// weights rounded.
extern "C" int sake_resid_infer_cluster16(const float* h0, const float* xs, const float* v0,
                                          const float* upd, const float* mask,
                                          const void* const* leaf_ptrs,
                                          const long long* leaf_strides, float* h_fin,
                                          float* x_fin, float* pool, int B, int N, int F, int H,
                                          int R, int K, int C, int depth, void* stream) {
  using namespace sake;
  const Dims d{B, N, F, H, R, K, C, depth};
  return launch_fwd16<true, true, false>(d, h0, xs, v0, upd, mask,
                                         leaves_of(leaf_ptrs, leaf_strides), nullptr, nullptr,
                                         nullptr, h_fin, x_fin, nullptr, pool_resids(pool, d),
                                         nullptr, stream);
}

// The clock probe's slots (probe.cuh) of this source's kernels.
extern "C" int sake_resid_fwd_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}

extern "C" const char* sake_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
