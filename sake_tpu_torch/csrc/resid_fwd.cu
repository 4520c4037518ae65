// K1: forward of the dense SAKE layer stack with residuals, f32, and the
// same forward without residuals.
//
// Replaces three TPU kernels of sake_tpu/kernels/resid_ef.py, which all run
// layer_fwd_resid over depth:
// - resid_energy_forces -> fwd_kernel (the pallas_call at :1157), the E + F
//   serving forward: this kernel with kStream, no mask;
// - make_hidden_fn -> fwd_kernel (:1545, body :1484), the training forward
//   on padded batches: this kernel with kStream and an edge mask (B, N, N);
// - make_hidden_fn -> infer_kernel (:1780, body :1732), the forward no
//   backward will read: this kernel without kStream, which writes only the
//   final h and x.
// With kStream it writes the boundary states (h, x, v) and the 17 residuals
// the hand-written backward (resid_bwd.cu) reads. The TPU kernels' velocity
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
// vectors go to device memory even without kStream (to a (3, B, N, C)
// scratch the wrapper reuses layer after layer): at N = 29 shared memory
// cannot hold them beside the row buffers.
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
// launch bounds ask for two. Tensor cores (wgmma on bf16) are the next
// step and a later change.

#include "resid_fwd.cuh"

namespace sake {

// Two blocks per SM (<= 128 registers) measured faster than one with
// more registers at aspirin's N = 21.
template <bool kStream>
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
  fwd_begin(d, S, B, b, h0, xs, v0, mb);
  for (int l = 0; l < d.depth; ++l) fwd_layer<kStream>(d, S, b, l, upd[l], mb, L, bh, bx, bv, RS);

  for (int e = tid; e < N * F; e += nt) h_fin[(size_t)b * N * F + e] = S.sh[e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    x_fin[((size_t)k * B + b) * N + i] = S.sx[e];
    if constexpr (kStream) v_fin[((size_t)k * B + b) * N + i] = S.sv[e];
  }
}

template <bool kStream>
int launch_fwd(const sake::Dims& d, const float* h0, const float* xs, const float* v0,
               const float* upd, const float* mask, const void* const* leaf_ptrs,
               const long long* leaf_strides, float* bh, float* bx, float* bv, float* h_fin,
               float* x_fin, float* v_fin, const Resids& RS, void* stream) {
  Leaves L;
  for (int i = 0; i < kLeaves; ++i) {
    L.p[i] = static_cast<const float*>(leaf_ptrs[i]);
    L.stride[i] = leaf_strides[i];
  }
  const size_t smem = fwd_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      resid_fwd_kernel<kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  resid_fwd_kernel<kStream><<<d.B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      d, h0, xs, v0, upd, mask, L, bh, bx, bv, h_fin, x_fin, v_fin, RS);
  return (int)cudaGetLastError();
}

}  // namespace sake

extern "C" long long sake_resid_fwd_smem_bytes(int B, int N, int F, int H, int R, int K,
                                               int C, int depth) {
  sake::Dims d{B, N, F, H, R, K, C, depth};
  return sake::fwd_smem_floats(d) * (long long)sizeof(float);
}

// mask: (B, N, N) f32 or null.
extern "C" int sake_resid_fwd(const float* h0, const float* xs, const float* v0,
                              const float* upd, const float* mask,
                              const void* const* leaf_ptrs, const long long* leaf_strides,
                              float* bh, float* bx, float* bv, float* h_fin, float* x_fin,
                              float* v_fin, void* const* resid_ptrs, int B, int N, int F,
                              int H, int R, int K, int C, int depth, void* stream) {
  sake::Resids RS;
  for (int i = 0; i < sake::kResids; ++i) RS.p[i] = static_cast<float*>(resid_ptrs[i]);
  return sake::launch_fwd<true>(sake::Dims{B, N, F, H, R, K, C, depth}, h0, xs, v0, upd,
                                mask, leaf_ptrs, leaf_strides, bh, bx, bv, h_fin, x_fin,
                                v_fin, RS, stream);
}

// The forward without residuals: pool is a (3, B, N, C) scratch for one
// layer's pooled vectors.
extern "C" int sake_resid_infer(const float* h0, const float* xs, const float* v0,
                                const float* upd, const float* mask,
                                const void* const* leaf_ptrs, const long long* leaf_strides,
                                float* h_fin, float* x_fin, float* pool, int B, int N, int F,
                                int H, int R, int K, int C, int depth, void* stream) {
  sake::Resids RS{};
  const size_t plane = (size_t)B * N * C;
  RS.p[sake::RS_POOL0] = pool;
  RS.p[sake::RS_POOL1] = pool + plane;
  RS.p[sake::RS_POOL2] = pool + 2 * plane;
  return sake::launch_fwd<false>(sake::Dims{B, N, F, H, R, K, C, depth}, h0, xs, v0, upd,
                                 mask, leaf_ptrs, leaf_strides, nullptr, nullptr, nullptr,
                                 h_fin, x_fin, nullptr, RS, stream);
}

extern "C" const char* sake_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
