// #20: fused_energy_forces, the whole model's E + F in one launch, in f32 or
// with the JAX bf16 products (its default).
//
// Replaces sake_tpu/kernels/fused_ef.py -> fused_energy_forces's kernel (the
// pallas_call at :183, body :94): per tile of molecules the embedding, a
// fori_loop forward over depth that keeps only each layer's input state (h,
// x, v) in VMEM scratch, the readout and its seed, and a backward fori_loop
// that re-traces each layer under jax.vjp from its boundary; outputs E and
// F = -dx. Every layer runs the update branch, selected by a 0/1 gate (x + u
// (x2 - x)), and v starts at zero. With matmul_dtype=bfloat16 (fused_ef.py:67)
// each product mm(a, w) of the embedding, the layers and the readout is
// dot(bf16(a), bf16(w)) with f32 sums (functional.py:98-105), and its
// pullback bf16(g @ bf16(w)^T).
//
// Design: a persistent grid of one 512-thread block per SM (as #3's kScratch
// instantiation, fused_ef.cu), each block walking molecules blockIdx.x, +
// gridDim.x, ...; per molecule it embeds (readout_head.cuh's products), runs
// K1's body over depth writing only the boundaries (as #21), runs the readout
// and its seed (readout_seed_head), and per layer in reverse re-runs the layer
// into a one-layer residual scratch and pulls back through it (remat_step.cuh,
// as #22). The boundaries (about 35 KB per aspirin molecule at depth 6) and
// the residuals of one layer (about 0.87 MB) live in device memory, in slots
// of one molecule per block, so the scratch is the grid's (about 120 MB on
// 132 SMs), not the batch's, and mostly stays in L2 between the writes and
// the reads of the same block. The block writes and reads its slots in the
// same launch: every scratch pointer is a plain (not const __restrict__)
// kernel argument, so no read is served from the non-coherent cache, and
// each read follows a __syncthreads after the write.
//
// bf16: kBf16 instantiates the same bodies (resid_fwd.cuh, resid_bwd.cuh,
// readout_head.cuh) with each product's activation operand rounded to bf16 as
// it is read and each product's pullback rounded before it joins a sum; the
// wrapper passes the weights already rounded (their transposes too). A
// product of two bf16 values is exact in f32, so f32 FMAs on the CUDA cores
// compute the bf16 product exactly; tensor cores (mma.sync / wgmma on bf16
// operands) are a later change.
//
// What bounds it on an H100: as #21 + #22, f32 FMA issue and the per-row
// synchronisation of one block per molecule (K1's forward body runs in a
// 512-thread block, one block per SM); bf16 adds the roundings, a few integer
// operations per operand read.

#include "readout_head.cuh"
#include "remat_step.cuh"

namespace sake {
namespace {

constexpr int kFusedRematThreads = 512;

struct Embed {
  const float *w, *b;  // (F_in, F), (F)
  int F_in;
};

// The buffer after the forward's carve: the raw features (N, F_in) before the
// embedding, then the readout head's.
__host__ __device__ inline long long head_buf_floats(const Dims& d, int F_in, int F0) {
  const long long s = seed_head_floats(d.N, F0), r = ((long long)d.N * F_in + 3) & ~3LL;
  return s > r ? s : r;
}

// The larger of the forward (cotangent state, K1's carve, the head buffer)
// and the pullback with its re-forward.
__host__ __device__ inline long long fused_remat_smem_floats(const Dims& d, int F_in, int F0) {
  const long long f =
      bwd_state_floats(d) + fwd_smem_floats(d) + head_buf_floats(d, F_in, F0);
  const long long b = remat_bwd_smem_floats(d);
  return f > b ? f : b;
}

// d.B: the scratch's slots (the grid); B: the batch. h_raw (B, N, F_in), x
// (B, N, 3); e_out (B,), f_out (B, N, 3). bh (depth, d.B, N, F), bx, bv
// (depth, 3, d.B, N): the boundary slots; RS: one layer's residual slots.
template <bool kBf16>
__global__ void __launch_bounds__(kFusedRematThreads, 1)
fused_remat_ef_kernel(Dims d, int B, const float* __restrict__ h_raw,
                      const float* __restrict__ x, const float* __restrict__ upd, Leaves L,
                      Leaves LT, Embed em, Readout ro, float* bh, float* bx, float* bv,
                      Resids RS, float* e_out, float* f_out) {
  extern __shared__ float4 smem4[];
  const int N = d.N, F = d.F, F_in = em.F_in, slot = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  BwdSmem SB;
  FwdSmem SF;
  float* buf = reinterpret_cast<float*>(smem4) +
               remat_carves(reinterpret_cast<float*>(smem4), d, &SB, &SF);
  for (int m = blockIdx.x; m < B; m += gridDim.x) {
    // the embedding, x, v = 0
    for (int e = tid; e < N * F_in; e += nt) buf[e] = h_raw[(size_t)m * N * F_in + e];
    for (int e = tid; e < 3 * N; e += nt) {
      SF.sx[e] = x[((size_t)m * N + e % N) * 3 + e / N];
      SF.sv[e] = 0.f;
    }
    sender_counts(nullptr, N, SF.scnt);
    __syncthreads();
    mm_head<kBf16>(N, F_in, F, buf, F_in, em.w,
                   [&](int r, int c, float a) { SF.sh[r * F + c] = a + em.b[c]; });
    __syncthreads();

    // forward over depth, keeping the state entering each layer
    for (int l = 0; l < d.depth; ++l)
      fwd_layer<false, true, kBf16>(d, SF, slot, l, upd[l], nullptr, L, bh, bx, bv, RS);

    // e and the seed dh_fin into the pullback's state
    readout_seed_head<kBf16>(N, F, ro, SF.sh, nullptr, buf, SB.sdh, e_out + m);
    for (int e = tid; e < 3 * N; e += nt) SB.sdx[e] = SB.sdv[e] = 0.f;
    __syncthreads();

    // per layer in reverse: re-forward from the boundary, pull back
    for (int l = d.depth - 1; l >= 0; --l)
      remat_layer<kBf16>(d, SF, SB, slot, l, upd[l], L, LT, bh, bx, bv, RS);
    for (int e = tid; e < 3 * N; e += nt)
      f_out[((size_t)m * N + e % N) * 3 + e / N] = -SB.sdx[e];
    __syncthreads();  // the next molecule reuses the shared memory
  }
}

template <bool kBf16>
cudaError_t set_smem(const Dims& d, int F_in, int F0, size_t* smem) {
  *smem = fused_remat_smem_floats(d, F_in, F0) * sizeof(float);
  return cudaFuncSetAttribute(fused_remat_ef_kernel<kBf16>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <bool kBf16>
int grid_of(const Dims& d, int F_in, int F0) {
  size_t smem;
  if (set_smem<kBf16>(d, F_in, F0, &smem) != cudaSuccess) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_remat_ef_kernel<kBf16>,
                                                    kFusedRematThreads, smem) != cudaSuccess)
    return -1;
  const long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(g < d.B ? g : d.B);
}

template <bool kBf16>
int launch(const Dims& slots, int B, const float* h_raw, const float* x, const float* upd,
           const Leaves& L, const Leaves& LT, const Embed& em, const Readout& ro, float* bh,
           float* bx, float* bv, const Resids& RS, float* e_out, float* f_out, void* stream) {
  size_t smem;
  cudaError_t err = set_smem<kBf16>(slots, em.F_in, ro.F0, &smem);
  if (err != cudaSuccess) return (int)err;
  fused_remat_ef_kernel<kBf16>
      <<<slots.B, kFusedRematThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          slots, B, h_raw, x, upd, L, LT, em, ro, bh, bx, bv, RS, e_out, f_out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sake

extern "C" long long sake_fused_remat_ef_smem_bytes(int B, int N, int F, int H, int R, int K,
                                                    int C, int depth, int F_in, int F0) {
  return sake::fused_remat_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}, F_in, F0) *
         (long long)sizeof(float);
}

// #20's grid for a batch of B: as many blocks as the card holds at once, at
// most B (-1 on a CUDA error).
extern "C" int sake_fused_remat_ef_grid(int bf16, int B, int N, int F, int H, int R, int K,
                                        int C, int depth, int F_in, int F0) {
  const sake::Dims d{B, N, F, H, R, K, C, depth};
  return bf16 ? sake::grid_of<true>(d, F_in, F0) : sake::grid_of<false>(d, F_in, F0);
}

// #20. bf16: 0 for f32 products, 1 for bf16 products (the leaves, their
// transposes, w_emb, w0, w1 and w0t then hold bf16-rounded weights). h_raw
// (B, N, F_in), x (B, N, 3); w_emb (F_in, F), b_emb (F); the readout w0 (F,
// F0), b0, w1 (F0, O), b1, w0t (F0, F); the scratch of `grid` molecule slots:
// bh (depth, grid, N, F), bx, bv (depth, 3, grid, N), resid_ptrs one layer's
// residuals (RESIDS order, (grid, ...)). Writes e_out (B,) and f_out = -dE/dx
// (B, N, 3).
extern "C" int sake_fused_remat_ef(int bf16, const float* h_raw, const float* x,
                                   const float* upd, const void* const* leaf_ptrs,
                                   const void* const* leaf_t_ptrs,
                                   const long long* leaf_strides, const float* w_emb,
                                   const float* b_emb, const float* w0, const float* b0,
                                   const float* w1, const float* b1, const float* w0t, float* bh,
                                   float* bx, float* bv, void* const* resid_ptrs, float* e_out,
                                   float* f_out, int grid, int B, int N, int F, int H, int R,
                                   int K, int C, int depth, int F_in, int F0, int O,
                                   void* stream) {
  using namespace sake;
  const Dims slots{grid, N, F, H, R, K, C, depth};
  const Leaves L = leaves_of(leaf_ptrs, leaf_strides), LT = leaves_of(leaf_t_ptrs, leaf_strides);
  const Resids RS = resids_of(resid_ptrs);
  const Embed em{w_emb, b_emb, F_in};
  const Readout ro{w0, b0, w1, b1, w0t, F0, O};
  return bf16 ? launch<true>(slots, B, h_raw, x, upd, L, LT, em, ro, bh, bx, bv, RS, e_out,
                             f_out, stream)
              : launch<false>(slots, B, h_raw, x, upd, L, LT, em, ro, bh, bx, bv, RS, e_out,
                              f_out, stream);
}
