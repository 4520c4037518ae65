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
// Design: a persistent grid of one 512-thread block per SM, each block walking
// molecules blockIdx.x, + gridDim.x, ...; per molecule it embeds (readout_head.cuh's
// products), runs K1's body over depth writing the state entering each layer and
// the layer's 17 residuals (as K1 does), runs the readout and its seed
// (readout_seed_head), and pulls the cotangents back over depth in reverse with K2's
// body on those residuals. The boundaries and residuals of every layer (about 5.3 MB
// per aspirin molecule at depth 6) live in device memory, in one slot per block, so
// the scratch is the grid's (about 665 MiB on 132 SMs), not the batch's. The slots
// are larger than the card's 50 MB L2: each residual goes to HBM once and comes back
// once. The TPU kernel instead re-ran each layer from its boundary before pulling
// back through it, to keep VMEM small; on the H100 that re-forward saved no traffic
// (its one-layer slots, 115 MB on 132 blocks, went through HBM as well) and took a
// third of the block's cycles (tools/probe_fused.py --k20).
// The block writes and reads its slots in the same launch: every scratch pointer is
// a plain (not const __restrict__) kernel argument, so no read is served from the
// non-coherent cache, and each read follows a __syncthreads after the write.
//
// Products: the x-mixing product and the edge products o_f and o1, forward and
// pullback, run on the tensor cores (mma_tf32x3.cuh: the kTc bodies, the W ring
// ahead of their carves) where tc_dims allows (aspirin's widths), on the CUDA cores
// elsewhere (the narrow models); the route is the shape's, the same for the whole
// launch (sake_fused_remat_ef_tc). f32: 3xTF32. bf16: kBf16 instantiates the same
// bodies with each product's activation operand rounded to bf16 as it is read and
// each product's pullback rounded before it joins a sum; the wrapper passes the
// weights already rounded (their transposes too). A bf16 weight is exact in TF32, so
// the tensor-core products take fewer passes (tc_passes): one for the forward's o_f
// and o1 (both operands bf16 values: exact), two for the x-mixing (bf16(h_e) att is
// an f32 value) and every pullback product (g is not rounded). The other products
// run on the CUDA cores, in bf16 as exact products of bf16 values with f32 sums.
//
// What bounds it on an H100: one 512-thread block per SM and the row loop's block
// barriers, the products left on the CUDA cores (the node phase, sem, the
// projections), mma.sync at a fraction of the TF32 rate, and register spills.

#include "readout_head.cuh"
#include "resid_bwd.cuh"
#include "resid_fwd.cuh"

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

// The W ring of the tensor-core products (none where tc_dims does not take
// them), the cotangent state (sdh, sdx, sdv), then one region that the forward's
// carve with the head buffer and the pullback's buffers take in turn.
__host__ __device__ inline long long fused_remat_smem_floats(const Dims& d, int F_in, int F0) {
  const long long f =
      bwd_state_floats(d) + fwd_smem_floats<true>(d) + head_buf_floats(d, F_in, F0);
  const long long b = bwd_smem_floats<true>(d);
  return tc_ring_floats(d) + (f > b ? f : b);
}

// d.B: the scratch's slots (the grid); B: the batch. h_raw (B, N, F_in), x
// (B, N, 3); e_out (B,), f_out (B, N, 3). bh (depth, d.B, N, F), bx, bv
// (depth, 3, d.B, N): the boundary slots; RS: the residual slots of every
// layer (K1's layout with d.B molecules).
template <bool kBf16>
__global__ void __launch_bounds__(kFusedRematThreads, 1)
fused_remat_ef_kernel(Dims d, int B, const float* __restrict__ h_raw,
                      const float* __restrict__ x, const float* __restrict__ upd, Leaves L,
                      Leaves LT, Embed em, Readout ro, float* bh, float* bx, float* bv,
                      Resids RS, float* e_out, float* f_out) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // the tensor-core products' W ring
  float* base = ring + tc_ring_floats(d);
  const int N = d.N, F = d.F, F_in = em.F_in, slot = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  // SB from the base (its cotangent state outlives the forward), SF after that state
  Carver cb{base};
  const BwdSmem SB = carve_bwd<true>(cb, d);
  Carver cf{base + bwd_state_floats(d)};
  const FwdSmem SF = carve_fwd<true>(cf, d);
  float* buf = base + bwd_state_floats(d) + cf.off;
  SAKE_PROBE_START();
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
    SAKE_PROBE(PR_OTHER);

    // forward over depth, keeping the state entering each layer and its residuals
    for (int l = 0; l < d.depth; ++l)
      fwd_layer<true, true, kBf16, true>(d, SF, slot, l, upd[l], nullptr, L, bh, bx, bv, RS,
                                         ring);

    // e and the seed dh_fin into the pullback's state
    readout_seed_head<kBf16>(N, F, ro, SF.sh, nullptr, buf, SB.sdh, e_out + m);
    for (int e = tid; e < 3 * N; e += nt) SB.sdx[e] = SB.sdv[e] = 0.f;
    __syncthreads();
    SAKE_PROBE(PR_HEAD);

    // pullback over depth on the layers' residuals (the forward's closing
    // barrier orders their writes before these reads, through plain pointers)
    for (int l = d.depth - 1; l >= 0; --l)
      bwd_layer<false, kBf16, true>(d, SB, slot, l, upd[l], nullptr, L, LT, bh, bx, bv, RS,
                                    Rows{}, nullptr, nullptr, nullptr, ring);
    for (int e = tid; e < 3 * N; e += nt)
      f_out[((size_t)m * N + e % N) * 3 + e / N] = -SB.sdx[e];
    __syncthreads();  // the next molecule reuses the shared memory
    SAKE_PROBE(PR_OTHER);
  }
}

// One of the bf16 tier's tensor-core products alone, in one block as the
// bodies call it: out (n, m) = A (n, kd) @ W (kd, m), W of bf16 values. kd = m
// = 256: mm_tc at 2 passes (the x-mixing and its pullback; n at most 24, A at
// tc_ld's padded stride); kd at most 64: mm_tc_small at `passes` 1 (the
// forward's o_f and o1, A rounded to bf16 as read) or 2 (their pullbacks).
__global__ void __launch_bounds__(kFusedRematThreads, 1)
tc_product_kernel(int passes, int n, int kd, int m, const float* __restrict__ A,
                  const float* __restrict__ W, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* sa = ring + kTcWarps * kTcStages * kTcStage;
  const bool wide = kd == kTcK;
  const int lda = wide ? kd + kTcPad : kd;
  for (int e = threadIdx.x; e < n * kd; e += blockDim.x) sa[(e / kd) * lda + e % kd] = A[e];
  __syncthreads();
  auto st = [&](int r, int c, float v) { out[(size_t)r * m + c] = v; };
  if (wide) mm_tc<3, 2>(n, sa, lda, W, ring, st);
  else if (passes == 1) mm_tc_small<1>(n, kd, m, sa, lda, W, st);
  else mm_tc_small<2>(n, kd, m, sa, lda, W, st);
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

// The clock probe's slots (probe.cuh), block cycles summed over this source's
// launches since the last reset; an error unless built with -DSAKE_PROBE.
extern "C" int sake_fused_remat_ef_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}

extern "C" long long sake_fused_remat_ef_smem_bytes(int B, int N, int F, int H, int R, int K,
                                                    int C, int depth, int F_in, int F0) {
  return sake::fused_remat_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}, F_in, F0) *
         (long long)sizeof(float);
}

// Whether #20 runs its x-mixing and edge products on the tensor cores at these
// widths (tc_dims: aspirin's), 1, or on the CUDA cores, 0.
extern "C" int sake_fused_remat_ef_tc(int B, int N, int F, int H, int R, int K, int C,
                                      int depth) {
  return sake::tc_dims(sake::Dims{B, N, F, H, R, K, C, depth}) ? 1 : 0;
}

// tc_product_kernel on the stream (see there): 0, or cudaErrorInvalidValue for
// a shape or pass count that no bf16 product of #20 takes.
extern "C" int sake_fused_remat_ef_tc_product(int passes, const float* A, const float* W,
                                              float* out, int n, int kd, int m, void* stream) {
  using namespace sake;
  const bool wide = kd == kTcK && m == kTcK && n >= 1 && n <= 8 * tc_tiles<false>() &&
                    passes == tc_passes<true>();
  const bool small = kd >= 1 && kd <= kTcSmallK && m >= 1 && m <= kTcSmallK && n >= 1 &&
                     (passes == tc_passes<true, true>() || passes == tc_passes<true>());
  if (!wide && !small) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)kTcWarps * kTcStages * kTcStage + (size_t)n * (wide ? kd + kTcPad : kd)) *
      sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  tc_product_kernel<<<1, kFusedRematThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      passes, n, kd, m, A, W, out);
  return (int)cudaGetLastError();
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
// bh (depth, grid, N, F), bx, bv (depth, 3, grid, N), resid_ptrs the residuals
// of every layer (RESIDS order, (depth, grid, ...)). Writes e_out (B,) and f_out
// = -dE/dx (B, N, 3).
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
