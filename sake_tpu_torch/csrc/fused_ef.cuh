// #11 and #3: the whole E + F of a batch in one kernel launch: the forward
// over depth, the readout head and its seed, and the pullback over depth, one
// molecule at a time per thread block. fused_ef.cu holds the f32 entries of
// #11 and #3, fused_ef16.cu #11's in resid_ef's bf16 tier (kE16).
//
// Replaces two TPU kernels that run the same body:
// - sake_tpu/kernels/train2_ef.py -> _fused_primal's kernel (the pallas_call
//   at :1320, body :1239), the primal of make_ef_train2's fused mode
//   (fused_primal): the boundary states and the 17 residual streams are
//   outputs, because the training backward reads them again; so are h_fin,
//   the final x and v, the energy and dx (F = -dx);
// - sake_tpu/kernels/one_ef.py -> one_energy_forces's kernel (the
//   pallas_call at :261, body :177), the single-launch E + F of serving:
//   the streams go to a scratch of one molecule per resident block (a
//   persistent grid: each block walks molecules blockIdx.x, + gridDim.x,
//   ...), so the whole batch is one launch and no chunking bounds the
//   scratch; with an edge mask (B, N, N) the layers take the masked
//   semantics and the energy sums the atoms of the mask's diagonal. Only the
//   energy and dx leave the kernel.
//
// Design: K1's layer body (resid_fwd.cuh), the head (readout_head.cuh) and
// K2's layer body (resid_bwd.cuh) in turn, all on one block of 512 threads
// (K2's block size; K1 alone runs 256 threads, two blocks per SM). The
// state stays in shared memory from phase to phase: the head reads the
// forward's final h and writes the pullback's dh where the forward's h was.
// The phases take turns on one shared-memory region, sized by the larger
// of the forward (plus the head's buffer) and the pullback. On the TPU the
// streams stayed in VMEM between the two loops; an H100 block has 227 KB of
// shared memory against about 5 MB of streams per aspirin molecule at
// depth 6, so here the streams go to device memory (mostly L2-resident
// between the forward and the pullback of the same molecule) and what
// fusion saves is the launches, the torch readout between them, and, for
// #3, the stream memory of the batch.
//
// What bounds it on an H100, and the redesign of #11: a clock probe of the
// block (tools/probe_fused.py, probe.cuh) put the x-mixing product (he_att @
// w_xmix and its pullback, one receiver row of 21 senders at a time) at 39%
// of the block's cycles and the edge products o_f, o1 and sem at 27%; the
// CUDA-core tiling ran the x-mixing on 192 or 384 of the 512 threads and
// K1's products of 64 columns on 48. In #11 (kTc) both run on the tensor
// cores in 3xTF32 (mma_tf32x3.cuh): the x-mixing as W^T A^T, so the 21 rows
// pad to three n8 tiles, with w_xmix streamed through a per-warp cp.async
// ring, and the edge products one (m16, n8) tile per warp. What bounds it now:
// the mma.sync TF32 rate (about 18 cycles per m16n8k8 per SM sub-partition
// on an H100, so three passes cost as much as the CUDA cores' FMAs did for
// the padded tile) and the row loop's other work (the staging of the saved
// row, the softmax, the elementwise passes between 20-odd block barriers a
// row). #3 (kScratch) keeps the CUDA-core products.

#pragma once

#include "readout_head.cuh"
#include "resid_bwd.cuh"
#include "resid_fwd.cuh"

namespace sake {
namespace {

constexpr int kFusedThreads = 512;

// kTc: #11's, the W ring of the tensor-core products ahead of the bodies'
// kTc carves. The bf16 tier adds no shared memory.
template <bool kTc>
__host__ __device__ inline long long fused_ef_smem_floats(const Dims& d, int F0) {
  const long long f = fwd_smem_floats<kTc>(d) + seed_head_floats(d.N, F0);
  const long long b = bwd_smem_floats<kTc>(d);
  return (f > b ? f : b) + (kTc ? tc_ring_floats(d) : 0);
}

// d.B: the batch; slots: the molecules the streams hold (d.B for the fused
// primal, the grid for one_ef's per-block scratch). The fused primal (#11)
// runs its x-mixing products on the tensor cores (kTc); one_ef (#3) does not.
// kE16 (#11 only, no mask): resid_ef's bf16 tier, JAX's _fused_primal built
// with edge_matmul_dtype=bfloat16 and resid_dtype=bfloat16: fwd_layer's and
// bwd_layer's kE16, the streams RS bf16 but r and t (:1327-1332) and read back
// widened by the pullback (:1296-1299), the boundary states and the head f32;
// the forward's node phase reads the layer's pooled vectors in f32 from
// pool16 (a (3, B, N, C) scratch), as JAX computes them before it rounds them
// for the stream.
template <bool kScratch, bool kE16 = false>
__global__ void __launch_bounds__(kFusedThreads, 1)
fused_ef_kernel(Dims d, int slots, const float* __restrict__ h0, const float* __restrict__ xs,
                const float* __restrict__ upd, const float* __restrict__ mask, Leaves L,
                Leaves LT, Readout ro, float* bh, float* bx, float* bv, ResidsOf<kE16> RS,
                float* h_fin, float* x_fin, float* v_fin, float* e_out, float* dx_out,
                float* pool16) {
  static_assert(!(kScratch && kE16), "the bf16 tier is #11's");
  constexpr bool kTc = !kScratch;
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  float* ring = nullptr;  // kTc: the W ring of the tensor-core products
  if constexpr (kTc) {
    ring = base;
    base += tc_ring_floats(d);
  }
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  Dims ds = d;  // the streams' layout
  ds.B = slots;
  SAKE_PROBE_START();
  for (int m = blockIdx.x; m < B; m += gridDim.x) {
    const int slot = kScratch ? (int)blockIdx.x : m;
    // this molecule's (N, N)
    const float* mb = !kE16 && mask ? mask + (size_t)m * N * N : nullptr;

    // forward over depth
    Carver cf{base};
    const FwdSmem SF = carve_fwd<kTc>(cf, d);
    fwd_begin(d, SF, B, m, h0, xs, nullptr, mb);
    SAKE_PROBE(PR_OTHER);
    for (int l = 0; l < d.depth; ++l)
      fwd_layer<true, true, false, kTc, false, kTcWarps, kE16>(ds, SF, slot, l, upd[l], mb, L,
                                                               bh, bx, bv, RS, ring, pool16);
    if constexpr (!kScratch) {
      for (int e = tid; e < N * F; e += nt) h_fin[(size_t)m * N * F + e] = SF.sh[e];
      for (int e = tid; e < 3 * N; e += nt) {
        const size_t at = ((size_t)(e / N) * B + m) * N + e % N;
        x_fin[at] = SF.sx[e];
        v_fin[at] = SF.sv[e];
      }
    }

    // the readout head: e, and the seed dh_fin into the pullback's dh
    // (which aliases the forward's h: the head reads h before it writes dh)
    Carver cb{base};
    const BwdSmem SB = carve_bwd<kTc>(cb, d);
    readout_seed_head(N, F, ro, SF.sh, mb, base + cf.off, SB.sdh, e_out + m);
    for (int e = tid; e < 3 * N; e += nt) SB.sdx[e] = SB.sdv[e] = 0.f;
    sender_counts(mb, N, SB.scnt);
    __syncthreads();
    SAKE_PROBE(PR_HEAD);

    // pullback over depth: dx
    for (int l = d.depth - 1; l >= 0; --l)
      bwd_layer<false, false, kTc, kE16>(ds, SB, slot, l, upd[l], mb, L, LT, bh, bx, bv, RS,
                                         Rows{}, nullptr, nullptr, nullptr, ring);
    for (int e = tid; e < 3 * N; e += nt)
      dx_out[((size_t)(e / N) * B + m) * N + e % N] = SB.sdx[e];
    __syncthreads();  // the next molecule reuses the shared memory
    SAKE_PROBE(PR_OTHER);
  }
}

template <bool kScratch, bool kE16 = false>
cudaError_t set_smem(const Dims& d, int F0, size_t* smem) {
  *smem = fused_ef_smem_floats<!kScratch>(d, F0) * sizeof(float);
  return cudaFuncSetAttribute(fused_ef_kernel<kScratch, kE16>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// pool16: kE16's scratch, else null.
template <bool kScratch, bool kE16 = false>
int launch(const Dims& d, int grid, const float* h0, const float* xs, const float* upd,
           const float* mask, const void* const* leaf_ptrs, const void* const* leaf_t_ptrs,
           const long long* leaf_strides, const Readout& ro, float* bh, float* bx, float* bv,
           void* const* resid_ptrs, float* h_fin, float* x_fin, float* v_fin, float* e_out,
           float* dx_out, float* pool16, void* stream) {
  const Leaves L = leaves_of(leaf_ptrs, leaf_strides), LT = leaves_of(leaf_t_ptrs, leaf_strides);
  const ResidsOf<kE16> RS = resids_as<kE16>(resid_ptrs);
  size_t smem;
  cudaError_t err = set_smem<kScratch, kE16>(d, ro.F0, &smem);
  if (err != cudaSuccess) return (int)err;
  fused_ef_kernel<kScratch, kE16>
      <<<grid, kFusedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          d, grid, h0, xs, upd, mask, L, LT, ro, bh, bx, bv, RS, h_fin, x_fin, v_fin, e_out,
          dx_out, pool16);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sake
