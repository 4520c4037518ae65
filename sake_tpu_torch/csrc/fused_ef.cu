// #11 and #3: the whole E + F of a batch in one kernel launch, f32: the
// forward over depth, the readout head and its seed, and the pullback over
// depth, one molecule at a time per thread block.
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

#include "readout_head.cuh"
#include "resid_bwd.cuh"
#include "resid_fwd.cuh"

namespace sake {
namespace {

constexpr int kFusedThreads = 512;

// kTc: #11's, the W ring of the tensor-core products ahead of the bodies'
// kTc carves.
template <bool kTc>
__host__ __device__ inline long long fused_ef_smem_floats(const Dims& d, int F0) {
  const long long f = fwd_smem_floats<kTc>(d) + seed_head_floats(d.N, F0);
  const long long b = bwd_smem_floats<kTc>(d);
  return (f > b ? f : b) + (kTc ? tc_ring_floats(d) : 0);
}

// d.B: the batch; slots: the molecules the streams hold (d.B for the fused
// primal, the grid for one_ef's per-block scratch). The fused primal (#11)
// runs its x-mixing products on the tensor cores (kTc); one_ef (#3) does not.
template <bool kScratch>
__global__ void __launch_bounds__(kFusedThreads, 1)
fused_ef_kernel(Dims d, int slots, const float* __restrict__ h0, const float* __restrict__ xs,
                const float* __restrict__ upd, const float* __restrict__ mask, Leaves L,
                Leaves LT, Readout ro, float* bh, float* bx, float* bv, Resids RS,
                float* h_fin, float* x_fin, float* v_fin, float* e_out, float* dx_out) {
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
    const float* mb = mask ? mask + (size_t)m * N * N : nullptr;  // this molecule's (N, N)

    // forward over depth
    Carver cf{base};
    const FwdSmem SF = carve_fwd<kTc>(cf, d);
    fwd_begin(d, SF, B, m, h0, xs, nullptr, mb);
    SAKE_PROBE(PR_OTHER);
    for (int l = 0; l < d.depth; ++l)
      fwd_layer<true, true, false, kTc>(ds, SF, slot, l, upd[l], mb, L, bh, bx, bv, RS, ring);
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
      bwd_layer<false, false, kTc>(ds, SB, slot, l, upd[l], mb, L, LT, bh, bx, bv, RS, Rows{},
                                   nullptr, nullptr, nullptr, ring);
    for (int e = tid; e < 3 * N; e += nt)
      dx_out[((size_t)(e / N) * B + m) * N + e % N] = SB.sdx[e];
    __syncthreads();  // the next molecule reuses the shared memory
    SAKE_PROBE(PR_OTHER);
  }
}

void tables(const void* const* leaf_ptrs, const void* const* leaf_t_ptrs,
            const long long* leaf_strides, void* const* resid_ptrs, Leaves* L, Leaves* LT,
            Resids* RS) {
  *L = leaves_of(leaf_ptrs, leaf_strides);
  *LT = leaves_of(leaf_t_ptrs, leaf_strides);
  *RS = resids_of(resid_ptrs);
}

template <bool kScratch>
cudaError_t set_smem(const Dims& d, int F0, size_t* smem) {
  *smem = fused_ef_smem_floats<!kScratch>(d, F0) * sizeof(float);
  return cudaFuncSetAttribute(fused_ef_kernel<kScratch>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <bool kScratch>
int launch(const Dims& d, int grid, const float* h0, const float* xs, const float* upd,
           const float* mask, const void* const* leaf_ptrs, const void* const* leaf_t_ptrs,
           const long long* leaf_strides, const Readout& ro, float* bh, float* bx, float* bv,
           void* const* resid_ptrs, float* h_fin, float* x_fin, float* v_fin, float* e_out,
           float* dx_out, void* stream) {
  Leaves L, LT;
  Resids RS;
  tables(leaf_ptrs, leaf_t_ptrs, leaf_strides, resid_ptrs, &L, &LT, &RS);
  size_t smem;
  cudaError_t err = set_smem<kScratch>(d, ro.F0, &smem);
  if (err != cudaSuccess) return (int)err;
  fused_ef_kernel<kScratch><<<grid, kFusedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      d, grid, h0, xs, upd, mask, L, LT, ro, bh, bx, bv, RS, h_fin, x_fin, v_fin, e_out, dx_out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sake

extern "C" long long sake_fused_ef_smem_bytes(int B, int N, int F, int H, int R, int K, int C,
                                              int depth, int F0) {
  // #11's (tc): at least #3's
  return sake::fused_ef_smem_floats<true>(sake::Dims{B, N, F, H, R, K, C, depth}, F0) *
         (long long)sizeof(float);
}

// #11. h0 (B, N, F) embedded, xs (3, B, N), v = 0; w0 (F, F0), b0, w1 (F0,
// O), b1, w0t (F0, F): the readout. Writes the boundary states bh (depth, B,
// N, F), bx, bv (depth, 3, B, N), the residuals (resid_ptrs, RESIDS order, K1's
// shapes), h_fin (B, N, F), x_fin, v_fin (3, B, N), e_out (B,) and dx_out
// (3, B, N).
extern "C" int sake_fused_primal(const float* h0, const float* xs, const float* upd,
                                 const void* const* leaf_ptrs, const void* const* leaf_t_ptrs,
                                 const long long* leaf_strides, const float* w0,
                                 const float* b0, const float* w1, const float* b1,
                                 const float* w0t, float* bh, float* bx, float* bv,
                                 void* const* resid_ptrs, float* h_fin, float* x_fin,
                                 float* v_fin, float* e_out, float* dx_out, int B, int N, int F,
                                 int H, int R, int K, int C, int depth, int F0, int O,
                                 void* stream) {
  using namespace sake;
  return launch<false>(Dims{B, N, F, H, R, K, C, depth}, B, h0, xs, upd, nullptr, leaf_ptrs,
                       leaf_t_ptrs, leaf_strides, Readout{w0, b0, w1, b1, w0t, F0, O}, bh, bx,
                       bv, resid_ptrs, h_fin, x_fin, v_fin, e_out, dx_out, stream);
}

// The clock probe's slots (probe.cuh), block cycles summed over this source's
// launches since the last reset; an error unless built with -DSAKE_PROBE.
extern "C" int sake_fused_ef_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}

// #3's grid: as many blocks as the card holds at once, at most B.
extern "C" int sake_one_ef_grid(int B, int N, int F, int H, int R, int K, int C, int depth,
                                int F0) {
  using namespace sake;
  size_t smem;
  if (set_smem<true>(Dims{B, N, F, H, R, K, C, depth}, F0, &smem) != cudaSuccess) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_ef_kernel<true>,
                                                    kFusedThreads, smem) != cudaSuccess)
    return -1;
  const long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(g < B ? g : B);
}

// #3. As sake_fused_primal, with mask (B, N, N) f32 or null, and the streams
// (bh, bx, bv, resid_ptrs) a scratch of `grid` molecules (the layouts of
// sake_fused_primal with B = grid); writes only e_out and dx_out.
extern "C" int sake_one_ef(const float* h0, const float* xs, const float* upd,
                           const float* mask, const void* const* leaf_ptrs,
                           const void* const* leaf_t_ptrs, const long long* leaf_strides,
                           const float* w0, const float* b0, const float* w1, const float* b1,
                           const float* w0t, float* bh, float* bx, float* bv,
                           void* const* resid_ptrs, float* e_out, float* dx_out, int grid, int B,
                           int N, int F, int H, int R, int K, int C, int depth, int F0, int O,
                           void* stream) {
  using namespace sake;
  return launch<true>(Dims{B, N, F, H, R, K, C, depth}, grid, h0, xs, upd, mask, leaf_ptrs,
                      leaf_t_ptrs, leaf_strides, Readout{w0, b0, w1, b1, w0t, F0, O}, bh, bx, bv,
                      resid_ptrs, nullptr, nullptr, nullptr, e_out, dx_out, stream);
}
