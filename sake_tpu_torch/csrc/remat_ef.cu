// #21-#24: the E + F kernels of the kernel API that keep only the boundary
// states, f32: the layer stack's forward writing each layer's input state
// (h, x, v), and its pullback re-running each layer from its boundary.
//
// Replaces four TPU kernels that compute the same function in two
// orchestrations:
// - sake_tpu/kernels/fori_ef.py -> fori_energy_forces: fwd_kernel (#21, the
//   pallas_call at :161, body :133), all layers in a fori_loop writing the
//   boundaries and the final h; bwd_kernel (#22, :237, body :200), the layers
//   in reverse, each re-traced under jax.vjp from its boundary, input
//   cotangents only, dx after layer 0. Here: one launch each, every block
//   looping over depth for its molecule.
// - sake_tpu/kernels/depthgrid_ef.py -> depthgrid_energy_forces: fwd_kernel
//   (#23, :400, body :360) and bwd_kernel (#24, :487, body :438), the same
//   bodies with depth as the inner grid axis and the carried state in VMEM
//   scratch between grid steps. CUDA blocks of one grid run in no order, so
//   here depth is the launch: one launch per layer (in reverse for #24), the
//   carried state (h, x, v) or cotangent (dh, dx, dv) in device memory between
//   launches, read and overwritten in place (each block reads and writes only
//   its molecule's slot).
// Both JAX kernels differentiate depthgrid_ef.layer_forward_wide, the same
// layer as layer_fwd_resid (the wide head expansion is the hidden-major /
// head-minor product both index as h*K + k), so the bodies here are K1's and
// K2's: fwd_layer (resid_fwd.cuh) writing only the boundary, and, per layer
// of the pullback, fwd_layer writing that layer's 17 residuals into a
// one-layer, per-molecule scratch in device memory followed by bwd_layer
// (resid_bwd.cuh) reading them. Only one layer's residuals are ever alive
// (about 0.87 MB per aspirin molecule) against K1's whole stack (about 5.3 MB
// at depth 6): the memory of E + F is the boundaries, about 35 KB per
// molecule, and the scratch of the molecules in flight.
//
// Design: the forward runs K1's 256-thread block (two per SM), at aspirin's
// widths on K1's tensor-core body (remat_fwd_kernel<true>, resid_fwd_tc_kernel's
// layout: the 8-warp W ring before the kTc carve); the pullback
// one 512-thread block per molecule (K2's size, and mm_tc's 16 warp strips; the
// forward body loops over the block): the W ring of the tensor-core products,
// its cotangent state, and one work region that the re-forward and the
// pullback take in turn, all in shared memory. The residuals pass from the one
// body to the other through device memory (L2), read through plain (not const
// __restrict__) pointers after a __syncthreads, so no read is served from the
// non-coherent cache. The pullback keeps the re-forward on purpose: without it
// the scratch would hold every layer's residuals, K1 + K2's memory, which is
// what these paths exist to avoid (remat_step.cuh).
//
// What bounds it on an H100: #21 and #23 run K1's body without its residual
// writes: where fwd_tc_route holds (aspirin's widths, N <= 21) its kTc
// instantiation, the x-mixing product and o_f, o1 in 3xTF32 on mma.sync, the
// rest of each row on the CUDA cores; elsewhere the CUDA-core body, the f32
// FMA rate and per-row synchronisation. #22 and #24 run K1's and K2's kTc bodies
// (remat_layer): at aspirin's widths (tc_dims, reported by sake_remat_bwd_tc)
// the x-mixing product, its transpose and the edge products o_f and o1 take
// the tensor cores in 3xTF32 on mma.sync (a fraction of the TF32 rate,
// mma_tf32x3.cuh), the rest of each row the CUDA cores, with block barriers
// per row and one 512-thread block per SM; elsewhere every product runs on the
// CUDA cores. E + F costs about one forward more than K1 +
// K2. The per-layer launches of #23 and #24 add depth launches and a read and
// write of the carried state per layer (about 6 KB per aspirin molecule).

#include "remat_step.cuh"

namespace sake {
namespace {

constexpr int kRematFwdThreads = 256;
constexpr int kRematBwdThreads = 512;

// Layers [l0, l1) of molecule b from the state (h_in (B, N, F), x_in, v_in
// (3, B, N); v_in null: zeros), writing the state entering each layer to the
// boundary streams bh (depth, B, N, F), bx, bv (depth, 3, B, N) and the state
// after layer l1 - 1 to h_out, x_out, v_out (x_out null: h only). pool is the
// (3, B, N, C) scratch of one layer's pooled vectors. The outputs may be the
// inputs: each block reads its slot before it writes it. kTc: K1's
// tensor-core body in resid_fwd_tc_kernel's layout, the x-mixing product and
// the edge products o_f and o1 in 3xTF32 on mma.sync through an 8-warp W ring
// carved first (256 threads, two blocks an SM), taken where fwd_tc_route
// holds (aspirin's widths, N <= 21); else the CUDA-core body.
static_assert(kRematFwdThreads == 32 * kTcFwdWarps);

template <bool kTc>
__global__ void __launch_bounds__(kRematFwdThreads, 2)
remat_fwd_kernel(Dims d, int l0, int l1, const float* h_in, const float* x_in,
                 const float* v_in, const float* __restrict__ upd, Leaves L, float* bh,
                 float* bx, float* bv, Resids pool, float* h_out, float* x_out, float* v_out) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  Carver cv{reinterpret_cast<float*>(smem4)};
  [[maybe_unused]] float* ring = nullptr;
  if constexpr (kTc) ring = cv.take(tc_ring_floats<kTcFwdWarps>(d));
  const FwdSmem S = carve_fwd<kTc>(cv, d);
  fwd_begin(d, S, B, b, h_in, x_in, v_in, nullptr);
  for (int l = l0; l < l1; ++l) {
    if constexpr (kTc)
      fwd_layer<false, true, false, true, false, kTcFwdWarps>(d, S, b, l, upd[l], nullptr, L,
                                                              bh, bx, bv, pool, ring);
    else
      fwd_layer<false, true>(d, S, b, l, upd[l], nullptr, L, bh, bx, bv, pool);
  }

  for (int e = tid; e < N * F; e += nt) h_out[(size_t)b * N * F + e] = S.sh[e];
  if (x_out) {
    for (int e = tid; e < 3 * N; e += nt) {
      const size_t at = ((size_t)(e / N) * B + b) * N + e % N;
      x_out[at] = S.sx[e];
      v_out[at] = S.sv[e];
    }
  }
}

// Layers l_hi down to l_lo of the pullback of molecule b: the cotangents of
// the state leaving layer l_hi (dh_in (B, N, F), dx_in, dv_in (3, B, N); dx_in
// null: zeros, and dv_in with it) to those of the state entering layer l_lo
// (dh_out, dx_out, dv_out, which may be the inputs). bh, bx, bv: the boundary
// streams of the forward; RS: the one-layer residual scratch (B, ...).
__global__ void __launch_bounds__(kRematBwdThreads, 1)
remat_bwd_kernel(Dims d, int l_hi, int l_lo, const float* __restrict__ bh,
                 const float* __restrict__ bx, const float* __restrict__ bv,
                 const float* __restrict__ upd, Leaves L, Leaves LT, Resids RS,
                 const float* dh_in, const float* dx_in, const float* dv_in, float* dh_out,
                 float* dx_out, float* dv_out) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* ring = reinterpret_cast<float*>(smem4);  // the tensor-core products' W ring
  BwdSmem SB;
  FwdSmem SF;
  remat_carves(ring + tc_ring_floats(d), d, &SB, &SF);
  SAKE_PROBE_START();

  for (int e = tid; e < N * F; e += nt) SB.sdh[e] = dh_in[(size_t)b * N * F + e];
  for (int e = tid; e < 3 * N; e += nt) {
    const size_t at = ((size_t)(e / N) * B + b) * N + e % N;
    SB.sdx[e] = dx_in ? dx_in[at] : 0.f;
    SB.sdv[e] = dx_in ? dv_in[at] : 0.f;
  }
  for (int l = l_hi; l >= l_lo; --l)
    remat_layer(d, SF, SB, b, l, upd[l], L, LT, bh, bx, bv, RS, ring);

  for (int e = tid; e < N * F; e += nt) dh_out[(size_t)b * N * F + e] = SB.sdh[e];
  for (int e = tid; e < 3 * N; e += nt) {
    const size_t at = ((size_t)(e / N) * B + b) * N + e % N;
    dx_out[at] = SB.sdx[e];
    dv_out[at] = SB.sdv[e];
  }
}

}  // namespace
}  // namespace sake

// The clock probe's slots (probe.cuh), block cycles summed over this source's
// launches since the last reset (the forward body's slots: #22's and #24's
// re-forward; the pullback's: their pullback); an error unless built with
// -DSAKE_PROBE. Only remat_bwd_kernel starts the probe's clock.
extern "C" int sake_remat_bwd_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}

// Whether #22 and #24 run their x-mixing and edge products on the tensor cores
// at these widths (tc_dims: aspirin's), 1, or on the CUDA cores, 0.
extern "C" int sake_remat_bwd_tc(int B, int N, int F, int H, int R, int K, int C, int depth) {
  return sake::tc_dims(sake::Dims{B, N, F, H, R, K, C, depth}) ? 1 : 0;
}

// Whether #21 and #23 take remat_fwd_kernel<true> at these widths and N
// (fwd_tc_route: aspirin's widths, two blocks an SM), 1, or <false>, 0.
extern "C" int sake_remat_fwd_tc(int B, int N, int F, int H, int R, int K, int C, int depth) {
  return sake::fwd_tc_route(sake::Dims{B, N, F, H, R, K, C, depth}) ? 1 : 0;
}

// The shared memory of the forward kernel the shape takes.
extern "C" long long sake_remat_fwd_smem_bytes(int B, int N, int F, int H, int R, int K, int C,
                                               int depth) {
  const sake::Dims d{B, N, F, H, R, K, C, depth};
  return (sake::fwd_tc_route(d) ? sake::fwd_tc_smem_floats(d) : sake::fwd_smem_floats(d)) *
         (long long)sizeof(float);
}

extern "C" long long sake_remat_bwd_smem_bytes(int B, int N, int F, int H, int R, int K, int C,
                                               int depth) {
  return sake::remat_bwd_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}) *
         (long long)sizeof(float);
}

// Layers [l0, l1) of the forward (#21: 0, depth; #23: l, l + 1), on
// remat_fwd_kernel<true> where fwd_tc_route takes the shape, else <false>.
// h_in (B, N, F), x_in, v_in (3, B, N; v_in null: zeros);
// bh (depth, B, N, F), bx, bv (depth, 3, B, N): the boundary streams, written
// at layers l0 ... l1 - 1; pool: a (3, B, N, C) scratch; h_out (B, N, F),
// x_out, v_out (3, B, N; x_out null: not written) the state after layer l1 - 1.
extern "C" int sake_remat_fwd(int l0, int l1, const float* h_in, const float* x_in,
                              const float* v_in, const float* upd, const void* const* leaf_ptrs,
                              const long long* leaf_strides, float* bh, float* bx, float* bv,
                              float* pool, float* h_out, float* x_out, float* v_out, int B,
                              int N, int F, int H, int R, int K, int C, int depth, void* stream) {
  using namespace sake;
  const Dims d{B, N, F, H, R, K, C, depth};
  const bool tc = fwd_tc_route(d);
  const auto kernel = tc ? remat_fwd_kernel<true> : remat_fwd_kernel<false>;
  const size_t smem = (tc ? fwd_tc_smem_floats(d) : fwd_smem_floats(d)) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kRematFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      d, l0, l1, h_in, x_in, v_in, upd, leaves_of(leaf_ptrs, leaf_strides), bh, bx, bv,
      pool_resids(pool, d), h_out, x_out, v_out);
  return (int)cudaGetLastError();
}

// Layers l_hi down to l_lo of the pullback (#22: depth - 1, 0; #24: l, l).
// bh, bx, bv: the boundary streams; resid_ptrs: one layer's residual scratch
// (B, ...), RESIDS order; dh_in (B, N, F), dx_in, dv_in (3, B, N; dx_in null:
// both zero) the cotangents of the state leaving layer l_hi; dh_out, dx_out,
// dv_out those of the state entering layer l_lo.
extern "C" int sake_remat_bwd(int l_hi, int l_lo, const float* bh, const float* bx,
                              const float* bv, const float* upd, const void* const* leaf_ptrs,
                              const void* const* leaf_t_ptrs, const long long* leaf_strides,
                              void* const* resid_ptrs, const float* dh_in, const float* dx_in,
                              const float* dv_in, float* dh_out, float* dx_out, float* dv_out,
                              int B, int N, int F, int H, int R, int K, int C, int depth,
                              void* stream) {
  using namespace sake;
  const Dims d{B, N, F, H, R, K, C, depth};
  const size_t smem = remat_bwd_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(remat_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  remat_bwd_kernel<<<B, kRematBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      d, l_hi, l_lo, bh, bx, bv, upd, leaves_of(leaf_ptrs, leaf_strides),
      leaves_of(leaf_t_ptrs, leaf_strides), resids_of(resid_ptrs), dh_in, dx_in, dv_in, dh_out,
      dx_out, dv_out);
  return (int)cudaGetLastError();
}
