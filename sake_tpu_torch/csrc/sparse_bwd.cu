// #14: the pullback of the cutoff-sparse edge chain, f32, in two
// instantiations.
//
// Replaces the TPU kernel of sake_tpu/kernels/sparse_ef.py at :432
// (bwd_kernel, :401). Like it, it recomputes #13's chain from the saved
// inputs and then runs _edge_pullback (:173-304): the input cotangents
// d_h_g (NR, K, F), d_a_i (NR, R), d_o_i (NR, H) and d_d0 (3, NR, K).
// - sake_sparse_bwd: input cotangents only (force evaluation, MD);
// - sake_sparse_bwd_rows: also the cotangent rows of the 11 edge-leaf
//   gradients (EDGE_ROWS, each (NR * K, width)), which sparse_contract.cu
//   sums over all edges in a fixed order: the JAX kernel's
//   want_param_grads=True accumulates them across its sequential grid,
//   which blocks running in parallel cannot do without float atomics.
//
// What bounds it on an H100: multiply-adds, about 2.0 times the forward's
// (the x-mixing product runs forward and transposed). Both x-mixing products
// run on the tensor cores as #13's (wgmma_tf32.cuh; the transpose reads the
// packed planes of w_xmix itself, TF32 wgmma taking only K-major operands),
// which puts the bound at 0.649 ms at N = 4096, K = 64 (1.258 at the f32
// rate); the narrow products and the pullback's tail stay on the CUDA cores:
// 4.73 ms there on an H100 (700 W; tools/sparse_ab.py), 7.95 before.

#include "sparse_edge.cuh"

namespace {

sake::EdgeArgs bwd_args(const float* hg, const float* ai, const float* oi, const float* d0,
                        const float* m, const void* const* w, const float* gp, const float* gh,
                        float* d_hg, float* d_ai, float* d_oi, float* d_d0, int NR, int K, int F,
                        int R, int H, int Kh, int C) {
  sake::EdgeArgs A{};
  A.d = sake::EDims{NR, K, F, R, H, Kh, C};
  A.hg = hg;
  A.ai = ai;
  A.oi = oi;
  A.d0 = d0;
  A.m = m;
  A.W = sake::edge_weights(w);
  A.gp = gp;
  A.gh = gh;
  A.d_hg = d_hg;
  A.d_ai = d_ai;
  A.d_oi = d_oi;
  A.d_d0 = d_d0;
  return A;
}

}  // namespace

// gp: (3, NR, C) and gh: (NR, H * Kh), the cotangents of #13's outputs.
extern "C" int sake_sparse_bwd(const float* hg, const float* ai, const float* oi,
                               const float* d0, const float* m, const void* const* w,
                               const float* gp, const float* gh, float* d_hg, float* d_ai,
                               float* d_oi, float* d_d0, int NR, int K, int F, int R, int H,
                               int Kh, int C, void* stream) {
  const sake::EdgeArgs A =
      bwd_args(hg, ai, oi, d0, m, w, gp, gh, d_hg, d_ai, d_oi, d_d0, NR, K, F, R, H, Kh, C);
  return sake::launch_edge_wg<false, true, false>(A, sake::edge_planes(w), stream);
}

// rows: the 12 EDGE_ROWS buffers.
extern "C" int sake_sparse_bwd_rows(const float* hg, const float* ai, const float* oi,
                                    const float* d0, const float* m, const void* const* w,
                                    const float* gp, const float* gh, float* d_hg, float* d_ai,
                                    float* d_oi, float* d_d0, void* const* rows, int NR, int K,
                                    int F, int R, int H, int Kh, int C, void* stream) {
  sake::EdgeArgs A =
      bwd_args(hg, ai, oi, d0, m, w, gp, gh, d_hg, d_ai, d_oi, d_d0, NR, K, F, R, H, Kh, C);
  for (int i = 0; i < sake::kEdgeRows; ++i) A.rows[i] = static_cast<float*>(rows[i]);
  return sake::launch_edge_wg<false, true, true>(A, sake::edge_planes(w), stream);
}

// The most neighbour slots a row may have at these widths, for both
// instantiations (sparse_edge.cuh's wg_max_slots).
extern "C" int sake_sparse_bwd_max_slots(int F, int R, int H, int Kh, int C) {
  return sake::wg_max_slots<false, true>(sake::EDims{1, 1, F, R, H, Kh, C});
}

// The clock probe's slots (probe.cuh) of both instantiations, block cycles
// summed over this source's launches since the last reset; an error unless
// built with -DSAKE_PROBE.
extern "C" int sake_sparse_bwd_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}
