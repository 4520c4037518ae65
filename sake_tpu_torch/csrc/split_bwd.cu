// #26 and #28: the pullback kernels of the split ops, f32.
//
// Replaces the TPU kernels of sake_tpu/kernels/split_ef.py at :212
// (_generic_bwd.kernel, :190: jax.vjp of _edge_att_body or
// _coeff_pool_body) and at :513 (make_edge_pool_op's backward kernel,
// :471: jax.vjp of _merged_body). Like them, each recomputes its op's
// forward from the saved inputs and pulls the output cotangents back: the
// cotangents of every batched input, and with rows the per-edge cotangent
// rows (SplitRow) of the weights. The JAX kernels add the weight
// cotangents up in outputs that stay resident across their sequential grid
// (:199-207, :498-508); blocks on an H100 run in no order, so the rows go
// to sparse_contract.cu, which sums them in a fixed order in f64.
//
// A block owns one molecule, because the senders' x_j, a_j and o_j get
// cotangents from every receiver row: those sums stay in shared memory, one
// thread per element, the rows in order, no atomics. Two routes
// (split_edge.cuh, chosen by split_bwd_tc):
// - the tensor cores (split_tc_kernel) where H * Kh = C = 256 and the edge
//   widths are at most 64 (aspirin's): the rows 64 / N at a time as one 64-row
//   tile, the x-mixing and its transpose on wgmma, o_f, o1 and their pullbacks
//   on mma.sync, all in 3xTF32; coeff_pool and merged one block an SM (about
//   180-220 KB of shared memory with the product tile and its ring), edge_att
//   (about 105 KB at aspirin's widths) two;
// - the CUDA cores (split_kernel) elsewhere: the rows one at a time.
//
// What bounds them on an H100: the x-mixing product (forward and
// transposed, 88% of coeff_pool's multiply-adds) and the edge products in
// 3xTF32 at 3 passes over 495 TFLOP/s, the rest at 67 TFLOP/s f32: 0.17 ms
// (edge_att), 1.51 ms (coeff_pool) and 1.68 ms (merged) at B = 2048 aspirin
// (chip_smoke.py phase 22's SPLIT BOUNDS; 0.41, 3.61 and 4.02 with every
// product at the f32 rate). On an NVIDIA H100 80GB HBM3 at 700 W the
// tensor-core route takes edge_att 4.80 ms, coeff_pool 7.50 ms and merged
// 15.21 ms there, 28, 5.0 and 9.0 times its bounds, where the CUDA-core route
// took 6.92, 18.16 and 24.70 ms (tools/tc_ab.py --time-sets split, three
// alternating processes a tree).

#include "split_edge.cuh"

// op: sake::SplitOp; in: as sake_split_fwd; w: its weights and transposes,
// then the packed forward and pullback planes of w_xmix
// (sparse_ef.xmix_planes; null where the op or the route reads none); g:
// g_h_e, g_att, g_pooled0..2, g_hatt_sum (null where the op has none); out: dx0, dx1,
// dx2, d_a_j, d_a_i, d_o_j, d_o_i, d_h_e, d_att (null where the op has
// none); rows: null, or the kSplitRows row buffers (null where the op
// writes none).
extern "C" int sake_split_bwd(int op, const void* const* in, const void* const* w,
                              const void* const* g, void* const* out, void* const* rows, int B,
                              int N, int R, int H, int Kh, int C, void* stream) {
  sake::SplitArgs A = sake::split_args(in, w, B, N, R, H, Kh, C);
  A.g_he = static_cast<const float*>(g[0]);
  A.g_att = static_cast<const float*>(g[1]);
  for (int k = 0; k < 3; ++k) A.gp[k] = static_cast<const float*>(g[2 + k]);
  A.g_hs = static_cast<const float*>(g[5]);
  for (int k = 0; k < 3; ++k) A.dx[k] = static_cast<float*>(out[k]);
  A.d_aj = static_cast<float*>(out[3]);
  A.d_ai = static_cast<float*>(out[4]);
  A.d_oj = static_cast<float*>(out[5]);
  A.d_oi = static_cast<float*>(out[6]);
  A.d_he = static_cast<float*>(out[7]);
  A.d_att = static_cast<float*>(out[8]);
  if (rows)
    for (int k = 0; k < sake::kSplitRows; ++k) A.rows[k] = static_cast<float*>(rows[k]);
  if (sake::split_bwd_tc(op, A.d)) {
    const sake::WgPlanes P{static_cast<const float*>(w[sake::kSplitWPtrs]),
                           static_cast<const float*>(w[sake::kSplitWPtrs + 1])};
    switch (op) {
      case sake::OP_EDGE_ATT:
        return rows ? sake::launch_split_tc<true, false, true>(A, P, stream)
                    : sake::launch_split_tc<true, false, false>(A, P, stream);
      case sake::OP_COEFF_POOL:
        return rows ? sake::launch_split_tc<false, true, true>(A, P, stream)
                    : sake::launch_split_tc<false, true, false>(A, P, stream);
      case sake::OP_MERGED:
        return rows ? sake::launch_split_tc<true, true, true>(A, P, stream)
                    : sake::launch_split_tc<true, true, false>(A, P, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (op) {
    case sake::OP_EDGE_ATT:
      return rows ? sake::launch_split<true, false, true, true>(A, stream)
                  : sake::launch_split<true, false, true, false>(A, stream);
    case sake::OP_COEFF_POOL:
      return rows ? sake::launch_split<false, true, true, true>(A, stream)
                  : sake::launch_split<false, true, true, false>(A, stream);
    case sake::OP_MERGED:
      return rows ? sake::launch_split<true, true, true, true>(A, stream)
                  : sake::launch_split<true, true, true, false>(A, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 1 where the op's pullback takes the tensor-core route at these dimensions
// (split_tc_kernel), 0 where it takes the CUDA cores (split_kernel).
extern "C" int sake_split_bwd_tc(int op, int B, int N, int R, int H, int Kh, int C) {
  return sake::split_bwd_tc(op, sake::SDims{B, N, R, H, Kh, C}) ? 1 : 0;
}

// The clock probe's slots (probe.cuh) of both routes, block cycles summed over
// the launches since the last reset; only in a build with -DSAKE_PROBE.
extern "C" int sake_split_bwd_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}
