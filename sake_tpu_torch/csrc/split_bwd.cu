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
// A block owns one molecule and runs its receiver rows in order, because
// the senders' x_j, a_j and o_j get cotangents from every row: those sums
// stay in shared memory, one thread per element, no atomics.
//
// What bounds them on an H100: f32 multiply-adds, the forward's plus the
// pullback's (the x-mixing product runs forward and transposed: about
// twice the forward for coeff_pool): 0.41 ms (edge_att), 3.61 ms
// (coeff_pool) and 4.02 ms (merged) at B = 2048 aspirin. One block per
// molecule (56-89 KB of shared memory, 111-128 registers) runs at 5-17
// times that: edge_att 6.87 ms, coeff_pool 18.16 ms, merged 24.61 ms on an
// H100 (700 W) (chip_smoke.py phase 22).

#include "split_edge.cuh"

// op: sake::SplitOp; in, w: as sake_split_fwd; g: g_h_e, g_att,
// g_pooled0..2, g_hatt_sum (null where the op has none); out: dx0, dx1,
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
