// #15: the second-order kernel of the cutoff-sparse edge op, f32.
//
// Replaces the TPU kernel of sake_tpu/kernels/sparse_ef.py at :546
// (bwd2_kernel, :501), which takes jax.vjp of (_edge_chain followed by
// _edge_pullback) on a block of rows: given the cotangents c of the
// pullback's outputs (d_h_g, d_a_i, d_o_i, d_d0), the cotangents of its
// inputs. Here the same function runs forward-over-reverse, the design of
// #9 + #10 for the dense layer: with pb(x, g) = J(x)^T g (J the chain's
// Jacobian in its inputs x = (h_g, a_i, o_i, d0)),
// - the cotangents of the g streams, c^T J^T = J c, are the tangents of
//   the chain's outputs along the direction c;
// - the cotangents of x, grad_x (c . pb), are the tangents of the pullback
//   itself when x carries the tangent c (the Hessian of g . f is
//   symmetric);
// - the cotangents of the 11 edge leaves are the tangents of the leaf
//   gradients (the mixed partials commute): their rows' tangents, which
//   sparse_contract.cu contracts as sum_e (t_a^T g + a^T t_g).
// So this kernel is edge_row on dual numbers (Dl: a value and a tangent):
// it writes the tangents of pooled, hatt, d_h_g, d_a_i, d_o_i and d_d0 and
// both halves of the 12 cotangent rows.
//
// What bounds it on an H100: multiply-adds, about twice #14's with rows (every
// product on values and tangents), 82% of them in the x-mixing product and its
// transpose. Those run on the tensor cores (wgmma_tf32.cuh, 3xTF32 with chunked
// sums, the planes of #13 and #14): w_xmix carries no tangent, so one 64-row M
// tile holds 32 slots' values and their tangents (sparse_edge.cuh's
// edge_wide_dl), and at K = 48 each plane streams twice per row and product.
// The narrow products and the tail stay on the CUDA cores. A dual slot takes
// twice a float slot's shared memory, so pre and rbf lie under the product tile
// and wait in two of the rows across the wide part (carve_wg, dl_park_pre_rbf),
// and a row takes at most 67 slots at the sparse widths
// (sake_sparse_bwd2_max_slots).

#include "sparse_edge.cuh"

// w: as #14's (the 11 edge leaves, the 6 transposes, the packed planes of the
// forward's and the pullback's x-mixing). c_hg (NR, K, F), c_ai (NR, R), c_oi
// (NR, H), c_d0 (3, NR, K): the incoming cotangents. Outputs: e_hg, e_ai, e_oi,
// e_d0 (the inputs' cotangents), e_gp (3, NR, C), e_gh (NR, H * Kh) (the g
// streams'), and rows / t_rows, the 12 EDGE_ROWS buffers and their tangents.
extern "C" int sake_sparse_bwd2(const float* hg, const float* ai, const float* oi,
                                const float* d0, const float* m, const void* const* w,
                                const float* gp, const float* gh, const float* c_hg,
                                const float* c_ai, const float* c_oi, const float* c_d0,
                                float* e_hg, float* e_ai, float* e_oi, float* e_d0, float* e_gp,
                                float* e_gh, void* const* rows, void* const* t_rows, int NR,
                                int K, int F, int R, int H, int Kh, int C, void* stream) {
  sake::EdgeArgs A{};
  A.d = sake::EDims{NR, K, F, R, H, Kh, C};
  A.hg = hg;
  A.ai = ai;
  A.oi = oi;
  A.d0 = d0;
  A.m = m;
  A.c_hg = c_hg;
  A.c_ai = c_ai;
  A.c_oi = c_oi;
  A.c_d0 = c_d0;
  A.W = sake::edge_weights(w);
  A.gp = gp;
  A.gh = gh;
  A.pooled = e_gp;
  A.hatt = e_gh;
  A.d_hg = e_hg;
  A.d_ai = e_ai;
  A.d_oi = e_oi;
  A.d_d0 = e_d0;
  for (int i = 0; i < sake::kEdgeRows; ++i) {
    A.rows[i] = static_cast<float*>(rows[i]);
    A.t_rows[i] = static_cast<float*>(t_rows[i]);
  }
  return sake::launch_edge_wg<true, true, true, sake::Dl>(A, sake::edge_planes(w), stream);
}

// The most neighbour slots a row may have at these widths (sparse_edge.cuh's
// wg_max_slots on dual numbers).
extern "C" int sake_sparse_bwd2_max_slots(int F, int R, int H, int Kh, int C) {
  return sake::wg_max_slots<true, true, sake::Dl>(sake::EDims{1, 1, F, R, H, Kh, C});
}

// The clock probe's slots (probe.cuh), block cycles summed over this source's
// launches since the last reset; an error unless built with -DSAKE_PROBE.
extern "C" int sake_sparse_bwd2_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}
