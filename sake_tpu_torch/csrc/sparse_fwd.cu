// #13: the cutoff-sparse edge chain, f32.
//
// Replaces the TPU kernel of sake_tpu/kernels/sparse_ef.py at :364
// (fwd_kernel, :353): per receiver row, the in-kernel j-projections of the
// gathered h_g, rbf, the CFConv filter, h_e, the semantic softmax over the
// row's K slots with the mask renormalisation, the head expansion, the
// tanh x-mixing and the pooled planes and attended features. a_i and o_i
// arrive with b_in and b_o0 folded in. The body is edge_row
// (sparse_edge.cuh), which #14 and #15 share.
//
// What bounds it on an H100: multiply-adds, about 80.4k per edge, of which
// the x-mixing product (HK x C per edge) is 82%. That product runs on the
// tensor cores (wgmma_tf32.cuh: wgmma in 3xTF32 with chunked sums, the row's
// K slots as the 64-row M tile, the weight's packed hi and lo planes streamed
// once per row through a ring of bulk copies), which puts the bound at 0.324
// ms at N = 4096, K = 64 (0.629 with every product at the f32 rate). The
// narrow products stay on the CUDA cores (mmT, mm_wide) and are now half the
// block's cycles: 2.16 ms there on an H100 (700 W; tools/sparse_ab.py), 3.36
// before. One 256-thread block per row (two warpgroups) leaves one block per
// SM.

#include "sparse_edge.cuh"

// d0: (3, NR, K); m: (NR, K); w: the 11 edge leaves, the 6 transposes (unread
// here), the packed planes of the forward's and the pullback's x-mixing;
// pooled: (3, NR, C); hatt: (NR, H * Kh).
extern "C" int sake_sparse_fwd(const float* hg, const float* ai, const float* oi,
                               const float* d0, const float* m, const void* const* w,
                               float* pooled, float* hatt, int NR, int K, int F, int R, int H,
                               int Kh, int C, void* stream) {
  sake::EdgeArgs A{};
  A.d = sake::EDims{NR, K, F, R, H, Kh, C};
  A.hg = hg;
  A.ai = ai;
  A.oi = oi;
  A.d0 = d0;
  A.m = m;
  A.W = sake::edge_weights(w);
  A.pooled = pooled;
  A.hatt = hatt;
  return sake::launch_edge_wg<true, false, false>(A, sake::edge_planes(w), stream);
}

// The most neighbour slots a row may have at these widths (sparse_edge.cuh's
// wg_max_slots): the route holds a row's edge values in shared memory.
extern "C" int sake_sparse_fwd_max_slots(int F, int R, int H, int Kh, int C) {
  return sake::wg_max_slots<true, false>(sake::EDims{1, 1, F, R, H, Kh, C});
}

// The clock probe's slots (probe.cuh), block cycles summed over this source's
// launches since the last reset; an error unless built with -DSAKE_PROBE.
extern "C" int sake_sparse_fwd_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}
