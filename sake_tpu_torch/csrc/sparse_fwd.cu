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
// What bounds it on an H100: f32 multiply-adds, about 80.4k per edge, of
// which the x-mixing product (HK x C per edge) is 82%. That product stages
// 16 rows of w_xmix (256 KB in all) at a time in shared memory, prefetching
// the next 16 into registers, with 4 x 4 output tiles per thread
// (mm_wide); silu(e0) is computed once per element before its product; the
// softmax's elementwise steps use every thread. One 256-thread block per row
// (134 KB of shared memory and 155 registers at K = 64) leaves one block,
// eight warps, per SM, so latency still sets the pace: 3.5 ms at N = 4096,
// K = 64 on an H100 (700 W) against a 0.63 ms bound (chip_smoke.py).

#include "sparse_edge.cuh"

// d0: (3, NR, K); m: (NR, K); w: the 11 edge leaves then the 6 transposes;
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
  return sake::launch_edge<float, true, false, false>(A, stream);
}
