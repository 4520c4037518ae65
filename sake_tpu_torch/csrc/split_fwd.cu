// #25 and #27: the forward kernels of the split ops, f32.
//
// Replaces the TPU kernels of sake_tpu/kernels/split_ef.py at :158
// (_call_batched.kernel, :151), which runs _edge_att_body (:56) for the
// edge_att op and _coeff_pool_body (:101) for the coeff_pool op, and at
// :448 (make_edge_pool_op._fwd_kernel, :423), which runs _merged_body
// (:394): the two bodies back to back, h_e and att never leaving the
// kernel. Two routes (split_edge.cuh, chosen by split_fwd_tc, the pullbacks'
// widths rule split_tc_dims with a carve of their own):
// - the tensor cores (split_tc_fwd_kernel) where H * Kh = C = 256 and the edge
//   widths are at most 64 (aspirin's): 64 / N receiver rows as one 64-row tile
//   (split_group_fwd, the forward half of the pullbacks' split_group), o_f and
//   o1 on mma.sync and the x-mixing on wgmma, all in 3xTF32 with chunked sums;
//   h_e @ w_sem and the softmax warp-wide on the CUDA cores; hatt_sum and the
//   pooled planes summed over the senders in order. A block strides over the
//   groups (b, i0) of every molecule; the ops that mix x take one block an SM
//   (the x-mixing's 128 accumulators a thread), with a ring of four stages whose
//   first copies start while the block finishes the previous group, edge_att four;
// - the CUDA cores (split_kernel, a receiver row a block, every product in f32;
//   the x-mixing's w_xmix staged 16 rows at a time by mm_wide) elsewhere: hidden
//   8 and 16, H * Kh != 256.
//
// What bounds them on an H100 at B = 2048 aspirin: on the tensor-core route the
// products in 3xTF32 at 3 passes over 495 TFLOP/s and the rest (h_e @ w_sem,
// the epilogue) at the 67 TFLOP/s f32 peak: about 0.09 ms (edge_att), 0.74 ms
// (coeff_pool) and 0.83 ms (merged); every product at the f32 rate, 0.20, 1.79
// and 1.99 ms (chip_smoke.py phase 22's SPLIT BOUNDS). The edge_att op's 246 MB
// of h_e and att take 0.07 ms at 3.35 TB/s. On an NVIDIA H100 80GB HBM3 at 700 W
// the tensor-core route takes edge_att 1.70 ms, coeff_pool 3.18 ms and merged
// about 6.2 ms there, 19.6, 4.3 and 7.5 times its bounds, where the CUDA-core
// route took 3.49, 8.13 and 11.25 ms (tools/tc_ab.py --time-sets split, three
// alternating processes a tree). The clock probe (tools/probe_split.py) charges
// 58% of edge_att's block cycles to o_f and o1, and 61% of coeff_pool's to the
// x-mixing with 13% more to the waits for its ring (512 KB of planes a group
// from L2).

#include "split_edge.cuh"

// op: sake::SplitOp; in: x0, x1, x2, a_j, a_i, o_j, o_i, h_e, att (null where
// the op takes none); w: the 10 weights, 4 transposes (the forward reads none),
// then the packed forward plane of w_xmix (sparse_ef.xmix_planes; null where
// the op or the route reads none); out: h_e, att, pooled0, pooled1, pooled2,
// hatt_sum (null where the op writes none).
extern "C" int sake_split_fwd(int op, const void* const* in, const void* const* w,
                              void* const* out, int B, int N, int R, int H, int Kh, int C,
                              void* stream) {
  sake::SplitArgs A = sake::split_args(in, w, B, N, R, H, Kh, C);
  A.he_out = static_cast<float*>(out[0]);
  A.att_out = static_cast<float*>(out[1]);
  for (int k = 0; k < 3; ++k) A.pool[k] = static_cast<float*>(out[2 + k]);
  A.hs = static_cast<float*>(out[5]);
  if (sake::split_fwd_tc(op, A.d)) {
    const sake::WgPlanes P{static_cast<const float*>(w[sake::kSplitWPtrs]), nullptr};
    switch (op) {
      case sake::OP_EDGE_ATT: return sake::launch_split_tc_fwd<true, false>(A, P, stream);
      case sake::OP_COEFF_POOL: return sake::launch_split_tc_fwd<false, true>(A, P, stream);
      case sake::OP_MERGED: return sake::launch_split_tc_fwd<true, true>(A, P, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (op) {
    case sake::OP_EDGE_ATT: return sake::launch_split<true, false, false, false>(A, stream);
    case sake::OP_COEFF_POOL: return sake::launch_split<false, true, false, false>(A, stream);
    case sake::OP_MERGED: return sake::launch_split<true, true, false, false>(A, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 1 where the op's forward takes the tensor-core route at these dimensions
// (split_tc_fwd_kernel), 0 where it takes the CUDA cores (split_kernel).
extern "C" int sake_split_fwd_tc(int op, int B, int N, int R, int H, int Kh, int C) {
  return sake::split_fwd_tc(op, sake::SDims{B, N, R, H, Kh, C}) ? 1 : 0;
}

// The clock probe's slots (probe.cuh) of the forwards' kernels, block cycles
// summed over the launches since the last reset; only in a build with -DSAKE_PROBE.
extern "C" int sake_split_fwd_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}

// Bytes of shared memory one block of the op's forward (pull = 0) or
// pullback (pull = 1) takes: the kernel its route launches.
extern "C" long long sake_split_smem_bytes(int op, int pull, int B, int N, int R, int H, int Kh,
                                           int C) {
  return sake::split_smem(op, pull != 0, sake::SDims{B, N, R, H, Kh, C});
}
