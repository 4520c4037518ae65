// #25 and #27: the forward kernels of the split ops, f32.
//
// Replaces the TPU kernels of sake_tpu/kernels/split_ef.py at :158
// (_call_batched.kernel, :151), which runs _edge_att_body (:56) for the
// edge_att op and _coeff_pool_body (:101) for the coeff_pool op, and at
// :448 (make_edge_pool_op._fwd_kernel, :423), which runs _merged_body
// (:394): the two bodies back to back, h_e and att never leaving the
// kernel. The body is split_row (split_edge.cuh); a block owns one
// receiver row.
//
// What bounds them on an H100: f32 multiply-adds. Per edge the edge_att
// body does R*H + H*H + H*Kh of them (7,552 at aspirin's widths) and the
// coeff_pool body HK*C + 3C (66,304), so at B = 2048 one launch needs 0.20 ms
// (edge_att) and 1.79 ms (coeff_pool) at the 67 TFLOP/s f32 peak, above the
// 0.07 ms the edge_att op's 246 MB of h_e and att take at 3.35 TB/s. The
// x-mixing product, 88% of the work, stages 16 rows of w_xmix at a time in
// shared memory (mm_wide) for chunks of at most 16 senders; the merged
// kernel keeps h_e and att in shared memory instead of device memory.
// With one 256-thread block per row (43-69 KB of shared memory, 128
// registers: two blocks per SM) latency sets the pace: at B = 2048 aspirin
// on an H100 (700 W), edge_att 3.50 ms, coeff_pool 8.14 ms, merged 11.35 ms
// (chip_smoke.py phase 22).

#include "split_edge.cuh"

// op: sake::SplitOp; in: x0, x1, x2, a_j, a_i, o_j, o_i, h_e, att (null where
// the op takes none); w: the 10 weights then 4 transposes (the forward reads
// no transpose); out: h_e, att, pooled0, pooled1, pooled2, hatt_sum (null
// where the op writes none).
extern "C" int sake_split_fwd(int op, const void* const* in, const void* const* w,
                              void* const* out, int B, int N, int R, int H, int Kh, int C,
                              void* stream) {
  sake::SplitArgs A = sake::split_args(in, w, B, N, R, H, Kh, C);
  A.he_out = static_cast<float*>(out[0]);
  A.att_out = static_cast<float*>(out[1]);
  for (int k = 0; k < 3; ++k) A.pool[k] = static_cast<float*>(out[2 + k]);
  A.hs = static_cast<float*>(out[5]);
  switch (op) {
    case sake::OP_EDGE_ATT: return sake::launch_split<true, false, false, false>(A, stream);
    case sake::OP_COEFF_POOL: return sake::launch_split<false, true, false, false>(A, stream);
    case sake::OP_MERGED: return sake::launch_split<true, true, false, false>(A, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Bytes of shared memory one block of the op's forward (pull = 0) or
// pullback (pull = 1) takes.
extern "C" long long sake_split_smem_bytes(int op, int pull, int B, int N, int R, int H, int Kh,
                                           int C) {
  return sake::split_smem(op, pull != 0, sake::SDims{B, N, R, H, Kh, C});
}
