// #12's block in f32: the entry of fused_bwd.cuh's kernel (its design is
// there).
//
// Replaces the TPU kernel sake_tpu/kernels/train2_ef.py -> _fused_bwd_chunk's
// kernel (the pallas_call at :1908, body :1750).

#include "fused_bwd.cuh"

extern "C" long long sake_fused_bwd_smem_bytes(int B, int N, int F, int H, int R, int K, int C,
                                               int depth, int F0) {
  return sake::fused_bwd_smem_floats(sake::Dims{B, N, F, H, R, K, C, depth}, F0) *
         (long long)sizeof(float);
}

// bh, bx, bv, resid_ptrs: the primal's boundary states and residuals; h_fin
// (B, N, F); tx0 (3, B, N) the force cotangent; g_e (B,) the energy
// cotangent; w0, b0, w1, b1, w0t the readout as in sake_fused_primal.
// Writes the tangent boundaries tbh, tbx, tbv and residuals (tresid_ptrs),
// the rows of the primal chain (row_ptrs), of the tangent chain (trow_ptrs)
// and their tangents (ttrow_ptrs), dh0 (B, N, F), dx0 (3, B, N) and ro_part
// (B, F*F0 + F0 + F0*O + O). scratch: B * 2N * (H*K + C) floats.
extern "C" int sake_fused_bwd(const float* bh, const float* bx, const float* bv,
                              const float* upd, const void* const* leaf_ptrs,
                              const void* const* leaf_t_ptrs, const long long* leaf_strides,
                              void* const* resid_ptrs, const float* h_fin, const float* tx0,
                              const float* g_e, const float* w0, const float* b0,
                              const float* w1, const float* b1, const float* w0t, float* tbh,
                              float* tbx, float* tbv, void* const* tresid_ptrs,
                              void* const* row_ptrs, void* const* trow_ptrs,
                              void* const* ttrow_ptrs, float* scratch, float* dh0, float* dx0,
                              float* ro_part, int B, int N, int F, int H, int R, int K, int C,
                              int depth, int F0, int O, void* stream) {
  using namespace sake;
  return launch_fused_bwd<false>(bh, bx, bv, upd, leaf_ptrs, leaf_t_ptrs, leaf_strides,
                                 resid_ptrs, h_fin, tx0, g_e, Readout{w0, b0, w1, b1, w0t, F0, O},
                                 tbh, tbx, tbv, tresid_ptrs, row_ptrs, trow_ptrs, ttrow_ptrs,
                                 scratch, dh0, dx0, ro_part, nullptr,
                                 Dims{B, N, F, H, R, K, C, depth}, stream);
}

// The clock probe's slots, as sake_fused_ef_probe.
extern "C" int sake_fused_bwd_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}
