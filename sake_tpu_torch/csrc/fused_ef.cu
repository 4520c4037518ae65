// #11 and #3 in f32: the entries of fused_ef.cuh's kernel (its design, and
// the TPU kernels it replaces, are there).
//
// Replaces sake_tpu/kernels/train2_ef.py -> _fused_primal's kernel (the
// pallas_call at :1320, body :1239) and sake_tpu/kernels/one_ef.py ->
// one_energy_forces's kernel (the pallas_call at :261, body :177).

#include "fused_ef.cuh"

extern "C" long long sake_fused_ef_smem_bytes(int B, int N, int F, int H, int R, int K, int C,
                                              int depth, int F0) {
  // #11's (tc): at least #3's
  return sake::fused_ef_smem_floats<true>(sake::Dims{B, N, F, H, R, K, C, depth}, F0) *
         (long long)sizeof(float);
}

// #11. h0 (B, N, F) embedded, xs (3, B, N), v = 0; w0 (F, F0), b0, w1 (F0,
// O), b1, w0t (F0, F): the readout. Writes the boundary states bh (depth, B,
// N, F), bx, bv (depth, 3, B, N), the residuals (resid_ptrs, RESIDS order, K1's
// shapes), h_fin (B, N, F), x_fin, v_fin (3, B, N), e_out (B,) and dx_out
// (3, B, N).
extern "C" int sake_fused_primal(const float* h0, const float* xs, const float* upd,
                                 const void* const* leaf_ptrs, const void* const* leaf_t_ptrs,
                                 const long long* leaf_strides, const float* w0,
                                 const float* b0, const float* w1, const float* b1,
                                 const float* w0t, float* bh, float* bx, float* bv,
                                 void* const* resid_ptrs, float* h_fin, float* x_fin,
                                 float* v_fin, float* e_out, float* dx_out, int B, int N, int F,
                                 int H, int R, int K, int C, int depth, int F0, int O,
                                 void* stream) {
  using namespace sake;
  return launch<false>(Dims{B, N, F, H, R, K, C, depth}, B, h0, xs, upd, nullptr, leaf_ptrs,
                       leaf_t_ptrs, leaf_strides, Readout{w0, b0, w1, b1, w0t, F0, O}, bh, bx,
                       bv, resid_ptrs, h_fin, x_fin, v_fin, e_out, dx_out, nullptr, stream);
}

// The clock probe's slots (probe.cuh), block cycles summed over this source's
// launches since the last reset; an error unless built with -DSAKE_PROBE.
extern "C" int sake_fused_ef_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}

// #3's grid: as many blocks as the card holds at once, at most B.
extern "C" int sake_one_ef_grid(int B, int N, int F, int H, int R, int K, int C, int depth,
                                int F0) {
  using namespace sake;
  size_t smem;
  if (set_smem<true>(Dims{B, N, F, H, R, K, C, depth}, F0, &smem) != cudaSuccess) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_ef_kernel<true>,
                                                    kFusedThreads, smem) != cudaSuccess)
    return -1;
  const long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(g < B ? g : B);
}

// #3. As sake_fused_primal, with mask (B, N, N) f32 or null, and the streams
// (bh, bx, bv, resid_ptrs) a scratch of `grid` molecules (the layouts of
// sake_fused_primal with B = grid); writes only e_out and dx_out.
extern "C" int sake_one_ef(const float* h0, const float* xs, const float* upd,
                           const float* mask, const void* const* leaf_ptrs,
                           const void* const* leaf_t_ptrs, const long long* leaf_strides,
                           const float* w0, const float* b0, const float* w1, const float* b1,
                           const float* w0t, float* bh, float* bx, float* bv,
                           void* const* resid_ptrs, float* e_out, float* dx_out, int grid, int B,
                           int N, int F, int H, int R, int K, int C, int depth, int F0, int O,
                           void* stream) {
  using namespace sake;
  return launch<true>(Dims{B, N, F, H, R, K, C, depth}, grid, h0, xs, upd, mask, leaf_ptrs,
                      leaf_t_ptrs, leaf_strides, Readout{w0, b0, w1, b1, w0t, F0, O}, bh, bx, bv,
                      resid_ptrs, nullptr, nullptr, nullptr, e_out, dx_out, nullptr, stream);
}
