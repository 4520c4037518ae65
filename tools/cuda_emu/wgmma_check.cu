// The warpgroup product of csrc/wgmma_tf32.cuh alone, for the CPU emulator
// (emulate.py --wgmma): out = A @ B for A (n x 256, n <= 64) in shared memory
// and B given as its packed hi and lo planes (sparse_ef.xmix_planes), through
// wg_xmix, one block of 256 threads with a ring of `stages` stages, the product
// run `reps` times in a row (the ring's phases wrap).
#include "wgmma_tf32.cuh"

namespace {

__global__ void __launch_bounds__(256, 1)
check_kernel(int n, const float* A, const float* bpk, float* out, int stages, int reps) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  sake::WgRing rg;
  rg.ring = As + sake::kWgRows * sake::kWgDepth;
  rg.full = reinterpret_cast<unsigned long long*>(rg.ring + (size_t)stages * sake::kWgStage);
  rg.empty = rg.full + stages;
  rg.stages = stages;
  rg.q = 0;
  for (int e = threadIdx.x; e < n * sake::kWgDepth; e += blockDim.x) As[e] = A[e];
  sake::wg_init(rg);
  __syncthreads();
  for (int i = 0; i < reps; ++i)
    sake::wg_xmix(n, [&](int r, int k) { return As[r * sake::kWgDepth + k]; }, bpk, rg,
                  [&](int r, int c, float v) { out[r * sake::kWgCols + c] = v; });
}

}  // namespace

extern "C" int sake_wgmma_check(int n, const float* A, const float* bpk, float* out, int stages,
                                int reps) {
  const size_t smem = ((size_t)sake::kWgRows * sake::kWgDepth +
                       (size_t)stages * sake::kWgStage + 4 * stages) * 4;
  check_kernel<<<1, 256, smem, nullptr>>>(n, A, bpk, out, stages, reps);
  return 0;
}
