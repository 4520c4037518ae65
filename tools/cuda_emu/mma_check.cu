// The tensor-core helpers of csrc/mma_tf32x3.cuh alone, for the CPU emulator
// (emulate.py --helper): out = A @ W through mm_tc (which: 3, k = 256 and 256
// columns, up to 24 rows; 6: up to 48 rows) or mm_tc_small (which: 0, k and
// columns given), one block of 512 threads with A in shared memory.
#include "mma_tf32x3.cuh"

namespace {

__global__ void __launch_bounds__(512, 1)
check_kernel(int which, int n, int kd, int m, const float* A, int lda, const float* W,
             float* out) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* ring = As + (size_t)n * lda;
  for (int e = threadIdx.x; e < n * lda; e += blockDim.x) As[e] = A[e];
  __syncthreads();
  auto st = [&](int r, int c, float a) { out[(size_t)r * m + c] = a; };
  if (which == 3) sake::mm_tc<3>(n, As, lda, W, ring, st);
  else if (which == 6) sake::mm_tc<6>(n, As, lda, W, ring, st);
  else sake::mm_tc_small(n, kd, m, As, lda, W, st);
}

}  // namespace

extern "C" int sake_mma_check(int which, int n, int kd, int m, const float* A, int lda,
                              const float* W, float* out) {
  const size_t smem =
      ((size_t)n * lda + (size_t)sake::kTcWarps * sake::kTcStages * sake::kTcStage) * 4;
  check_kernel<<<1, 512, smem, nullptr>>>(which, n, kd, m, A, lda, W, out);
  return 0;
}
