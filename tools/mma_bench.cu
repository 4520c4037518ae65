// The x-mixing product of one receiver row (A: n x 256 in shared memory, W:
// 256 x 256 in device memory) and the o1 edge product (n x 64 @ 64 x 64), alone,
// 126 times in a row per block (one molecule's rows over depth 6) on 132
// blocks of 512 threads: the CUDA-core tiling the bodies ran before (mm_tiled,
// mm_smem), the 3xTF32 tensor-core products (mm_tc, mm_tc_small), and one TF32
// pass over every row's tile, padding included (what the split costs). Prints cycles per product
// (block 0, clock64) and ms per launch (CUDA events), then the x-mixing product's error
// against float64 on the CUDA cores and in 3xTF32 with and without chunk sums. Then the
// sparse shape (one receiver row of #13 and #14: 64 slots by 256 against 256 x 256), 31
// times in a row per block (a row per SM at N = 4096) on 132 blocks of 256 threads:
// mm_wide in chunks of 16 slots (the CUDA cores, the route #13 and #14 had before),
// #11's and #12's mma.sync 3xTF32 (mm_tc, eight n8 tiles), and the wgmma 3xTF32 of #13
// and #14 (wg_xmix), and wg_xmix against float64. Run by mma_bench.py.
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <vector>

#include "sparse_edge.cuh"

using namespace sake;

// mm_tc's loop with the hi parts only: one TF32 pass
template <int kTiles, class ST>
__device__ void mm_one_pass(int n, const float* A, int lda, const float* __restrict__ W,
                            float* ring, ST st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  float* my = ring + warp * (kTcStages * kTcStage);
  const int ck = lane >> 2, cc = 4 * (lane & 3), cdst = tc_stage_at(ck, cc);
  for (int strip = warp; strip < kTcStrips; strip += blockDim.x >> 5) {
    const int c0 = strip * kTcStrip;
    const float* src = W + (size_t)ck * kTcK + c0 + cc;
    cp_async16(my + cdst, src);
    cp_async_commit();
    float acc[kTiles][2][4] = {};
    for (int ks = 0; ks < kTcK / 8; ++ks) {
      if (ks + 1 < kTcK / 8)
        cp_async16(my + ((ks + 1) & 1) * kTcStage + cdst, src + (size_t)(ks + 1) * 8 * kTcK);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();
      const float* sb = my + (ks & 1) * kTcStage;
      uint32_t b[2][2];
      for (int j = 0; j < 2; ++j)
        for (int q = 0; q < 2; ++q) b[j][q] = tf32_rna(sb[tc_stage_at(2 * t + q, 8 * j + g)]);
      for (int mi = 0; mi < kTiles; ++mi) {
        const int ra = 16 * mi + g, rb = ra + 8, k = 8 * ks + 2 * t;
        auto at = [&](int r, int kk) { return tf32_rna(r < n ? A[r * lda + kk] : 0.f); };
        const uint32_t a[4] = {at(ra, k), at(rb, k), at(ra, k + 1), at(rb, k + 1)};
        for (int j = 0; j < 2; ++j) mma_tf32(acc[mi][j], a, b[j][0], b[j][1]);
      }
      __syncwarp();
    }
    for (int mi = 0; mi < kTiles; ++mi)
      for (int j = 0; j < 2; ++j)
        if (16 * mi + g < n) st(16 * mi + g, c0 + 8 * j + 2 * t, acc[mi][j][0]);
  }
}

// mm_tc as it was first written: the three passes of every k-step added into
// one running accumulator by the mma itself (the accuracy check below holds it
// against mm_tc, which sums chunks of k-steps from zero and adds them in f32)
template <int kTiles, class ST>
__device__ void mm_tc_one_sum(int n, const float* A, int lda, const float* __restrict__ W,
                              float* ring, ST st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  float* my = ring + warp * (kTcStages * kTcStage);
  const int ck = lane >> 2, cc = 4 * (lane & 3), cdst = tc_stage_at(ck, cc);
  int woff[4];
  for (int q = 0; q < 4; ++q) woff[q] = tc_stage_at(2 * t + (q >> 1), g + 8 * (q & 1));
  for (int strip = warp; strip < kTcStrips; strip += blockDim.x >> 5) {
    const int c0 = strip * kTcStrip;
    const float* src = W + (size_t)ck * kTcK + c0 + cc;
    cp_async16(my + cdst, src);
    cp_async_commit();
    float acc[kTiles][4] = {};
    for (int ks = 0; ks < kTcK / 8; ++ks) {
      if (ks + 1 < kTcK / 8)
        cp_async16(my + ((ks + 1) & 1) * kTcStage + cdst, src + (size_t)(ks + 1) * 8 * kTcK);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();
      const float* sb = my + (ks & 1) * kTcStage;
      uint32_t wh[4], wl[4];
      for (int q = 0; q < 4; ++q) tf32_split(sb[woff[q]], wh[q], wl[q]);
      for (int ni = 0; ni < kTiles; ++ni) {
        const int r = 8 * ni + g;
        float2 x = make_float2(0.f, 0.f);
        if (r < n) x = *reinterpret_cast<const float2*>(A + (size_t)r * lda + 2 * t + 8 * ks);
        uint32_t xh0, xl0, xh1, xl1;
        tf32_split(x.x, xh0, xl0);
        tf32_split(x.y, xh1, xl1);
        mma_tf32x3(acc[ni], wh, wl, xh0, xh1, xl0, xl1);
      }
      __syncwarp();
    }
    cp_async_wait<0>();
    for (int ni = 0; ni < kTiles; ++ni) {
      const int r = 8 * ni + 2 * t, c = c0 + g;
      if (r < n) {
        st(r, c, acc[ni][0]);
        st(r, c + 8, acc[ni][2]);
      }
      if (r + 1 < n) {
        st(r + 1, c, acc[ni][1]);
        st(r + 1, c + 8, acc[ni][3]);
      }
    }
  }
}

// One x-mixing product (n <= 24 rows) of the host's A and W into out, by
// variant: 0 the CUDA cores (mm_tiled), 1 mm_tc, 2 mm_tc_one_sum.
template <int kV>
__global__ void __launch_bounds__(512, 1) accuracy(const float* Ag, const float* W, float* out,
                                                   int n) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);
  float* ring = A + 24 * 264;
  for (int e = threadIdx.x; e < n * 256; e += blockDim.x) A[(e / 256) * 264 + e % 256] = Ag[e];
  __syncthreads();
  auto st = [&](int r, int c, float a) { out[r * 256 + c] = a; };
  if constexpr (kV == 0) mm_tiled<2>(n, 256, 256, A, 264, W, st);
  if constexpr (kV == 1) mm_tc<3>(n, A, 264, W, ring, st);
  if constexpr (kV == 2) mm_tc_one_sum<3>(n, A, 264, W, ring, st);
}

// kTiles: m16 tiles of mm_one_pass (n8 tiles of mm_tc: twice as many)
template <int kV, int kTiles>
__global__ void __launch_bounds__(512, 1) kern(const float* W, float* out, int rows, int n,
                                               long long* cyc) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);
  float* ring = A + 48 * 264;
  float* O = ring + kTcWarps * kTcStages * kTcStage;
  for (int e = threadIdx.x; e < n * 264; e += blockDim.x) A[e] = 0.001f * (e % 97) - 0.03f;
  __syncthreads();
  const long long t0 = clock64();
  float sink = 0.f;
  for (int i = 0; i < rows; ++i) {
    auto st = [&](int r, int c, float a) { O[r * 256 + c] = a; };
    if constexpr (kV == 0) mm_tiled<2>(n, 256, 256, A, 264, W, st);
    if constexpr (kV == 1) mm_tc<kTiles == 2 ? 3 : 6>(n, A, 264, W, ring, st);
    if constexpr (kV == 2) mm_one_pass<kTiles>(n, A, 264, W, ring, st);
    if constexpr (kV == 3) mm_smem<4, 16>(n, 64, 64, A, 264, W, st);  // K1's body's policy
    if constexpr (kV == 4) mm_smem<2, 128>(n, 64, 64, A, 264, W, st);  // K2's
    if constexpr (kV == 5) mm_tc_small(n, 64, 64, A, 264, W, st);
    if constexpr (kV == 6) {  // the tangent pullback's 2N rows as two N-row products
      mm_tc<3>(n / 2, A, 264, W, ring, st);
      mm_tc<3>(n / 2, A + (size_t)(n / 2) * 264, 264, W, ring,
               [&](int r, int c, float a) { st(n / 2 + r, c, a); });
    }
    __syncthreads();
    sink += O[threadIdx.x];
  }
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  out[blockIdx.x * 512 + threadIdx.x] = sink;
}

// The sparse shape: one row's 64 x 256 product kRepeat times per block, by
// variant: 0 mm_wide in chunks of 16 slots, 1 mm_tc<8>, 2 wg_xmix; out: the
// last product of block 0 (the accuracy check reads it after one repeat).
template <int kV>
__global__ void __launch_bounds__(256, 1) sparse_kern(const float* Ag, const float* W,
                                                      const float* bpk, float* out, int reps,
                                                      long long* cyc) {
  extern __shared__ float4 smem4[];
  constexpr int lda = kWgCols + kWgXPad, n = kWgRows;
  float* A = reinterpret_cast<float*>(smem4);
  float* O = A + n * lda;
  float* scratch = O + n * kWgCols;  // mm_wide's W tile, mm_tc's ring or wg_xmix's ring
  for (int e = threadIdx.x; e < n * kWgDepth; e += blockDim.x)
    A[(e / kWgDepth) * lda + e % kWgDepth] = Ag[e];
  WgRing rg{scratch, reinterpret_cast<unsigned long long*>(scratch + 4 * kWgStage), nullptr, 4,
            0};
  rg.empty = rg.full + 4;
  if constexpr (kV == 2) wg_init(rg);
  __syncthreads();
  auto st = [&](int r, int c, float a) { O[r * kWgCols + c] = a; };
  const long long t0 = clock64();
  for (int i = 0; i < reps; ++i) {
    if constexpr (kV == 0)
      for (int c0 = 0; c0 < n; c0 += kWTile)
        mm_wide<float>(kWTile, kWgDepth, kWgCols, A + c0 * lda, lda, W, scratch,
                       [&](int r, int c, float a) { st(c0 + r, c, a); });
    if constexpr (kV == 1) mm_tc<8>(n, A, lda, W, scratch, st);
    if constexpr (kV == 2) wg_xmix(n, [&](int r, int k) { return A[r * lda + k]; }, bpk, rg, st);
    __syncthreads();
  }
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  if (blockIdx.x == 0)
    for (int e = threadIdx.x; e < n * kWgCols; e += blockDim.x) out[e] = O[e];
}

// tf32(x) with cvt.rna's rounding, on the host
static float tf32_host(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0x1000u;
  u &= 0xffffe000u;
  std::memcpy(&x, &u, 4);
  return x;
}

// sparse_ef.xmix_planes' forward packing of W (256 x 256, row-major): B = W^T,
// [k-step][hi, lo][column group][k half][column in group][k in half]
static std::vector<float> pack_planes(const std::vector<float>& w) {
  std::vector<float> p((size_t)kWgSteps * kWgStage);
  for (int ks = 0; ks < kWgSteps; ++ks)
    for (int pl = 0; pl < 2; ++pl)
      for (int c = 0; c < kWgCols; ++c)
        for (int kk = 0; kk < 8; ++kk) {
          const float x = w[(size_t)(8 * ks + kk) * kWgCols + c], hi = tf32_host(x);
          p[(size_t)ks * kWgStage + pl * kWgPlane + (c / 8) * 64 + (kk / 4) * 32 + (c % 8) * 4 +
            kk % 4] = pl ? tf32_host(x - hi) : hi;
        }
  return p;
}

static void sparse_bench(float* W, float* out, long long* cyc) {
  const int blocks = 132, reps = 31;
  const size_t smem = ((size_t)kWgRows * (kWgCols + kWgXPad) + (size_t)kWgRows * kWgCols +
                       4 * kWgStage + 16) * 4;
  std::vector<float> ha(kWgRows * kWgDepth), hw(65536);
  unsigned long long x = 0x2545F4914F6CDD1Dull;
  auto uni = [&]() {
    x = x * 6364136223846793005ull + 1442695040888963407ull;
    return (double)(x >> 11) / 9007199254740992.0;
  };
  for (auto& v : ha) v = (float)(2 * uni() - 1);
  for (auto& v : hw) v = (float)((2 * uni() - 1) / 16);
  std::vector<float> hp = pack_planes(hw);
  float *Ad, *Pd;
  cudaMalloc(&Ad, ha.size() * 4);
  cudaMalloc(&Pd, hp.size() * 4);
  cudaMemcpy(Ad, ha.data(), ha.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(W, hw.data(), hw.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(Pd, hp.data(), hp.size() * 4, cudaMemcpyHostToDevice);
  auto run = [&](auto k, const char* name) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    k<<<blocks, 256, smem>>>(Ad, W, Pd, out, reps, cyc);
    cudaEventRecord(a);
    k<<<blocks, 256, smem>>>(Ad, W, Pd, out, reps, cyc);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    std::vector<long long> c(blocks);
    cudaMemcpy(c.data(), cyc, blocks * 8, cudaMemcpyDeviceToHost);
    printf("MMA_BENCH sparse n=64 %s: %.4f ms per launch (%d products a block on %d blocks), "
           "%lld cycles per product (%s)\n", name, ms, reps, blocks, c[0] / reps,
           cudaGetErrorString(cudaGetLastError()));
    // one product against float64
    k<<<1, 256, smem>>>(Ad, W, Pd, out, 1, cyc);
    std::vector<float> o(kWgRows * kWgCols);
    cudaMemcpy(o.data(), out, o.size() * 4, cudaMemcpyDeviceToHost);
    double e = 0, rmax = 0;
    for (int r = 0; r < kWgRows; ++r)
      for (int cc = 0; cc < kWgCols; ++cc) {
        double acc = 0;
        for (int kk = 0; kk < kWgDepth; ++kk)
          acc += (double)ha[r * kWgDepth + kk] * hw[kk * kWgCols + cc];
        e = std::max(e, std::fabs(o[r * kWgCols + cc] - acc));
        rmax = std::max(rmax, std::fabs(acc));
      }
    printf("MMA_ACCURACY sparse n=64 %s: max |diff| / max |ref| %.3e against float64\n", name,
           e / rmax);
  };
  run(sparse_kern<0>, "x-mixing, CUDA cores (mm_wide, chunks of 16 slots)");
  run(sparse_kern<1>, "x-mixing, mma.sync 3xTF32 (mm_tc<8>)");
  run(sparse_kern<2>, "x-mixing, wgmma 3xTF32 (wg_xmix)");
  cudaFree(Ad);
  cudaFree(Pd);
}

int main() {
  const int rows = 126, blocks = 132;
  float *W, *out;
  long long* cyc;
  cudaMalloc(&W, 256 * 256 * 4);
  cudaMalloc(&out, blocks * 512 * 4);
  cudaMalloc(&cyc, blocks * 8);
  std::vector<float> hw(65536);
  for (int i = 0; i < 65536; ++i) hw[i] = 0.01f * ((i * 7919) % 101) - 0.5f;
  cudaMemcpy(W, hw.data(), 65536 * 4, cudaMemcpyHostToDevice);
  const size_t smem = (48 * 264 + kTcWarps * kTcStages * kTcStage + 48 * 256) * 4;
  auto run = [&](auto k, int n, const char* name) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    k<<<blocks, 512, smem>>>(W, out, rows, n, cyc);
    cudaEventRecord(a);
    k<<<blocks, 512, smem>>>(W, out, rows, n, cyc);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    std::vector<long long> c(blocks);
    cudaMemcpy(c.data(), cyc, blocks * 8, cudaMemcpyDeviceToHost);
    printf("MMA_BENCH n=%d %s: %.4f ms per launch, %lld cycles per product (%s)\n", n, name, ms,
           c[0] / rows, cudaGetErrorString(cudaGetLastError()));
  };
  run(kern<0, 2>, 21, "x-mixing, CUDA cores (mm_tiled, 2 columns)");
  run(kern<1, 2>, 21, "x-mixing, 3xTF32 (mm_tc)");
  run(kern<2, 2>, 21, "x-mixing, one TF32 pass");
  run(kern<0, 3>, 42, "x-mixing, CUDA cores (mm_tiled, 2 columns)");
  run(kern<1, 3>, 42, "x-mixing, 3xTF32 (mm_tc)");
  run(kern<2, 3>, 42, "x-mixing, one TF32 pass");
  run(kern<6, 3>, 42, "x-mixing, 3xTF32 (mm_tc, two products of 21 rows)");
  run(kern<3, 2>, 21, "o1 64x64, CUDA cores (K1's 4-column tiles)");
  run(kern<4, 2>, 21, "o1 64x64, CUDA cores (K2's one output per thread)");
  run(kern<5, 2>, 21, "o1 64x64, 3xTF32 (mm_tc_small)");

  // accuracy: 21 x 256 @ 256 x 256 against a float64 product on the host,
  // max |diff| / max |ref| over the outputs, on signed operands (A and W in
  // [-1, 1), W / 16) and on non-negative ones (no cancellation), 8 seeds each
  const int n = 21;
  float *Ad, *Od;
  cudaMalloc(&Ad, n * 256 * 4);
  cudaMalloc(&Od, n * 256 * 4);
  const size_t smem_acc = (24 * 264 + kTcWarps * kTcStages * kTcStage) * 4;
  const char* names[3] = {"CUDA cores f32 (mm_tiled)", "3xTF32, chunk sums (mm_tc)",
                          "3xTF32, one running sum (mm_tc_one_sum)"};
  for (int sign = 0; sign < 2; ++sign) {
    double worst[3] = {0, 0, 0}, mean[3] = {0, 0, 0};
    for (int seed = 0; seed < 8; ++seed) {
      unsigned long long x = 0x9E3779B97F4A7C15ull * (seed + 1);
      auto uni = [&]() {  // [0, 1)
        x = x * 6364136223846793005ull + 1442695040888963407ull;
        return (double)(x >> 11) / 9007199254740992.0;
      };
      std::vector<float> ha(n * 256), hwt(65536);
      for (auto& v : ha) v = (float)(sign ? uni() : 2 * uni() - 1);
      for (auto& v : hwt) v = (float)((sign ? uni() : 2 * uni() - 1) / 16);
      cudaMemcpy(Ad, ha.data(), n * 256 * 4, cudaMemcpyHostToDevice);
      cudaMemcpy(W, hwt.data(), 65536 * 4, cudaMemcpyHostToDevice);
      std::vector<double> ref(n * 256, 0.0);
      double rmax = 0;
      for (int r = 0; r < n; ++r)
        for (int c = 0; c < 256; ++c) {
          double acc = 0;
          for (int k = 0; k < 256; ++k) acc += (double)ha[r * 256 + k] * hwt[k * 256 + c];
          ref[r * 256 + c] = acc;
          rmax = std::max(rmax, std::fabs(acc));
        }
      void (*kerns[3])(const float*, const float*, float*, int) = {accuracy<0>, accuracy<1>,
                                                                   accuracy<2>};
      for (int v = 0; v < 3; ++v) {
        cudaFuncSetAttribute(kerns[v], cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_acc);
        kerns[v]<<<1, 512, smem_acc>>>(Ad, W, Od, n);
        std::vector<float> o(n * 256);
        cudaMemcpy(o.data(), Od, n * 256 * 4, cudaMemcpyDeviceToHost);
        double e = 0;
        for (int i = 0; i < n * 256; ++i) e = std::max(e, std::fabs(o[i] - ref[i]));
        worst[v] = std::max(worst[v], e / rmax);
        mean[v] += e / rmax / 8;
      }
    }
    for (int v = 0; v < 3; ++v)
      printf("MMA_ACCURACY n=%d %s operands, %s: max |diff| / max |ref| worst %.3e, mean %.3e "
             "over 8 seeds (%s)\n", n, sign ? "non-negative" : "signed", names[v], worst[v],
             mean[v], cudaGetErrorString(cudaGetLastError()));
  }
  sparse_bench(W, out, cyc);
  return 0;
}
