// CPU emulation of the CUDA subset the kernels of sake_tpu_torch/csrc use, so
// that a kernel source runs (slowly) without a card: one std::thread per CUDA
// thread, std::barrier for __syncthreads, a barrier per warp and a slot array
// for __shfl_xor_sync, __syncwarp and the tensor-core product (mma_tf32x3.cuh's
// mma_tf32, fragment for fragment; cvt.rna.tf32 and cp.async beside it),
// NaN-filled dynamic shared memory, the blocks of a launch one after another.
// emulate.py rewrites `kern<<<g, b, smem, stream>>>(args)` into
// emu_launch(kern, g, b, smem, stream, args) and `extern __shared__ float4
// smem4[]` into a pointer before compiling with g++ -std=c++20.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static  // blocks run one after another: one copy serves each
#define __align__(n) __attribute__((aligned(n)))
#define SAKE_CUDA_EMU 1  // mma_tf32x3.cuh takes the stand-ins below

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

using cudaError_t = int;
using cudaStream_t = void*;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaErrorNotSupported = 801;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
constexpr int cudaDevAttrMultiProcessorCount = 0;
template <class K>
inline int cudaFuncSetAttribute(K, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
// Two SMs, one block each: a grid smaller than the batch, so persistent
// kernels walk several molecules per block.
inline int cudaDeviceGetAttribute(int* v, int, int) {
  *v = 2;
  return 0;
}
template <class K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return 0;
}
inline const char* cudaGetErrorString(int) { return "emulated"; }

struct EmuBlock {
  std::barrier<>* block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<double> slots;  // one per thread, for the shuffles
  std::vector<uint32_t> frags;  // six per thread, for the mma
  float4* smem;
};
inline thread_local EmuBlock* emu_blk;

inline void __syncthreads() { emu_blk->block->arrive_and_wait(); }
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int o) {
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  auto& bar = *emu_blk->warps[w];
  emu_blk->slots[t] = (double)v;
  bar.arrive_and_wait();
  const T r = (T)emu_blk->slots[(w << 5) | (lane ^ o)];
  bar.arrive_and_wait();
  return r;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_blk->warps[threadIdx.x >> 5]->arrive_and_wait();
}
template <class T>
inline T __ldg(const T* p) { return *p; }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }

inline float2 make_float2(float x, float y) { return {x, y}; }

// cvt.rna.tf32.f32: round the significand to 10 bits, to nearest, ties away
// from zero (on the magnitude), as a 32-bit pattern; inf and NaN pass.
inline uint32_t tf32_rna(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0x1000u;
  return u & 0xffffe000u;
}
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += a b for the warp:
// each lane posts its fragments (the PTX ISA layout: a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); d (g,
// 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1); g = lane / 4, t = lane % 4),
// then reads the warp's to form its own four outputs. Operands keep their
// upper 19 bits, as the tensor cores read a tf32; their products are exact in
// f32 and are added to d in k order.
inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  auto& bar = *emu_blk->warps[w];
  uint32_t* f = emu_blk->frags.data() + (size_t)w * 32 * 6;
  for (int i = 0; i < 4; ++i) f[lane * 6 + i] = a[i] & 0xffffe000u;
  f[lane * 6 + 4] = b0 & 0xffffe000u;
  f[lane * 6 + 5] = b1 & 0xffffe000u;
  bar.arrive_and_wait();
  auto A = [&](int r, int k) {
    return __uint_as_float(f[((r & 7) * 4 + (k & 3)) * 6 + (r >> 3) + 2 * (k >> 2)]);
  };
  auto B = [&](int k, int n) { return __uint_as_float(f[(n * 4 + (k & 3)) * 6 + 4 + (k >> 2)]); };
  const int g = lane >> 2, tt = lane & 3;
  for (int q = 0; q < 4; ++q) {
    const int r = g + 8 * (q >> 1), n = 2 * tt + (q & 1);
    float acc = d[q];
    for (int k = 0; k < 8; ++k) acc += A(r, k) * B(k, n);
    d[q] = acc;
  }
  bar.arrive_and_wait();
}
// cp.async: the copy lands at once; the groups have nothing to wait for.
inline void cp_async16(float* smem, const float* gmem) { std::memcpy(smem, gmem, 16); }
inline void cp_async_commit() {}
template <int kPending>
inline void cp_async_wait() {}

inline float4* emu_smem() { return emu_blk->smem; }

// The block size of a 512-thread launch, EMU_THREADS when set: the layer
// bodies loop over blockDim.x, so such a kernel runs at 128 threads, and
// faster. Other blocks keep their size (param_grads.cu's tiles assume theirs).
inline int emu_threads(int b) {
  const char* e = std::getenv("EMU_THREADS");
  return e && b == 512 ? std::atoi(e) : b;
}

template <class K, class... A>
void emu_launch(K kern, int grid, int block, size_t smem, void*, A... args) {
  block = emu_threads(block);
  for (int g = 0; g < grid; ++g) {
    std::barrier<> bar(block);
    EmuBlock eb;
    eb.block = &bar;
    for (int w = 0; w < block / 32; ++w) eb.warps.emplace_back(new std::barrier<>(32));
    eb.slots.assign(block, 0.0);
    eb.frags.assign((size_t)block * 6, 0u);
    std::vector<float4> mem(smem / 16 + 1);
    const float nan = std::numeric_limits<float>::quiet_NaN();
    for (auto& v : mem) v = {nan, nan, nan, nan};
    eb.smem = mem.data();
    std::vector<std::thread> ts;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([&, t] {
        emu_blk = &eb;
        threadIdx.x = t;
        blockIdx.x = g;
        blockDim.x = block;
        gridDim.x = grid;
        kern(args...);
      });
    for (auto& t : ts) t.join();
  }
}
