// CPU emulation of the CUDA subset the kernels of sake_tpu_torch/csrc use, so
// that a kernel source runs (slowly) without a card: one std::thread per CUDA
// thread, std::barrier for __syncthreads, a barrier per warp and a slot array
// for __shfl_xor_sync, NaN-filled dynamic shared memory, the blocks of a launch
// one after another. emulate.py rewrites `kern<<<g, b, smem, stream>>>(args)`
// into emu_launch(kern, g, b, smem, stream, args) and `extern __shared__ float4
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
#define __shared__

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

inline float4* emu_smem() { return emu_blk->smem; }

// The block size of every launch, EMU_THREADS when set: the bodies loop over
// blockDim.x, so a 512-thread kernel runs at 128 threads, and faster.
inline int emu_threads(int b) {
  const char* e = std::getenv("EMU_THREADS");
  return e ? std::atoi(e) : b;
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
