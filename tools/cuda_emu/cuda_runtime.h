// CPU emulation of the CUDA subset the kernels of sake_tpu_torch/csrc use, so
// that a kernel source runs (slowly) without a card: one std::thread per CUDA
// thread, std::barrier for __syncthreads, a barrier per warp and a slot array
// for __shfl_xor_sync, __syncwarp and the tensor-core products (mma_tf32x3.cuh's
// mma_tf32 and dmma_f64.cuh's f64 dmma, fragment for fragment; cvt.rna.tf32
// and cp.async beside them), the
// warpgroup product of wgmma_tf32.cuh (wgmma.mma_async on TF32 with A in
// registers and B by its shared-memory descriptor, run when wgmma.wait_group
// retires its group, as the PTX ISA allows; the fence, commit and wait), the
// mbarriers and the TMA's bulk copy that feed it, NaN-filled dynamic shared
// memory, the blocks of a launch one after another; thread-block clusters
// (cluster.cuh: cudaLaunchKernelEx with a cluster dimension runs the CTAs of
// a cluster at once, each with its own shared memory, which cl_map reaches by
// the cluster rank, and a barrier over all their threads whose arrive and wait
// each thread must alternate).
// emulate.py rewrites `kern<<<g, b, smem, stream>>>(args)` into
// emu_launch(kern, g, b, smem, stream, args) and `extern __shared__ float4
// smem4[]` into a pointer before compiling with g++ -std=c++20.
#pragma once
#include <math.h>

#include <algorithm>
#include <cmath>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <optional>
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
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
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

// cudaLaunchKernelEx's configuration, with the cluster dimension its only attribute.
struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  int id;
  cudaLaunchAttributeValue val;
};
constexpr int cudaLaunchAttributeClusterDimension = 4;
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline int cudaOccupancyMaxActiveClusters(int* n, const void*, const cudaLaunchConfig_t*) {
  *n = 1;
  return 0;
}

// An mbarrier: arrivals still expected in the current phase, the bytes of
// transactions still expected, and the number of completed phases.
struct EmuMbar {
  int count = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;
};

struct EmuBlock {
  std::barrier<>* block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<std::unique_ptr<std::barrier<>>> wgroups;  // one per 128 threads, for wgmma
  std::vector<double> slots;  // one per thread, for the shuffles
  std::vector<uint32_t> frags;  // six per thread, for the mma (four for wgmma)
  std::vector<double> dfrags;   // six per thread, for the f64 mma
  float4* smem;
  size_t smem_bytes = 0;
  std::mutex mu;  // guards the mbarriers
  std::map<const void*, EmuMbar> mbars;
  // a cluster's CTA: its rank, the shared memory of every CTA of the cluster
  // (null outside a cluster launch) and the cluster barrier
  int cl_rank = 0;
  const std::vector<float4*>* cl_smem = nullptr;
  std::barrier<>* cl_bar = nullptr;
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
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
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
// mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 (dmma_f64.cuh's dmma), d
// += a b for the warp, in the fragment layout of mma_tf32 above: each lane
// posts its fragments, then forms its four outputs, adding the products to d
// in k order in f64.
inline void dmma(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  auto& bar = *emu_blk->warps[w];
  double* f = emu_blk->dfrags.data() + (size_t)w * 32 * 6;
  for (int i = 0; i < 4; ++i) f[lane * 6 + i] = a[i];
  f[lane * 6 + 4] = b[0];
  f[lane * 6 + 5] = b[1];
  bar.arrive_and_wait();
  auto A = [&](int r, int k) { return f[((r & 7) * 4 + (k & 3)) * 6 + (r >> 3) + 2 * (k >> 2)]; };
  auto B = [&](int k, int n) { return f[(n * 4 + (k & 3)) * 6 + 4 + (k >> 2)]; };
  const int g = lane >> 2, tt = lane & 3;
  for (int q = 0; q < 4; ++q) {
    const int r = g + 8 * (q >> 1), n = 2 * tt + (q & 1);
    double acc = d[q];
    for (int k = 0; k < 8; ++k) acc = std::fma(A(r, k), B(k, n), acc);
    d[q] = acc;
  }
  bar.arrive_and_wait();
}
// dmma_f64.cuh's cp.async of 16 bytes, `bytes` of them read and the rest
// zeros: the copy lands at once (it aborts on a misaligned address).
inline void dm_cp_async(float* smem, const float* gmem, int bytes) {
  if (((uintptr_t)smem & 15) || (bytes && ((uintptr_t)gmem & 15))) {
    std::fprintf(stderr, "emu: cp.async of 16 bytes needs 16-byte addresses\n");
    std::abort();
  }
  std::memset(smem, 0, 16);
  std::memcpy(smem, gmem, bytes);
}
inline void dm_commit() {}
template <int N>
inline void dm_wait() {}
// cp.async: the copy lands at once; the groups have nothing to wait for.
inline void cp_async16(float* smem, const float* gmem) { std::memcpy(smem, gmem, 16); }
inline void cp_async_commit() {}
template <int kPending>
inline void cp_async_wait() {}

inline float4* emu_smem() { return emu_blk->smem; }

// ---- the Hopper subset of wgmma_tf32.cuh --------------------------------------
// A shared-memory address: the byte offset into the block's dynamic shared
// memory (the only shared memory the descriptors and barriers point into).
inline unsigned smem_u32(const void* p) {
  const long long off = (const char*)p - (const char*)emu_blk->smem;
  if (off < 0 || off >= (1 << 18)) {
    std::fprintf(stderr, "emu: shared address outside the dynamic shared memory\n");
    std::abort();
  }
  return (unsigned)off;
}
inline void emu_mbar_complete(EmuMbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    ++b.phase;
    b.pending = b.count;
  }
}
inline void mbar_init(unsigned long long* b, int count) {
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  EmuMbar& m = emu_blk->mbars[b];
  m.count = m.pending = count;
  m.tx = 0;
  m.phase = 0;
}
inline void mbar_fence_init() {}
inline EmuMbar& emu_mbar(unsigned long long* b) {
  auto it = emu_blk->mbars.find(b);
  if (it == emu_blk->mbars.end()) {
    std::fprintf(stderr, "emu: mbarrier used before mbarrier.init\n");
    std::abort();
  }
  return it->second;
}
inline void mbar_arrive(unsigned long long* b) {
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  EmuMbar& m = emu_mbar(b);
  --m.pending;
  emu_mbar_complete(m);
}
inline void mbar_expect_tx(unsigned long long* b, unsigned bytes) {
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  EmuMbar& m = emu_mbar(b);
  m.tx += bytes;
  --m.pending;
  emu_mbar_complete(m);
}
// try_wait.parity in a loop: returns once the phase of that parity has completed.
inline void mbar_wait(unsigned long long* b, unsigned parity) {
  for (;;) {
    {
      std::lock_guard<std::mutex> lk(emu_blk->mu);
      if ((emu_mbar(b).phase & 1) != (parity & 1)) return;
    }
    std::this_thread::yield();
  }
}
// cp.async.bulk: the bytes land at once, then complete their transaction.
inline void bulk_g2s(float* dst, const float* src, unsigned bytes, unsigned long long* b) {
  if ((bytes & 15) || ((uintptr_t)dst & 15) || ((uintptr_t)src & 15)) {
    std::fprintf(stderr, "emu: cp.async.bulk needs 16-byte sizes and addresses\n");
    std::abort();
  }
  smem_u32(dst);
  smem_u32(dst + bytes / 4 - 1);
  std::memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  EmuMbar& m = emu_mbar(b);
  m.tx -= bytes;
  emu_mbar_complete(m);
}
// A wgmma.mma_async waiting for its group to retire: its accumulator and A
// registers by address (read and written when it runs, so that a kernel that
// touches them before wgmma.wait_group reads wrong values here), its B
// descriptor and scale-d.
struct EmuWgmma {
  float* d;
  const uint32_t* a;
  uint64_t desc;
  int scale_d, group;
};
inline thread_local std::vector<EmuWgmma> emu_wg_pending;
inline thread_local int emu_wg_committed = 0;
inline void wg_fence() {}
inline void wg_fence_proxy() {}
inline void wg_fence_operand(float&) {}
inline void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  emu_wg_pending.push_back({d, a, desc_b, scale_d, emu_wg_committed});
}
inline void wg_commit() { ++emu_wg_committed; }
// Runs one product for the warpgroup: each thread posts its A fragment, then
// forms its 64 outputs (the PTX ISA's m64nNk8 layouts: A rows 16w + g (+ 8),
// columns t (+ 4); D row 16w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2t + i
// % 2), B read through the descriptor (no swizzle: 8 x 16-byte core matrices,
// LBO between the k halves, SBO between 8-column groups). Operands keep their
// upper 19 bits, as the tensor cores read a tf32; products are added in k order.
inline void emu_wgmma_run(const EmuWgmma& op) {
  const int t = threadIdx.x, wg = t >> 7, lt = t & 127;
  auto& bar = *emu_blk->wgroups[wg];
  uint32_t* f = emu_blk->frags.data() + (size_t)wg * 128 * 6;
  for (int i = 0; i < 4; ++i) f[lt * 6 + i] = op.a[i] & 0xffffe000u;
  bar.arrive_and_wait();
  if ((op.desc >> 62) != 0) {
    std::fprintf(stderr, "emu: wgmma descriptor with a swizzle mode\n");
    std::abort();
  }
  const char* base = (const char*)emu_blk->smem + (size_t)(op.desc & 0x3FFF) * 16;
  const size_t lbo = (size_t)((op.desc >> 16) & 0x3FFF) * 16;
  const size_t sbo = (size_t)((op.desc >> 32) & 0x3FFF) * 16;
  auto A = [&](int r, int k) {
    const int w = r >> 4, rr = r & 15;
    return __uint_as_float(f[(w * 32 + (rr & 7) * 4 + (k & 3)) * 6 + (rr >> 3) + 2 * (k >> 2)]);
  };
  auto B = [&](int k, int c) {
    uint32_t u;
    std::memcpy(&u, base + (c >> 3) * sbo + (c & 7) * 16 + (k >> 2) * lbo + (k & 3) * 4, 4);
    return __uint_as_float(u & 0xffffe000u);
  };
  const int w = lt >> 5, lane = lt & 31, g = lane >> 2, tt = lane & 3;
  for (int i = 0; i < 64; ++i) {
    const int r = 16 * w + g + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + 2 * tt + (i & 1);
    float acc = op.scale_d ? op.d[i] : 0.f;
    for (int k = 0; k < 8; ++k) acc += A(r, k) * B(k, c);
    op.d[i] = acc;
  }
  bar.arrive_and_wait();
}
// wgmma.wait_group N: runs every pending product of the groups but the newest N.
template <int kPending>
inline void wg_wait() {
  std::vector<EmuWgmma> keep;
  for (const EmuWgmma& op : emu_wg_pending) {
    if (op.group < emu_wg_committed - kPending) emu_wgmma_run(op);
    else keep.push_back(op);
  }
  emu_wg_pending.swap(keep);
}

// The block size of a 512-thread launch, EMU_THREADS when set: the layer
// bodies loop over blockDim.x, so such a kernel runs at 128 threads, and
// faster. Other blocks keep their size (param_grads.cu's tiles assume theirs).
inline int emu_threads(int b) {
  const char* e = std::getenv("EMU_THREADS");
  return e && b == 512 ? std::atoi(e) : b;
}

// A block's barriers, shuffle and fragment slots, and its shared memory
// (NaN-filled) in mem.
inline void emu_block_init(EmuBlock& eb, std::barrier<>* bar, int block, size_t smem,
                           std::vector<float4>& mem) {
  eb.block = bar;
  for (int w = 0; w < block / 32; ++w) eb.warps.emplace_back(new std::barrier<>(32));
  for (int w = 0; w < block / 128; ++w) eb.wgroups.emplace_back(new std::barrier<>(128));
  eb.slots.assign(block, 0.0);
  eb.frags.assign((size_t)block * 6, 0u);
  eb.dfrags.assign((size_t)block * 6, 0.0);
  mem.assign(smem / 16 + 1, float4{});
  const float nan = std::numeric_limits<float>::quiet_NaN();
  for (auto& v : mem) v = {nan, nan, nan, nan};
  eb.smem = mem.data();
  eb.smem_bytes = smem;
}

template <class K, class... A>
void emu_launch(K kern, dim3 grid, int block, size_t smem, void*, A... args) {
  block = emu_threads(block);
  for (unsigned g = 0; g < grid.x * grid.y; ++g) {
    std::barrier<> bar(block);
    EmuBlock eb;
    std::vector<float4> mem;
    emu_block_init(eb, &bar, block, smem, mem);
    std::vector<std::thread> ts;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([&, t] {
        emu_blk = &eb;
        emu_wg_pending.clear();
        emu_wg_committed = 0;
        threadIdx.x = t;
        blockIdx = dim3(g % grid.x, g / grid.x);
        blockDim.x = block;
        gridDim = grid;
        kern(args...);
      });
    for (auto& t : ts) t.join();
  }
}

// ---- thread-block clusters (cluster.cuh) ------------------------------------
inline thread_local std::optional<std::barrier<>::arrival_token> emu_cl_token;
inline int cl_rank() { return emu_blk->cl_rank; }
// The address of *p (this CTA's dynamic shared memory) in the shared memory of
// the cluster's CTA `rank`; it aborts on any other address or rank.
template <class T>
inline T* cl_map(T* p, int rank) {
  const long long off = (const char*)p - (const char*)emu_blk->smem;
  if (!emu_blk->cl_smem || rank < 0 || rank >= (int)emu_blk->cl_smem->size() || off < 0 ||
      off >= (long long)emu_blk->smem_bytes) {
    std::fprintf(stderr, "emu: cl_map outside a cluster's dynamic shared memory\n");
    std::abort();
  }
  return (T*)((char*)(*emu_blk->cl_smem)[rank] + off);
}
inline void cl_arrive() {
  if (!emu_blk->cl_bar || emu_cl_token) {
    std::fprintf(stderr, "emu: cluster arrive outside a cluster or twice without a wait\n");
    std::abort();
  }
  emu_cl_token.emplace(emu_blk->cl_bar->arrive());
}
inline void cl_wait() {
  if (!emu_cl_token) {
    std::fprintf(stderr, "emu: cluster wait without an arrive\n");
    std::abort();
  }
  emu_blk->cl_bar->wait(std::move(*emu_cl_token));
  emu_cl_token.reset();
}

// A cluster launch: clusters of `cl` consecutive CTAs along x, one cluster
// after another, the CTAs of a cluster at once. The 256- and 512-thread
// blocks (the cluster bodies loop over blockDim.x) take EMU_THREADS when set.
template <class K, class... A>
void emu_launch_cluster(K kern, dim3 grid, int block, size_t smem, unsigned cl, A... args) {
  const char* e = std::getenv("EMU_THREADS");
  if (e && (block == 256 || block == 512)) block = std::atoi(e);
  if (cl == 0 || grid.x % cl) {
    std::fprintf(stderr, "emu: a grid of %u is no multiple of the cluster %u\n", grid.x, cl);
    std::abort();
  }
  for (unsigned c0 = 0; c0 < grid.x * grid.y; c0 += cl) {
    std::barrier<> cbar((std::ptrdiff_t)cl * block);
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<std::unique_ptr<EmuBlock>> ebs;
    std::vector<std::vector<float4>> mems(cl);
    std::vector<float4*> bases(cl);
    for (unsigned r = 0; r < cl; ++r) {
      bars.emplace_back(new std::barrier<>(block));
      ebs.emplace_back(new EmuBlock);
      emu_block_init(*ebs[r], bars[r].get(), block, smem, mems[r]);
      bases[r] = ebs[r]->smem;
      ebs[r]->cl_rank = (int)r;
      ebs[r]->cl_smem = &bases;
      ebs[r]->cl_bar = &cbar;
    }
    std::vector<std::thread> ts;
    for (unsigned r = 0; r < cl; ++r)
      for (int t = 0; t < block; ++t)
        ts.emplace_back([&, r, t] {
          emu_blk = ebs[r].get();
          emu_wg_pending.clear();
          emu_wg_committed = 0;
          threadIdx.x = t;
          blockIdx = dim3((c0 + r) % grid.x, (c0 + r) / grid.x);
          blockDim.x = block;
          gridDim = grid;
          kern(args...);
          if (emu_cl_token) {
            std::fprintf(stderr, "emu: a thread ended with a cluster arrive not waited\n");
            std::abort();
          }
        });
    for (auto& t : ts) t.join();
  }
}

template <class... P, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kern)(P...), A&&... args) {
  unsigned cl = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cl = cfg->attrs[i].val.clusterDim.x;
  emu_launch_cluster(kern, cfg->gridDim, (int)cfg->blockDim.x, cfg->dynamicSmemBytes, cl,
                     P(args)...);
  return 0;
}
