// Thread-block clusters (Hopper, sm_90): the split of a molecule's receiver
// rows over the two CTAs of a cluster, the CTA's rank, another CTA's shared
// memory through the cluster's window (distributed shared memory, mapa) and
// the cluster barrier, split into its arrive and its wait. Used by the cluster
// instantiations of the layer bodies (resid_fwd.cuh, resid_bwd.cuh: #4 and #5,
// the QM9 training pair), one molecule per cluster.
#pragma once

#include <cuda_runtime.h>

namespace sake {

constexpr int kClSize = 2;  // CTAs per cluster: one molecule's receiver rows in two halves

// Receivers a CTA of a cluster takes at most: ceil(N / kClSize).
__host__ __device__ inline int cl_span(int N) { return (N + kClSize - 1) / kClSize; }

// The receiver rows [i0, i1) of cluster rank `rank`: consecutive spans of
// cl_span(N), the last one short (or empty, at N = 1).
__host__ __device__ inline void cl_rows(int N, int rank, int& i0, int& i1) {
  const int s = cl_span(N);
  i0 = rank * s < N ? rank * s : N;
  i1 = i0 + s < N ? i0 + s : N;
}

#ifndef SAKE_CUDA_EMU  // the CPU emulator (tools/cuda_emu) supplies these four
__device__ __forceinline__ int cl_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
// The address of *p in the shared memory of the cluster's CTA `rank` (a
// generic address: plain loads and stores reach the other SM).
template <class T>
__device__ __forceinline__ T* cl_map(T* p, int rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(out);
}
// barrier.cluster: every thread of the cluster arrives (release: its earlier
// shared-memory writes, local and remote, are seen by the threads that then
// wait) and waits (acquire) for the phase all of them arrived in. Each thread
// alternates arrive and wait.
__device__ __forceinline__ void cl_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cl_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
#endif

__device__ __forceinline__ void cl_sync() {
  cl_arrive();
  cl_wait();
}

// The launch of a cluster kernel over B molecules: a grid of kClSize * B
// CTAs of `threads`, clusters of kClSize along x; attr holds the cluster
// dimension the config points to.
inline cudaLaunchConfig_t cl_config(int B, int threads, size_t smem, void* stream,
                                    cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClSize * B, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClSize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace sake
