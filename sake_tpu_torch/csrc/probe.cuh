// A clock64() probe of where a block's time goes, per phase and per product
// site of the layer bodies. Compiled in only with -DSAKE_PROBE (tools/
// probe_fused.py builds #11 and #12 so); otherwise every mark is empty and
// the bodies compile without it. Thread 0 reads the SM's clock right after a
// block barrier and charges the cycles since its previous mark to a slot, so
// a slot holds block cycles summed over every block of a launch.
#pragma once

namespace sake {

// Per body: before the row loop (PRE), the row loop's x-mixing product (XMIX),
// its edge products e0 / o_f, o1 and sem (MM), its staging of the saved row
// (LOAD), the rest of the row (ROW), and the node phase after it (NODE).
enum ProbeSlot {
  PR_FWD_PRE, PR_FWD_ROW, PR_FWD_XMIX, PR_FWD_NODE,  // the forward (K1's body)
  PR_BWD_PRE, PR_BWD_ROW, PR_BWD_XMIX, PR_BWD_NODE,  // the pullback (K2's body)
  PR_JVP_PRE, PR_JVP_ROW, PR_JVP_XMIX, PR_JVP_NODE,  // the tangent forward
  PR_TB_PRE, PR_TB_ROW, PR_TB_XMIX, PR_TB_NODE,      // the tangent pullback
  PR_HEAD,   // the readout head
  PR_OTHER,  // the kernels' own loads, stores and Hessian terms
  PR_FWD_MM, PR_BWD_MM, PR_JVP_MM, PR_TB_MM, PR_BWD_LOAD, PR_TB_LOAD,
  // the sparse edge row (sparse_edge.cuh): geometry and loads, the narrow
  // products, the softmax, forming he_att, the x-mixing product and its
  // transpose, their epilogues (pooling, d_u, d_xm, d_h_e, d_att2), the
  // pullback's narrow tail, and the rows instantiation's row stores
  PR_SP_LOAD, PR_SP_NARROW, PR_SP_SOFTMAX, PR_SP_HEATT, PR_SP_XMIX_F, PR_SP_XMIX_B, PR_SP_EPI,
  PR_SP_TAIL, PR_SP_STORE,
  // the contractions: sparse_contract.cu's staging (loads, conversion), its
  // products, its stores of the partial sums and the second pass; then
  // param_grads.cu's w_xmix leaf and its other wide leaves (staging and
  // operand formation, products, the f64 flushes and stores), its narrow
  // leaves and its second pass
  PR_SC_STAGE, PR_SC_MMA, PR_SC_STORE, PR_SC_SUM,
  PR_PG_XMIX_STAGE, PR_PG_XMIX_MMA, PR_PG_XMIX_FLUSH, PR_PG_WIDE_STAGE, PR_PG_WIDE_MMA,
  PR_PG_WIDE_FLUSH, PR_PG_NARROW, PR_PG_SUM,
  // the dense bodies' edge products o_f and o1 apart from sem (the *_MM slots
  // keep sem), the cluster instantiations' exchange between their two CTAs
  // (the barrier waits and the remote stores or reads), and the pullback's
  // node rows
  PR_FWD_OF_MM, PR_FWD_O1_MM, PR_BWD_OF_MM, PR_BWD_O1_MM, PR_FWD_CL, PR_BWD_CL, PR_BWD_ROWS,
  kProbeSlots
};

}  // namespace sake

#ifdef SAKE_PROBE
namespace sake {
static __device__ unsigned long long g_probe[kProbeSlots];
__device__ __forceinline__ long long& probe_last() {
  __shared__ long long t;
  return t;
}
}  // namespace sake
#define SAKE_PROBE_START()                                  \
  do {                                                      \
    if (threadIdx.x == 0) ::sake::probe_last() = clock64(); \
  } while (0)
#define SAKE_PROBE(slot)                                                      \
  do {                                                                        \
    if (threadIdx.x == 0) {                                                   \
      const long long t_ = clock64();                                         \
      atomicAdd(&::sake::g_probe[slot],                                       \
                (unsigned long long)(t_ - ::sake::probe_last()));             \
      ::sake::probe_last() = t_;                                              \
    }                                                                         \
  } while (0)
// A block barrier that only the probe build has, so that work interleaved
// with other work between the body's own barriers gets a slot of its own.
#define SAKE_PROBE_BARRIER(slot) \
  do {                           \
    __syncthreads();             \
    SAKE_PROBE(slot);            \
  } while (0)
namespace sake {
// Copies this source's slots to the host, and zeroes them when reset.
static inline int probe_read(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[kProbeSlots] = {};
    err = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  }
  return (int)err;
}
}  // namespace sake
#else
#define SAKE_PROBE_START() ((void)0)
#define SAKE_PROBE(slot) ((void)0)
#define SAKE_PROBE_BARRIER(slot) ((void)0)
namespace sake {
// Without the probe there is nothing to read.
static inline int probe_read(unsigned long long*, int) { return (int)cudaErrorNotSupported; }
}  // namespace sake
#endif
