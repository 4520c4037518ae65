// The contraction half of #14's and #15's edge-leaf gradients: sums over
// all E = NR * K edges of row products a^T g (and of row sums, a = ones).
//
// The JAX kernels accumulate these in resident output blocks across their
// sequential grid (sparse_ef.py:421-428, :537-543). Blocks on an H100 run
// in parallel, so #14 and #15 write the cotangent rows and this kernel
// contracts them: a term is (a (E, na) or null for ones, g (E, ng)); the
// terms of one leaf add up. The first pass gives each block one tile of one
// term (64 of a's columns against up to 256 of g's: w_xmix's 256 x 256 takes
// four; the 256-wide and the 64-wide tiles are kernels of their own) over one
// chunk of edges, on the f64 tensor cores (dmma_f64.cuh): the rows stream
// through a ring of cp.async stages, the products convert their fragments to
// f64 as they read them, and the products and sums are f64 from the first
// product (the rows of b_sem and the softmax terms cancel). The second pass
// adds a leaf's terms and chunks in a fixed order. No atomics: the result is
// the same on every run.
//
// What bounds it on an H100: f64 multiply-adds on DMMA, about 80k per edge
// for #14 (w_xmix's HK x C outer product is 65,536 of them), twice that for
// #15, at 67 TFLOP/s; the rows (about 3.5 KB per edge for #14) are read once
// per 64-column slab of a (g four times for w_xmix, mostly from L2).

#include "dmma_f64.cuh"

namespace {

using namespace sake;

constexpr int kMaxTerms = 32;

struct Terms {
  const float* a[kMaxTerms];
  const float* g[kMaxTerms];
  int na[kMaxTerms], ng[kMaxTerms], leaf[kMaxTerms];
  long long toff[kMaxTerms];  // offset of the term's (na, ng) block in a partial row
  long long loff[kMaxTerms + 1];  // each leaf's offset in out, and out's size
  int n, n_leaves;
};

// g's columns a block tile takes: the whole of a narrow g, 256 of a wide one.
__host__ __device__ inline int tile_cols(int ng) { return ng > 64 ? 256 : 64; }
__host__ __device__ inline int term_tiles(int na, int ng) {
  return ((na + kDmM - 1) / kDmM) * ((ng + tile_cols(ng) - 1) / tile_cols(ng));
}

// The ring of one tile 32 NT wide: a's slab (or ones) and g's, read as f64.
template <int NT>
struct SparseFill {
  static constexpr int kSlot = kDmK * (dm_ldr(kDmM) + dm_ldr(32 * NT));  // floats
  DmStream<1> sa;       // a's slab; base null: a is ones
  DmStream<NT / 2> sg;  // g's (kDmK x 32 NT floats: NT / 2 pieces a thread)
  float* ring;          // kDmRing slots
  int n_stages;
  long long e0, e_end;  // the chunk's edges

  __device__ float* slot_a(int s) const { return ring + (s % kDmRing) * kSlot; }
  __device__ float* slot_g(int s) const { return slot_a(s) + kDmK * dm_ldr(kDmM); }
  __device__ void issue(int s) const {
    if (s < n_stages) {
      if (sa.base) sa.issue(slot_a(s), e0 + (long long)s * kDmK);
      sg.issue(slot_g(s), e0 + (long long)s * kDmK);
    }
    dm_commit();  // one group a stage, empty past the last
  }
  __device__ void start() const {
    for (int s = 0; s < kDmRing - 2; ++s) issue(s);
  }
  __device__ void prefetch(int) const {}  // every load goes through the ring
  __device__ void stage(int s) const {
    dm_wait<kDmRing - 3>();  // this thread's copies of stage s have landed
    issue(s + kDmRing - 2);
  }

  struct Op {
    const float *A, *G;
    int lda, ldg, ones;  // ones: the stage's live edges (a is ones), else 0
    template <int K8>
    __device__ __forceinline__ double a(int k, int m) const {
      const int r = 8 * K8 + k;
      if (A == nullptr) return m == 0 && r < ones ? 1.0 : 0.0;
      return (double)A[r * lda + m];
    }
    template <int K8>
    __device__ __forceinline__ double b(int k, int n) const {
      return (double)G[(8 * K8 + k) * ldg + n];
    }
  };
  __device__ Op op(int s) const {
    const long long e = e0 + (long long)s * kDmK;
    return {sa.base ? slot_a(s) : nullptr, slot_g(s), sa.ld, sg.ld,
            (int)(e_end - e < kDmK ? e_end - e : kDmK)};
  }
};

template <int NT>
__device__ void contract_tile(const Terms& T, int t, int tile, long long E, long long chunk,
                              long long P, double* partial, float* ring) {
  constexpr int TN = 32 * NT;
  const int na = T.na[t], ng = T.ng[t];
  const int tiles_g = (ng + TN - 1) / TN;
  const int i0 = (tile / tiles_g) * kDmM, j0 = (tile % tiles_g) * TN;
  const long long e_begin = min(E, (long long)blockIdx.y * chunk);
  const long long e_end = min(E, e_begin + chunk);
  const int m_live = min(kDmM, na - i0), n_live = min(TN, ng - j0);
  SparseFill<NT> fill;
  fill.sa.init(T.a[t], e_end, na, i0, m_live, kDmK);
  fill.sg.init(T.g[t], e_end, ng, j0, n_live, kDmK);
  fill.ring = ring;
  fill.e0 = e_begin;
  fill.e_end = e_end;
  fill.n_stages = (int)((e_end - e_begin + kDmK - 1) / kDmK);
  DmTile<NT> acc;
  dm_run(acc, fill.n_stages, m_live, n_live, fill, PR_SC_STAGE, PR_SC_MMA);
  dm_wait<0>();
  double* dst = partial + blockIdx.y * P + T.toff[t];
  acc.store(m_live, n_live, [&](int m, int n, double v) {
    dst[(long long)(i0 + m) * ng + j0 + n] = v;
  });
  SAKE_PROBE_BARRIER(PR_SC_STORE);
}

// The tiles 32 NT wide of every term, one per block: the wide tiles (NT = 8)
// and the narrow ones (NT = 2) are separate kernels, so that the narrow ones
// run with the registers and shared memory of their own tile, several blocks
// to an SM.
template <int NT>
__global__ void __launch_bounds__(kDmThreads) contract_tiles(Terms T, long long E,
                                                             long long chunk, long long P,
                                                             double* partial) {
  extern __shared__ float4 smem4[];
  SAKE_PROBE_START();
  // which term and tile this block owns
  int tile = blockIdx.x, t = 0;
  for (; t < T.n; ++t) {
    const int nt = tile_cols(T.ng[t]) == 32 * NT ? term_tiles(T.na[t], T.ng[t]) : 0;
    if (tile < nt) break;
    tile -= nt;
  }
  contract_tile<NT>(T, t, tile, E, chunk, P, partial, reinterpret_cast<float*>(smem4));
}

__global__ void contract_sum(Terms T, int n_chunks, long long P, const double* partial,
                             float* out) {
  SAKE_PROBE_START();
  const long long total = T.loff[T.n_leaves];
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < total;
       o += (long long)gridDim.x * blockDim.x) {
    int L = 0;
    while (o >= T.loff[L + 1]) ++L;
    const long long idx = o - T.loff[L];
    double acc = 0.0;
    for (int t = 0; t < T.n; ++t) {
      if (T.leaf[t] != L) continue;
      for (int c = 0; c < n_chunks; ++c) acc += partial[c * P + T.toff[t] + idx];
    }
    out[o] = (float)acc;
  }
  SAKE_PROBE_BARRIER(PR_SC_SUM);
}

// Launches the tiles 32 NT wide (tiles of them) over the chunks.
template <int NT>
cudaError_t launch_tiles(const Terms& T, int tiles, int n_chunks, long long E, long long chunk,
                         long long P, double* partial, cudaStream_t s) {
  if (tiles == 0) return cudaSuccess;
  const int smem = kDmRing * SparseFill<NT>::kSlot * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(contract_tiles<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  contract_tiles<NT><<<dim3(tiles, n_chunks), kDmThreads, smem, s>>>(T, E, chunk, P, partial);
  return cudaGetLastError();
}

// Whether the ring can stream an operand w wide from p: 16-byte aligned, and
// either taken whole (w at most the tile's width) or in slabs (w a multiple
// of 4).
bool streamable(const void* p, int w, int tile_w) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (w <= tile_w || w % 4 == 0);
}

}  // namespace

// n_terms terms (a[t] may be null: ones, na[t] = 1), each adding a[t]^T g[t]
// to leaf leaf[t]; leaf_off (n_leaves + 1, on the host) gives each leaf's
// offset in out. partial: (n_chunks, sum_t na[t] * ng[t]) f64 scratch. Every
// row array starts 16-byte aligned.
extern "C" int sake_sparse_contract(int n_terms, const void* const* a, const int* na,
                                    const void* const* g, const int* ng, const int* leaf,
                                    long long E, int n_chunks, double* partial,
                                    const long long* leaf_off, int n_leaves, float* out,
                                    void* stream) {
  if (n_terms > kMaxTerms || n_leaves > kMaxTerms || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  Terms T{};
  T.n = n_terms;
  T.n_leaves = n_leaves;
  for (int L = 0; L <= n_leaves; ++L) T.loff[L] = leaf_off[L];
  long long P = 0;
  int tiles[2] = {0, 0};  // narrow (NT = 2) and wide (NT = 8) tiles
  for (int t = 0; t < n_terms; ++t) {
    T.a[t] = static_cast<const float*>(a[t]);
    T.g[t] = static_cast<const float*>(g[t]);
    T.na[t] = na[t];
    T.ng[t] = ng[t];
    T.leaf[t] = leaf[t];
    T.toff[t] = P;
    P += (long long)na[t] * ng[t];
    tiles[tile_cols(ng[t]) == 256] += term_tiles(na[t], ng[t]);
    if ((a[t] && !streamable(a[t], na[t], kDmM)) || !streamable(g[t], ng[t], tile_cols(ng[t])))
      return (int)cudaErrorInvalidValue;
  }
  // chunks of whole stages, so that every stage starts 16-byte aligned
  const long long chunk = ((E + n_chunks - 1) / n_chunks + kDmK - 1) / kDmK * kDmK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_tiles<8>(T, tiles[1], n_chunks, E, chunk, P, partial, s);
  if (err == cudaSuccess) err = launch_tiles<2>(T, tiles[0], n_chunks, E, chunk, P, partial, s);
  if (err != cudaSuccess) return (int)err;
  contract_sum<<<256, 256, 0, s>>>(T, n_chunks, P, partial, out);
  return (int)cudaGetLastError();
}

// The clock probe's slots (probe.cuh): out (kProbeSlots,), zeroed when reset.
extern "C" int sake_sparse_contract_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}
