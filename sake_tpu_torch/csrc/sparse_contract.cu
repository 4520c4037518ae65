// The contraction half of #14's and #15's edge-leaf gradients: sums over
// all E = NR * K edges of row products a^T g (and of row sums, a = ones).
//
// The JAX kernels accumulate these in resident output blocks across their
// sequential grid (sparse_ef.py:421-428, :537-543). Blocks on an H100 run
// in parallel, so #14 and #15 write the cotangent rows and this kernel
// contracts them: a term is (a (E, na) or null for ones, g (E, ng)); the
// terms of one leaf add up. The first pass gives each block one 32 x 32
// output tile of one term and one chunk of edges, summed in edge order in
// f64 (the rows of b_sem and the softmax terms cancel); the second pass
// adds a leaf's terms and chunks in a fixed order. No atomics: the result
// is the same on every run.
//
// What bounds it on an H100: f64 multiply-adds, about 75k per edge for
// #14 (w_xmix's HK x C outer product is 65,536 of them), twice that for
// #15, at half the f32 rate; the operand rows (about 3.5 KB per edge for
// #14) are read once per 32-wide tile column.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTerms = 32;
constexpr int kTile = 32;
constexpr int kEdgeBatch = 32;

struct Terms {
  const float* a[kMaxTerms];
  const float* g[kMaxTerms];
  int na[kMaxTerms], ng[kMaxTerms], leaf[kMaxTerms];
  long long toff[kMaxTerms];  // offset of the term's (na, ng) block in a partial row
  int n;
};

__global__ void __launch_bounds__(256) contract_tiles(Terms T, long long E, long long chunk,
                                                      long long P, double* partial) {
  __shared__ float sa[kEdgeBatch][kTile];
  __shared__ float sg[kEdgeBatch][kTile];
  // which term and tile this block owns
  int tile = blockIdx.x, t = 0;
  for (; t < T.n; ++t) {
    const int nt = ((T.na[t] + kTile - 1) / kTile) * ((T.ng[t] + kTile - 1) / kTile);
    if (tile < nt) break;
    tile -= nt;
  }
  const int na = T.na[t], ng = T.ng[t];
  const int tiles_g = (ng + kTile - 1) / kTile;
  const int i0 = (tile / tiles_g) * kTile, j0 = (tile % tiles_g) * kTile;
  const float* a = T.a[t];
  const float* g = T.g[t];
  const long long e_begin = blockIdx.y * chunk;
  const long long e_end = min(E, e_begin + chunk);
  const int tid = threadIdx.x;
  const int j = tid % kTile, ib = tid / kTile;  // rows ib, ib + 8, ib + 16, ib + 24
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (long long e0 = e_begin; e0 < e_end; e0 += kEdgeBatch) {
    for (int q = tid; q < kEdgeBatch * kTile; q += blockDim.x) {
      const int eo = q / kTile, c = q % kTile;
      const long long e = e0 + eo;
      const bool in = e < e_end;
      sa[eo][c] = (in && i0 + c < na) ? (a ? a[e * na + i0 + c] : 1.f) : 0.f;
      sg[eo][c] = (in && j0 + c < ng) ? g[e * ng + j0 + c] : 0.f;
    }
    __syncthreads();
    for (int eo = 0; eo < kEdgeBatch; ++eo) {
      const double gv = sg[eo][j];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += (double)sa[eo][ib + 8 * q] * gv;
    }
    __syncthreads();
  }
  double* dst = partial + blockIdx.y * P + T.toff[t];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = i0 + ib + 8 * q;
    if (i < na && j0 + j < ng) dst[(long long)i * ng + j0 + j] = acc[q];
  }
}

__global__ void contract_sum(Terms T, int n_chunks, long long P, const double* partial,
                             const long long* leaf_off, int n_leaves, float* out) {
  const long long total = leaf_off[n_leaves];
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < total;
       o += (long long)gridDim.x * blockDim.x) {
    int L = 0;
    while (o >= leaf_off[L + 1]) ++L;
    const long long idx = o - leaf_off[L];
    double acc = 0.0;
    for (int t = 0; t < T.n; ++t) {
      if (T.leaf[t] != L) continue;
      for (int c = 0; c < n_chunks; ++c) acc += partial[c * P + T.toff[t] + idx];
    }
    out[o] = (float)acc;
  }
}

}  // namespace

// n_terms terms (a[t] may be null: ones, na[t] = 1), each adding a[t]^T g[t]
// to leaf leaf[t]; leaf_off (n_leaves + 1, on the device) gives each leaf's
// offset in out. partial: (n_chunks, sum_t na[t] * ng[t]) f64 scratch.
extern "C" int sake_sparse_contract(int n_terms, const void* const* a, const int* na,
                                    const void* const* g, const int* ng, const int* leaf,
                                    long long E, int n_chunks, double* partial,
                                    const long long* leaf_off, int n_leaves, float* out,
                                    void* stream) {
  if (n_terms > kMaxTerms || n_chunks < 1) return (int)cudaErrorInvalidValue;
  Terms T{};
  T.n = n_terms;
  long long P = 0;
  int tiles = 0;
  for (int t = 0; t < n_terms; ++t) {
    T.a[t] = static_cast<const float*>(a[t]);
    T.g[t] = static_cast<const float*>(g[t]);
    T.na[t] = na[t];
    T.ng[t] = ng[t];
    T.leaf[t] = leaf[t];
    T.toff[t] = P;
    P += (long long)na[t] * ng[t];
    tiles += ((na[t] + kTile - 1) / kTile) * ((ng[t] + kTile - 1) / kTile);
  }
  const long long chunk = (E + n_chunks - 1) / n_chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  contract_tiles<<<dim3(tiles, n_chunks), 256, 0, s>>>(T, E, chunk, P, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  contract_sum<<<256, 256, 0, s>>>(T, n_chunks, P, partial, leaf_off, n_leaves, out);
  return (int)cudaGetLastError();
}
