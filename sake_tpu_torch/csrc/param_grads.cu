// Parameter gradients of the layer stack, f32: every one of the 29 leaves'
// gradient per layer, summed over the batch, from the cotangent rows that
// resid_bwd.cu (with kRows) writes, K1's residuals and boundary states.
//
// Replaces the parameter-gradient half of the TPU kernel
// sake_tpu/kernels/resid_ef.py:make_hidden_fn -> bwd_kernel (the
// pallas_call at :1680, body :1598): the row contractions a^T @ g of
// layer_bwd_resid(want_param_grads=True) (:678-773) and the bias/offset
// row sums. layer_param_grads in resid_ef.py is its plain version, leaf
// for leaf. Operands that are products of residuals (h_e (x) att2 for
// w_xmix, silu of a pre-activation, h_in + silu(uv), the rbf offset
// terms) are formed as they are loaded, not stored.
//
// Design: the TPU kernel carried dW in resident VMEM output blocks across
// its sequential (batch tile, depth) grid. Here blocks run in parallel and
// in no order, so the batch is cut into chunks of molecules: one block
// computes one output tile of one leaf, for one layer, over one chunk's
// rows, and writes it to that chunk's own partial sums; a second kernel
// adds the chunks in order. No atomics, so the result is the same from run
// to run. Wide leaves (a and g at least 8 columns) take 64 x 64 output
// tiles, 4 x 4 per thread, 16 rows staged in shared memory per step, summed
// in f32; the narrow ones (the semantic weights, w_vmix, w_vel1 and every
// row sum) take 64 output rows per block (8 for the head biases), row
// groups summed in double and then in order. The chunks' partial sums are
// double too: the row sums cancel, and in f32 the b_sem gradient lost 1e-4
// of its size against the plain version on an H100.
//
// What bounds it on an H100: f32 FMA issue. The w_xmix contraction is
// most of the work: 256 x 256 outputs over B * N^2 edge rows per layer
// (about 3.5 G FMA at QM9's batch 64, N = 29). The rows (about 1.6 MB per
// molecule and layer) are read once per output tile column, from L2 or
// device memory. Tensor cores (wgmma on bf16 or tf32) are a later change.

#include "resid_common.cuh"

namespace sake {

constexpr int kTile = 64;      // output tile edge, and columns of a narrow block
constexpr int kStep = 16;      // rows staged per step of a tile
constexpr int kThreads = 256;
constexpr int kNarrowMax = 8;  // widest g of a narrow contraction

enum RowKind { EDGE_ROW, NODE_ROW, VMIX_ROW };

__host__ __device__ constexpr RowKind row_kind(int leaf) {
  return (leaf == W_O_F || leaf == W_O1 || leaf == W_SEM || leaf == W_XMIX ||
          leaf == RBF_M || leaf == RBF_B || leaf == W_O_R || leaf == B_O0 || leaf == B_O1 ||
          leaf == B_SEM)
             ? EDGE_ROW
             : (leaf == W_VMIX ? VMIX_ROW : NODE_ROW);
}

// Row sums (the (1, c) leaves, contracted as (c, 1) against a column of
// ones) and the contractions whose g is at most kNarrowMax wide.
__host__ __device__ constexpr bool narrow_leaf(int leaf) {
  return leaf == B_IN || leaf == RBF_M || leaf == RBF_B || leaf == W_O_R || leaf == B_O0 ||
         leaf == B_O1 || leaf == W_SEM || leaf == B_SEM || leaf == B_POST0 ||
         leaf == B_POST1 || leaf == B_NODE0 || leaf == B_NODE1 || leaf == W_VMIX ||
         leaf == B_VEL0 || leaf == W_VEL1;
}

// Shape (rows, cols) of one layer's leaf, as _leaf_shapes in resid_ef.py.
inline void leaf_shape(int leaf, const Dims& d, int* rows, int* cols) {
  const int F = d.F, H = d.H, R = d.R, K = d.K, C = d.C, HK = d.H * d.K;
  int r = 1, c = 1;
  switch (leaf) {
    case W_IN_J: case W_IN_I: r = F; c = R; break;
    case B_IN: case RBF_M: case RBF_B: c = R; break;
    case W_O_J: case W_O_I: case W_NODE_H: case W_VEL0: r = F; c = H; break;
    case W_O_F: r = R; c = H; break;
    case W_O_R: case B_O0: case B_O1: case B_POST0: case B_POST1: case B_NODE0:
    case B_VEL0: c = H; break;
    case W_O1: case W_POST1: case W_NODE_COMB: r = H; c = H; break;
    case W_SEM: r = H; c = K; break;
    case B_SEM: c = K; break;
    case W_XMIX: r = HK; c = C; break;
    case W_POST0: r = C; c = H; break;
    case W_NODE_AGG: r = HK; c = H; break;
    case W_NODE1: r = H; c = F; break;
    case B_NODE1: c = F; break;
    case W_VMIX: r = C; c = 1; break;
    case W_VEL1: r = H; c = 1; break;
  }
  *rows = r;
  *cols = c;
}

struct GradArgs {
  Dims d;
  int per_chunk, n_chunks;  // molecules per chunk, chunks
  const float* bh;          // (depth, B, N, F) h entering each layer
  Leaves L;
  const float* rs[kResids];
  const float* rw[kRows];
  double* partial;          // (n_chunks, total)
  long long total;          // floats of every leaf's gradient, all layers
  long long off[kLeaves];   // each leaf's (depth, rows, cols) offset in total
  int ra[kLeaves], cg[kLeaves];  // contraction output (ra, cg): (cols, 1) for a row sum
  int tiles_c[kLeaves], row_tile[kLeaves];  // tiles across cg; output rows per tile
  int first_block[kLeaves + 1];

  // element c of a node (atom n) or edge (e) row of layer l, width ch
  __device__ float node(const float* p, int l, size_t n, int ch, int c) const {
    return p[((size_t)l * d.B * d.N + n) * ch + c];
  }
  __device__ float edge(const float* p, int l, size_t e, int ch, int c) const {
    return p[((size_t)l * d.B * d.N * d.N + e) * ch + c];
  }
};

__device__ __forceinline__ float silu(float x) { return siluf_(x); }

// Operand a (column r) of a leaf's contraction at global row `row` of
// layer l: a node index, an edge index, or k * B * N + node for w_vmix.
template <int LEAF>
__device__ __forceinline__ float load_a(const GradArgs& g, int l, size_t row, int r) {
  const int F = g.d.F, H = g.d.H, R = g.d.R, K = g.d.K, C = g.d.C, HK = g.d.H * g.d.K;
  const float* const* rw = g.rw;
  const float* const* rs = g.rs;
  if constexpr (LEAF == W_IN_J || LEAF == W_IN_I || LEAF == W_O_J || LEAF == W_O_I ||
                LEAF == W_NODE_H) {
    return g.node(g.bh, l, row, F, r);
  } else if constexpr (LEAF == B_IN) {
    return g.node(rw[RW_DAJ], l, row, R, r);
  } else if constexpr (LEAF == RBF_M || LEAF == RBF_B) {
    const float q = g.edge(rw[RW_DRBF], l, row, R, r) * g.edge(rs[RS_RBF], l, row, R, r);
    const float tm = g.edge(rs[RS_T], l, row, 1, 0) - g.L.at(RBF_M, l)[r];
    if constexpr (LEAF == RBF_M) return q * ((2.f * g.L.at(RBF_B, l)[r]) * tm);
    else return q * (-(tm * tm));
  } else if constexpr (LEAF == W_O_F) {
    return g.edge(rw[RW_FILT], l, row, R, r);
  } else if constexpr (LEAF == W_O_R) {
    return g.edge(rw[RW_DE0], l, row, H, r) * g.edge(rs[RS_R], l, row, 1, 0);
  } else if constexpr (LEAF == B_O0) {
    return g.edge(rw[RW_DE0], l, row, H, r);
  } else if constexpr (LEAF == W_O1) {
    return silu(g.edge(rs[RS_E0], l, row, H, r));
  } else if constexpr (LEAF == B_O1) {
    return g.edge(rw[RW_DHE], l, row, H, r);
  } else if constexpr (LEAF == W_SEM) {
    return g.edge(rs[RS_H_E], l, row, H, r);
  } else if constexpr (LEAF == B_SEM) {
    return g.edge(rw[RW_DSEM], l, row, K, r);
  } else if constexpr (LEAF == W_XMIX) {  // he_att[h*K + k] = h_e[h] * att2[k]
    return g.edge(rs[RS_H_E], l, row, H, r / K) * g.edge(rw[RW_ATT2], l, row, K, r % K);
  } else if constexpr (LEAF == W_POST0) {
    return g.node(rw[RW_PSQ], l, row, C, r);
  } else if constexpr (LEAF == B_POST0) {
    return g.node(rw[RW_DPS0], l, row, H, r);
  } else if constexpr (LEAF == W_POST1) {
    return silu(g.node(rs[RS_PS0], l, row, H, r));
  } else if constexpr (LEAF == B_POST1) {
    return g.node(rw[RW_DPS1], l, row, H, r);
  } else if constexpr (LEAF == W_NODE_AGG) {
    return g.node(rw[RW_HATT], l, row, HK, r);
  } else if constexpr (LEAF == W_NODE_COMB) {
    return silu(g.node(rs[RS_PS1], l, row, H, r));
  } else if constexpr (LEAF == B_NODE0) {
    return g.node(rw[RW_DNP], l, row, H, r);
  } else if constexpr (LEAF == W_NODE1) {
    return silu(g.node(rs[RS_NODE_PRE], l, row, H, r));
  } else if constexpr (LEAF == B_NODE1) {
    return g.node(rw[RW_DUV], l, row, F, r);
  } else if constexpr (LEAF == W_VMIX) {
    const size_t bn = (size_t)g.d.B * g.d.N;
    return g.node(rs[RS_POOL0 + row / bn], l, row % bn, C, r);
  } else if constexpr (LEAF == W_VEL0) {
    return g.node(g.bh, l, row, F, r) + silu(g.node(rs[RS_UV], l, row, F, r));
  } else if constexpr (LEAF == B_VEL0) {
    return g.node(rw[RW_DG0], l, row, H, r);
  } else {
    static_assert(LEAF == W_VEL1, "every leaf has an operand a");
    return silu(g.node(rs[RS_G0], l, row, H, r));
  }
}

// Operand g (column c); a row sum contracts against ones.
template <int LEAF>
__device__ __forceinline__ float load_g(const GradArgs& g, int l, size_t row, int c) {
  const int F = g.d.F, H = g.d.H, R = g.d.R, K = g.d.K, C = g.d.C;
  const float* const* rw = g.rw;
  if constexpr (LEAF == W_IN_J) return g.node(rw[RW_DAJ], l, row, R, c);
  else if constexpr (LEAF == W_IN_I) return g.node(rw[RW_DAI], l, row, R, c);
  else if constexpr (LEAF == W_O_J) return g.node(rw[RW_DOJ], l, row, H, c);
  else if constexpr (LEAF == W_O_I) return g.node(rw[RW_DOI], l, row, H, c);
  else if constexpr (LEAF == W_O_F) return g.edge(rw[RW_DE0], l, row, H, c);
  else if constexpr (LEAF == W_O1) return g.edge(rw[RW_DHE], l, row, H, c);
  else if constexpr (LEAF == W_SEM) return g.edge(rw[RW_DSEM], l, row, K, c);
  else if constexpr (LEAF == W_XMIX) return g.edge(rw[RW_DXM], l, row, C, c);
  else if constexpr (LEAF == W_POST0) return g.node(rw[RW_DPS0], l, row, H, c);
  else if constexpr (LEAF == W_POST1) return g.node(rw[RW_DPS1], l, row, H, c);
  else if constexpr (LEAF == W_NODE_H || LEAF == W_NODE_AGG || LEAF == W_NODE_COMB)
    return g.node(rw[RW_DNP], l, row, H, c);
  else if constexpr (LEAF == W_NODE1) return g.node(rw[RW_DUV], l, row, F, c);
  else if constexpr (LEAF == W_VMIX) {
    const size_t bn = (size_t)g.d.B * g.d.N;
    return g.node(rw[RW_DDEL], l, row % bn, 3, (int)(row / bn));
  } else if constexpr (LEAF == W_VEL0) return g.node(rw[RW_DG0], l, row, H, c);
  else if constexpr (LEAF == W_VEL1) return g.node(rw[RW_DG1], l, row, 1, c);
  else {
    static_assert(narrow_leaf(LEAF), "only row sums contract against ones");
    return 1.f;
  }
}

// Rows of a chunk of nm molecules, and the global row of chunk row `row`.
template <int LEAF>
__device__ __forceinline__ int chunk_rows(const Dims& d, int nm) {
  constexpr RowKind kind = row_kind(LEAF);
  return kind == EDGE_ROW ? nm * d.N * d.N : (kind == NODE_ROW ? nm * d.N : 3 * nm * d.N);
}

template <int LEAF>
__device__ __forceinline__ size_t global_row(const Dims& d, int m0, int nm, int row) {
  constexpr RowKind kind = row_kind(LEAF);
  if constexpr (kind == EDGE_ROW) return (size_t)m0 * d.N * d.N + row;
  if constexpr (kind == NODE_ROW) return (size_t)m0 * d.N + row;
  const int per_k = nm * d.N;  // w_vmix: the three pooled planes in turn
  return (size_t)(row / per_k) * d.B * d.N + (size_t)m0 * d.N + row % per_k;
}

// out[r, c] = sum over the chunk's rows of a[row, r] * g[row, c], for one
// 64 x 64 tile at (r0, c0).
template <int LEAF>
__device__ void contract_tile(const GradArgs& g, int l, int m0, int nm, int r0, int c0,
                              int ra, int cg, double* out, float* sm) {
  float* As = sm;
  float* Gs = sm + kStep * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = chunk_rows<LEAF>(g.d, nm);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < rows; k0 += kStep) {
    for (int q = tid; q < kStep * kTile; q += kThreads) {
      const int kk = q / kTile, col = q % kTile, row = k0 + kk;
      float a = 0.f, gv = 0.f;
      if (row < rows) {
        const size_t gr = global_row<LEAF>(g.d, m0, nm, row);
        if (r0 + col < ra) a = load_a<LEAF>(g, l, gr, r0 + col);
        if (c0 + col < cg) gv = load_g<LEAF>(g, l, gr, c0 + col);
      }
      As[q] = a;
      Gs[q] = gv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(As + kk * kTile + ty * 4);
      const float4 g4 = *reinterpret_cast<const float4*>(Gs + kk * kTile + tx * 4);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w}, gw[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gw[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (r < ra && c < cg) out[(size_t)r * cg + c] = acc[i][j];
    }
  }
}

// Output rows a narrow block covers: 8 for the narrowest sums (the
// semantic-head biases), else 64; the block's other threads split the rows.
__host__ __device__ inline int narrow_cols(int ra) { return ra <= 8 ? 8 : kTile; }

// out[r, c] for narrow_cols(ra) rows r0.. and every c < cg <= kNarrowMax:
// each thread takes one r and every groups-th row of the chunk, summing in
// double; the row groups are summed in order at the end. These are the
// row sums, whose terms cancel (a softmax's cotangents sum to zero over
// its senders), so f32 sums lose digits the plain version keeps.
template <int LEAF>
__device__ void contract_narrow(const GradArgs& g, int l, int m0, int nm, int r0, int ra,
                                int cg, double* out, double* sm) {
  const int cols = narrow_cols(ra), groups = kThreads / cols;
  const int rl = threadIdx.x % cols, rg = threadIdx.x / cols;
  const int r = r0 + rl;
  const int rows = chunk_rows<LEAF>(g.d, nm);
  double acc[kNarrowMax];
#pragma unroll
  for (int c = 0; c < kNarrowMax; ++c) acc[c] = 0.0;
  if (r < ra) {
    for (int row = rg; row < rows; row += groups) {
      const size_t gr = global_row<LEAF>(g.d, m0, nm, row);
      const double a = load_a<LEAF>(g, l, gr, r);
#pragma unroll
      for (int c = 0; c < kNarrowMax; ++c)
        if (c < cg) acc[c] = fma(a, (double)load_g<LEAF>(g, l, gr, c), acc[c]);
    }
  }
  double* red = sm;  // (groups, cols, kNarrowMax)
#pragma unroll
  for (int c = 0; c < kNarrowMax; ++c) red[(rg * cols + rl) * kNarrowMax + c] = acc[c];
  __syncthreads();
  if (rg == 0 && r < ra) {
    for (int c = 0; c < cg; ++c) {
      double s = 0.0;
      for (int q = 0; q < groups; ++q) s += red[(q * cols + rl) * kNarrowMax + c];
      out[(size_t)r * cg + c] = s;
    }
  }
}

template <int LEAF>
__device__ void contract(const GradArgs& g, int l, int m0, int nm, int r0, int c0, int ra,
                         int cg, double* out, double* sm) {
  if constexpr (narrow_leaf(LEAF)) contract_narrow<LEAF>(g, l, m0, nm, r0, ra, cg, out, sm);
  else contract_tile<LEAF>(g, l, m0, nm, r0, c0, ra, cg, out, reinterpret_cast<float*>(sm));
}

__global__ void __launch_bounds__(kThreads) param_grads_kernel(const GradArgs g) {
  __shared__ __align__(16) double sm[kThreads * kNarrowMax];
  static_assert(sizeof(sm) >= 2 * kStep * kTile * sizeof(float), "both routines fit");
  int leaf = 0;
  while ((int)blockIdx.x >= g.first_block[leaf + 1]) ++leaf;
  int rel = blockIdx.x - g.first_block[leaf];
  const int ra = g.ra[leaf], cg = g.cg[leaf], tc = g.tiles_c[leaf];
  const int rows_per_tile = g.row_tile[leaf];
  const int tiles = ((ra + rows_per_tile - 1) / rows_per_tile) * tc;
  const int tile = rel % tiles;
  rel /= tiles;
  const int chunk = rel % g.n_chunks, l = rel / g.n_chunks;
  const int r0 = (tile / tc) * rows_per_tile, c0 = (tile % tc) * kTile;
  const int m0 = chunk * g.per_chunk, nm = min(g.d.B, m0 + g.per_chunk) - m0;
  double* out = g.partial + chunk * g.total + g.off[leaf] + (size_t)l * ra * cg;
#define SAKE_LEAF(X) \
  case X: contract<X>(g, l, m0, nm, r0, c0, ra, cg, out, sm); break;
  switch (leaf) {
    SAKE_LEAF(W_IN_J) SAKE_LEAF(W_IN_I) SAKE_LEAF(B_IN) SAKE_LEAF(RBF_M) SAKE_LEAF(RBF_B)
    SAKE_LEAF(W_O_J) SAKE_LEAF(W_O_I) SAKE_LEAF(W_O_F) SAKE_LEAF(W_O_R) SAKE_LEAF(B_O0)
    SAKE_LEAF(W_O1) SAKE_LEAF(B_O1) SAKE_LEAF(W_SEM) SAKE_LEAF(B_SEM) SAKE_LEAF(W_XMIX)
    SAKE_LEAF(W_POST0) SAKE_LEAF(B_POST0) SAKE_LEAF(W_POST1) SAKE_LEAF(B_POST1)
    SAKE_LEAF(W_NODE_H) SAKE_LEAF(W_NODE_AGG) SAKE_LEAF(W_NODE_COMB) SAKE_LEAF(B_NODE0)
    SAKE_LEAF(W_NODE1) SAKE_LEAF(B_NODE1) SAKE_LEAF(W_VMIX) SAKE_LEAF(W_VEL0)
    SAKE_LEAF(B_VEL0) SAKE_LEAF(W_VEL1)
  }
#undef SAKE_LEAF
}

// out[i] = sum over chunks, in chunk order and in double, of partial[chunk, i].
__global__ void sum_chunks(const double* __restrict__ partial, float* out, long long total,
                           int n_chunks) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    double s = 0.0;
    for (int c = 0; c < n_chunks; ++c) s += partial[c * total + i];
    out[i] = (float)s;
  }
}

}  // namespace sake

// out: every leaf's (depth, rows, cols) gradient, in LEAF_NAMES order,
// concatenated; partial: (ceil(B / per_chunk), len(out)) f64 scratch.
extern "C" int sake_param_grads(const float* bh, const void* const* leaf_ptrs,
                                const long long* leaf_strides, void* const* resid_ptrs,
                                void* const* row_ptrs, double* partial, float* out,
                                int per_chunk, int B, int N, int F, int H, int R, int K, int C,
                                int depth, void* stream) {
  using namespace sake;
  GradArgs g;
  g.d = Dims{B, N, F, H, R, K, C, depth};
  g.per_chunk = per_chunk;
  g.n_chunks = (B + per_chunk - 1) / per_chunk;
  g.bh = bh;
  for (int i = 0; i < kLeaves; ++i) {
    g.L.p[i] = static_cast<const float*>(leaf_ptrs[i]);
    g.L.stride[i] = leaf_strides[i];
  }
  for (int i = 0; i < kResids; ++i) g.rs[i] = static_cast<const float*>(resid_ptrs[i]);
  for (int i = 0; i < kRows; ++i) g.rw[i] = static_cast<const float*>(row_ptrs[i]);
  g.partial = partial;
  long long off = 0;
  long long blocks = 0;
  for (int leaf = 0; leaf < kLeaves; ++leaf) {
    int rows, cols;
    leaf_shape(leaf, g.d, &rows, &cols);
    g.ra[leaf] = rows == 1 ? cols : rows;
    g.cg[leaf] = rows == 1 ? 1 : cols;
    if (narrow_leaf(leaf) && g.cg[leaf] > kNarrowMax) return (int)cudaErrorInvalidValue;
    g.tiles_c[leaf] = narrow_leaf(leaf) ? 1 : (g.cg[leaf] + kTile - 1) / kTile;
    g.row_tile[leaf] = narrow_leaf(leaf) ? narrow_cols(g.ra[leaf]) : kTile;
    g.first_block[leaf] = (int)blocks;
    blocks += (long long)((g.ra[leaf] + g.row_tile[leaf] - 1) / g.row_tile[leaf]) *
              g.tiles_c[leaf] * g.n_chunks * depth;
    g.off[leaf] = off;
    off += (long long)depth * rows * cols;
  }
  g.first_block[kLeaves] = (int)blocks;
  g.total = off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  param_grads_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long grid = (off + kThreads - 1) / kThreads;
  sum_chunks<<<(unsigned)(grid < 4096 ? grid : 4096), kThreads, 0, s>>>(partial, out, off,
                                                                        g.n_chunks);
  return (int)cudaGetLastError();
}
