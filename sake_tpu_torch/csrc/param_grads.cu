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
// in f32 over 64 rows and in double across them; the narrow ones (the semantic weights, w_vmix, w_vel1 and every
// row sum) take 64 output rows per block (8 for the head biases), row
// groups summed in double and then in order. The chunks' partial sums are
// double too: the row sums cancel, and in f32 the b_sem gradient lost 1e-4
// of its size against the plain version on an H100.
//
// Augmented (sake_param_grads_aug): the parameter gradients of the
// shared-mode training backward, the dW_a + dW_t sums of
// sake_tpu/kernels/train2_ef.py -> bwd_kernel (the pallas_call at :1632,
// body :1568-1607). Per leaf and layer it is the contraction of the primal
// chain's rows (resid_bwd.cu with an addend) plus the tangent of the
// contraction of the tangent chain's rows (resid_tbwd.cu) along the tangent
// forward (resid_jvp.cu): sum a^T g_p + t_a^T g_t + a^T t_g for a weight,
// sum s_p + t(s_t) for a row sum s. The operands are the same loaders
// evaluated on dual numbers, so every formed operand (silu, h_e (x) att2,
// the rbf offset terms) brings its tangent by the product rule. A weight's
// a is the same in both chains (a function of the residuals), so a tile
// contracts 2x the rows: a against g_p + t_g, then t_a against g_t.
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

// The arrays one set of operands is read from: boundary states h, the 17
// residuals and the 20 rows.
enum Arr { A_BH, A_RS, A_RW };
struct Tables {
  const float* bh;
  const float* rs[kResids];
  const float* rw[kRows];
  __device__ const float* arr(int a, int i) const {
    return a == A_BH ? bh : (a == A_RS ? rs[i] : rw[i]);
  }
};

// Operands as floats (one set of tables) or as dual numbers (the values'
// tables and their tangents').
template <class T>
struct Src;
template <>
struct Src<float> {
  const Tables* v;
  __device__ float at(int a, int i, size_t off) const { return v->arr(a, i)[off]; }
};
template <>
struct Src<Dl> {
  const Tables *v, *t;
  __device__ Dl at(int a, int i, size_t off) const {
    return {v->arr(a, i)[off], t->arr(a, i)[off]};
  }
};

struct GradArgs {
  Dims d;
  int per_chunk, n_chunks;  // molecules per chunk, chunks
  Leaves L;
  Tables P;                 // the rows' chain: K1's bh and residuals, its rows
  Tables Tv, Tt;            // augmented: the tangent chain's rows, and the tangents
  double* partial;          // (n_chunks, total)
  long long total;          // floats of every leaf's gradient, all layers
  long long off[kLeaves];   // each leaf's (depth, rows, cols) offset in total
  int ra[kLeaves], cg[kLeaves];  // contraction output (ra, cg): (cols, 1) for a row sum
  int tiles_c[kLeaves], row_tile[kLeaves];  // tiles across cg; output rows per tile
  int first_block[kLeaves + 1];

  // element c of a node (atom n) or edge (e) row of layer l, width ch
  template <class T>
  __device__ T node(const Src<T>& s, int a, int i, int l, size_t n, int ch, int c) const {
    return s.at(a, i, ((size_t)l * d.B * d.N + n) * ch + c);
  }
  template <class T>
  __device__ T edge(const Src<T>& s, int a, int i, int l, size_t e, int ch, int c) const {
    return s.at(a, i, ((size_t)l * d.B * d.N * d.N + e) * ch + c);
  }
};

__device__ __forceinline__ float silu(float x) { return siluf_(x); }
__device__ __forceinline__ Dl silu(Dl x) { return silu_d(x); }

// Operand a (column r) of a leaf's contraction at global row `row` of
// layer l: a node index, an edge index, or k * B * N + node for w_vmix.
template <int LEAF, class T>
__device__ __forceinline__ T load_a(const GradArgs& g, const Src<T>& s, int l, size_t row,
                                    int r) {
  const int F = g.d.F, H = g.d.H, R = g.d.R, K = g.d.K, C = g.d.C, HK = g.d.H * g.d.K;
  auto nd = [&](int a, int i, int ch, int c) { return g.node(s, a, i, l, row, ch, c); };
  auto ed = [&](int a, int i, int ch, int c) { return g.edge(s, a, i, l, row, ch, c); };
  if constexpr (LEAF == W_IN_J || LEAF == W_IN_I || LEAF == W_O_J || LEAF == W_O_I ||
                LEAF == W_NODE_H) {
    return nd(A_BH, 0, F, r);
  } else if constexpr (LEAF == B_IN) {
    return nd(A_RW, RW_DAJ, R, r);
  } else if constexpr (LEAF == RBF_M || LEAF == RBF_B) {
    const T q = ed(A_RW, RW_DRBF, R, r) * ed(A_RS, RS_RBF, R, r);
    const T tm = ed(A_RS, RS_T, 1, 0) - g.L.at(RBF_M, l)[r];
    if constexpr (LEAF == RBF_M) return q * ((2.f * g.L.at(RBF_B, l)[r]) * tm);
    else return q * (-(tm * tm));
  } else if constexpr (LEAF == W_O_F) {
    return ed(A_RW, RW_FILT, R, r);
  } else if constexpr (LEAF == W_O_R) {
    return ed(A_RW, RW_DE0, H, r) * ed(A_RS, RS_R, 1, 0);
  } else if constexpr (LEAF == B_O0) {
    return ed(A_RW, RW_DE0, H, r);
  } else if constexpr (LEAF == W_O1) {
    return silu(ed(A_RS, RS_E0, H, r));
  } else if constexpr (LEAF == B_O1) {
    return ed(A_RW, RW_DHE, H, r);
  } else if constexpr (LEAF == W_SEM) {
    return ed(A_RS, RS_H_E, H, r);
  } else if constexpr (LEAF == B_SEM) {
    return ed(A_RW, RW_DSEM, K, r);
  } else if constexpr (LEAF == W_XMIX) {  // he_att[h*K + k] = h_e[h] * att2[k]
    return ed(A_RS, RS_H_E, H, r / K) * ed(A_RW, RW_ATT2, K, r % K);
  } else if constexpr (LEAF == W_POST0) {
    return nd(A_RW, RW_PSQ, C, r);
  } else if constexpr (LEAF == B_POST0) {
    return nd(A_RW, RW_DPS0, H, r);
  } else if constexpr (LEAF == W_POST1) {
    return silu(nd(A_RS, RS_PS0, H, r));
  } else if constexpr (LEAF == B_POST1) {
    return nd(A_RW, RW_DPS1, H, r);
  } else if constexpr (LEAF == W_NODE_AGG) {
    return nd(A_RW, RW_HATT, HK, r);
  } else if constexpr (LEAF == W_NODE_COMB) {
    return silu(nd(A_RS, RS_PS1, H, r));
  } else if constexpr (LEAF == B_NODE0) {
    return nd(A_RW, RW_DNP, H, r);
  } else if constexpr (LEAF == W_NODE1) {
    return silu(nd(A_RS, RS_NODE_PRE, H, r));
  } else if constexpr (LEAF == B_NODE1) {
    return nd(A_RW, RW_DUV, F, r);
  } else if constexpr (LEAF == W_VMIX) {
    const size_t bn = (size_t)g.d.B * g.d.N;
    return g.node(s, A_RS, RS_POOL0 + (int)(row / bn), l, row % bn, C, r);
  } else if constexpr (LEAF == W_VEL0) {
    return nd(A_BH, 0, F, r) + silu(nd(A_RS, RS_UV, F, r));
  } else if constexpr (LEAF == B_VEL0) {
    return nd(A_RW, RW_DG0, H, r);
  } else {
    static_assert(LEAF == W_VEL1, "every leaf has an operand a");
    return silu(nd(A_RS, RS_G0, H, r));
  }
}

// Operand g (column c); a row sum contracts against ones.
template <int LEAF, class T>
__device__ __forceinline__ T load_g(const GradArgs& g, const Src<T>& s, int l, size_t row,
                                    int c) {
  const int F = g.d.F, H = g.d.H, R = g.d.R, K = g.d.K, C = g.d.C;
  auto nd = [&](int i, int ch) { return g.node(s, A_RW, i, l, row, ch, c); };
  auto ed = [&](int i, int ch) { return g.edge(s, A_RW, i, l, row, ch, c); };
  if constexpr (LEAF == W_IN_J) return nd(RW_DAJ, R);
  else if constexpr (LEAF == W_IN_I) return nd(RW_DAI, R);
  else if constexpr (LEAF == W_O_J) return nd(RW_DOJ, H);
  else if constexpr (LEAF == W_O_I) return nd(RW_DOI, H);
  else if constexpr (LEAF == W_O_F) return ed(RW_DE0, H);
  else if constexpr (LEAF == W_O1) return ed(RW_DHE, H);
  else if constexpr (LEAF == W_SEM) return ed(RW_DSEM, K);
  else if constexpr (LEAF == W_XMIX) return ed(RW_DXM, C);
  else if constexpr (LEAF == W_POST0) return nd(RW_DPS0, H);
  else if constexpr (LEAF == W_POST1) return nd(RW_DPS1, H);
  else if constexpr (LEAF == W_NODE_H || LEAF == W_NODE_AGG || LEAF == W_NODE_COMB)
    return nd(RW_DNP, H);
  else if constexpr (LEAF == W_NODE1) return nd(RW_DUV, F);
  else if constexpr (LEAF == W_VMIX) {
    const size_t bn = (size_t)g.d.B * g.d.N;
    return g.node(s, A_RW, RW_DDEL, l, row % bn, 3, (int)(row / bn));
  } else if constexpr (LEAF == W_VEL0) return nd(RW_DG0, H);
  else if constexpr (LEAF == W_VEL1) return nd(RW_DG1, 1);
  else {
    static_assert(narrow_leaf(LEAF), "only row sums contract against ones");
    if constexpr (sizeof(T) == sizeof(float)) return 1.f;
    else return Dl{1.f, 0.f};
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
// 64 x 64 tile at (r0, c0). Augmented, over twice the rows: a against g_p +
// t_g, then t_a against g_t. The sums run in f32 over kFlush steps of kStep
// rows and in double across them: an f32 sum over the 2 x 132,300 edge rows
// of B = 300 aspirin molecules lost up to 9e-5 of w_o1's gradient against
// the plain version on an H100. The doubles live in shared memory (acc: 16
// per thread, thread-major), since 16 more double registers halved the
// blocks per SM.
constexpr int kFlush = 4;
template <int LEAF, bool kAug>
__device__ void contract_tile(const GradArgs& g, int l, int m0, int nm, int r0, int c0,
                              int ra, int cg, double* out, float* sm, double* accd) {
  float* As = sm;
  float* Gs = sm + kStep * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = chunk_rows<LEAF>(g.d, nm), total = (kAug ? 2 : 1) * rows;
  const Src<float> sp{&g.P}, st{&g.Tv};
  const Src<Dl> sd{&g.Tv, &g.Tt};
#pragma unroll
  for (int q = 0; q < 16; ++q) accd[q * kThreads + tid] = 0.0;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  int steps = 0;
  for (int k0 = 0; k0 < total; k0 += kStep) {
    for (int q = tid; q < kStep * kTile; q += kThreads) {
      const int kk = q / kTile, col = q % kTile, vrow = k0 + kk;
      const bool second = kAug && vrow >= rows;
      const int row = second ? vrow - rows : vrow;
      float a = 0.f, gv = 0.f;
      if (vrow < (kAug ? 2 : 1) * rows) {
        const size_t gr = global_row<LEAF>(g.d, m0, nm, row);
        if (r0 + col < ra) {
          if (!kAug) a = load_a<LEAF>(g, sp, l, gr, r0 + col);
          else if (!second) a = load_a<LEAF>(g, st, l, gr, r0 + col);
          else a = load_a<LEAF>(g, sd, l, gr, r0 + col).t;
        }
        if (c0 + col < cg) {
          if (!kAug) gv = load_g<LEAF>(g, sp, l, gr, c0 + col);
          else if (!second)
            gv = load_g<LEAF>(g, sp, l, gr, c0 + col) + load_g<LEAF>(g, sd, l, gr, c0 + col).t;
          else gv = load_g<LEAF>(g, st, l, gr, c0 + col);
        }
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
    if (++steps == kFlush || k0 + kStep >= total) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accd[(i * 4 + j) * kThreads + tid] += (double)acc[i][j];
          acc[i][j] = 0.f;
        }
      steps = 0;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (r < ra && c < cg) out[(size_t)r * cg + c] = accd[(i * 4 + j) * kThreads + tid];
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
template <int LEAF, bool kAug>
__device__ void contract_narrow(const GradArgs& g, int l, int m0, int nm, int r0, int ra,
                                int cg, double* out, double* sm) {
  const int cols = narrow_cols(ra), groups = kThreads / cols;
  const int rl = threadIdx.x % cols, rg = threadIdx.x / cols;
  const int r = r0 + rl;
  const int rows = chunk_rows<LEAF>(g.d, nm);
  const Src<float> sp{&g.P};
  const Src<Dl> sd{&g.Tv, &g.Tt};
  double acc[kNarrowMax];
#pragma unroll
  for (int c = 0; c < kNarrowMax; ++c) acc[c] = 0.0;
  if (r < ra) {
    for (int row = rg; row < rows; row += groups) {
      const size_t gr = global_row<LEAF>(g.d, m0, nm, row);
      const double a = load_a<LEAF>(g, sp, l, gr, r);
      // augmented: a_p g_p + t_a g_t + a_t t_g (a row sum: s_p + t(s_t))
      Dl at{0.f, 0.f};
      if constexpr (kAug) at = load_a<LEAF>(g, sd, l, gr, r);
#pragma unroll
      for (int c = 0; c < kNarrowMax; ++c) {
        if (c < cg) {
          acc[c] = fma(a, (double)load_g<LEAF>(g, sp, l, gr, c), acc[c]);
          if constexpr (kAug) {
            const Dl gt = load_g<LEAF>(g, sd, l, gr, c);
            acc[c] = fma((double)at.t, (double)gt.v, fma((double)at.v, (double)gt.t, acc[c]));
          }
        }
      }
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

template <int LEAF, bool kAug>
__device__ void contract(const GradArgs& g, int l, int m0, int nm, int r0, int c0, int ra,
                         int cg, double* out, double* sm, double* acc) {
  if constexpr (narrow_leaf(LEAF))
    contract_narrow<LEAF, kAug>(g, l, m0, nm, r0, ra, cg, out, sm);
  else
    contract_tile<LEAF, kAug>(g, l, m0, nm, r0, c0, ra, cg, out, reinterpret_cast<float*>(sm),
                              acc);
}

template <bool kAug>
__global__ void __launch_bounds__(kThreads) param_grads_kernel(const GradArgs g) {
  __shared__ __align__(16) double sm[kThreads * kNarrowMax];
  __shared__ double tile_acc[kThreads * 16];  // contract_tile's double sums
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
  case X: contract<X, kAug>(g, l, m0, nm, r0, c0, ra, cg, out, sm, tile_acc); break;
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
template <class T>
__global__ void sum_chunks(const T* __restrict__ partial, float* out, long long total,
                           int n_chunks) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    double s = 0.0;
    for (int c = 0; c < n_chunks; ++c) s += (double)partial[c * total + i];
    out[i] = (float)s;
  }
}

}  // namespace sake

namespace sake {

Tables tables(const float* bh, void* const* resid_ptrs, void* const* row_ptrs) {
  Tables t;
  t.bh = bh;
  for (int i = 0; i < kResids; ++i) t.rs[i] = static_cast<const float*>(resid_ptrs[i]);
  for (int i = 0; i < kRows; ++i) t.rw[i] = static_cast<const float*>(row_ptrs[i]);
  return t;
}

template <class T>
void sum_rows(const T* partial, float* out, long long total, int n, cudaStream_t s) {
  const long long grid = (total + kThreads - 1) / kThreads;
  sum_chunks<T><<<(unsigned)(grid < 4096 ? grid : 4096), kThreads, 0, s>>>(partial, out, total,
                                                                           n);
}

template <bool kAug>
int launch_grads(GradArgs& g, const void* const* leaf_ptrs, const long long* leaf_strides,
                 double* partial, float* out, int per_chunk, void* stream) {
  g.per_chunk = per_chunk;
  g.n_chunks = (g.d.B + per_chunk - 1) / per_chunk;
  for (int i = 0; i < kLeaves; ++i) {
    g.L.p[i] = static_cast<const float*>(leaf_ptrs[i]);
    g.L.stride[i] = leaf_strides[i];
  }
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
              g.tiles_c[leaf] * g.n_chunks * g.d.depth;
    g.off[leaf] = off;
    off += (long long)g.d.depth * rows * cols;
  }
  g.first_block[kLeaves] = (int)blocks;
  g.total = off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  param_grads_kernel<kAug><<<(unsigned)blocks, kThreads, 0, s>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows(partial, out, off, g.n_chunks, s);
  return (int)cudaGetLastError();
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
  g.P = tables(bh, resid_ptrs, row_ptrs);
  return launch_grads<false>(g, leaf_ptrs, leaf_strides, partial, out, per_chunk, stream);
}

// The augmented gradients: row_ptrs the primal chain's rows, trow_ptrs the
// tangent chain's and ttrow_ptrs their tangents (ROWS order); tbh and
// tresid_ptrs the tangent forward's boundary h and residuals. Output and
// scratch as sake_param_grads. ro_part (B, ro_len) or null: per-molecule
// partial sums (the fused training backward's readout gradients), summed
// over the molecules in order and in double into ro_out (ro_len).
extern "C" int sake_param_grads_aug(const float* bh, const float* tbh,
                                    const void* const* leaf_ptrs,
                                    const long long* leaf_strides, void* const* resid_ptrs,
                                    void* const* tresid_ptrs, void* const* row_ptrs,
                                    void* const* trow_ptrs, void* const* ttrow_ptrs,
                                    double* partial, float* out, const float* ro_part,
                                    float* ro_out, long long ro_len, int per_chunk, int B, int N,
                                    int F, int H, int R, int K, int C, int depth, void* stream) {
  using namespace sake;
  GradArgs g;
  g.d = Dims{B, N, F, H, R, K, C, depth};
  g.P = tables(bh, resid_ptrs, row_ptrs);
  g.Tv = tables(bh, resid_ptrs, trow_ptrs);
  g.Tt = tables(tbh, tresid_ptrs, ttrow_ptrs);
  const int err = launch_grads<true>(g, leaf_ptrs, leaf_strides, partial, out, per_chunk, stream);
  if (err != 0 || ro_part == nullptr) return err;
  sum_rows(ro_part, ro_out, ro_len, B, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
