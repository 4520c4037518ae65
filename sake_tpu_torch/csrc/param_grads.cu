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
// terms) are formed as they are staged, not stored.
//
// Design: the TPU kernel carried dW in resident VMEM output blocks across
// its sequential (batch tile, depth) grid. Here blocks run in parallel and
// in no order, so each layer's rows (edges, atoms, or w_vmix's three pooled
// planes) are cut into n_chunks ranges: one block computes one output tile
// of one leaf, for one layer, over one chunk's rows, and writes it to that
// chunk's own partial sums; a second kernel adds the chunks in order. No
// atomics, so the result is the same from run to run. The wide leaves (g at
// least 8 columns) run on the f64 tensor cores (dmma_f64.cuh): a block owns
// 64 output rows against all of g's columns up to 256 (w_xmix) or 64 (the
// others, in a kernel of their own), so each operand row is formed once per
// block; w_xmix's block is one head's 64 rows of he_att = h_e * att2[head]
// against all 256 columns of d_xm. Their raw rows (augmented, also the
// tangents and the tangent chain's g) stream through a cp.async ring and are
// formed there (StreamFill); w_vel0 (a = h_in + silu(uv)), and a leaf whose
// tables the ring cannot stream, form theirs through the loaders below
// (LoaderFill). Every product and sum is f64 from the first product. The
// narrow leaves (the semantic weights, w_vmix, w_vel1 and every row sum)
// take 64 output rows per block (8 for the head biases) on the CUDA cores,
// row groups summed in double and then in order: the row sums cancel, and in
// f32 the b_sem gradient lost 1e-4 of its size against the plain version on
// an H100.
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
// a is the same in both chains (a function of the residuals), so a stage
// holds each row twice: a against g_p + t_g, then t_a against g_t, into the
// same sums.
//
// resid_ef's bf16 tier (sake_param_grads16, the kernels' kE16): the residual
// streams but r and t are bf16 tensors, read through Src<float, true>; the
// four edge leaves (w_o_f, w_o1, w_sem, w_xmix: JAX's _EDGE_MM_LEAVES, whose
// contractions run at the edge products' tier) round both operands to bf16 as
// they are formed, and every sum stays f64 and ordered. Its wide tiles all go
// through the loaders: a simple route, not yet a fast one. Augmented in that
// tier (sake_param_grads_aug16, #12's contraction in the tier): the primal and
// tangent streams are bf16 (Src<Dl, true>), and an edge leaf's three terms a^T
// g_p, t_a^T g_t and a^T t_g round each operand apart (JAX's
// contract_param_pairs and contract_param_pair_tangents with mm_edge_t in
// bf16): the stage's first half holds bf16(a) against bf16(g_p) + bf16(t_g),
// summed in f32 (two bf16 values: exact unless their exponents lie 16 apart).
//
// What bounds it on an H100: f64 multiply-adds on DMMA at 67 TFLOP/s. The
// w_xmix contraction is most of the work: 256 x 256 outputs over B * N^2
// edge rows per layer (about 3.5 G multiply-adds at QM9's batch 64, N = 29;
// twice the rows augmented). The narrow leaves are bound by their loads (the
// dual numbers' tables, about nine loads an element for the rbf sums).

#include "dmma_f64.cuh"
#include "resid_common.cuh"

namespace sake {

constexpr int kTile = 64;      // columns of a narrow block
constexpr int kThreads = kDmThreads;
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
// tables and their tangents'). kLow: floats of resid_ef's bf16 tier, whose
// residual streams but r and t are bf16 tensors: the table holds their base
// pointers, read as Bf16 elements (get_res).
template <class T, bool kLow = false>
struct Src;
template <>
struct Src<float> {
  const Tables* v;
  __device__ float at(int a, int i, size_t off) const { return v->arr(a, i)[off]; }
};
template <>
struct Src<float, true> {
  const Tables* v;
  __device__ float at(int a, int i, size_t off) const {
    const bool low = a == A_RS && i != RS_R && i != RS_T;
    return low ? get_res(reinterpret_cast<const Bf16*>(v->arr(a, i)), off) : v->arr(a, i)[off];
  }
};
template <>
struct Src<Dl> {
  const Tables *v, *t;
  __device__ Dl at(int a, int i, size_t off) const {
    return {v->arr(a, i)[off], t->arr(a, i)[off]};
  }
};
template <>
struct Src<Dl, true> {
  const Tables *v, *t;
  __device__ Dl at(int a, int i, size_t off) const {
    const Src<float, true> sv{v}, st{t};
    return {sv.at(a, i, off), st.at(a, i, off)};
  }
};

struct GradArgs {
  Dims d;
  int n_chunks;             // row ranges each layer's rows are cut into
  Leaves L;
  Tables P;                 // the rows' chain: K1's bh and residuals, its rows
  Tables Tv, Tt;            // augmented: the tangent chain's rows, and the tangents
  double* partial;          // (n_chunks, total)
  long long total;          // floats of every leaf's gradient, all layers
  long long off[kLeaves];   // each leaf's (depth, rows, cols) offset in total
  int ra[kLeaves], cg[kLeaves];  // contraction output (ra, cg): (cols, 1) for a row sum
  int tiles_c[kLeaves], row_tile[kLeaves];  // tiles across cg; output rows per tile
  int tiles[kLeaves];       // a leaf's tiles per layer and chunk
  // each kernel's blocks by leaf: the narrow leaves', the wide leaves' whose
  // tiles are 64 wide (NT = 2), w_xmix's (NT = 8)
  int first[3][kLeaves + 1];
  bool ring_ok[kLeaves];    // a wide leaf's raw rows stream through the ring (else the loaders)

  // element c of a node (atom n) or edge (e) row of layer l, width ch
  template <class T, bool kLow>
  __device__ T node(const Src<T, kLow>& s, int a, int i, int l, size_t n, int ch, int c) const {
    return s.at(a, i, ((size_t)l * d.B * d.N + n) * ch + c);
  }
  template <class T, bool kLow>
  __device__ T edge(const Src<T, kLow>& s, int a, int i, int l, size_t e, int ch, int c) const {
    return s.at(a, i, ((size_t)l * d.B * d.N * d.N + e) * ch + c);
  }
};

__device__ __forceinline__ float silu(float x) { return siluf_(x); }
__device__ __forceinline__ Dl silu(Dl x) { return silu_d(x); }

// Operand a (column r) of a leaf's contraction at global row `row` of
// layer l: a node index, an edge index, or k * B * N + node for w_vmix.
template <int LEAF, class T, bool kLow>
__device__ __forceinline__ T load_a(const GradArgs& g, const Src<T, kLow>& s, int l, size_t row,
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
template <int LEAF, class T, bool kLow>
__device__ __forceinline__ T load_g(const GradArgs& g, const Src<T, kLow>& s, int l, size_t row,
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

// The four leaves whose contraction runs at the edge products' tier (the JAX
// _EDGE_MM_LEAVES): in resid_ef's bf16 tier (kE16) both operands of their
// contractions are rounded to bf16 before the f64 products.
__host__ __device__ constexpr bool edge_mm_leaf(int leaf) {
  return leaf == W_O_F || leaf == W_O1 || leaf == W_SEM || leaf == W_XMIX;
}
template <int LEAF, bool kE16>
__device__ __forceinline__ float edge_rd(float x) {
  if constexpr (kE16 && edge_mm_leaf(LEAF)) return bf16r(x);
  else return x;
}

// A layer's rows of a leaf: its edges, atoms, or (w_vmix) the three pooled
// planes' atoms in turn; row r is the loaders' global row r.
template <int LEAF>
__device__ __forceinline__ long long leaf_rows(const Dims& d) {
  constexpr RowKind kind = row_kind(LEAF);
  const long long bn = (long long)d.B * d.N;
  return kind == EDGE_ROW ? bn * d.N : (kind == NODE_ROW ? bn : 3 * bn);
}

// Rows of a chunk: ceil(rows / n_chunks), whole f64 stages (so that every
// stage of the ring starts 16-byte aligned); the last chunks may be short or
// empty. sake_tpu_torch.kernels.resid_ef.grad_chunk_rows is the same rule.
__host__ __device__ inline long long chunk_span(long long rows, int n_chunks) {
  return ((rows + n_chunks - 1) / n_chunks + kDmK - 1) / kDmK * kDmK;
}

// g's columns of a wide block tile: all 256 of w_xmix's d_xm, else 64.
__host__ __device__ constexpr int tile_nt(int leaf) { return leaf == W_XMIX ? 8 : 2; }
// A wide leaf's tiles across a: 64 columns each; w_xmix's are one head's 64
// rows of h_e each (a column r = h * K + head).
__host__ __device__ inline int tiles_r(int leaf, const Dims& d, int ra) {
  return leaf == W_XMIX ? d.K * ((d.H + kDmM - 1) / kDmM) : (ra + kDmM - 1) / kDmM;
}

// Real rows of an f64 stage: each row fills two stage rows augmented.
template <bool kAug>
__host__ __device__ constexpr int stage_rows() { return kAug ? kDmK / 2 : kDmK; }

// One wide block: the tile's place in the leaf and its chunk's rows.
struct WideTile {
  int l, rt, ct;              // layer, tile along a, tile along g
  long long r_begin, r_end;   // the chunk's rows
  int m_live, n_live, c0;     // live output rows and columns; g's first column
  int head, h0, r0;           // w_xmix: the head and its first h; else a's first column
  __device__ int col_a(int m, int K) const { return head >= 0 ? (h0 + m) * K + head : r0 + m; }
};

// The ring of one tile 32 NT wide whose operands are formed by the loaders
// (w_vel0, and a wide leaf whose tables the ring cannot stream), read as f64.
// A 64-wide tile's
// (NT = 2) elements are loaded and formed into registers by prefetch, before
// the previous stage's products, and stored by stage; a wider one's are formed
// and stored four at a time.
template <int LEAF, bool kAug, int NT, bool kE16 = false>
struct LoaderFill {
  static constexpr int TN = 32 * NT, qa = kDmK * kDmM / kDmThreads;
  static constexpr int qb = kDmK * TN / kDmThreads;
  static constexpr int lda = dm_ldr(kDmM), ldb = dm_ldr(TN);
  static constexpr int kSlot = kDmK * (lda + ldb);  // floats
  static constexpr bool kPre = NT == 2;
  const GradArgs* g;
  WideTile w;
  float* ring;
  float va[kPre ? qa : 1], vb[kPre ? qb : 1];

  // element (v, j) of stage s: row v (augmented: v >= per is row v - per's
  // second half) of the chunk's stage; a's (kA) or g's column j
  template <bool kA>
  __device__ __forceinline__ float form(int s, int v, int j) const {
    constexpr int per = stage_rows<kAug>();
    const Src<float> sp{&g->P}, st{&g->Tv};
    const Src<Dl> sd{&g->Tv, &g->Tt};
    const bool second = kAug && v >= per;
    const long long row = w.r_begin + (long long)s * per + (second ? v - per : v);
    if (row >= w.r_end || j >= (kA ? w.m_live : w.n_live)) return 0.f;
    if constexpr (kE16 && !kAug) {  // the bf16 tier
      const Src<float, true> sl{&g->P};
      if constexpr (kA)
        return edge_rd<LEAF, true>(load_a<LEAF>(*g, sl, w.l, row, w.col_a(j, g->d.K)));
      else return edge_rd<LEAF, true>(load_g<LEAF>(*g, sl, w.l, row, w.c0 + j));
    } else if constexpr (kE16) {  // the bf16 tier augmented: g_p and t_g rounded apart
      const Src<float, true> lp{&g->P}, lv{&g->Tv};
      const Src<Dl, true> ld{&g->Tv, &g->Tt};
      if constexpr (kA) {
        const int r = w.col_a(j, g->d.K);
        if (!second) return edge_rd<LEAF, true>(load_a<LEAF>(*g, lv, w.l, row, r));
        return edge_rd<LEAF, true>(load_a<LEAF>(*g, ld, w.l, row, r).t);
      } else {
        const int c = w.c0 + j;
        if (!second)
          return edge_rd<LEAF, true>(load_g<LEAF>(*g, lp, w.l, row, c)) +
                 edge_rd<LEAF, true>(load_g<LEAF>(*g, ld, w.l, row, c).t);
        return edge_rd<LEAF, true>(load_g<LEAF>(*g, lv, w.l, row, c));
      }
    }
    if constexpr (kA) {
      const int r = w.col_a(j, g->d.K);
      if (!kAug) return load_a<LEAF>(*g, sp, w.l, row, r);
      if (!second) return load_a<LEAF>(*g, st, w.l, row, r);
      return load_a<LEAF>(*g, sd, w.l, row, r).t;
    } else {
      const int c = w.c0 + j;
      if (!kAug) return load_g<LEAF>(*g, sp, w.l, row, c);
      if (!second) return load_g<LEAF>(*g, sp, w.l, row, c) + load_g<LEAF>(*g, sd, w.l, row, c).t;
      return load_g<LEAF>(*g, st, w.l, row, c);
    }
  }

  __device__ float* slot(int s) const { return ring + (s % kDmRing) * kSlot; }
  __device__ void start() const {}
  __device__ void prefetch(int s) {
    if constexpr (kPre) {
#pragma unroll
      for (int i = 0; i < qa; ++i) {
        const int q = threadIdx.x + i * kDmThreads;
        va[i] = form<true>(s, q / kDmM, q % kDmM);
      }
#pragma unroll
      for (int i = 0; i < qb; ++i) {
        const int q = threadIdx.x + i * kDmThreads;
        vb[i] = form<false>(s, q / TN, q % TN);
      }
    }
  }
  __device__ void stage(int s) const {
    float* A = slot(s);
    float* B = A + kDmK * lda;
#pragma unroll
    for (int i = 0; i < qa; ++i) {
      const int q = threadIdx.x + i * kDmThreads;
      A[(q / kDmM) * lda + q % kDmM] = kPre ? va[i] : form<true>(s, q / kDmM, q % kDmM);
    }
    if constexpr (kPre) {
#pragma unroll
      for (int i = 0; i < qb; ++i) {
        const int q = threadIdx.x + i * kDmThreads;
        B[(q / TN) * ldb + q % TN] = vb[i];
      }
    } else {
      for (int i0 = 0; i0 < qb; i0 += 4) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = threadIdx.x + (i0 + i) * kDmThreads;
          v[i] = form<false>(s, q / TN, q % TN);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = threadIdx.x + (i0 + i) * kDmThreads;
          B[(q / TN) * ldb + q % TN] = v[i];
        }
      }
    }
  }

  struct Op {
    const float *A, *B;
    template <int K8>
    __device__ __forceinline__ double a(int k, int m) const {
      return (double)A[(8 * K8 + k) * lda + m];
    }
    template <int K8>
    __device__ __forceinline__ double b(int k, int n) const {
      return (double)B[(8 * K8 + k) * ldb + n];
    }
  };
  __device__ Op op(int s) const { return {slot(s), slot(s) + kDmK * lda}; }
};

// How a wide leaf's operands reach the ring: a = form(one residual, boundary
// or row stream) against one row stream g. FORM_LOADER: through the loaders
// (w_vel0's a = h_in + silu(uv) reads two streams).
enum Form { FORM_ID, FORM_SILU, FORM_XMIX, FORM_LOADER };
struct StreamSpec {
  int a_arr, a_idx, g_idx, form;
};
__host__ __device__ constexpr StreamSpec stream_spec(int leaf) {
  switch (leaf) {
    case W_IN_J: return {A_BH, 0, RW_DAJ, FORM_ID};
    case W_IN_I: return {A_BH, 0, RW_DAI, FORM_ID};
    case W_O_J: return {A_BH, 0, RW_DOJ, FORM_ID};
    case W_O_I: return {A_BH, 0, RW_DOI, FORM_ID};
    case W_NODE_H: return {A_BH, 0, RW_DNP, FORM_ID};
    case W_O_F: return {A_RW, RW_FILT, RW_DE0, FORM_ID};
    case W_O1: return {A_RS, RS_E0, RW_DHE, FORM_SILU};
    case W_XMIX: return {A_RS, RS_H_E, RW_DXM, FORM_XMIX};  // a = h_e * att2[head]
    case W_POST0: return {A_RW, RW_PSQ, RW_DPS0, FORM_ID};
    case W_POST1: return {A_RS, RS_PS0, RW_DPS1, FORM_SILU};
    case W_NODE_AGG: return {A_RW, RW_HATT, RW_DNP, FORM_ID};
    case W_NODE_COMB: return {A_RS, RS_PS1, RW_DNP, FORM_SILU};
    case W_NODE1: return {A_RS, RS_NODE_PRE, RW_DUV, FORM_SILU};
    default: return {0, 0, 0, FORM_LOADER};
  }
}
__host__ __device__ inline const float* table(const Tables& t, int arr, int i) {
  return arr == A_BH ? t.bh : (arr == A_RS ? t.rs[i] : t.rw[i]);
}

// Floats of a ring slot of a streamed leaf's tile 32 NT wide: a's slab (and
// its tangent), w_xmix's att2 (and its tangent), g (augmented: the primal
// chain's, its tangent, the tangent chain's), each per x its padded stride.
template <bool kAug>
__host__ __device__ constexpr int stream_slot(int nt, bool xmix, int K) {
  return stage_rows<kAug>() * ((kAug ? 2 : 1) * (dm_ldr(kDmM) + (xmix ? K + 8 : 0)) +
                               (kAug ? 3 : 1) * dm_ldr(32 * nt));
}

// A streamed leaf's ring: the raw rows of a's stream and g's (augmented: the
// tangent chain's a and its tangent, the primal chain's g, its tangent and the
// tangent chain's g; w_xmix also att2 and its tangent). silu's operands are
// formed in place by the thread that copied them, once it has them; w_xmix's
// he_att = h_e * att2[head] (and its tangent by the product rule) and every
// augmented g (g_p + t(g), then the tangent chain's g) are formed as the
// products read their fragments.
template <int LEAF, bool kAug>
struct StreamFill {
  static constexpr int per = stage_rows<kAug>(), nA = kAug ? 2 : 1, nB = kAug ? 3 : 1;
  static constexpr int NT = tile_nt(LEAF), TN = 32 * NT, form = stream_spec(LEAF).form;
  static constexpr bool kX = form == FORM_XMIX;
  DmStream<1> a[nA];                             // a's slab (per x 64: a piece a thread at most)
  DmStream<1> t2[kX ? nA : 1];                   // w_xmix: att2's rows (per x K floats)
  DmStream<(per * TN / 4 + kDmThreads - 1) / kDmThreads> b[nB];  // g (per x TN floats)
  float* ring;
  int slot_floats, off_t2, off_b;  // a slot's floats; where att2's and g's parts start
  int head, n_stages;
  long long r_begin;

  __device__ float* slot(int s) const { return ring + (s % kDmRing) * slot_floats; }
  __device__ void issue(int s) const {
    if (s < n_stages) {
      const long long r0 = r_begin + (long long)s * per;
      float* p = slot(s);
#pragma unroll
      for (int i = 0; i < nA; ++i) {
        a[i].issue(p + i * per * dm_ldr(kDmM), r0);
        if constexpr (kX) t2[i].issue(p + off_t2 + i * per * t2[0].ld, r0);
      }
#pragma unroll
      for (int i = 0; i < nB; ++i) b[i].issue(p + off_b + i * per * dm_ldr(TN), r0);
    }
    dm_commit();  // one group a stage, empty past the last
  }
  __device__ void start() const {
    for (int s = 0; s < kDmRing - 2; ++s) issue(s);
  }
  __device__ void prefetch(int) const {}  // every load goes through the ring
  __device__ void stage(int s) const {
    dm_wait<kDmRing - 3>();  // this thread's copies of stage s have landed
    if constexpr (form == FORM_SILU) {  // this thread's own pieces, in place
      float* av = slot(s);
      float* at = av + per * dm_ldr(kDmM);
      if (a[0].dst[0] >= 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* v = av + a[0].dst[0] + j;
          if constexpr (kAug) at[a[0].dst[0] + j] *= dsiluf_(*v);
          *v = siluf_(*v);
        }
      }
    }
    issue(s + kDmRing - 2);
  }

  struct Op {
    const float *av, *at, *kv, *kt, *g0, *g1, *g2;
    int lda, ldk, ldb, head;
    template <int K8>
    __device__ __forceinline__ double a(int k, int m) const {
      const int r = kAug ? k : 8 * K8 + k;
      if constexpr (kX) {
        if constexpr (!kAug || K8 == 0) return (double)(av[r * lda + m] * kv[r * ldk + head]);
        const Dl he{av[r * lda + m], at[r * lda + m]}, a2{kv[r * ldk + head], kt[r * ldk + head]};
        return (double)(he * a2).t;
      } else {
        return (double)(kAug && K8 == 1 ? at : av)[r * lda + m];
      }
    }
    template <int K8>
    __device__ __forceinline__ double b(int k, int n) const {
      if constexpr (!kAug) return (double)g0[(8 * K8 + k) * ldb + n];
      else if constexpr (K8 == 0) return (double)(g0[k * ldb + n] + g1[k * ldb + n]);
      else return (double)g2[k * ldb + n];
    }
  };
  __device__ Op op(int s) const {
    const float* p = slot(s);
    const int la = dm_ldr(kDmM), lk = kX ? t2[0].ld : 0, lb = dm_ldr(TN);
    const float* tb = p + off_t2;
    const float* gb = p + off_b;
    return {p, p + (kAug ? per * la : 0), tb, tb + (kAug ? per * lk : 0), gb,
            gb + (kAug ? per * lb : 0), gb + (kAug ? 2 * per * lb : 0), a[0].ld, lk, b[0].ld,
            head};
  }
};

// out[r, c] = sum over the chunk's rows of a[row, r] * g[row, c] for one
// wide tile (augmented: a against g_p + t_g, then t_a against g_t), on DMMA.
template <int LEAF, bool kAug, bool kE16 = false>
__device__ void contract_wide(const GradArgs& g, const WideTile& w, double* out, float* ring) {
  constexpr int NT = tile_nt(LEAF);
  constexpr int per = stage_rows<kAug>();
  constexpr int stage_slot = LEAF == W_XMIX ? PR_PG_XMIX_STAGE : PR_PG_WIDE_STAGE;
  constexpr int mma_slot = LEAF == W_XMIX ? PR_PG_XMIX_MMA : PR_PG_WIDE_MMA;
  const int n_stages = (int)((w.r_end - w.r_begin + per - 1) / per);
  DmTile<NT> acc;
  if constexpr (stream_spec(LEAF).form != FORM_LOADER && !kE16) {
    if (g.ring_ok[LEAF]) {
      constexpr StreamSpec sp = stream_spec(LEAF);
      constexpr bool kX = sp.form == FORM_XMIX;
      const Dims& d = g.d;
      const long long rows = leaf_rows<LEAF>(d);
      const Tables& tv = kAug ? g.Tv : g.P;
      const int wa = kX ? d.H : g.ra[LEAF], wg = g.cg[LEAF];
      const int a0 = kX ? w.h0 : w.r0;
      const auto at = [&](const float* t, int width) { return t + (size_t)w.l * rows * width; };
      StreamFill<LEAF, kAug> fill;
      fill.a[0].init(at(table(tv, sp.a_arr, sp.a_idx), wa), w.r_end, wa, a0, w.m_live, per);
      fill.b[0].init(at(g.P.rw[sp.g_idx], wg), w.r_end, wg, w.c0, w.n_live, per);
      if constexpr (kX) fill.t2[0].init(at(tv.rw[RW_ATT2], d.K), w.r_end, d.K, 0, d.K, per);
      if constexpr (kAug) {
        fill.a[1].init(at(table(g.Tt, sp.a_arr, sp.a_idx), wa), w.r_end, wa, a0, w.m_live, per);
        fill.b[1].init(at(g.Tt.rw[sp.g_idx], wg), w.r_end, wg, w.c0, w.n_live, per);
        fill.b[2].init(at(g.Tv.rw[sp.g_idx], wg), w.r_end, wg, w.c0, w.n_live, per);
        if constexpr (kX) fill.t2[1].init(at(g.Tt.rw[RW_ATT2], d.K), w.r_end, d.K, 0, d.K, per);
      }
      fill.ring = ring;
      fill.slot_floats = stream_slot<kAug>(NT, kX, d.K);
      fill.off_t2 = (kAug ? 2 : 1) * per * dm_ldr(kDmM);
      fill.off_b = fill.off_t2 + (kX ? (kAug ? 2 : 1) * per * (d.K + 8) : 0);
      fill.head = w.head;
      fill.n_stages = n_stages;
      fill.r_begin = w.r_begin;
      dm_run(acc, n_stages, w.m_live, w.n_live, fill, stage_slot, mma_slot);
      dm_wait<0>();
    }
  }
  if (stream_spec(LEAF).form == FORM_LOADER || !g.ring_ok[LEAF]) {
    LoaderFill<LEAF, kAug, NT, kE16> fill;
    fill.g = &g;
    fill.w = w;
    fill.ring = ring;
    dm_run(acc, n_stages, w.m_live, w.n_live, fill, stage_slot, mma_slot);
  }
  const int cg = g.cg[LEAF], K = g.d.K;
  acc.store(w.m_live, w.n_live, [&](int m, int n, double v) {
    out[(size_t)w.col_a(m, K) * cg + w.c0 + n] = v;
  });
  SAKE_PROBE_BARRIER(LEAF == W_XMIX ? PR_PG_XMIX_FLUSH : PR_PG_WIDE_FLUSH);
}

// Output rows a narrow block covers: 8 for the narrowest sums (the
// semantic-head biases), else 64; the block's other threads split the rows.
__host__ __device__ inline int narrow_cols(int ra) { return ra <= 8 ? 8 : kTile; }

// out[r, c] for narrow_cols(ra) rows r0.. and every c < cg <= kNarrowMax:
// each thread takes one r and every groups-th row of the chunk, summing in
// double; the row groups are summed in order at the end. These are the
// row sums, whose terms cancel (a softmax's cotangents sum to zero over
// its senders), so f32 sums lose digits the plain version keeps.
template <int LEAF, bool kAug, bool kE16 = false>
__device__ void contract_narrow(const GradArgs& g, int l, long long r_begin, long long r_end,
                                int r0, int ra, int cg, double* out, double* sm) {
  const int cols = narrow_cols(ra), groups = kThreads / cols;
  const int rl = threadIdx.x % cols, rg = threadIdx.x / cols;
  const int r = r0 + rl;
  const Src<float, kE16> sp{&g.P};
  const Src<Dl, kE16> sd{&g.Tv, &g.Tt};
  double acc[kNarrowMax];
#pragma unroll
  for (int c = 0; c < kNarrowMax; ++c) acc[c] = 0.0;
  if (r < ra) {
    for (long long row = r_begin + rg; row < r_end; row += groups) {
      const double a = edge_rd<LEAF, kE16>(load_a<LEAF>(g, sp, l, row, r));
      // augmented: a_p g_p + t_a g_t + a_t t_g (a row sum: s_p + t(s_t))
      Dl at{0.f, 0.f};
      if constexpr (kAug) at = load_a<LEAF>(g, sd, l, row, r);
#pragma unroll
      for (int c = 0; c < kNarrowMax; ++c) {
        if (c < cg) {
          acc[c] = fma(a, (double)edge_rd<LEAF, kE16>(load_g<LEAF>(g, sp, l, row, c)), acc[c]);
          if constexpr (kAug && kE16) {  // each term's operands rounded apart
            const Dl gt = load_g<LEAF>(g, sd, l, row, c);
            acc[c] = fma((double)edge_rd<LEAF, true>(at.t), (double)edge_rd<LEAF, true>(gt.v),
                         fma((double)edge_rd<LEAF, true>(at.v),
                             (double)edge_rd<LEAF, true>(gt.t), acc[c]));
          } else if constexpr (kAug) {
            const Dl gt = load_g<LEAF>(g, sd, l, row, c);
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
  SAKE_PROBE_BARRIER(PR_PG_NARROW);
}

// A block's leaf, and its layer, chunk and tile, from its kernel's first
// blocks; out points at its (layer, chunk) block of the partial sums.
struct BlockPlace {
  int leaf, l, chunk, tile;
  __device__ BlockPlace(const GradArgs& g, const int* first) {
    leaf = 0;
    while ((int)blockIdx.x >= first[leaf + 1]) ++leaf;
    int rel = blockIdx.x - first[leaf];
    tile = rel % g.tiles[leaf];
    rel /= g.tiles[leaf];
    chunk = rel % g.n_chunks;
    l = rel / g.n_chunks;
  }
  __device__ double* out(const GradArgs& g) const {
    return g.partial + chunk * g.total + g.off[leaf] + (size_t)l * g.ra[leaf] * g.cg[leaf];
  }
};

template <int LEAF>
__device__ void chunk_of(const GradArgs& g, int chunk, long long* r_begin, long long* r_end) {
  const long long rows = leaf_rows<LEAF>(g.d), span = chunk_span(rows, g.n_chunks);
  *r_begin = min(rows, chunk * span);
  *r_end = min(rows, *r_begin + span);
}

template <int LEAF, bool kAug, bool kE16 = false>
__device__ void wide_block(const GradArgs& g, const BlockPlace& p, float* ring) {
  WideTile w;
  w.l = p.l;
  w.rt = p.tile / g.tiles_c[LEAF];
  w.ct = p.tile % g.tiles_c[LEAF];
  chunk_of<LEAF>(g, p.chunk, &w.r_begin, &w.r_end);
  w.c0 = w.ct * 32 * tile_nt(LEAF);
  w.n_live = min(32 * tile_nt(LEAF), g.cg[LEAF] - w.c0);
  if (LEAF == W_XMIX) {
    w.head = w.rt % g.d.K;
    w.h0 = (w.rt / g.d.K) * kDmM;
    w.r0 = 0;
    w.m_live = min(kDmM, g.d.H - w.h0);
  } else {
    w.head = -1;
    w.h0 = 0;
    w.r0 = w.rt * kDmM;
    w.m_live = min(kDmM, g.ra[LEAF] - w.r0);
  }
  contract_wide<LEAF, kAug, kE16>(g, w, p.out(g), ring);
}

// The wide leaves' tiles 32 NT wide, one per block: w_xmix's (NT = 8) and the
// others' (NT = 2) are separate kernels, so that the narrower tiles run with
// the registers and shared memory of their own, several blocks to an SM.
// kE16: resid_ef's bf16 tier (the residual streams but r and t bf16, the four
// edge leaves' operands rounded; every wide tile through the loaders).
template <bool kAug, int NT, bool kE16 = false>
__global__ void __launch_bounds__(kThreads) param_grads_wide(const GradArgs g) {
  extern __shared__ float4 smem4[];
  SAKE_PROBE_START();
  const BlockPlace p(g, g.first[NT == 8 ? 2 : 1]);
  float* ring = reinterpret_cast<float*>(smem4);
#define SAKE_LEAF(X) \
  case X:            \
    if constexpr (tile_nt(X) == NT) wide_block<X, kAug, kE16>(g, p, ring); \
    break;
  switch (p.leaf) {
    SAKE_LEAF(W_IN_J) SAKE_LEAF(W_IN_I) SAKE_LEAF(W_O_J) SAKE_LEAF(W_O_I) SAKE_LEAF(W_O_F)
    SAKE_LEAF(W_O1) SAKE_LEAF(W_XMIX) SAKE_LEAF(W_POST0) SAKE_LEAF(W_POST1)
    SAKE_LEAF(W_NODE_H) SAKE_LEAF(W_NODE_AGG) SAKE_LEAF(W_NODE_COMB) SAKE_LEAF(W_NODE1)
    SAKE_LEAF(W_VEL0)
  }
#undef SAKE_LEAF
}

template <bool kAug, bool kE16 = false>
__global__ void __launch_bounds__(kThreads) param_grads_narrow(const GradArgs g) {
  __shared__ double sm[kThreads * kNarrowMax];
  SAKE_PROBE_START();
  const BlockPlace p(g, g.first[0]);
  const int ra = g.ra[p.leaf], cg = g.cg[p.leaf];
  const int r0 = p.tile * g.row_tile[p.leaf];
  double* out = p.out(g);
  long long r_begin, r_end;
#define SAKE_LEAF(X)                                                        \
  case X:                                                                   \
    chunk_of<X>(g, p.chunk, &r_begin, &r_end);                              \
    contract_narrow<X, kAug, kE16>(g, p.l, r_begin, r_end, r0, ra, cg, out, sm); \
    break;
  switch (p.leaf) {
    SAKE_LEAF(B_IN) SAKE_LEAF(RBF_M) SAKE_LEAF(RBF_B) SAKE_LEAF(W_O_R) SAKE_LEAF(B_O0)
    SAKE_LEAF(B_O1) SAKE_LEAF(W_SEM) SAKE_LEAF(B_SEM) SAKE_LEAF(B_POST0) SAKE_LEAF(B_POST1)
    SAKE_LEAF(B_NODE0) SAKE_LEAF(B_NODE1) SAKE_LEAF(W_VMIX) SAKE_LEAF(B_VEL0)
    SAKE_LEAF(W_VEL1)
  }
#undef SAKE_LEAF
}

// out[i] = sum over chunks, in chunk order and in double, of partial[chunk, i].
template <class T>
__global__ void sum_chunks(const T* __restrict__ partial, float* out, long long total,
                           int n_chunks) {
  SAKE_PROBE_START();
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    double s = 0.0;
    for (int c = 0; c < n_chunks; ++c) s += (double)partial[c * total + i];
    out[i] = (float)s;
  }
  SAKE_PROBE_BARRIER(PR_PG_SUM);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Launches the wide tiles 32 NT wide (blocks of them), each with kDmRing ring
// slots of `slot` floats.
template <bool kAug, int NT, bool kE16 = false>
cudaError_t launch_wide(const GradArgs& g, long long blocks, int slot, cudaStream_t s) {
  if (blocks == 0) return cudaSuccess;
  const int smem = kDmRing * slot * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(param_grads_wide<kAug, NT, kE16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  param_grads_wide<kAug, NT, kE16><<<(unsigned)blocks, kThreads, smem, s>>>(g);
  return cudaGetLastError();
}

template <bool kAug, bool kE16 = false>
int launch_grads(GradArgs& g, const void* const* leaf_ptrs, const long long* leaf_strides,
                 double* partial, float* out, int n_chunks, void* stream) {
  if (n_chunks < 1) return (int)cudaErrorInvalidValue;
  g.n_chunks = n_chunks;
  g.L = leaves_of(leaf_ptrs, leaf_strides);
  g.partial = partial;
  long long off = 0, blocks[3] = {0, 0, 0};  // by kernel (BlockPlace)
  for (int leaf = 0; leaf < kLeaves; ++leaf) {
    int rows, cols;
    leaf_shape(leaf, g.d, &rows, &cols);
    g.ra[leaf] = rows == 1 ? cols : rows;
    g.cg[leaf] = rows == 1 ? 1 : cols;
    const bool nar = narrow_leaf(leaf);
    if (nar && g.cg[leaf] > kNarrowMax) return (int)cudaErrorInvalidValue;
    const int tn = 32 * tile_nt(leaf);
    g.tiles_c[leaf] = nar ? 1 : (g.cg[leaf] + tn - 1) / tn;
    g.row_tile[leaf] = nar ? narrow_cols(g.ra[leaf]) : kDmM;
    g.tiles[leaf] = nar ? (g.ra[leaf] + g.row_tile[leaf] - 1) / g.row_tile[leaf]
                        : tiles_r(leaf, g.d, g.ra[leaf]) * g.tiles_c[leaf];
    for (int k = 0; k < 3; ++k) g.first[k][leaf] = (int)blocks[k];
    blocks[nar ? 0 : (tile_nt(leaf) == 8 ? 2 : 1)] += (long long)g.tiles[leaf] * n_chunks * g.d.depth;
    g.off[leaf] = off;
    off += (long long)g.d.depth * rows * cols;
  }
  for (int k = 0; k < 3; ++k) g.first[k][kLeaves] = (int)blocks[k];
  g.total = off;
  // A wide leaf's ring streams 16-byte pieces: its tables aligned, every
  // layer's rows starting on a piece, and a slab's width a multiple of 4
  const Tables& tv = kAug ? g.Tv : g.P;
  const long long node_rows = (long long)g.d.B * g.d.N, edge_rows = node_rows * g.d.N;
  int slot[2] = {0, 0};  // ring slot floats of the NT = 2 and the NT = 8 kernel
  for (int leaf = 0; leaf < kLeaves; ++leaf) {
    const StreamSpec sp = stream_spec(leaf);
    const bool xmix = sp.form == FORM_XMIX;
    const long long rows = row_kind(leaf) == EDGE_ROW ? edge_rows : node_rows;
    const int wa = xmix ? g.d.H : g.ra[leaf], wg = g.cg[leaf];
    auto ok = [&](const float* p, int w, int tile_w) {
      return aligned16(p) && (rows * w) % 4 == 0 && (w <= tile_w || w % 4 == 0);
    };
    bool on = !kE16 && !narrow_leaf(leaf) && sp.form != FORM_LOADER &&
              ok(table(tv, sp.a_arr, sp.a_idx), wa, kDmM) &&
              ok(g.P.rw[sp.g_idx], wg, 32 * tile_nt(leaf)) &&
              (!xmix || (g.d.K <= kDmM && ok(tv.rw[RW_ATT2], g.d.K, kDmM)));
    if (kAug)
      on = on && ok(table(g.Tt, sp.a_arr, sp.a_idx), wa, kDmM) &&
           ok(g.Tt.rw[sp.g_idx], wg, 32 * tile_nt(leaf)) &&
           ok(g.Tv.rw[sp.g_idx], wg, 32 * tile_nt(leaf)) &&
           (!xmix || ok(g.Tt.rw[RW_ATT2], g.d.K, kDmM));
    g.ring_ok[leaf] = on;
    if (!narrow_leaf(leaf)) {
      const int nt = tile_nt(leaf);
      const int need = on ? stream_slot<kAug>(nt, xmix, g.d.K)
                          : kDmK * (dm_ldr(kDmM) + dm_ldr(32 * nt));
      int& at = slot[nt == 8];
      at = need > at ? need : at;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_wide<kAug, 8, kE16>(g, blocks[2], slot[1], s);
  if (err == cudaSuccess) err = launch_wide<kAug, 2, kE16>(g, blocks[1], slot[0], s);
  if (err != cudaSuccess) return (int)err;
  param_grads_narrow<kAug, kE16><<<(unsigned)blocks[0], kThreads, 0, s>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows(partial, out, off, g.n_chunks, s);
  return (int)cudaGetLastError();
}

}  // namespace sake

// out: every leaf's (depth, rows, cols) gradient, in LEAF_NAMES order,
// concatenated; partial: (n_chunks, len(out)) f64 scratch. Each layer's rows
// are cut into n_chunks ranges (chunk_span).
extern "C" int sake_param_grads(const float* bh, const void* const* leaf_ptrs,
                                const long long* leaf_strides, void* const* resid_ptrs,
                                void* const* row_ptrs, double* partial, float* out,
                                int n_chunks, int B, int N, int F, int H, int R, int K, int C,
                                int depth, void* stream) {
  using namespace sake;
  GradArgs g;
  g.d = Dims{B, N, F, H, R, K, C, depth};
  g.P = tables(bh, resid_ptrs, row_ptrs);
  return launch_grads<false>(g, leaf_ptrs, leaf_strides, partial, out, n_chunks, stream);
}

// sake_param_grads in resid_ef's bf16 tier: the residual streams but r and t
// bf16 tensors, the rows those of the bf16 tier's pullback (att2 rounded); the
// four edge leaves' operands rounded to bf16 before their f64 products.
extern "C" int sake_param_grads16(const float* bh, const void* const* leaf_ptrs,
                                  const long long* leaf_strides, void* const* resid_ptrs,
                                  void* const* row_ptrs, double* partial, float* out,
                                  int n_chunks, int B, int N, int F, int H, int R, int K, int C,
                                  int depth, void* stream) {
  using namespace sake;
  GradArgs g;
  g.d = Dims{B, N, F, H, R, K, C, depth};
  g.P = tables(bh, resid_ptrs, row_ptrs);
  return launch_grads<false, true>(g, leaf_ptrs, leaf_strides, partial, out, n_chunks, stream);
}

// The augmented gradients in resid_ef's bf16 tier (#12's contraction in the
// tier): the arguments of sake_param_grads_aug below, the primal's and the
// tangent's residual streams (resid_ptrs, tresid_ptrs) bf16 tensors but r and
// t, the rows f32.
extern "C" int sake_param_grads_aug16(const float* bh, const float* tbh,
                                      const void* const* leaf_ptrs,
                                      const long long* leaf_strides, void* const* resid_ptrs,
                                      void* const* tresid_ptrs, void* const* row_ptrs,
                                      void* const* trow_ptrs, void* const* ttrow_ptrs,
                                      double* partial, float* out, const float* ro_part,
                                      float* ro_out, long long ro_len, int n_chunks, int B,
                                      int N, int F, int H, int R, int K, int C, int depth,
                                      void* stream) {
  using namespace sake;
  GradArgs g;
  g.d = Dims{B, N, F, H, R, K, C, depth};
  g.P = tables(bh, resid_ptrs, row_ptrs);
  g.Tv = tables(bh, resid_ptrs, trow_ptrs);
  g.Tt = tables(tbh, tresid_ptrs, ttrow_ptrs);
  const int err =
      launch_grads<true, true>(g, leaf_ptrs, leaf_strides, partial, out, n_chunks, stream);
  if (err != 0 || ro_part == nullptr) return err;
  sum_rows(ro_part, ro_out, ro_len, B, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
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
                                    float* ro_out, long long ro_len, int n_chunks, int B, int N,
                                    int F, int H, int R, int K, int C, int depth, void* stream) {
  using namespace sake;
  GradArgs g;
  g.d = Dims{B, N, F, H, R, K, C, depth};
  g.P = tables(bh, resid_ptrs, row_ptrs);
  g.Tv = tables(bh, resid_ptrs, trow_ptrs);
  g.Tt = tables(tbh, tresid_ptrs, ttrow_ptrs);
  const int err = launch_grads<true>(g, leaf_ptrs, leaf_strides, partial, out, n_chunks, stream);
  if (err != 0 || ro_part == nullptr) return err;
  sum_rows(ro_part, ro_out, ro_len, B, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The clock probe's slots (probe.cuh): out (kProbeSlots,), zeroed when reset.
extern "C" int sake_param_grads_probe(unsigned long long* out, int reset) {
  return sake::probe_read(out, reset);
}
