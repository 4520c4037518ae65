// K1: forward of the dense SAKE layer stack with residuals, f32, and the
// same forward without residuals.
//
// Replaces three TPU kernels of sake_tpu/kernels/resid_ef.py, which all run
// layer_fwd_resid over depth:
// - resid_energy_forces -> fwd_kernel (the pallas_call at :1157), the E + F
//   serving forward: this kernel with kStream, no mask;
// - make_hidden_fn -> fwd_kernel (:1545, body :1484), the training forward
//   on padded batches: this kernel with kStream and an edge mask (B, N, N);
// - make_hidden_fn -> infer_kernel (:1780, body :1732), the forward no
//   backward will read: this kernel without kStream, which writes only the
//   final h and x.
// With kStream it writes the boundary states (h, x, v) and the 17 residuals
// the hand-written backward (resid_bwd.cu) reads. The TPU kernels' velocity
// input is v0 here.
//
// Masked semantics (layer_fwd_resid with a mask): logits - 1e5 * (1 - m),
// the raw softmax saved, attention renormalized over live senders
// (att2 = att * m / sum_j att * m, a zero sum read as 1), coefficients
// times m, pooled sums over the sender count + 1e-8 and the velocity
// update over the count + 1e-10.
//
// Design: one thread block per molecule, looping over depth inside the
// block, so the molecule's (h, x, v) state stays in shared memory between
// layers (the TPU kernel's VMEM scratch sh/sx/sv). Per layer, the node
// projections a_j, a_i, o_j, o_i go to shared memory; then each receiver
// row i builds its N sender edges there (rbf, e0, h_e, logits, the softmax
// over senders, coefficients), pools them into pool0-2 and hatt_sum, and
// streams the row's edge residuals out; the node MLP, velocity gate and
// x/v update follow once all rows are done. Weights (about 2 MB for the
// depth-6 model) are read from device memory and stay in L2. The pooled
// vectors go to device memory even without kStream (to a (3, B, N, C)
// scratch the wrapper reuses layer after layer): at N = 29 shared memory
// cannot hold them beside the row buffers.
//
// What bounds it on an H100: f32 FMA issue, and the synchronisation of a
// block that works on one receiver row (N edges) at a time. The widest
// product, the x_mixing contraction (N x HK) @ (HK x C) per row, is about
// 90% of the FLOPs. The wide products run register-tiled (mm_tiled: 7
// rows x 4 columns per thread, float4 loads), so one shared-memory load
// feeds 16 FMAs; with one load per FMA the shared-memory pipe was the
// limit. Narrower products take one output per thread or one warp per row
// (mm_smem picks by width), since 7 x 4 tiles would leave the block idle. Residual writes (about
// 0.87 MB per molecule and layer for aspirin) are coalesced row blocks,
// well below HBM bandwidth at the rates this reaches. At QM9's N = 29 the
// block needs 146 KB of shared memory, so one block fits an SM where the
// launch bounds ask for two. Tensor cores (wgmma on bf16) are the next
// step and a later change.

#include "resid_common.cuh"

namespace sake {

constexpr int kFwdTileCols = 4;  // columns per tile in mm_tiled
constexpr int kFwdTiledMinCols = 16;  // narrowest tiled product

// This kernel's block products (see mm_smem).
template <class ST>
__device__ __forceinline__ void mm(int n, int kd, int m, const float* A, int lda,
                                   const float* __restrict__ W, ST st) {
  mm_smem<kFwdTileCols, kFwdTiledMinCols>(n, kd, m, A, lda, W, st);
}

// Shared-memory buffers of K1, in floats. Node-level state lives across
// the row loop; row buffers are rebuilt for every receiver row i; the
// node phase reuses the row buffers once all rows are done.
struct FwdSmem {
  float *sh, *sx, *sv, *saj, *sai, *soj, *soi, *shatt, *sdel, *scnt;  // node level
  float *sd, *sr, *sir, *smk, *srbf, *se0, *she, *ssem, *satt, *shea, *scf;  // row
};

__host__ __device__ inline FwdSmem carve_fwd(Carver& cv, const Dims& d) {
  const long long N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  FwdSmem s;
  s.sh = cv.take(N * F);        // h
  s.sx = cv.take(3 * N);        // x planes
  s.sv = cv.take(3 * N);        // v planes
  s.saj = cv.take(N * R);       // h @ w_in_j + b_in
  s.sai = cv.take(N * R);       // h @ w_in_i
  s.soj = cv.take(N * H);
  s.soi = cv.take(N * H);
  s.shatt = cv.take(N * H * K); // sum_j h_e (x) att
  s.sdel = cv.take(3 * N);      // pooled_k @ w_vmix
  s.scnt = cv.take(N);          // senders per receiver (masked)
  s.sd = cv.take(3 * N);        // row: d_k[j] = x_k[j] - x_k[i]
  s.sr = cv.take(N);            // row: r
  s.sir = cv.take(2 * N);       // row: 1 / (r + 1e-5), then t = exp(-r)
  s.smk = cv.take(N);           // row: m[i, j], 1 without a mask
  s.srbf = cv.take(N * R);
  s.se0 = cv.take(N * H);       // row: e0 -> silu(e0); node: ps0
  s.she = cv.take(N * H);       // row: h_e; node: ps1 -> h_comb
  s.ssem = cv.take(N * K);
  s.satt = cv.take(N * K);
  s.shea = cv.take(N * H * K);  // row: h_e (x) att, column h*K + k
  // row: coeff; node: pool_sq, then node_pre, uv, g0, g1 (below)
  s.scf = cv.take((C > 2 * H + F + 1 ? C : 2 * H + F + 1) * N);
  return s;
}

__host__ __device__ inline long long fwd_smem_floats(const Dims& d) {
  Carver cv{nullptr};
  carve_fwd(cv, d);
  return cv.off;
}

// Two blocks per SM (<= 128 registers) measured faster than one with
// more registers at aspirin's N = 21.
template <bool kStream>
__global__ void __launch_bounds__(256, 2)
resid_fwd_kernel(Dims d, const float* __restrict__ h0,
                 const float* __restrict__ xs, const float* __restrict__ v0,
                 const float* __restrict__ upd, const float* __restrict__ mask, Leaves L,
                 float* bh, float* bx, float* bv, float* h_fin, float* x_fin,
                 float* v_fin, Resids RS) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int B = d.B, N = d.N, F = d.F, H = d.H, R = d.R, K = d.K, C = d.C;
  const int HK = H * K, NN = N * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
  const float n_eff = (float)N;
  const bool masked = mask != nullptr;
  const float* mb = masked ? mask + (size_t)b * NN : nullptr;  // this molecule's (N, N)

  Carver cv{reinterpret_cast<float*>(smem4)};
  const FwdSmem S = carve_fwd(cv, d);
  float *sh = S.sh, *sx = S.sx, *sv = S.sv, *saj = S.saj, *sai = S.sai, *soj = S.soj,
        *soi = S.soi, *shatt = S.shatt, *sdel = S.sdel, *scnt = S.scnt, *sd = S.sd,
        *sr = S.sr, *sir = S.sir, *smk = S.smk, *srbf = S.srbf, *se0 = S.se0,
        *she = S.she, *ssem = S.ssem, *satt = S.satt, *shea = S.shea, *scf = S.scf;
  float* snp = scf;             // node: (N, H) node_pre -> silu
  float* suv = snp + N * H;     // node: (N, F) uv
  float* sg0 = suv + N * F;     // node: (N, H) g0 -> silu
  float* sg1 = sg0 + N * H;     // node: (N) g1

  for (int e = tid; e < N * F; e += nt) sh[e] = h0[(size_t)b * N * F + e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    sx[e] = xs[((size_t)k * B + b) * N + i];
    sv[e] = v0[((size_t)k * B + b) * N + i];
  }
  sender_counts(mb, N, scnt);
  __syncthreads();

  for (int l = 0; l < d.depth; ++l) {
    const float u = upd[l];
    const size_t lb = (size_t)l * B + b;
    // without kStream the pooled vectors go to a one-layer scratch
    const size_t lp = kStream ? lb : (size_t)b;
    auto W = [&](int leaf) { return L.at(leaf, l); };
    const float* b_in = W(B_IN);
    const float* rbf_m = W(RBF_M);
    const float* rbf_b = W(RBF_B);
    const float* w_o_r = W(W_O_R);
    const float* b_o0 = W(B_O0);
    const float* b_o1 = W(B_O1);
    const float* b_sem = W(B_SEM);

    // boundary state in
    if constexpr (kStream) {
      for (int e = tid; e < N * F; e += nt) bh[lb * N * F + e] = sh[e];
      for (int e = tid; e < 3 * N; e += nt) {
        const int k = e / N, i = e % N;
        bx[(((size_t)l * 3 + k) * B + b) * N + i] = sx[e];
        bv[(((size_t)l * 3 + k) * B + b) * N + i] = sv[e];
      }
    }

    // node projections
    mm(N, F, R, sh, F, W(W_IN_J),
            [&](int r, int c, float a) { saj[r * R + c] = a + b_in[c]; });
    mm(N, F, R, sh, F, W(W_IN_I),
            [&](int r, int c, float a) { sai[r * R + c] = a; });
    mm(N, F, H, sh, F, W(W_O_J),
            [&](int r, int c, float a) { soj[r * H + c] = a; });
    mm(N, F, H, sh, F, W(W_O_I),
            [&](int r, int c, float a) { soi[r * H + c] = a; });
    __syncthreads();

    for (int i = 0; i < N; ++i) {
      const size_t erow = lb * NN + (size_t)i * N;  // edge (i, 0)

      // geometry
      for (int j = tid; j < N; j += nt) {
        float s = 0.f;
        float dk[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          dk[k] = sx[k * N + j] - sx[k * N + i];
          sd[k * N + j] = dk[k];
        }
        s = dk[0] * dk[0] + dk[1] * dk[1] + dk[2] * dk[2];
        const float r = sqrtf(fmaxf(s, 0.f) + kEps);
        sr[j] = r;
        sir[j] = 1.f / (r + 1e-5f);
        sir[N + j] = expf(-r);  // t
        smk[j] = masked ? mb[i * N + j] : 1.f;
        if constexpr (kStream) {
          RS.p[RS_R][erow + j] = r;
          RS.p[RS_T][erow + j] = sir[N + j];
        }
      }
      __syncthreads();

      // rbf filter; srbf keeps filtered = rbf * (a_j[j] + a_i[i])
      for (int e = tid; e < N * R; e += nt) {
        const int j = e / R, c = e % R;
        const float z = sir[N + j] - rbf_m[c];
        const float v = expf(-rbf_b[c] * (z * z));
        if constexpr (kStream) RS.p[RS_RBF][erow * R + e] = v;
        srbf[e] = v * (saj[e] + sai[i * R + c]);
      }
      __syncthreads();

      // e0 = o_j[j] + o_i[i] + filtered @ w_o_f + r * w_o_r + b_o0
      mm(N, R, H, srbf, R, W(W_O_F), [&](int r, int c, float a) {
        const float v = soj[r * H + c] + soi[i * H + c] + a + sr[r] * w_o_r[c] + b_o0[c];
        se0[r * H + c] = v;
        if constexpr (kStream) RS.p[RS_E0][(erow + r) * H + c] = v;
      });
      __syncthreads();
      for (int e = tid; e < N * H; e += nt) se0[e] = siluf_(se0[e]);
      __syncthreads();

      // h_e = silu(e0) @ w_o1 + b_o1
      mm(N, H, H, se0, H, W(W_O1),
              [&](int r, int c, float a) {
                const float v = a + b_o1[c];
                she[r * H + c] = v;
                if constexpr (kStream) RS.p[RS_H_E][(erow + r) * H + c] = v;
              });
      __syncthreads();

      // semantic logits
      mm(N, H, K, she, H, W(W_SEM),
              [&](int r, int c, float a) {
                const float v = a + b_sem[c];
                ssem[r * K + c] = v;
                if constexpr (kStream) RS.p[RS_SEM_PRE][(erow + r) * K + c] = v;
              });
      __syncthreads();

      // softmax over senders j, one warp per head; the raw softmax is the
      // residual, the renormalized one (masked) feeds the products
      for (int k = warp; k < K; k += nwarp) {
        float mx = -3.4e38f;
        for (int j = lane; j < N; j += 32) {
          const float s = ssem[j * K + k];
          float lg = s > 0.f ? s : 2.f * (expf(s / 2.f) - 1.f);
          if (j == i) lg -= kInf;
          lg -= kInf * (1.f - smk[j]);
          satt[j * K + k] = lg;
          mx = fmaxf(mx, lg);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
        for (int j = lane; j < N; j += 32) {
          const float ex = expf(satt[j * K + k] - mx);
          satt[j * K + k] = ex;
          sum += ex;
        }
        sum = warp_sum(sum);
        float live = 0.f;
        for (int j = lane; j < N; j += 32) {
          const float a = satt[j * K + k] / sum;
          satt[j * K + k] = a;
          live += a * smk[j];
          if constexpr (kStream) RS.p[RS_ATT][(erow + j) * K + k] = a;
        }
        if (masked) {
          live = warp_sum(live);
          const float dg = live == 0.f ? 1.f : live;
          for (int j = lane; j < N; j += 32) satt[j * K + k] = satt[j * K + k] * smk[j] / dg;
        }
      }
      __syncthreads();

      // attended edges h_e (x) att, hidden-major / head-minor: column h*K + k
      for (int e = tid; e < N * HK; e += nt) {
        const int j = e / HK, q = e % HK;
        shea[e] = she[j * H + q / K] * satt[j * K + q % K];
      }
      __syncthreads();
      // hatt_sum[i] = sum_j he_att[j]; coeff = tanh(he_att @ w_xmix) * m
      for (int q = tid; q < HK; q += nt) {
        float s = 0.f;
        for (int j = 0; j < N; ++j) s += shea[j * HK + q];
        shatt[i * HK + q] = s;
      }
      mm(N, HK, C, shea, HK, W(W_XMIX), [&](int r, int c, float a) {
        const float v = tanhf(a) * smk[r];
        scf[r * C + c] = v;
        if constexpr (kStream) RS.p[RS_COEFF][(erow + r) * C + c] = v;
      });
      __syncthreads();

      // pooled_k[i] = sum_j coeff[j] * d_k[j] / (r_j + 1e-5)
      for (int c = tid; c < C; c += nt) {
        float p[3] = {0.f, 0.f, 0.f};
        for (int j = 0; j < N; ++j) {
          const float cf = scf[j * C + c];
#pragma unroll
          for (int k = 0; k < 3; ++k) p[k] += cf * (sd[k * N + j] * sir[j]);
        }
        RS.p[RS_POOL0][(lp * N + i) * C + c] = p[0];
        RS.p[RS_POOL1][(lp * N + i) * C + c] = p[1];
        RS.p[RS_POOL2][(lp * N + i) * C + c] = p[2];
      }
      __syncthreads();
    }

    // ---- node phase -----------------------------------------------------
    const float* pool[3] = {RS.p[RS_POOL0] + lp * N * C, RS.p[RS_POOL1] + lp * N * C,
                            RS.p[RS_POOL2] + lp * N * C};
    for (int e = tid; e < N * C; e += nt) {
      const float pd = pool_denom(masked, scnt[e / C], n_eff);
      const float n0 = pool[0][e] / pd, n1 = pool[1][e] / pd, n2 = pool[2][e] / pd;
      scf[e] = n0 * n0 + n1 * n1 + n2 * n2;  // pool_sq
    }
    {
      const float* wv = W(W_VMIX);
      for (int q = warp; q < 3 * N; q += nwarp) {
        const int k = q / N, i = q % N;
        float s = 0.f;
        for (int c = lane; c < C; c += 32) s += pool[k][i * C + c] * wv[c];
        s = warp_sum(s);
        if (lane == 0) sdel[q] = s;
      }
    }
    __syncthreads();

    const float* b_post0 = W(B_POST0);
    mm(N, C, H, scf, C, W(W_POST0),
            [&](int r, int c, float a) {
              const float v = a + b_post0[c];
              se0[r * H + c] = v;
              if constexpr (kStream) RS.p[RS_PS0][(lb * N + r) * H + c] = v;
            });
    __syncthreads();
    for (int e = tid; e < N * H; e += nt) se0[e] = siluf_(se0[e]);
    __syncthreads();
    const float* b_post1 = W(B_POST1);
    mm(N, H, H, se0, H, W(W_POST1),
            [&](int r, int c, float a) {
              const float v = a + b_post1[c];
              she[r * H + c] = v;
              if constexpr (kStream) RS.p[RS_PS1][(lb * N + r) * H + c] = v;
            });
    __syncthreads();
    for (int e = tid; e < N * H; e += nt) she[e] = siluf_(she[e]);  // h_comb

    // node_pre = h @ w_node_h + hatt @ w_node_agg + h_comb @ w_node_comb + b
    const float* b_node0 = W(B_NODE0);
    mm(N, F, H, sh, F, W(W_NODE_H),
            [&](int r, int c, float a) { snp[r * H + c] = a + b_node0[c]; });
    __syncthreads();
    mm(N, HK, H, shatt, HK, W(W_NODE_AGG),
            [&](int r, int c, float a) { snp[r * H + c] += a; });
    __syncthreads();
    mm(N, H, H, she, H, W(W_NODE_COMB),
            [&](int r, int c, float a) { snp[r * H + c] += a; });
    __syncthreads();
    for (int e = tid; e < N * H; e += nt) {
      if constexpr (kStream) RS.p[RS_NODE_PRE][lb * N * H + e] = snp[e];
      snp[e] = siluf_(snp[e]);
    }
    __syncthreads();
    const float* b_node1 = W(B_NODE1);
    mm(N, H, F, snp, H, W(W_NODE1),
            [&](int r, int c, float a) {
              const float v = a + b_node1[c];
              suv[r * F + c] = v;
              if constexpr (kStream) RS.p[RS_UV][(lb * N + r) * F + c] = v;
            });
    __syncthreads();
    for (int e = tid; e < N * F; e += nt) sh[e] = sh[e] + siluf_(suv[e]);  // h_out
    __syncthreads();

    // velocity gate and x/v update
    const float* b_vel0 = W(B_VEL0);
    mm(N, F, H, sh, F, W(W_VEL0), [&](int r, int c, float a) {
      const float v = a + b_vel0[c];
      if constexpr (kStream) RS.p[RS_G0][(lb * N + r) * H + c] = v;
      sg0[r * H + c] = siluf_(v);
    });
    __syncthreads();
    {
      const float* wv1 = W(W_VEL1);
      for (int i = warp; i < N; i += nwarp) {
        float s = 0.f;
        for (int h = lane; h < H; h += 32) s += sg0[i * H + h] * wv1[h];
        s = warp_sum(s);
        if (lane == 0) {
          sg1[i] = s;
          if constexpr (kStream) RS.p[RS_G1][lb * N + i] = s;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < N; i += nt) {
      const float gate = 2.f * sigmoidf_(sg1[i]);
      const float dvd = dv_denom(masked, scnt[i], n_eff);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float xv = sx[k * N + i], vv = sv[k * N + i];
        const float v_new = gate * vv + sdel[k * N + i] / dvd;
        const float x_new = xv + v_new;
        sx[k * N + i] = xv + u * (x_new - xv);
        sv[k * N + i] = vv + u * (v_new - vv);
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < N * F; e += nt) h_fin[(size_t)b * N * F + e] = sh[e];
  for (int e = tid; e < 3 * N; e += nt) {
    const int k = e / N, i = e % N;
    x_fin[((size_t)k * B + b) * N + i] = sx[e];
    if constexpr (kStream) v_fin[((size_t)k * B + b) * N + i] = sv[e];
  }
}

template <bool kStream>
int launch_fwd(const sake::Dims& d, const float* h0, const float* xs, const float* v0,
               const float* upd, const float* mask, const void* const* leaf_ptrs,
               const long long* leaf_strides, float* bh, float* bx, float* bv, float* h_fin,
               float* x_fin, float* v_fin, const Resids& RS, void* stream) {
  Leaves L;
  for (int i = 0; i < kLeaves; ++i) {
    L.p[i] = static_cast<const float*>(leaf_ptrs[i]);
    L.stride[i] = leaf_strides[i];
  }
  const size_t smem = fwd_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      resid_fwd_kernel<kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  resid_fwd_kernel<kStream><<<d.B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      d, h0, xs, v0, upd, mask, L, bh, bx, bv, h_fin, x_fin, v_fin, RS);
  return (int)cudaGetLastError();
}

}  // namespace sake

extern "C" long long sake_resid_fwd_smem_bytes(int B, int N, int F, int H, int R, int K,
                                               int C, int depth) {
  sake::Dims d{B, N, F, H, R, K, C, depth};
  return sake::fwd_smem_floats(d) * (long long)sizeof(float);
}

// mask: (B, N, N) f32 or null.
extern "C" int sake_resid_fwd(const float* h0, const float* xs, const float* v0,
                              const float* upd, const float* mask,
                              const void* const* leaf_ptrs, const long long* leaf_strides,
                              float* bh, float* bx, float* bv, float* h_fin, float* x_fin,
                              float* v_fin, void* const* resid_ptrs, int B, int N, int F,
                              int H, int R, int K, int C, int depth, void* stream) {
  sake::Resids RS;
  for (int i = 0; i < sake::kResids; ++i) RS.p[i] = static_cast<float*>(resid_ptrs[i]);
  return sake::launch_fwd<true>(sake::Dims{B, N, F, H, R, K, C, depth}, h0, xs, v0, upd,
                                mask, leaf_ptrs, leaf_strides, bh, bx, bv, h_fin, x_fin,
                                v_fin, RS, stream);
}

// The forward without residuals: pool is a (3, B, N, C) scratch for one
// layer's pooled vectors.
extern "C" int sake_resid_infer(const float* h0, const float* xs, const float* v0,
                                const float* upd, const float* mask,
                                const void* const* leaf_ptrs, const long long* leaf_strides,
                                float* h_fin, float* x_fin, float* pool, int B, int N, int F,
                                int H, int R, int K, int C, int depth, void* stream) {
  sake::Resids RS{};
  const size_t plane = (size_t)B * N * C;
  RS.p[sake::RS_POOL0] = pool;
  RS.p[sake::RS_POOL1] = pool + plane;
  RS.p[sake::RS_POOL2] = pool + 2 * plane;
  return sake::launch_fwd<false>(sake::Dims{B, N, F, H, R, K, C, depth}, h0, xs, v0, upd,
                                 mask, leaf_ptrs, leaf_strides, nullptr, nullptr, nullptr,
                                 h_fin, x_fin, nullptr, RS, stream);
}

extern "C" const char* sake_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
