"""The cutoff-sparse edge kernels (#13-#15) and the sparse model on them.

Port of ``sake_tpu/kernels/sparse_ef.py``. The per-layer edge chain of the
cutoff-sparse model (rbf, CFConv filter, h_e, the semantic softmax over the
K neighbour slots with its mask renormalisation, head expansion, tanh
x-mixing, pooled planes and attended features) runs in CUDA kernels; the
node-level products, the embedding, the readout, the gathers of h and x and
the scatter of ``d_h_g`` stay torch ops, which autograd differentiates
(twice for the force loss), as the JAX package leaves them to XLA
(``:786-860``).

- :func:`edge_chain` (JAX ``_edge_chain`` ``:108-170``), :func:`edge_pullback`
  (``_edge_pullback`` ``:173-304``, with the 11 ``EDGE_LEAVES`` gradients)
  and :func:`edge_pullback2` (the VJP of chain and pullback, which the JAX
  ``_call_bwd2`` traces, ``:510-527``) are the plain versions of the
  kernels.
- :func:`sparse_fwd` (#13, ``csrc/sparse_fwd.cu``), :func:`sparse_bwd` (#14,
  input cotangents, ``csrc/sparse_bwd.cu``), :func:`sparse_bwd_grads` (#14
  with the leaf gradients: the rows instantiation of ``sparse_bwd.cu`` and
  the contraction ``csrc/sparse_contract.cu``) and :func:`sparse_bwd2` (#15,
  ``csrc/sparse_bwd2.cu`` and the contraction) take their plain versions
  only for CPU tensors; on a CUDA tensor they launch the kernels or raise.
  #13 and #14 run the x-mixing product and its transpose on the tensor cores
  (``csrc/wgmma_tf32.cuh``, 3xTF32 with chunked sums), which take ``H *
  heads = C = 256`` (the sparse tasks' widths) and raise on other widths
  and on rows with more neighbour slots than their shared memory holds (145
  there); :func:`xmix_planes` splits and packs the weight for them once per
  layer.
- :func:`sparse_kernel_model_forward` (``:725``),
  :func:`make_sparse_kernel_energy_forces` (``:863``),
  :func:`make_sparse_kernel_energy_loss` (``:905``) and
  :func:`make_sparse_kernel_force_loss` (``:953``).

The kernels run the f32 tier. ``edge_matmul_dtype`` and ``gather_dtype``
accept None or float32 (the JAX tasks' bf16 edge tier is queued in
ROADMAP); ``block_rows``, ``bn2``, ``vmem_limit``, ``interpret`` and
``edge_precision`` only shape the TPU grid or its compile and are accepted
and ignored. ``SPARSE_TRAIN_COMPILER_OPTIONS`` is a TPU compile flag and has
no counterpart.

Differentiation: a gradient that reaches the edge leaves through the
kernel op is the true one or raises. The JAX op returns zero leaf
cotangents where it skips them (``edge_bwd`` with ``param_grads=False`` and
``edge_op2_bwd``, ``:609-621``, ``:700-712``); here the op asks the autograd
engine whether the running backward pass will use the leaves' gradients and
raises if it would and the op does not compute them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from sake_tpu_torch.kernels import build
from sake_tpu_torch.kernels.functional import (
    EPSILON,
    INF,
    ModelParams,
    _silu,
    embed,
    flat_params,
    per_layer,
    readout,
)
from sake_tpu_torch.kernels.leaves import split_layer
from sake_tpu_torch.kernels.resid_ef import _check_cuda, _require_cuda, _stream
from sake_tpu_torch.kernels.tf32 import tf32_split, wgmma_planes
from sake_tpu_torch.sparse import _f32_only, _gather, _min_image

# the leaves the edge kernels read, in the JAX ``_EDGE_LEAVES`` order
EDGE_LEAVES = ("w_in_j", "w_o_j", "rbf_m", "rbf_b", "w_o_f", "w_o_r", "w_o1", "b_o1",
               "w_sem", "b_sem", "w_xmix")
# the products whose transposes the pullback reads
_TRANSPOSED = ("w_in_j", "w_o_j", "w_o_f", "w_o1", "w_sem", "w_xmix")

# Cotangent rows (E = NR * K, width) the kernels write for the leaf
# gradients, in kernel order (``EdgeRow`` in ``csrc/sparse_edge.cuh``).
EDGE_ROWS = ("d_pre", "d_e0", "q_m", "q_b", "filt", "r", "se", "d_h_e", "h_e", "d_sem",
             "he_att", "d_xm")

# Each leaf's gradient as a sum over edges of products a^T g of rows (a None:
# a row sum); "h_g" is the gathered input itself.
GRAD_TERMS = {
    "w_in_j": (("h_g", "d_pre"),), "w_o_j": (("h_g", "d_e0"),),
    "rbf_m": ((None, "q_m"),), "rbf_b": ((None, "q_b"),),
    "w_o_f": (("filt", "d_e0"),), "w_o_r": (("r", "d_e0"),),
    "w_o1": (("se", "d_h_e"),), "b_o1": ((None, "d_h_e"),),
    "w_sem": (("h_e", "d_sem"),), "b_sem": ((None, "d_sem"),),
    "w_xmix": (("he_att", "d_xm"),),
}


def _neg(x):
    """``min(x, 0)``: the celu branch's exponent, so that the branch a
    ``where`` does not take cannot overflow to inf and turn its (zero)
    derivative into NaN under autograd (the kernels branch instead)."""
    return torch.clamp(x, max=0.0)


def _dsilu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


# --------------------------------------------------------------------------
# The plain edge scope: JAX shapes, h_g (NR, K, F), a_i (NR, R), o_i (NR, H),
# d0 3 x (NR, K, 1), m (NR, K, 1), ep the 11 edge leaves (2D).
# --------------------------------------------------------------------------


def edge_chain(h_g, a_i, o_i, d0, m, ep):
    """The per-edge forward chain on ``NR`` receiver rows: the pooled
    outputs and every intermediate the pullback reads (JAX ``_edge_chain``).
    The head expansion is ``he_att[..., h*Kh + k] = h_e[..., h] *
    att2[..., k]`` (the JAX ``e_rep``/``e_tile`` products)."""
    NR, K, F = h_g.shape
    pre = h_g @ ep["w_in_j"] + a_i[:, None, :]
    oji = h_g @ ep["w_o_j"] + o_i[:, None, :]
    r = torch.sqrt(torch.relu(d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2]) + EPSILON)
    t = torch.exp(-r)
    rbf = torch.exp(-ep["rbf_b"] * (t - ep["rbf_m"]) ** 2)
    e0 = oji + (rbf * pre) @ ep["w_o_f"] + r * ep["w_o_r"][0]
    h_e = _silu(e0) @ ep["w_o1"] + ep["b_o1"]

    sem_pre = h_e @ ep["w_sem"] + ep["b_sem"]
    logits = torch.where(sem_pre > 0, sem_pre, 2.0 * (torch.exp(_neg(sem_pre) / 2.0) - 1.0))
    logits = logits - INF * (1.0 - m)
    att = torch.softmax(logits, dim=-2)
    att_s = att * m
    denom = att_s.sum(dim=-2, keepdim=True)
    dg = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    att2 = att_s / dg

    H, Kh = h_e.shape[-1], att2.shape[-1]
    he_att = (h_e[..., :, None] * att2[..., None, :]).reshape(NR, K, H * Kh)
    tanh_v = torch.tanh(he_att @ ep["w_xmix"])
    coeff = tanh_v * m
    inv_r = 1.0 / (r + 1e-5)
    u = [dk * inv_r for dk in d0]
    pooled = [(coeff * u[k]).sum(dim=-2) for k in range(3)]
    hatt = he_att.sum(dim=-2)
    return dict(pre=pre, r=r, t=t, rbf=rbf, e0=e0, h_e=h_e, sem_pre=sem_pre, att=att,
                att_s=att_s, denom=denom, dg=dg, att2=att2, he_att=he_att, tanh_v=tanh_v,
                coeff=coeff, inv_r=inv_r, u=u, pooled=pooled, hatt=hatt)


def edge_pullback(h_g, d0, m, ep, f, g_pooled, g_hatt, want_param_grads=False):
    """Pullback of :func:`edge_chain` w.r.t. ``(h_g, a_i, o_i, d0)`` from
    the cotangents of its outputs, on the intermediates ``f`` (JAX
    ``_edge_pullback``). Returns ``(d_h_g, d_a_i, d_o_i, d_d0, dW)``; ``dW``
    is None, or with ``want_param_grads`` the 11 ``EDGE_LEAVES`` gradients
    summed over all edges, the ``GRAD_TERMS`` contraction of the rows the
    kernels write (in f64: the softmax's cotangents cancel over a row), or
    with ``want_param_grads="rows"`` those rows (``EDGE_ROWS``, each ``(NR *
    K, width)``)."""
    NR, K, F = h_g.shape
    pre = f["pre"]
    H, Kh = f["h_e"].shape[-1], f["att"].shape[-1]

    d_coeff = sum(g_pooled[k][:, None, :] * f["u"][k] for k in range(3))
    d_u = [(f["coeff"] * g_pooled[k][:, None, :]).sum(dim=-1, keepdim=True) for k in range(3)]
    d_xm = d_coeff * m * (1.0 - f["tanh_v"] * f["tanh_v"])
    d_he_att = d_xm @ ep["w_xmix"].T + g_hatt[:, None, :]
    d_he4 = d_he_att.reshape(NR, K, H, Kh)
    d_h_e = (d_he4 * f["att2"][..., None, :]).sum(dim=-1)
    d_att2 = (d_he4 * f["h_e"][..., :, None]).sum(dim=-2)

    # att2 = att * m / dg, with dg = 1 where no slot is live
    live = (f["denom"] != 0.0).to(d_att2.dtype)
    d_att = (d_att2 / f["dg"]
             - live * (d_att2 * f["att_s"]).sum(dim=-2, keepdim=True) / (f["dg"] * f["dg"])) * m
    att = f["att"]
    d_logits = att * (d_att - (d_att * att).sum(dim=-2, keepdim=True))
    dcelu = torch.where(f["sem_pre"] > 0, torch.ones_like(f["sem_pre"]),
                        torch.exp(_neg(f["sem_pre"]) / 2.0))
    d_sem = d_logits * dcelu
    d_h_e = d_h_e + d_sem @ ep["w_sem"].T

    d_e0 = (d_h_e @ ep["w_o1"].T) * _dsilu(f["e0"])
    d_r = (d_e0 * ep["w_o_r"][0]).sum(dim=-1, keepdim=True)
    d_filtered = d_e0 @ ep["w_o_f"].T
    d_rbf = d_filtered * pre
    d_pre = d_filtered * f["rbf"]
    d_t = (d_rbf * f["rbf"] * (-2.0 * ep["rbf_b"] * (f["t"] - ep["rbf_m"]))).sum(
        dim=-1, keepdim=True)
    d_r = d_r + (-f["t"]) * d_t

    inv_r = f["inv_r"]
    d_d0 = [d_u[k] * inv_r for k in range(3)]
    d_ir = d_u[0] * d0[0] + d_u[1] * d0[1] + d_u[2] * d0[2]
    d_r = d_r - (inv_r * inv_r) * d_ir
    r = f["r"]
    d_s = d_r * (0.5 / r) * (r * r > EPSILON).to(r.dtype)
    d_d0 = [d_d0[k] + 2.0 * d0[k] * d_s for k in range(3)]

    d_a_i = d_pre.sum(dim=-2)
    d_o_i = d_e0.sum(dim=-2)
    d_h_g = d_pre @ ep["w_in_j"].T + d_e0 @ ep["w_o_j"].T
    if not want_param_grads:
        return d_h_g, d_a_i, d_o_i, d_d0, None

    tm = f["t"] - ep["rbf_m"]
    q = d_rbf * f["rbf"]
    rows = dict(d_pre=d_pre, d_e0=d_e0, q_m=q * (2.0 * ep["rbf_b"] * tm), q_b=q * (-(tm * tm)),
                filt=f["rbf"] * pre, r=r, se=_silu(f["e0"]), d_h_e=d_h_e, h_e=f["h_e"],
                d_sem=d_sem, he_att=f["he_att"], d_xm=d_xm)
    rows = {n: a.reshape(NR * K, -1) for n, a in rows.items()}
    if want_param_grads == "rows":
        return d_h_g, d_a_i, d_o_i, d_d0, rows
    rows["h_g"] = h_g.reshape(NR * K, F)
    return d_h_g, d_a_i, d_o_i, d_d0, contract_plain(rows, GRAD_TERMS)


def edge_pullback2(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, cg):
    """The second-order body: the VJP of ``edge_chain`` followed by
    ``edge_pullback`` (what the JAX ``_call_bwd2`` traces), by
    ``torch.func.vjp``. ``cg = (c_hg, c_ai, c_oi, c_d0 (3 x (NR, K, 1)))``
    are the cotangents of the pullback's outputs. Returns ``(e_hg, e_ai,
    e_oi, e_d0, e_gp, e_gh, dW2)``: the cotangents of the primal inputs, of
    the ``g`` streams and of the 11 edge leaves."""
    def pb(hg, ai, oi, da, db, dc, p0, p1, p2, ph, *wl):
        ep_ = dict(zip(EDGE_LEAVES, wl))
        f = edge_chain(hg, ai, oi, [da, db, dc], m, ep_)
        d_h_g, d_a_i, d_o_i, d_d0, _ = edge_pullback(hg, [da, db, dc], m, ep_, f, [p0, p1, p2], ph)
        return d_h_g, d_a_i, d_o_i, *d_d0

    prim = (h_g, a_i, o_i, *d0, *g_pooled, g_hatt, *(ep[n] for n in EDGE_LEAVES))
    _, vjp_fn = torch.func.vjp(pb, *prim)
    c_hg, c_ai, c_oi, c_d0 = cg
    cots = vjp_fn((c_hg, c_ai, c_oi, *c_d0))
    return (cots[0], cots[1], cots[2], list(cots[3:6]), list(cots[6:9]), cots[9],
            dict(zip(EDGE_LEAVES, cots[10:])))


# --------------------------------------------------------------------------
# Kernel layout: d0 (3, NR, K), m (NR, K), pooled (3, NR, C). The plain
# versions of the wrappers convert to the JAX shapes above.
# --------------------------------------------------------------------------


def _jax_shapes(d0, m):
    return [d0[k][..., None] for k in range(3)], m[..., None]


def sparse_fwd_plain(h_g, a_i, o_i, d0, m, ep):
    """Plain version of #13: ``(pooled (3, NR, C), hatt (NR, HK))``."""
    d0p, m3 = _jax_shapes(d0, m)
    f = edge_chain(h_g, a_i, o_i, d0p, m3, ep)
    return torch.stack(f["pooled"]), f["hatt"]


def sparse_bwd_plain(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, want_param_grads=False):
    """Plain version of #14: ``(d_h_g, d_a_i, d_o_i, d_d0 (3, NR, K))``, and
    with ``want_param_grads`` the leaf gradients as a fifth item."""
    d0p, m3 = _jax_shapes(d0, m)
    f = edge_chain(h_g, a_i, o_i, d0p, m3, ep)
    d_h_g, d_a_i, d_o_i, d_d0, dW = edge_pullback(h_g, d0p, m3, ep, f, list(g_pooled), g_hatt,
                                                  want_param_grads)
    out = (d_h_g, d_a_i, d_o_i, torch.cat(d_d0, dim=-1).permute(2, 0, 1))
    return (*out, dW) if want_param_grads else out


def sparse_bwd2_plain(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, c_hg, c_ai, c_oi, c_d0):
    """Plain version of #15: ``(e_hg, e_ai, e_oi, e_d0 (3, NR, K), e_gp (3,
    NR, C), e_gh, dW2)``."""
    d0p, m3 = _jax_shapes(d0, m)
    e_hg, e_ai, e_oi, e_d0, e_gp, e_gh, dW2 = edge_pullback2(
        h_g, a_i, o_i, d0p, m3, ep, list(g_pooled), g_hatt,
        (c_hg, c_ai, c_oi, [c_d0[k][..., None] for k in range(3)]))
    return (e_hg, e_ai, e_oi, torch.cat(e_d0, dim=-1).permute(2, 0, 1), torch.stack(e_gp), e_gh,
            dW2)


def edge_rows_plain(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt):
    """The cotangent rows (``EDGE_ROWS``, each ``(NR * K, width)``) that the
    rows instantiation of #14 writes; :func:`contract_plain` of them under
    ``GRAD_TERMS`` is the leaf gradient."""
    return sparse_bwd_plain(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, "rows")[4]


def aug_terms(terms: dict) -> dict:
    """The terms of a leaf gradient's tangent: each ``a^T g`` becomes
    ``a^T t_g + t_a^T g`` and each row sum of ``g`` the row sum of ``t_g``
    (tangent rows are named ``t_<row>``; ``t_h_g`` is the cotangent ``c_hg``
    of #15)."""
    out = {}
    for leaf, pairs in terms.items():
        out[leaf] = tuple(
            p for a, g in pairs
            for p in (((None, "t_" + g),) if a is None else ((a, "t_" + g), ("t_" + a, g))))
    return out


def contract_plain(rows: dict, terms: dict) -> dict:
    """``{leaf: sum over its terms of a^T g}`` over all edges (a None: the
    row sum of g), in f64 and back to f32: the plain version of the
    contraction kernel."""
    def one(a, g):
        g = rows[g].double()
        if a is None:
            return g.sum(dim=0, keepdim=True)
        return rows[a].double().T @ g
    return {leaf: sum(one(a, g) for a, g in pairs).float() for leaf, pairs in terms.items()}


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _edge_dims(h_g, a_i, o_i, ep):
    NR, K, F = h_g.shape
    R, H = a_i.shape[-1], o_i.shape[-1]
    Kh, C = ep["w_sem"].shape[-1], ep["w_xmix"].shape[-1]
    return NR, K, F, R, H, Kh, C


# the widths the tensor-core x-mixing of #13 and #14 takes (csrc/wgmma_tf32.cuh):
# H * heads = C = 256
XMIX_TC_WIDTH = 256


def xmix_planes(w_xmix) -> list:
    """The packed hi and lo TF32 planes of ``w_xmix (HK, C)`` that #13 and #14
    read on the tensor cores (:func:`~sake_tpu_torch.kernels.tf32.wgmma_planes`
    of its K-major forms): the forward's (rows of ``w_xmix^T``) and the
    pullback's (rows of ``w_xmix``)."""
    hi, lo = tf32_split(w_xmix.detach())  # once for both forms
    return [wgmma_planes(hi.T, (hi.T, lo.T)), wgmma_planes(hi, (hi, lo))]


def edge_transposes(ep) -> list:
    """The transposed products the pullbacks read (``_TRANSPOSED`` order),
    then :func:`xmix_planes` (None where the widths are not the tensor-core
    route's): made once per layer and shared by its launches."""
    w = ep["w_xmix"]
    planes = (xmix_planes(w) if tuple(w.shape) == (XMIX_TC_WIDTH, XMIX_TC_WIDTH)
              else [None, None])
    return [ep[n].detach().T.contiguous() for n in _TRANSPOSED] + planes


def _check_edge(name, h_g, a_i, o_i, d0, m, ep, wt=None, tc=True):
    """Checks shared by the edge kernels; returns ``(dims, weight pointer
    array, wt)``: the pointers of the 11 leaves, the 6 transposes and the 2
    planes of :func:`edge_transposes` (``wt``; for the forward, which reads no
    transpose, None: the planes are made here, returned so that they outlive
    the launch, and the transposes' pointers are null). ``tc``: the kernel runs
    the x-mixing on the tensor cores (#13, #14), which take only ``H * heads =
    C = XMIX_TC_WIDTH``."""
    _require_cuda(name, h_g)
    dims = _edge_dims(h_g, a_i, o_i, ep)
    NR, K, F, R, H, Kh, C = dims
    dev = h_g.device
    if ep["w_xmix"].shape[0] != H * Kh:
        raise ValueError(f"{name}: w_xmix has {ep['w_xmix'].shape[0]} rows, needs H * heads")
    if tc and not H * Kh == C == XMIX_TC_WIDTH:
        raise ValueError(f"{name}: the tensor-core x-mixing takes H * heads = C = "
                         f"{XMIX_TC_WIDTH}, not {H} * {Kh} and {C}")
    _check_cuda("h_g", h_g, (NR, K, F), dev)
    _check_cuda("a_i", a_i, (NR, R), dev)
    _check_cuda("o_i", o_i, (NR, H), dev)
    _check_cuda("d0", d0, (3, NR, K), dev)
    _check_cuda("m", m, (NR, K), dev)
    shapes = dict(w_in_j=(F, R), w_o_j=(F, H), rbf_m=(1, R), rbf_b=(1, R), w_o_f=(R, H),
                  w_o_r=(1, H), w_o1=(H, H), b_o1=(1, H), w_sem=(H, Kh), b_sem=(1, Kh),
                  w_xmix=(H * Kh, C))
    for n in EDGE_LEAVES:
        _check_cuda(n, ep[n], shapes[n], dev)
    if wt is None:
        wt = [None] * len(_TRANSPOSED) + (xmix_planes(ep["w_xmix"]) if tc else [None, None])
    else:
        for n, a in zip(_TRANSPOSED, wt):
            _check_cuda(n + "^T", a, shapes[n][::-1], dev)
    if tc:
        HK = H * Kh
        for n, a, shape in (("forward", wt[-2], (HK // 8, 2, C // 8, 2, 8, 4)),
                            ("pullback", wt[-1], (C // 8, 2, HK // 8, 2, 8, 4))):
            _check_cuda(f"the {n} x-mixing planes", a, shape, dev)
            if a.data_ptr() % 16:  # the ring's bulk copies need 16-byte addresses
                raise ValueError(f"{name}: the {n} x-mixing planes must start 16-byte aligned")
    ptrs = [ep[n].data_ptr() for n in EDGE_LEAVES] + [
        None if a is None else a.data_ptr() for a in wt]
    return dims, (ctypes.c_void_p * len(ptrs))(*ptrs), wt


def _check_slots(name, dims, entry):
    """The tensor-core route holds a row's edge values in shared memory: raise,
    naming the largest, where a row has more neighbour slots than it takes at
    these widths (``entry``: the source's ``..._max_slots``)."""
    NR, K, F, R, H, Kh, C = dims
    most = entry(F, R, H, Kh, C)
    if K > most:
        raise ValueError(f"{name}: the tensor-core route takes at most {most} neighbour slots "
                         f"a row at F={F}, R={R}, H={H}, heads={Kh}, C={C}, not {K}")


def _row_widths(dims):
    NR, K, F, R, H, Kh, C = dims
    return dict(d_pre=R, d_e0=H, q_m=R, q_b=R, filt=R, r=1, se=H, d_h_e=H, h_e=H, d_sem=Kh,
                he_att=H * Kh, d_xm=C)


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _outs_like_inputs(h_g, a_i, o_i, d0):
    return torch.empty_like(h_g), torch.empty_like(a_i), torch.empty_like(o_i), torch.empty_like(d0)


def sparse_fwd(h_g, a_i, o_i, d0, m, ep, wt=None):
    """#13: the edge chain on ``NR`` receiver rows. ``h_g (NR, K, F)``,
    ``a_i (NR, R)``, ``o_i (NR, H)`` (biases folded in), ``d0 (3, NR, K)``,
    ``m (NR, K)``, ``ep`` the 11 edge leaves. Returns ``(pooled (3, NR, C),
    hatt (NR, HK))``. ``wt``: the layer's :func:`edge_transposes` (the kernel
    reads their x-mixing planes), made here when None. CPU tensors take the
    plain version."""
    if h_g.device.type == "cpu":
        return sparse_fwd_plain(h_g, a_i, o_i, d0, m, ep)
    out = _launch_fwd(h_g, a_i, o_i, d0, m, ep, wt)
    sparse_fwd.launches += 1
    return out


def _launch_fwd(h_g, a_i, o_i, d0, m, ep, wt=None):
    dims, w, wt = _check_edge("sparse_fwd", h_g, a_i, o_i, d0, m, ep, wt)
    NR, K, F, R, H, Kh, C = dims
    pooled = torch.empty(3, NR, C, device=h_g.device)
    hatt = torch.empty(NR, H * Kh, device=h_g.device)
    lib = build.load()
    _check_slots("sparse_fwd", dims, lib.sake_sparse_fwd_max_slots)
    err = lib.sake_sparse_fwd(h_g.data_ptr(), a_i.data_ptr(), o_i.data_ptr(), d0.data_ptr(),
                              m.data_ptr(), w, pooled.data_ptr(), hatt.data_ptr(),
                              *dims, _stream(h_g.device))
    build.check(lib, err, "sparse_fwd")
    return pooled, hatt


sparse_fwd.launches = 0


def _check_g(dims, g_pooled, g_hatt, dev):
    NR, K, F, R, H, Kh, C = dims
    _check_cuda("g_pooled", g_pooled, (3, NR, C), dev)
    _check_cuda("g_hatt", g_hatt, (NR, H * Kh), dev)


def sparse_bwd(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, wt=None):
    """#14, input cotangents: from the cotangents ``g_pooled (3, NR, C)``
    and ``g_hatt (NR, HK)`` of #13's outputs, ``(d_h_g, d_a_i, d_o_i, d_d0
    (3, NR, K))``. Recomputes the chain. ``wt``: the layer's
    :func:`edge_transposes`, made here when None. CPU tensors take the plain
    version."""
    if h_g.device.type == "cpu":
        return sparse_bwd_plain(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt)
    out = _launch_bwd(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, wt)
    sparse_bwd.launches += 1
    return out


def _launch_bwd(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, wt=None):
    wt = edge_transposes(ep) if wt is None else wt
    dims, w, wt = _check_edge("sparse_bwd", h_g, a_i, o_i, d0, m, ep, wt)
    _check_g(dims, g_pooled, g_hatt, h_g.device)
    outs = _outs_like_inputs(h_g, a_i, o_i, d0)
    lib = build.load()
    _check_slots("sparse_bwd", dims, lib.sake_sparse_bwd_max_slots)
    err = lib.sake_sparse_bwd(h_g.data_ptr(), a_i.data_ptr(), o_i.data_ptr(), d0.data_ptr(),
                              m.data_ptr(), w, g_pooled.data_ptr(), g_hatt.data_ptr(),
                              *(t.data_ptr() for t in outs), *dims,
                              _stream(h_g.device))
    build.check(lib, err, "sparse_bwd")
    return outs


sparse_bwd.launches = 0

_CONTRACT_EDGES = 1024  # edges per chunk of the contraction's first pass


def _contract(lib, rows: dict, terms: dict, shapes: dict, E: int, dev):
    """Launch the contraction of ``rows`` under ``terms``; ``{leaf: (r, c)}``."""
    leaves = list(terms)
    a_t, g_t, na, ng, leaf_of = [], [], [], [], []
    for li, leaf in enumerate(leaves):
        for a, g in terms[leaf]:
            a_t.append(None if a is None else rows[a])
            g_t.append(rows[g])
            na.append(1 if a is None else rows[a].shape[-1])
            ng.append(rows[g].shape[-1])
            leaf_of.append(li)
    sizes = [shapes[leaf][0] * shapes[leaf][1] for leaf in leaves]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    n_chunks = max(1, min(64, -(-E // _CONTRACT_EDGES)))
    partial = torch.empty(n_chunks, sum(a * g for a, g in zip(na, ng)), device=dev,
                          dtype=torch.float64)
    leaf_off = torch.tensor(offs, device=dev, dtype=torch.int64)
    out = torch.empty(offs[-1], device=dev)
    I = ctypes.c_int
    n = len(g_t)
    err = lib.sake_sparse_contract(
        n, (ctypes.c_void_p * n)(*[None if t is None else t.data_ptr() for t in a_t]),
        (I * n)(*na), _ptrs(g_t), (I * n)(*ng), (I * n)(*leaf_of), E, n_chunks,
        partial.data_ptr(), leaf_off.data_ptr(), len(leaves), out.data_ptr(), _stream(dev))
    build.check(lib, err, "sparse_contract")
    return {leaf: a.view(*shapes[leaf]) for leaf, a in zip(leaves, out.split(sizes))}


def sparse_bwd_grads(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, wt=None):
    """#14 with the leaf gradients (training): :func:`sparse_bwd`'s outputs
    and ``{leaf: gradient}`` for the 11 ``EDGE_LEAVES``, summed over all
    edges. On the card the rows instantiation of the pullback writes the
    ``EDGE_ROWS`` and the contraction kernel sums them in a fixed order
    (f64). CPU tensors take the plain version."""
    if h_g.device.type == "cpu":
        return sparse_bwd_plain(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, True)
    out = _launch_bwd_grads(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, wt)
    sparse_bwd_grads.launches += 1
    return out


def _launch_bwd_grads(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, wt=None):
    wt = edge_transposes(ep) if wt is None else wt
    dims, w, wt = _check_edge("sparse_bwd_grads", h_g, a_i, o_i, d0, m, ep, wt)
    _check_g(dims, g_pooled, g_hatt, h_g.device)
    NR, K = dims[:2]
    dev = h_g.device
    outs = _outs_like_inputs(h_g, a_i, o_i, d0)
    rows = {n: torch.empty(NR * K, wd, device=dev) for n, wd in _row_widths(dims).items()}
    lib = build.load()
    _check_slots("sparse_bwd_grads", dims, lib.sake_sparse_bwd_max_slots)
    err = lib.sake_sparse_bwd_rows(h_g.data_ptr(), a_i.data_ptr(), o_i.data_ptr(),
                                   d0.data_ptr(), m.data_ptr(), w, g_pooled.data_ptr(),
                                   g_hatt.data_ptr(), *(t.data_ptr() for t in outs),
                                   _ptrs([rows[n] for n in EDGE_ROWS]), *dims,
                                   _stream(dev))
    build.check(lib, err, "sparse_bwd_rows")
    rows["h_g"] = h_g.reshape(NR * K, -1)
    dW = _contract(lib, rows, GRAD_TERMS, {n: tuple(ep[n].shape) for n in EDGE_LEAVES},
                   NR * K, dev)
    return (*outs, dW)


sparse_bwd_grads.launches = 0


def sparse_bwd2(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, c_hg, c_ai, c_oi, c_d0,
                wt=None):
    """#15: the VJP of the chain and its pullback. From the cotangents
    ``(c_hg, c_ai, c_oi, c_d0)`` of #14's outputs: ``(e_hg, e_ai, e_oi, e_d0
    (3, NR, K), e_gp (3, NR, C), e_gh (NR, HK), {leaf: cotangent})``. On the
    card the pullback runs forward-over-reverse on dual numbers (tangent
    c) and the contraction kernel sums the augmented rows
    (:func:`aug_terms`). CPU tensors take the plain version."""
    if h_g.device.type == "cpu":
        return sparse_bwd2_plain(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, c_hg, c_ai, c_oi,
                                 c_d0)
    out = _launch_bwd2(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, c_hg, c_ai, c_oi, c_d0,
                       wt)
    sparse_bwd2.launches += 1
    return out


def _launch_bwd2(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, c_hg, c_ai, c_oi, c_d0,
                 wt=None):
    wt = edge_transposes(ep) if wt is None else wt
    dims, w, wt = _check_edge("sparse_bwd2", h_g, a_i, o_i, d0, m, ep, wt, tc=False)
    _check_g(dims, g_pooled, g_hatt, h_g.device)
    NR, K, F, R, H, Kh, C = dims
    dev = h_g.device
    _check_cuda("c_hg", c_hg, (NR, K, F), dev)
    _check_cuda("c_ai", c_ai, (NR, R), dev)
    _check_cuda("c_oi", c_oi, (NR, H), dev)
    _check_cuda("c_d0", c_d0, (3, NR, K), dev)
    outs = _outs_like_inputs(h_g, a_i, o_i, d0)
    e_gp = torch.empty(3, NR, C, device=dev)
    e_gh = torch.empty(NR, H * Kh, device=dev)
    widths = _row_widths(dims)
    rows = {n: torch.empty(NR * K, wd, device=dev) for n, wd in widths.items()}
    t_rows = {n: torch.empty(NR * K, wd, device=dev) for n, wd in widths.items()}
    lib = build.load()
    err = lib.sake_sparse_bwd2(
        h_g.data_ptr(), a_i.data_ptr(), o_i.data_ptr(), d0.data_ptr(), m.data_ptr(), w,
        g_pooled.data_ptr(), g_hatt.data_ptr(), c_hg.data_ptr(), c_ai.data_ptr(),
        c_oi.data_ptr(), c_d0.data_ptr(), *(t.data_ptr() for t in outs), e_gp.data_ptr(),
        e_gh.data_ptr(), _ptrs([rows[n] for n in EDGE_ROWS]),
        _ptrs([t_rows[n] for n in EDGE_ROWS]), *dims, _stream(dev))
    build.check(lib, err, "sparse_bwd2")
    allrows = {**rows, **{"t_" + n: a for n, a in t_rows.items()},
               "h_g": h_g.reshape(NR * K, F), "t_h_g": c_hg.reshape(NR * K, F)}
    dW2 = _contract(lib, allrows, aug_terms(GRAD_TERMS),
                    {n: tuple(ep[n].shape) for n in EDGE_LEAVES}, NR * K, dev)
    return (*outs, e_gp, e_gh, dW2)


sparse_bwd2.launches = 0


# --------------------------------------------------------------------------
# The autograd wiring (JAX ``_make_edge_op``, ``:597-715``)
# --------------------------------------------------------------------------


def _engine_will_use(nodes) -> bool:
    """Whether the running backward pass will execute any of the autograd
    ``nodes`` (the grad_fns of the edge leaves), i.e. use a gradient the
    edge op returns for them. ``_will_engine_execute_node`` is a private
    torch API; ``test_edge_leaf_gradient_is_true_or_raises`` fails loudly
    if a torch upgrade removes or changes it."""
    will = torch._C._will_engine_execute_node
    return any(n is not None and will(n) for n in nodes)


def _leaves_in(lp_leaves: dict):
    """The edge leaves as the op takes them: a tensor that requires grad
    but has no grad_fn (a parameter itself) goes in as a view, so that the
    op can ask whether the backward pass will use its gradient."""
    out = []
    for n in EDGE_LEAVES:
        t = lp_leaves[n]
        if t.requires_grad and t.grad_fn is None:
            t = t.view_as(t)
        out.append(t.contiguous())
    return out


class _EdgeOp(torch.autograd.Function):
    """The edge op: ``(h_g, a_i, o_i, d0, m, *leaves) -> (pooled, hatt)`` by
    #13. ``mode`` picks the backward:

    - "forces" (evaluation, MD): input cotangents by #14; the leaves'
      gradient raises if the pass would use it;
    - "grads" (first-order training): #14 with the leaf gradients;
    - "order2" (force-loss training): in the force pass (create_graph, so
      grad mode on) the input cotangents come from :class:`_EdgeBwd`, whose
      backward is #15; in the outer pass (grad mode off) #14 with the leaf
      gradients, the JAX ``fwd_l2`` rule.

    On the card the layer's :func:`edge_transposes` are made in the forward
    and kept on ``ctx`` for the pullbacks (#14 in both passes, #15).
    """

    @staticmethod
    def forward(ctx, mode, h_g, a_i, o_i, d0, m, *leaves):
        ctx.mode = mode
        ctx.leaf_nodes = [t.grad_fn for t in leaves]
        ep = dict(zip(EDGE_LEAVES, leaves))
        ctx.wt = edge_transposes(ep) if h_g.is_cuda else None
        ctx.save_for_backward(h_g, a_i, o_i, d0, m, *leaves)
        return sparse_fwd(h_g, a_i, o_i, d0, m, ep, ctx.wt)

    @staticmethod
    def backward(ctx, g_pooled, g_hatt):
        h_g, a_i, o_i, d0, m, *leaves = ctx.saved_tensors
        ep = dict(zip(EDGE_LEAVES, leaves))
        g_pooled, g_hatt = g_pooled.contiguous(), g_hatt.contiguous()
        want_leaves = _engine_will_use(ctx.leaf_nodes)
        none_leaves = (None,) * len(EDGE_LEAVES)
        if torch.is_grad_enabled():  # a create_graph pass: the force pass of a force loss
            if ctx.mode != "order2":
                raise RuntimeError(
                    "sparse edge op: a create_graph backward needs the op built with "
                    "order2=True (make_sparse_kernel_force_loss)")
            if want_leaves:
                raise RuntimeError(
                    "sparse edge op: the create_graph (force) pass does not compute the edge "
                    "leaves' gradient; take parameter gradients in the outer pass")
            outs = _EdgeBwd.apply(ctx.wt, h_g, a_i, o_i, d0, m, g_pooled, g_hatt, *leaves)
            return (None, *outs, None, *none_leaves)
        if want_leaves:
            if ctx.mode == "forces":
                raise RuntimeError(
                    "sparse edge op built without parameter gradients (param_grads=False): "
                    "pass param_grads=True to differentiate the edge leaves")
            d_h_g, d_a_i, d_o_i, d_d0, dW = sparse_bwd_grads(h_g, a_i, o_i, d0, m, ep,
                                                             g_pooled, g_hatt, ctx.wt)
            return (None, d_h_g, d_a_i, d_o_i, d_d0, None, *(dW[n] for n in EDGE_LEAVES))
        outs = sparse_bwd(h_g, a_i, o_i, d0, m, ep, g_pooled, g_hatt, ctx.wt)
        return (None, *outs, None, *none_leaves)


class _EdgeBwd(torch.autograd.Function):
    """#14 without the leaf gradients as a differentiable function (the JAX
    ``bwd_l2``): its backward is #15, the VJP of the chain and its
    pullback, with the leaves' second-order (dE/dp dx) terms. ``wt``: the
    layer's :func:`edge_transposes` (None on the CPU)."""

    @staticmethod
    def forward(ctx, wt, h_g, a_i, o_i, d0, m, g_pooled, g_hatt, *leaves):
        ctx.wt = wt
        ctx.save_for_backward(h_g, a_i, o_i, d0, m, g_pooled, g_hatt, *leaves)
        return sparse_bwd(h_g, a_i, o_i, d0, m, dict(zip(EDGE_LEAVES, leaves)), g_pooled,
                          g_hatt, wt)

    @staticmethod
    def backward(ctx, c_hg, c_ai, c_oi, c_d0):
        if torch.is_grad_enabled():
            raise RuntimeError("sparse edge op: third-order gradients are not supported")
        h_g, a_i, o_i, d0, m, g_pooled, g_hatt, *leaves = ctx.saved_tensors
        e_hg, e_ai, e_oi, e_d0, e_gp, e_gh, dW2 = sparse_bwd2(
            h_g, a_i, o_i, d0, m, dict(zip(EDGE_LEAVES, leaves)), g_pooled, g_hatt,
            c_hg.contiguous(), c_ai.contiguous(), c_oi.contiguous(), c_d0.contiguous(), ctx.wt)
        return (None, e_hg, e_ai, e_oi, e_d0, None, e_gp, e_gh,
                *(dW2[n] for n in EDGE_LEAVES))


def edge_inputs(L: dict, hc, xc, idx, box=None):
    """One layer's edge-op inputs in the kernel layout: ``h_g (NR, K, F)``
    the gathered senders' features, ``a_i (NR, R)`` and ``o_i (NR, H)`` the
    receivers' projections with ``b_in`` and ``b_o0`` folded in, and ``d0
    (3, NR, K)`` the displacement planes (minimum image with ``box``). ``L``
    is the layer's ``split_layer`` dict, ``hc (B, N, F)``, ``xc (B, N, 3)``.
    Torch ops, as the JAX package leaves them to XLA (``:803-813``)."""
    B, N, F = hc.shape
    K = idx.shape[-1]
    NR = B * N
    h2d = hc.reshape(NR, F)
    a_i = (h2d @ L["w_in_i"] + L["b_in"]).contiguous()
    o_i = (h2d @ L["w_o_i"] + L["b_o0"]).contiguous()
    h_g = _gather(hc, idx).reshape(NR, K, F).contiguous()
    d0 = _gather(xc, idx) - xc[:, :, None, :]
    if box is not None:
        d0 = _min_image(d0, box)
    return h_g, a_i, o_i, d0.permute(3, 0, 1, 2).reshape(3, NR, K).contiguous()


def sparse_kernel_model_forward(
    params: ModelParams,
    h: torch.Tensor,  # (B, N, F_in)
    x: torch.Tensor,  # (B, N, 3)
    idx: torch.Tensor,  # (B, N, K)
    nbr_mask: torch.Tensor,  # (B, N, K)
    v: Optional[torch.Tensor] = None,
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    block_rows: int = 32,
    edge_matmul_dtype=None,
    edge_precision=None,
    matmul_dtype=None,
    gather_dtype=None,
    box=None,
    interpret: bool = False,
    vmem_limit: Optional[int] = None,
    param_grads: bool = False,
    order2: bool = False,
    bn2: Optional[int] = None,
):
    """The sparse model with each layer's edge chain on the kernels; the
    contract of ``sparse.sparse_model_forward``: ``(out (B, N, F_out), x_out,
    v_out)``.

    ``param_grads=False`` (evaluation, MD): gradients reach ``x`` and ``h``;
    a backward pass that would use an edge leaf's gradient raises.
    ``param_grads=True`` (training): the backward also returns the edge
    leaves' gradients (#14 with the contraction). ``order2=True`` (force
    loss): also differentiable twice, through #15. ``block_rows``, ``bn2``,
    ``edge_precision``, ``interpret`` and ``vmem_limit`` only shape the
    TPU's grid or compile and are ignored."""
    _f32_only(edge_matmul_dtype=edge_matmul_dtype, matmul_dtype=matmul_dtype,
              gather_dtype=gather_dtype)
    mode = "order2" if order2 else ("grads" if param_grads else "forces")
    B, N, _ = h.shape
    K = idx.shape[-1]
    NR = B * N
    updates = per_layer(update, len(params.layers))
    hc = embed(params, h)
    F = hc.shape[-1]
    m3 = nbr_mask[..., None].float()
    m_flat = nbr_mask.reshape(NR, K).float().contiguous()
    count = m3.sum(dim=-2)  # (B, N, 1)
    xc = x
    vc = v if v is not None else torch.zeros_like(x)
    for lp, upd in zip(params.layers, updates):
        L = split_layer(lp, F, n_heads)
        h2d = hc.reshape(NR, F)
        h_g, a_i, o_i, d0 = edge_inputs(L, hc, xc, idx, box)
        pooled, hatt = _EdgeOp.apply(mode, h_g, a_i, o_i, d0, m_flat, *_leaves_in(L))
        pooled = pooled.reshape(3, B, N, -1)
        C = pooled.shape[-1]

        norm = [pooled[k] / (count + 1e-8) for k in range(3)]
        pool_sq = (norm[0] ** 2 + norm[1] ** 2 + norm[2] ** 2).reshape(NR, C)
        h_comb = _silu(_silu(pool_sq @ L["w_post0"] + L["b_post0"]) @ L["w_post1"]
                       + L["b_post1"])
        node_pre = (h2d @ L["w_node_h"] + hatt @ L["w_node_agg"] + h_comb @ L["w_node_comb"]
                    + L["b_node0"])
        uv = _silu(node_pre) @ L["w_node1"] + L["b_node1"]
        h_out = hc + _silu(uv).reshape(B, N, F)
        if upd:
            delta = torch.cat([(pooled[k].reshape(NR, C) @ L["w_vmix"]).reshape(B, N, 1)
                               for k in range(3)], dim=-1) / (count + 1e-10)
            g0 = h_out.reshape(NR, F) @ L["w_vel0"] + L["b_vel0"]
            gate = 2.0 * torch.sigmoid(_silu(g0) @ L["w_vel1"]).reshape(B, N, 1)
            vc = gate * vc + delta
            xc = xc + vc
        hc = h_out
    out = readout(params, hc)
    return out, xc, (vc if (v is not None or any(updates)) else None)


def _kw(n_heads, update, matmul_dtype, gather_dtype, edge_matmul_dtype, box):
    return dict(n_heads=n_heads, update=update, matmul_dtype=matmul_dtype,
                gather_dtype=gather_dtype, edge_matmul_dtype=edge_matmul_dtype, box=box)


def make_sparse_kernel_energy_forces(
    h: torch.Tensor,  # (B, N, F_in)
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    block_rows: int = 32,
    edge_matmul_dtype=None,
    matmul_dtype=None,
    gather_dtype=None,
    node_mask: Optional[torch.Tensor] = None,  # (B, N)
    box=None,
    interpret: bool = False,
    vmem_limit: Optional[int] = None,
):
    """``(params, x, idx, nbr_mask) -> (e (B,), f (B, N, 3))`` on the kernel
    model: the drop-in for ``sparse.make_sparse_energy_forces`` in
    ``md.neighborlist_verlet_rollout``. Both come back detached; the JAX
    default ``edge_matmul_dtype=bfloat16`` is the bf16 tier, not ported, so
    the default here is the f32 tier (None)."""
    nm = None if node_mask is None else node_mask[..., None]
    kw = _kw(n_heads, update, matmul_dtype, gather_dtype, edge_matmul_dtype, box)

    def energy_forces(p: ModelParams, x, idx, nbr_mask):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            out, _, _ = sparse_kernel_model_forward(p, h, xg, idx, nbr_mask, **kw)
            if nm is not None:
                out = out * nm
            e_b = out.sum(dim=(-2, -1))
            (g,) = torch.autograd.grad(e_b.sum(), xg)
        return e_b.detach(), -g

    return energy_forces


def make_sparse_kernel_energy_loss(
    h: torch.Tensor,
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = False,
    block_rows: int = 32,
    edge_matmul_dtype=None,
    matmul_dtype=None,
    gather_dtype=None,
    node_mask: Optional[torch.Tensor] = None,
    box=None,
    interpret: bool = False,
    vmem_limit: Optional[int] = None,
):
    """``(params, x, idx, nbr_mask, e_target (B,)) -> scalar`` energy-MAE
    loss on the kernel model, differentiable w.r.t. ``params`` (the edge
    leaves through #14 with the contraction, the rest by torch autograd)."""
    nm = None if node_mask is None else node_mask[..., None]
    kw = _kw(n_heads, update, matmul_dtype, gather_dtype, edge_matmul_dtype, box)

    def loss(p: ModelParams, x, idx, nbr_mask, e_target):
        out, _, _ = sparse_kernel_model_forward(p, h, x, idx, nbr_mask, param_grads=True, **kw)
        if nm is not None:
            out = out * nm
        return (out.sum(dim=(-2, -1)) - e_target).abs().mean()

    return loss


def make_sparse_kernel_force_loss(
    h: torch.Tensor,
    *,
    energy_coef: float = 1e-3,
    n_heads: int = 4,
    update: Sequence[bool] | bool = False,
    block_rows: int = 32,
    bn2: Optional[int] = None,
    edge_matmul_dtype=None,
    matmul_dtype=None,
    gather_dtype=None,
    node_mask: Optional[torch.Tensor] = None,
    box=None,
    interpret: bool = False,
    vmem_limit: Optional[int] = None,
):
    """``(params, x, idx, nbr_mask, f_target (B, N, 3), e_target (B,)) ->
    scalar``: F-MAE + ``energy_coef`` * E-MAE with ``F = -dE/dx``, second
    order in ``params``. The force pass runs #13 and #14 (as
    :class:`_EdgeBwd`); the parameter gradient adds #14 with the
    contraction (the dE/dp term) and #15 (the dE/dp dx term)."""
    nm = None if node_mask is None else node_mask[..., None]
    kw = _kw(n_heads, update, matmul_dtype, gather_dtype, edge_matmul_dtype, box)

    def loss(p: ModelParams, x, idx, nbr_mask, f_target, e_target):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            out, _, _ = sparse_kernel_model_forward(p, h, xg, idx, nbr_mask, order2=True, **kw)
            if nm is not None:
                out = out * nm
            e_b = out.sum(dim=(-2, -1))
            record = any(t.requires_grad for t in flat_params(p))
            (g,) = torch.autograd.grad(e_b.sum(), xg, create_graph=record)
        forces = -g
        if nm is not None:
            forces = forces * nm
        return ((forces - f_target).abs().mean()
                + energy_coef * (e_b - e_target).abs().mean())

    return loss
