"""Residual-saving layer stack: the layer forward that saves residuals,
its hand-derived pullback with parameter gradients, and the CUDA kernels
that run them.

Port of ``sake_tpu/kernels/resid_ef.py``:

- :func:`layer_fwd_resid` (JAX ``:147-320``) and :func:`layer_bwd_resid`
  (JAX ``:387-773``, with ``want_param_grads``) are the plain PyTorch
  versions of one layer; :func:`layer_param_grads` is the row-contraction
  half of its parameter gradients. The CUDA kernels compute the same
  functions.
- :func:`resid_fwd` (K1, ``csrc/resid_fwd.cu``; JAX ``fwd_kernel``
  ``:1099`` and, with an edge mask, ``make_hidden_fn``'s ``fwd_kernel``
  ``:1484``) runs ``layer_fwd_resid`` over depth; :func:`resid_infer`
  (the same source without residual streams; JAX ``infer_kernel``
  ``:1732``) keeps only the final state; :func:`resid_bwd` (K2,
  ``csrc/resid_bwd.cu``; JAX ``bwd_kernel`` ``:1211``) runs the input
  pullback in reverse; :func:`resid_bwd_rows` (the same source) also
  writes the cotangent rows the parameter gradients contract, and
  :func:`param_grads` (``csrc/param_grads.cu``) contracts them; together
  they replace ``make_hidden_fn``'s ``bwd_kernel`` ``:1598``. Each takes
  its plain version only for CPU tensors; on a CUDA tensor it launches
  the kernel or raises. With ``cluster=True`` (``make_hidden_fn``'s calls),
  :func:`resid_fwd` and :func:`resid_bwd_rows` launch their cluster kernels
  (one molecule per cluster of two CTAs, its receiver rows split between
  them); each route counts its own launches. :func:`resid_infer` (the
  evaluation forward of ``make_hidden_fn``) always takes its cluster kernel.
  Otherwise :func:`resid_fwd` and :func:`resid_bwd` (MD17 serving's K1 and K2)
  take their tensor-core kernels where the shape allows
  (:func:`fwd_tensor_core_route`, :func:`bwd_tensor_core_route`: aspirin's
  widths, K1 up to 21 atoms so that two blocks fit an SM), the CUDA-core
  kernels elsewhere, and count each launch under its route in ``.routes``.
- :func:`resid_energy_forces` (JAX ``:978-1330``) orchestrates embed, K1,
  the readout and its seed (plain torch, as the JAX package ran them
  outside Pallas), K2 and ``F = -dx``, per batch chunk so residual memory
  stays bounded. :func:`make_hidden_fn` (JAX ``:1376-1915``) is the
  first-order training entry: ``hidden(params, h, x, mask) -> h_fin`` as a
  ``torch.autograd.Function``.

The JAX package's TPU-only probes (``SAKE_ABLATE``/``geomfold``, the MXU
pooling ``spat``/``mm_pool``, ``pool_dtype``) have no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from sake_tpu_torch.kernels import build
from sake_tpu_torch.kernels.functional import (
    EPSILON,
    INF,
    CFConvParams,
    LayerParams,
    ModelParams,
    _bf16_edge_tier,
    _silu,
    bf16_round,
    embed,
    flat_params,
    per_layer,
    readout,
)
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, layer_leaves, transposed, wide_stack
from sake_tpu_torch.kernels.tf32 import mm_tf32x3_chunked_plain, mm_tf32x3_plain

# Residuals in kernel-boundary order. Edge residuals are (depth, B, N*N, ch),
# node residuals (depth, B, N, ch).
EDGE_RESIDS = ("r", "t", "rbf", "e0", "h_e", "sem_pre", "att", "coeff")
NODE_RESIDS = ("pool0", "pool1", "pool2", "ps0", "ps1", "node_pre", "uv",
               "g0", "g1")
RESIDS = EDGE_RESIDS + NODE_RESIDS

# The bf16 tier (JAX ``edge_matmul_dtype`` and ``resid_dtype`` bf16, the
# production setting of every JAX task that runs these kernels): the residual
# streams stored in bf16, every one but the geometry planes r and t (JAX
# ``_RESID_LOWP``, ``resid_ef.py:130``), and the leaves whose products (and
# weight-gradient contractions) round both operands to bf16 (JAX
# ``_EDGE_MM_LEAVES``, ``:760``).
RESID_LOWP = frozenset(RESIDS) - {"r", "t"}
EDGE_MM_LEAVES = ("w_o_f", "w_o1", "w_sem", "w_xmix")


def stream_dtype(name: str, bf16: bool):
    """The dtype of residual stream ``name`` in the f32 tier or the bf16 one."""
    return torch.bfloat16 if bf16 and name in RESID_LOWP else torch.float32


def edge_bf16_leaves(leaves: dict) -> dict:
    """``leaves`` (or their transposes) with the four edge weights rounded to
    bf16, as the bf16 tier's kernels read them."""
    return {n: bf16_round(a).contiguous() if n in EDGE_MM_LEAVES else a
            for n, a in leaves.items()}


def _edge_mm(bf16: bool):
    """The edge products ``a @ w``: f32, or the bf16 tier's (both operands
    rounded to bf16, f32 sums; JAX ``_make_mm_prec(bfloat16, None)``)."""
    return (lambda a, w: bf16_round(a) @ bf16_round(w)) if bf16 else torch.matmul

# Cotangent rows of the pullback that the parameter gradients contract (the
# operands of the JAX ``mm_pairs`` that are not residuals), in kernel order.
# Edge rows are (depth, B, N*N, ch), node rows (depth, B, N, ch).
EDGE_ROWS = ("de0", "dhe", "dsem", "dxm", "att2", "filt", "drbf")
NODE_ROWS = ("daj", "dai", "doj", "doi", "dps0", "dps1", "dnp", "duv", "dg0",
             "dg1", "ddel", "hatt", "psq")
ROWS = EDGE_ROWS + NODE_ROWS


def edge_channels(R, H, K, C):
    return dict(r=1, t=1, rbf=R, e0=H, h_e=H, sem_pre=K, att=K, coeff=C)


def node_channels(p: dict, C: int):
    """Node residual widths, read off one layer's (or the stacked) leaves."""
    w = lambda name: p[name].shape[-1]
    return dict(pool0=C, pool1=C, pool2=C, ps0=w("w_post0"), ps1=w("w_post1"),
                node_pre=w("w_node_h"), uv=w("w_node1"), g0=w("w_vel0"), g1=1)


def row_channels(p: dict, C: int):
    """Widths of the cotangent rows, read off one layer's (or the stacked)
    leaves."""
    w = lambda name: p[name].shape[-1]
    H, K, R = w("w_o_j"), w("w_sem"), w("w_in_j")
    return dict(de0=H, dhe=H, dsem=K, dxm=C, att2=K, filt=R, drbf=R,
                daj=R, dai=R, doj=H, doi=H, dps0=w("w_post0"), dps1=w("w_post1"),
                dnp=w("w_node_h"), duv=w("w_node1"), dg0=w("w_vel0"), dg1=1, ddel=3,
                hatt=H * K, psq=C)


def _dsilu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def raw_attention(sem_pre, *, mask=None, n_real=None):
    """The raw softmax over senders that :func:`layer_fwd_resid` saves as its
    ``att`` residual, from the semantic logits ``sem_pre (B, N, N, K)``
    (receiver, sender, head): celu2, the self pair and masked or padded senders
    pushed down by ``INF``. In a receiver row with no live sender every logit
    carries the ``-INF`` offset, whose f32 spacing (2^-7) rounds away the low
    bits of the logits, so that row's softmax moves by up to about 1e-3 when its
    logits move by 1e-7; no output reads it (the products see the renormalized
    attention, zero there)."""
    N = sem_pre.shape[1]
    logits = torch.where(sem_pre > 0, sem_pre, 2.0 * (torch.exp(sem_pre / 2.0) - 1.0))
    eye = torch.eye(N, dtype=sem_pre.dtype, device=sem_pre.device)
    logits = logits - INF * eye[None, :, :, None]
    if mask is not None:
        logits = logits - INF * (1.0 - mask)
    elif n_real is not None and n_real < N:
        pad = (torch.arange(N, device=sem_pre.device) >= n_real).to(sem_pre.dtype)
        logits = logits - INF * pad[None, None, :, None]
    return torch.softmax(logits, dim=-2)


def layer_fwd_resid(p: dict, h, xp, vp, upd, *, n_real=None, mask=None, bf16=False):
    """One layer's forward and the residuals the backward reads.

    ``p``: one layer's leaves (``leaves.split_layer``); ``h (B, N, F)``;
    ``xp``/``vp``: 3 planes ``(B, N, 1)``; ``upd`` in [0, 1] gates the x/v
    update; ``mask``: ``(B, N, N, 1)`` edge mask or None; ``n_real``: real
    atoms when the last ``N - n_real`` are padding (pad senders masked,
    divisor ``n_real``). Returns ``(h_out, xp_out, vp_out, resid)``.
    ``bf16``: the bf16 tier's edge products (JAX ``mm_edge`` in bf16): o_f,
    o1, the semantic logits, the two head expansions (``bf16(h_e) (x)
    bf16(att2)``, exact in f32) and the x-mixing (which rounds that product
    again) take both operands rounded to bf16; node products stay f32 and the
    residuals are returned in f32 (the streams round them).
    """
    B, N, F = h.shape
    n_eff = float(n_real if n_real is not None else N)

    d0 = [pk[:, None, :, :] - pk[:, :, None, :] for pk in xp]
    r = torch.sqrt(torch.relu(d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2]) + EPSILON)

    a_j = h @ p["w_in_j"] + p["b_in"]
    a_i = h @ p["w_in_i"]
    pre = a_j[:, None, :, :] + a_i[:, :, None, :]
    t = torch.exp(-r)
    rbf = torch.exp(-p["rbf_b"] * (t - p["rbf_m"]) ** 2)
    me = _edge_mm(bf16)
    o_j = h @ p["w_o_j"]
    o_i = h @ p["w_o_i"]
    o_f = me(rbf * pre, p["w_o_f"])
    e0 = o_j[:, None] + o_i[:, :, None] + o_f + r * p["w_o_r"][0] + p["b_o0"]
    h_e = me(_silu(e0), p["w_o1"]) + p["b_o1"]

    sem_pre = me(h_e, p["w_sem"]) + p["b_sem"]
    att = raw_attention(sem_pre, mask=mask, n_real=n_real)  # the saved residual
    if mask is not None:
        att_s = att * mask
        denom = att_s.sum(dim=-2, keepdim=True)
        att2 = att_s / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    else:
        att2 = att

    K = att.shape[-1]
    H = h_e.shape[-1]
    if bf16:
        h_e_att = (bf16_round(h_e)[..., :, None] * bf16_round(att2)[..., None, :]).reshape(
            B, N, N, H * K)
    else:
        h_e_att = (h_e[..., :, None] * att2[..., None, :]).reshape(B, N, N, H * K)
    coeff = torch.tanh(me(h_e_att, p["w_xmix"]))
    if mask is not None:
        coeff = coeff * mask
    inv_r = 1.0 / (r + 1e-5)
    pooled = [(coeff * (d0[k] * inv_r)).sum(dim=-2) for k in range(3)]
    if mask is not None:
        count = mask.sum(dim=-2)
        norm = [pk / (count + 1e-8) for pk in pooled]
    else:
        norm = [pk / n_eff for pk in pooled]
    pool_sq = norm[0] ** 2 + norm[1] ** 2 + norm[2] ** 2
    ps0 = pool_sq @ p["w_post0"] + p["b_post0"]
    ps1 = _silu(ps0) @ p["w_post1"] + p["b_post1"]
    h_comb = _silu(ps1)

    hatt_sum = h_e_att.sum(dim=-2)
    node_pre = (h @ p["w_node_h"] + hatt_sum @ p["w_node_agg"]
                + h_comb @ p["w_node_comb"] + p["b_node0"])
    uv = _silu(node_pre) @ p["w_node1"] + p["b_node1"]
    h_out = h + _silu(uv)

    dv_denom = (count + 1e-10) if mask is not None else n_eff
    delta = [pk @ p["w_vmix"] / dv_denom for pk in pooled]
    g0 = h_out @ p["w_vel0"] + p["b_vel0"]
    g1 = _silu(g0) @ p["w_vel1"]
    gate = 2.0 * torch.sigmoid(g1)
    v_new = [gate * vk + dk for vk, dk in zip(vp, delta)]
    x_new = [xk + vk for xk, vk in zip(xp, v_new)]
    xp_out = [xk + upd * (xn - xk) for xk, xn in zip(xp, x_new)]
    vp_out = [vk + upd * (vn - vk) for vk, vn in zip(vp, v_new)]

    e2 = lambda a: a.reshape(B, N * N, -1)
    resid = dict(
        r=e2(r), t=e2(t), rbf=e2(rbf), e0=e2(e0), h_e=e2(h_e),
        sem_pre=e2(sem_pre), att=e2(att), coeff=e2(coeff),
        pool0=pooled[0], pool1=pooled[1], pool2=pooled[2],
        ps0=ps0, ps1=ps1, node_pre=node_pre, uv=uv, g0=g0, g1=g1,
    )
    return h_out, xp_out, vp_out, resid


def layer_bwd_resid(p: dict, resid: dict, h_in, xp, vp, upd, d_h_out, d_xp_out,
                    d_vp_out, *, n_real=None, mask=None, want_param_grads=False, bf16=False):
    """Hand-derived pullback of :func:`layer_fwd_resid` w.r.t. its inputs
    ``(h, xp, vp)``. Only ``a_j``/``a_i`` are recomputed from ``h_in``;
    every nonlinearity is evaluated on the saved residuals. Returns
    ``(d_h, d_xp, d_vp)``; with ``want_param_grads=True`` also ``dW``, this
    layer's gradient of every ``LEAF_NAMES`` leaf (:func:`layer_param_grads`),
    and with ``want_param_grads="rows"`` instead the cotangent rows ``dW``
    is contracted from (``ROWS``: edge rows ``(B, N*N, ch)``, node rows
    ``(B, N, ch)``). ``bf16``: the pullback of the bf16 tier's forward (JAX's
    with ``mm_edge`` in bf16): each edge product's cotangent and weight
    rounded to bf16, the head expansion's terms ``bf16(d_he_att bf16(att2))``
    and ``bf16(d_he_att bf16(h_e))`` rounded before their sums; its rows hold
    att2 rounded, and hatt sums ``bf16(h_e) bf16(att2)``."""
    B, N, F = h_in.shape
    C = p["w_xmix"].shape[-1]
    n_eff = float(n_real if n_real is not None else N)

    e4 = lambda a: a.reshape(B, N, N, -1)
    r, t, rbf, e0, h_e, sem_pre, att, coeff = (
        e4(resid[n]) for n in EDGE_RESIDS
    )
    pooled = [resid["pool0"], resid["pool1"], resid["pool2"]]
    ps0, ps1, node_pre, uv, g0, g1 = (
        resid[n] for n in ("ps0", "ps1", "node_pre", "uv", "g0", "g1")
    )

    d0 = [pk[:, None, :, :] - pk[:, :, None, :] for pk in xp]
    inv_r = 1.0 / (r + 1e-5)

    # position/velocity gates: x_out = x + upd*v_new; v_out = v + upd*(v_new - v)
    d_v_new = [upd * (dxk + dvk) for dxk, dvk in zip(d_xp_out, d_vp_out)]
    sig_g1 = torch.sigmoid(g1)
    gate = 2.0 * sig_g1
    d_gate = sum(dvn * vk for dvn, vk in zip(d_v_new, vp))
    d_vp = [gate * dvn + (1.0 - upd) * dvk for dvn, dvk in zip(d_v_new, d_vp_out)]
    d_xp = list(d_xp_out)

    # gate MLP
    d_g1 = d_gate * 2.0 * sig_g1 * (1.0 - sig_g1)
    d_g0 = (d_g1 @ p["w_vel1"].T) * _dsilu(g0)
    dho = d_h_out + d_g0 @ p["w_vel0"].T

    if mask is not None:
        count = mask.sum(dim=-2)
        dv_denom, pool_denom = count + 1e-10, count + 1e-8
    else:
        dv_denom = pool_denom = n_eff
    d_pooled = [(dd @ p["w_vmix"].T) / dv_denom for dd in d_v_new]

    # h_out = h_in + silu(uv); node MLP
    d_uv = dho * _dsilu(uv)
    d_node_pre = (d_uv @ p["w_node1"].T) * _dsilu(node_pre)
    d_h = dho + d_node_pre @ p["w_node_h"].T
    d_hatt = d_node_pre @ p["w_node_agg"].T
    d_ps1 = (d_node_pre @ p["w_node_comb"].T) * _dsilu(ps1)
    d_ps0 = (d_ps1 @ p["w_post1"].T) * _dsilu(ps0)
    d_pool_sq = d_ps0 @ p["w_post0"].T

    # pool_sq = sum_k (pooled_k / denom)^2
    pd2 = pool_denom * pool_denom
    d_pooled = [d_pooled[k] + 2.0 * pooled[k] * d_pool_sq / pd2 for k in range(3)]

    # pooled_k = sum_j coeff * u_k
    u = [dk * inv_r for dk in d0]
    dp = [dpk[:, :, None, :] for dpk in d_pooled]
    d_coeff = dp[0] * u[0] + dp[1] * u[1] + dp[2] * u[2]
    d_u = [(coeff * dp[k]).sum(dim=-1, keepdim=True) for k in range(3)]
    d_d0 = [du * inv_r for du in d_u]
    d_ir = d_u[0] * d0[0] + d_u[1] * d0[1] + d_u[2] * d0[2]
    d_r = -(inv_r * inv_r) * d_ir

    # coeff = tanh(he_att @ w_xmix) [* mask]; the saved coeff is masked
    d_xm = d_coeff * (1.0 - coeff * coeff)
    if mask is not None:
        d_xm = d_xm * mask
    me = _edge_mm(bf16)
    d_he_att = me(d_xm, p["w_xmix"].T) + d_hatt[:, :, None, :]

    # he_att[..., h*K + k] = h_e[..., h] * att2[..., k]
    K = att.shape[-1]
    H = h_e.shape[-1]
    if mask is not None:
        att_s = att * mask
        denom = att_s.sum(dim=-2, keepdim=True)
        dg = torch.where(denom == 0.0, torch.ones_like(denom), denom)
        att2 = att_s / dg
    else:
        att2 = att
    d_he_att4 = d_he_att.reshape(B, N, N, H, K)
    if bf16:  # heE = bf16(h_e), attE = bf16(att2); each term rounded before the sum
        he_e, att_e = bf16_round(h_e), bf16_round(att2)
        d_h_e = bf16_round(d_he_att4 * att_e[..., None, :]).sum(dim=-1)
        d_att2 = bf16_round(d_he_att4 * he_e[..., :, None]).sum(dim=-2)
    else:
        he_e, att_e = h_e, att2
        d_h_e = (d_he_att4 * att2[..., None, :]).sum(dim=-1)
        d_att2 = (d_he_att4 * h_e[..., :, None]).sum(dim=-2)
    if mask is not None:
        live = (denom != 0.0).to(att.dtype)
        d_att = (d_att2 / dg
                 - live * (d_att2 * att_s).sum(dim=-2, keepdim=True) / (dg * dg)) * mask
    else:
        d_att = d_att2

    # softmax over senders, celu2
    d_logits = att * (d_att - (d_att * att).sum(dim=-2, keepdim=True))
    dcelu = torch.where(sem_pre > 0, torch.ones_like(sem_pre), torch.exp(sem_pre / 2.0))
    d_sem_pre = d_logits * dcelu
    d_h_e = d_h_e + me(d_sem_pre, p["w_sem"].T)

    # h_e = silu(e0) @ w_o1 + b_o1
    d_e0 = me(d_h_e, p["w_o1"].T) * _dsilu(e0)

    # e0 = o_j[j] + o_i[i] + o_f + r * w_o_r + b_o0
    d_o_j = d_e0.sum(dim=-3)
    d_o_i = d_e0.sum(dim=-2)
    d_r = d_r + (d_e0 * p["w_o_r"][0]).sum(dim=-1, keepdim=True)
    d_filtered = me(d_e0, p["w_o_f"].T)
    a_j = h_in @ p["w_in_j"] + p["b_in"]
    a_i = h_in @ p["w_in_i"]
    pre = a_j[:, None, :, :] + a_i[:, :, None, :]
    d_rbf = d_filtered * pre
    d_pre = d_filtered * rbf
    d_a_j = d_pre.sum(dim=-3)
    d_a_i = d_pre.sum(dim=-2)
    d_h = (d_h + d_a_j @ p["w_in_j"].T + d_a_i @ p["w_in_i"].T
           + d_o_j @ p["w_o_j"].T + d_o_i @ p["w_o_i"].T)

    # rbf = exp(-b (t - m)^2), t = exp(-r)
    d_t = (d_rbf * rbf * (-2.0 * p["rbf_b"] * (t - p["rbf_m"]))).sum(dim=-1, keepdim=True)
    d_r = d_r + (-t) * d_t

    # r = sqrt(relu(s) + eps), s = |d0|^2, d0[b, i, j] = x[b, j] - x[b, i]
    d_s = d_r * (0.5 / r) * (r * r > EPSILON).to(r.dtype)
    for k in range(3):
        dd = d_d0[k] + 2.0 * d0[k] * d_s
        d_xp[k] = d_xp[k] + dd.sum(dim=-3) - dd.sum(dim=-2)
    if not want_param_grads:
        return d_h, d_xp, d_vp

    # the cotangent rows the parameter gradients contract (JAX :678-737)
    e2 = lambda a: a.reshape(B, N * N, -1)
    he_att = (he_e[..., :, None] * att_e[..., None, :]).reshape(B, N, N, H * K)
    rows = dict(
        de0=e2(d_e0), dhe=e2(d_h_e), dsem=e2(d_sem_pre), dxm=e2(d_xm), att2=e2(att_e),
        filt=e2(rbf * pre), drbf=e2(d_rbf),
        daj=d_a_j, dai=d_a_i, doj=d_o_j, doi=d_o_i, dps0=d_ps0, dps1=d_ps1,
        dnp=d_node_pre, duv=d_uv, dg0=d_g0, dg1=d_g1,
        ddel=torch.cat([dd / dv_denom for dd in d_v_new], dim=-1),
        hatt=he_att.sum(dim=-2),
        psq=((pooled[0] / pool_denom) ** 2 + (pooled[1] / pool_denom) ** 2
             + (pooled[2] / pool_denom) ** 2),
    )
    if want_param_grads == "rows":
        return d_h, d_xp, d_vp, rows
    return d_h, d_xp, d_vp, layer_param_grads(p, resid, h_in, rows, bf16=bf16)


def layer_param_grads(p: dict, resid: dict, h_in, rows: dict, *, bf16=False) -> dict:
    """One layer's gradient of every ``LEAF_NAMES`` leaf, from its residuals,
    its input ``h_in`` and the cotangent rows of :func:`layer_bwd_resid`:
    row contractions ``a^T @ g`` for the weights and row sums for the
    biases and offsets (JAX ``:678-773``). The plain version of the
    ``param_grads`` kernel. ``bf16``: the contractions of ``EDGE_MM_LEAVES``
    round both operands to bf16 (JAX ``mm_edge_t``), from the bf16 tier's
    rows."""
    flat = lambda a: a.reshape(-1, a.shape[-1])
    mmt = lambda a, g: flat(a).T @ flat(g)
    mme = (lambda a, g: mmt(bf16_round(a), bf16_round(g))) if bf16 else mmt
    # row sums in f64: their terms cancel (a softmax's cotangents sum to zero
    # over its senders), and an f32 sum of the b_sem rows lost 3e-5 of the
    # result's size on an H100
    rsum = lambda g: flat(g).double().sum(dim=0, keepdim=True).to(g.dtype)
    r, t, rbf, e0, h_e = (resid[n] for n in ("r", "t", "rbf", "e0", "h_e"))
    he_e = bf16_round(h_e) if bf16 else h_e  # JAX heE = mm_edge(h_e, e_rep)
    he_att = (he_e[..., :, None] * rows["att2"][..., None, :]).flatten(-2)
    tm = t - p["rbf_m"]
    q = rows["drbf"] * rbf
    ddel = rows["ddel"]
    dnp = rows["dnp"]
    return dict(
        w_in_j=mmt(h_in, rows["daj"]), w_in_i=mmt(h_in, rows["dai"]), b_in=rsum(rows["daj"]),
        rbf_m=rsum(q * (2.0 * p["rbf_b"] * tm)), rbf_b=rsum(q * (-(tm * tm))),
        w_o_j=mmt(h_in, rows["doj"]), w_o_i=mmt(h_in, rows["doi"]),
        w_o_f=mme(rows["filt"], rows["de0"]), w_o_r=rsum(rows["de0"] * r),
        b_o0=rsum(rows["de0"]), w_o1=mme(_silu(e0), rows["dhe"]), b_o1=rsum(rows["dhe"]),
        w_sem=mme(h_e, rows["dsem"]), b_sem=rsum(rows["dsem"]),
        w_xmix=mme(he_att, rows["dxm"]),
        w_post0=mmt(rows["psq"], rows["dps0"]), b_post0=rsum(rows["dps0"]),
        w_post1=mmt(_silu(resid["ps0"]), rows["dps1"]), b_post1=rsum(rows["dps1"]),
        w_node_h=mmt(h_in, dnp), w_node_agg=mmt(rows["hatt"], dnp),
        w_node_comb=mmt(_silu(resid["ps1"]), dnp), b_node0=rsum(dnp),
        w_node1=mmt(_silu(resid["node_pre"]), rows["duv"]), b_node1=rsum(rows["duv"]),
        w_vmix=sum(mmt(resid[f"pool{k}"], ddel[..., k : k + 1]) for k in range(3)),
        w_vel0=mmt(h_in + _silu(resid["uv"]), rows["dg0"]), b_vel0=rsum(rows["dg0"]),
        w_vel1=mmt(_silu(resid["g0"]), rows["dg1"]),
    )


def layer_jvp_resid(p: dict, resid: dict, h, xp, vp, th, txp, tvp, upd, *, n_real=None,
                    mask=None, bf16=False):
    """Tangent-only forward of one layer (JAX ``:791-975``): pushes the
    tangent state ``(th, txp, tvp)`` through :func:`layer_fwd_resid`'s map
    on the saved primal residuals. Only ``a_j``/``a_i`` and the head
    expansion ``h_e (x) att2`` are recomputed, as in the pullback. Returns
    ``(th_out, txp_out, tvp_out, tresid)``, ``tresid`` the tangent of the
    residual dict. The plain version of the ``resid_jvp`` kernel. ``bf16``:
    the bf16 tier's tangent products (JAX's with ``mm_edge`` in bf16): t_o_f,
    t_h_e and t_sem_pre round both operands; the head expansions ``bf16(h_e)``,
    ``bf16(att2)``, ``bf16(t_h_e)`` and ``bf16(t_att2)`` are rounded before
    ``t_he_att`` forms, and the x-mixing rounds ``t_he_att`` again; node
    products and the tangent residuals stay f32 (the streams round them)."""
    B, N, F = h.shape
    n_eff = float(n_real if n_real is not None else N)

    e4 = lambda a: a.reshape(B, N, N, -1)
    r, t, rbf, e0, h_e, sem_pre, att, coeff = (e4(resid[n]) for n in EDGE_RESIDS)
    pooled = [resid["pool0"], resid["pool1"], resid["pool2"]]
    ps0, ps1, node_pre, uv, g0, g1 = (
        resid[n] for n in ("ps0", "ps1", "node_pre", "uv", "g0", "g1")
    )

    d0 = [pk[:, None, :, :] - pk[:, :, None, :] for pk in xp]
    td0 = [tk[:, None, :, :] - tk[:, :, None, :] for tk in txp]

    # r = sqrt(relu(s) + eps): t_r = 0.5 / r * relu'(s) * t_s
    t_s = 2.0 * (d0[0] * td0[0] + d0[1] * td0[1] + d0[2] * td0[2])
    t_r = (0.5 / r) * (r * r > EPSILON).to(r.dtype) * t_s

    a_j = h @ p["w_in_j"] + p["b_in"]
    a_i = h @ p["w_in_i"]
    pre = a_j[:, None, :, :] + a_i[:, :, None, :]
    t_pre = (th @ p["w_in_j"])[:, None, :, :] + (th @ p["w_in_i"])[:, :, None, :]
    t_t = -t * t_r
    t_rbf = rbf * (-2.0 * p["rbf_b"] * (t - p["rbf_m"])) * t_t
    t_filtered = t_rbf * pre + rbf * t_pre
    me = _edge_mm(bf16)
    t_e0 = ((th @ p["w_o_j"])[:, None] + (th @ p["w_o_i"])[:, :, None]
            + me(t_filtered, p["w_o_f"]) + t_r * p["w_o_r"][0])
    t_h_e = me(_dsilu(e0) * t_e0, p["w_o1"])
    t_sem_pre = me(t_h_e, p["w_sem"])
    dcelu = torch.where(sem_pre > 0, torch.ones_like(sem_pre), torch.exp(sem_pre / 2.0))
    t_logits = dcelu * t_sem_pre  # the additive -INF masks are constant
    # softmax jvp on the saved raw softmax (over senders)
    t_att = att * (t_logits - (att * t_logits).sum(dim=-2, keepdim=True))
    if mask is not None:
        att_s = att * mask
        t_att_s = t_att * mask
        denom = att_s.sum(dim=-2, keepdim=True)
        dg = torch.where(denom == 0.0, torch.ones_like(denom), denom)
        att2 = att_s / dg
        t_dg = torch.where(denom == 0.0, torch.zeros_like(denom),
                           t_att_s.sum(dim=-2, keepdim=True))
        t_att2 = (t_att_s - att2 * t_dg) / dg
    else:
        att2, t_att2 = att, t_att

    K = att.shape[-1]
    H = h_e.shape[-1]
    rd = bf16_round if bf16 else (lambda a: a)  # JAX heE, attE, t_heE, t_attE
    t_he_att = (rd(t_h_e)[..., :, None] * rd(att2)[..., None, :]
                + rd(h_e)[..., :, None] * rd(t_att2)[..., None, :]).reshape(B, N, N, H * K)
    # the saved coeff is masked; at mask = 0 the (1 - coeff^2) = 1 is zeroed
    t_coeff = (1.0 - coeff * coeff) * me(t_he_att, p["w_xmix"])
    if mask is not None:
        t_coeff = t_coeff * mask

    inv_r = 1.0 / (r + 1e-5)
    t_inv_r = -(inv_r * inv_r) * t_r
    t_pooled = [
        (t_coeff * (d0[k] * inv_r) + coeff * (td0[k] * inv_r + d0[k] * t_inv_r)).sum(dim=-2)
        for k in range(3)
    ]
    if mask is not None:
        count = mask.sum(dim=-2)
        pool_denom, dv_denom = count + 1e-8, count + 1e-10
    else:
        pool_denom = dv_denom = n_eff
    t_pool_sq = sum(2.0 * (pooled[k] / pool_denom) * (t_pooled[k] / pool_denom)
                    for k in range(3))
    t_ps0 = t_pool_sq @ p["w_post0"]
    t_ps1 = (_dsilu(ps0) * t_ps0) @ p["w_post1"]
    t_node_pre = (th @ p["w_node_h"] + t_he_att.sum(dim=-2) @ p["w_node_agg"]
                  + (_dsilu(ps1) * t_ps1) @ p["w_node_comb"])
    t_uv = (_dsilu(node_pre) * t_node_pre) @ p["w_node1"]
    t_h_out = th + _dsilu(uv) * t_uv

    t_delta = [tp @ p["w_vmix"] / dv_denom for tp in t_pooled]
    t_g0 = t_h_out @ p["w_vel0"]
    t_g1 = (_dsilu(g0) * t_g0) @ p["w_vel1"]
    sig_g1 = torch.sigmoid(g1)
    gate = 2.0 * sig_g1
    t_gate = 2.0 * sig_g1 * (1.0 - sig_g1) * t_g1
    t_v_new = [t_gate * vk + gate * tvk + tdk for vk, tvk, tdk in zip(vp, tvp, t_delta)]
    txp_out = [tk + upd * tvn for tk, tvn in zip(txp, t_v_new)]
    tvp_out = [tvk + upd * (tvn - tvk) for tvk, tvn in zip(tvp, t_v_new)]

    e2 = lambda a: a.reshape(B, N * N, -1)
    tresid = dict(
        r=e2(t_r), t=e2(t_t), rbf=e2(t_rbf), e0=e2(t_e0), h_e=e2(t_h_e),
        sem_pre=e2(t_sem_pre), att=e2(t_att), coeff=e2(t_coeff),
        pool0=t_pooled[0], pool1=t_pooled[1], pool2=t_pooled[2],
        ps0=t_ps0, ps1=t_ps1, node_pre=t_node_pre, uv=t_uv, g0=t_g0, g1=t_g1,
    )
    return t_h_out, txp_out, tvp_out, tresid


def layer_bwd_resid_jvp(p: dict, resid: dict, h_in, xp, vp, upd, d_h_out, d_xp_out,
                        d_vp_out, tresid: dict, th, txp, tvp, *, n_real=None, mask=None,
                        bf16=False):
    """The tangent pullback of one layer: the jvp of :func:`layer_bwd_resid`
    (with its cotangent rows) along ``(tresid, th, txp, tvp)``, the
    cotangents ``(d_h_out, d_xp_out, d_vp_out)`` held fixed, as the JAX
    training backward takes it with ``jax.jvp`` (``train2_ef.py:1585-1598``).

    Returns ``((d_h, d_xp, d_vp, rows), (hc, xc, vc, t_rows))``: the pullback
    ``J^T c`` and its rows, and their tangents, whose first three are the
    Hessian-vector term the primal cotangent chain adds. The plain version
    of the ``resid_tbwd`` kernel. ``bf16``: the jvp of the bf16 tier's
    pullback; ``torch.func.jvp`` of a rounding to bf16 rounds the tangent too
    (as JAX's jvp of ``astype``), so each edge product rounds its value
    operand and its tangent operand apart."""

    def pullback(resid_, h_, xp_, vp_):
        return layer_bwd_resid(p, resid_, h_, xp_, vp_, upd, d_h_out, d_xp_out, d_vp_out,
                               n_real=n_real, mask=mask, want_param_grads="rows", bf16=bf16)

    return torch.func.jvp(pullback, (resid, h_in, list(xp), list(vp)),
                          (tresid, th, list(txp), list(tvp)))


def layer_param_grads_tangent(p: dict, resid: dict, h_in, rows: dict, tresid: dict, th,
                              t_rows: dict, *, bf16=False) -> dict:
    """Tangent of :func:`layer_param_grads` along ``(tresid, th, t_rows)``:
    ``t_a^T g + a^T t_g`` for every contraction and the tangents of the bias
    and offset row sums, the JAX ``contract_param_pair_tangents`` plus the
    tangent of its bias ``dW`` (``resid_ef.py:738-788``). With the rows of
    :func:`layer_bwd_resid_jvp` it is the second-order half of one layer's
    parameter gradient; the plain version of the tangent half of the
    ``param_grads_aug`` kernel. ``bf16``: the bf16 tier's, ``t_a^T g`` and
    ``a^T t_g`` of ``EDGE_MM_LEAVES`` each with both operands rounded (JAX
    ``contract_param_pair_tangents`` with ``mm_edge_t`` in bf16)."""
    return torch.func.jvp(lambda r_, h_, w_: layer_param_grads(p, r_, h_, w_, bf16=bf16),
                          (resid, h_in, rows), (tresid, th, t_rows))[1]


def unsplit_layer_grads(g: dict) -> LayerParams:
    """Inverse of ``leaves.split_layer`` for gradient leaves (one layer,
    depth axis removed): reassemble a ``LayerParams`` (JAX ``:1344-1373``)."""
    edge = CFConvParams(
        w_in=torch.cat([g["w_in_j"], g["w_in_i"]]), b_in=g["b_in"][0],
        rbf_means=g["rbf_m"][0], rbf_betas=g["rbf_b"][0],
        w_out0=torch.cat([g["w_o_j"], g["w_o_i"], g["w_o_f"], g["w_o_r"]]),
        b_out0=g["b_o0"][0], w_out1=g["w_o1"], b_out1=g["b_o1"][0],
    )
    return LayerParams(
        edge=edge, w_sem=g["w_sem"], b_sem=g["b_sem"][0], w_xmix=g["w_xmix"],
        w_post0=g["w_post0"], b_post0=g["b_post0"][0],
        w_post1=g["w_post1"], b_post1=g["b_post1"][0],
        w_node0=torch.cat([g["w_node_h"], g["w_node_agg"], g["w_node_comb"]]),
        b_node0=g["b_node0"][0], w_node1=g["w_node1"], b_node1=g["b_node1"][0],
        w_vmix=g["w_vmix"], w_vel0=g["w_vel0"], b_vel0=g["b_vel0"][0], w_vel1=g["w_vel1"],
    )


# --------------------------------------------------------------------------
# Layer stacks: plain versions and the kernel wrappers. Coordinates cross
# as (3, B, N) plane stacks, the edge mask as the layer functions'
# (B, N, N, 1) plane.
# --------------------------------------------------------------------------


class FwdOut(NamedTuple):
    bh: torch.Tensor  # (depth, B, N, F) h entering each layer
    bx: torch.Tensor  # (depth, 3, B, N)
    bv: torch.Tensor  # (depth, 3, B, N)
    h_fin: torch.Tensor  # (B, N, F)
    x_fin: torch.Tensor  # (3, B, N)
    v_fin: torch.Tensor  # (3, B, N)
    resid: dict  # name -> (depth, B, N*N | N, ch)


def _planes(s):
    return [s[k][..., None] for k in range(3)]


def _unplanes(ps):
    return torch.stack([pk[..., 0] for pk in ps])


def _layer(d: dict, l: int) -> dict:
    return {n: a[l] for n, a in d.items()}


def _layer_f32(d: dict, l: int) -> dict:
    """Layer ``l`` of the residual streams, as f32 (the bf16 tier's widened)."""
    return {n: a[l].float() for n, a in d.items()}


def stream_tier(fwd: FwdOut) -> bool:
    """Whether ``fwd``'s residual streams are the bf16 tier's."""
    return fwd.resid["h_e"].dtype == torch.bfloat16


def resid_fwd_plain(leaves: dict, h0, xs, v0, upd: Sequence[float], mask=None,
                    bf16=False) -> FwdOut:
    """Plain version of K1: :func:`layer_fwd_resid` over depth. ``bf16``: the
    bf16 tier, whose streams but r and t are bf16 tensors (``stream_dtype``)."""
    h, xp, vp = h0, _planes(xs), _planes(v0)
    bh, bx, bv, res = [], [], [], {n: [] for n in RESIDS}
    for l, u in enumerate(upd):
        bh.append(h)
        bx.append(_unplanes(xp))
        bv.append(_unplanes(vp))
        h, xp, vp, r = layer_fwd_resid(layer_leaves(leaves, l), h, xp, vp, u, mask=mask,
                                       bf16=bf16)
        for n in RESIDS:
            res[n].append(r[n])
    return FwdOut(torch.stack(bh), torch.stack(bx), torch.stack(bv), h,
                  _unplanes(xp), _unplanes(vp),
                  {n: torch.stack(v).to(stream_dtype(n, bf16)) for n, v in res.items()})


def resid_infer_plain(leaves: dict, h0, xs, v0, upd: Sequence[float], mask=None, bf16=False):
    """Plain version of :func:`resid_infer`: the final ``h`` and ``x``."""
    h, xp, vp = h0, _planes(xs), _planes(v0)
    for l, u in enumerate(upd):
        h, xp, vp, _ = layer_fwd_resid(layer_leaves(leaves, l), h, xp, vp, u, mask=mask,
                                       bf16=bf16)
    return h, _unplanes(xp)


def _bwd_plain(leaves, fwd, upd, dh, dx, dv, mask, want):
    dxp, dvp = _planes(dx), _planes(dv)
    per = [None] * len(upd)
    bf16 = stream_tier(fwd)
    for l in reversed(range(len(upd))):
        out = layer_bwd_resid(
            layer_leaves(leaves, l), _layer_f32(fwd.resid, l), fwd.bh[l], _planes(fwd.bx[l]),
            _planes(fwd.bv[l]), upd[l], dh, dxp, dvp, mask=mask, want_param_grads=want,
            bf16=bf16,
        )
        dh, dxp, dvp = out[:3]
        per[l] = out[3:]
    return dh, _unplanes(dxp), _unplanes(dvp), per


def resid_bwd_plain(leaves: dict, fwd: FwdOut, upd: Sequence[float], dh, dx, dv,
                    mask=None):
    """Plain version of K2: :func:`layer_bwd_resid` in reverse depth (in the
    tier of ``fwd``'s streams). Returns the cotangents of the initial ``(h, x,
    v)``."""
    return _bwd_plain(leaves, fwd, upd, dh, dx, dv, mask, False)[:3]


def resid_bwd_rows_plain(leaves: dict, fwd: FwdOut, upd: Sequence[float], dh, dx, dv,
                         mask=None):
    """Plain version of :func:`resid_bwd_rows`: K2's cotangents and the
    depth-stacked cotangent rows ``{name: (depth, B, N*N | N, ch)}``."""
    dh, dx, dv, per = _bwd_plain(leaves, fwd, upd, dh, dx, dv, mask, "rows")
    return dh, dx, dv, {n: torch.stack([p[0][n] for p in per]) for n in ROWS}


def param_grads_plain(leaves: dict, fwd: FwdOut, rows: dict) -> dict:
    """Plain version of :func:`param_grads`: :func:`layer_param_grads` per
    layer, ``{name: (depth, r, c)}``."""
    bf16 = stream_tier(fwd)
    per = [
        layer_param_grads(layer_leaves(leaves, l), _layer_f32(fwd.resid, l), fwd.bh[l],
                          _layer(rows, l), bf16=bf16)
        for l in range(fwd.bh.shape[0])
    ]
    return {n: torch.stack([p[n] for p in per]) for n in LEAF_NAMES}


_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
# param_grads cuts each layer's rows into chunks; each chunk's partial sums
# land in their own (f64) buffer, summed in chunk order by a second pass
# (deterministic, no atomics). The chunk count: enough that w_xmix's blocks
# (depth x heads a chunk) cover the card's SMs twice, one chunk per
# _GRAD_CHUNK_ROWS edge rows of a layer beyond that, never under
# _GRAD_MIN_ROWS edge rows a chunk nor over _GRAD_MAX_CHUNKS chunks.
_GRAD_SMS = 132  # an H100's
_GRAD_CHUNK_ROWS = 8192
_GRAD_MIN_ROWS = 64
_GRAD_MAX_CHUNKS = 64
_GRAD_STAGE = 16  # rows of one f64 stage (csrc/dmma_f64.cuh's kDmK)


def grad_chunks(B: int, N: int, K: int, depth: int) -> int:
    """Row chunks of :func:`param_grads` (and the augmented contraction) at
    batch ``B``, ``N`` atoms, ``K`` heads and ``depth`` layers."""
    edges = B * N * N
    fill = -(-2 * _GRAD_SMS // (depth * K))
    n = max(fill, -(-edges // _GRAD_CHUNK_ROWS))
    return max(1, min(_GRAD_MAX_CHUNKS, n, -(-edges // _GRAD_MIN_ROWS)))


def grad_chunk_rows(rows: int, n_chunks: int) -> list:
    """``[(begin, end)]`` of each chunk of a layer's ``rows`` (edges, atoms or
    w_vmix's pooled rows): ``ceil(rows / n_chunks)`` rounded up to whole f64
    stages, the last chunks short or empty (``csrc/param_grads.cu``'s
    ``chunk_span``)."""
    span = -(-(-(-rows // n_chunks)) // _GRAD_STAGE) * _GRAD_STAGE
    return [(min(rows, c * span), min(rows, c * span + span)) for c in range(n_chunks)]


def _grad_scratch(dims, dev):
    """``(n_chunks, partial, out, sizes)``: the chunk count, the f64 partial
    sums ``(n_chunks, len(out))`` and the output of every leaf's gradient,
    and each leaf's size, in ``LEAF_NAMES`` order."""
    B, N, F, H, R, K, C, depth = dims
    shapes = _leaf_shapes(F, H, R, K, C)
    sizes = [depth * shapes[n][0] * shapes[n][1] for n in LEAF_NAMES]
    n_chunks = grad_chunks(B, N, K, depth)
    partial = torch.empty(n_chunks, sum(sizes), device=dev, dtype=torch.float64)
    return n_chunks, partial, torch.empty(sum(sizes), device=dev), sizes


def _dims(leaves: dict, h0):
    B, N, F = h0.shape
    depth, _, R = leaves["w_in_j"].shape
    H = leaves["w_o_j"].shape[-1]
    K = leaves["w_sem"].shape[-1]
    C = leaves["w_xmix"].shape[-1]
    return B, N, F, H, R, K, C, depth


def _leaf_shapes(F, H, R, K, C):
    HK = H * K
    return dict(
        w_in_j=(F, R), w_in_i=(F, R), b_in=(1, R), rbf_m=(1, R), rbf_b=(1, R),
        w_o_j=(F, H), w_o_i=(F, H), w_o_f=(R, H), w_o_r=(1, H), b_o0=(1, H),
        w_o1=(H, H), b_o1=(1, H), w_sem=(H, K), b_sem=(1, K), w_xmix=(HK, C),
        w_post0=(C, H), b_post0=(1, H), w_post1=(H, H), b_post1=(1, H),
        w_node_h=(F, H), w_node_agg=(HK, H), w_node_comb=(H, H), b_node0=(1, H),
        w_node1=(H, F), b_node1=(1, F), w_vmix=(C, 1), w_vel0=(F, H),
        b_vel0=(1, H), w_vel1=(H, 1),
    )


def _check_cuda(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name() if callable(name) else name}: needs a contiguous float32 "
                         f"tensor on {device}")
    if t.shape != tuple(shape):
        raise ValueError(f"{name() if callable(name) else name}: shape {tuple(t.shape)}, kernel "
                         f"expects {tuple(shape)}")


def _check_leaves(leaves, dims, device):
    B, N, F, H, R, K, C, depth = dims
    for name, shape in _leaf_shapes(F, H, R, K, C).items():
        _check_cuda(name, leaves[name], (depth, *shape), device)


def _check_tc_leaves(name, leaves, leaves_t=None):
    """The tensor-core kernels copy w_xmix and its transpose into shared memory
    16 bytes at a time (``csrc/mma_tf32x3.cuh``): both must start 16-byte
    aligned (w_xmix alone when ``leaves_t`` is None: K1's route reads no
    transpose)."""
    pairs = [("w_xmix", leaves["w_xmix"])]
    if leaves_t is not None:
        pairs.append(("w_xmix.T", leaves_t["w_xmix"]))
    for label, t in pairs:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must start at a 16-byte aligned address")


def _check_all(name, tensors: dict, shapes: dict, device):
    for n, s in shapes.items():  # the name is formatted only for an error
        _check_cuda(lambda n=n: f"{name}.{n}", tensors[n], s, device)


def _check_resid(resid: dict, dims, leaves, device, bf16: bool):
    """The 17 residual streams, in the tier's dtypes (``stream_dtype``)."""
    for n, s in _resid_shapes(dims, leaves).items():
        t = resid[n]
        if bf16 and n in RESID_LOWP:
            if t.device != device or t.dtype != torch.bfloat16 or not t.is_contiguous():
                raise ValueError(f"resid.{n}: needs a contiguous bfloat16 tensor on {device} in "
                                 "the bf16 tier")
            if t.shape != s:
                raise ValueError(f"resid.{n}: shape {tuple(t.shape)}, kernel expects {s}")
        else:
            _check_cuda(f"resid.{n}", t, s, device)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _strides(leaves):
    return (ctypes.c_longlong * len(LEAF_NAMES))(
        *[leaves[n][0].numel() for n in LEAF_NAMES]
    )


def _resid_shapes(dims, leaves):
    B, N, F, H, R, K, C, depth = dims
    ech = edge_channels(R, H, K, C)
    nch = node_channels(leaves, C)
    return {
        **{n: (depth, B, N * N, ech[n]) for n in EDGE_RESIDS},
        **{n: (depth, B, N, nch[n]) for n in NODE_RESIDS},
    }


def _row_shapes(dims, leaves):
    B, N, F, H, R, K, C, depth = dims
    ch = row_channels(leaves, C)
    return {
        **{n: (depth, B, N * N, ch[n]) for n in EDGE_ROWS},
        **{n: (depth, B, N, ch[n]) for n in NODE_ROWS},
    }


def _edge_mask(mask, dims, device):
    """The ``(B, N, N, 1)`` edge mask as the kernels read it: a contiguous
    f32 ``(B, N, N)`` tensor, or None (a null pointer: no mask)."""
    if mask is None:
        return None
    B, N = dims[:2]
    m = mask.reshape(B, N, N)
    _check_cuda("mask", m, (B, N, N), device)
    return m


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _require_cuda(name, t):
    """The kernels take CUDA tensors (CPU tensors go to the plain versions
    before this); any other device raises."""
    if not t.is_cuda:
        raise ValueError(f"{name}: unsupported device {t.device}")


CLUSTER_SIZE = 2  # CTAs of a cluster (csrc/cluster.cuh's kClSize)


def cluster_rows(N: int, rank: int) -> tuple:
    """``(i0, i1)``: the receiver rows of cluster rank ``rank`` in the cluster
    kernels, consecutive spans of ``ceil(N / 2)`` (``csrc/cluster.cuh``'s
    ``cl_rows``)."""
    span = -(-N // CLUSTER_SIZE)
    i0 = min(N, rank * span)
    return i0, min(N, i0 + span)


def _check_smem(lib, entry: str, dims, name: str):
    """Raises when the kernel whose carve ``entry`` sizes exceeds one block's
    shared memory at ``dims``."""
    if getattr(lib, entry)(*dims) > _SMEM_LIMIT:
        raise ValueError(f"{name}: N={dims[1]} at these widths exceeds one block's shared memory")


def _fwd_args(name, leaves, h0, xs, v0, upd, mask):
    """Checks shared by K1 and the forward without residuals; returns
    ``(lib, dims, upd, mask)`` as the kernels take them."""
    _require_cuda(name, h0)
    dims = _dims(leaves, h0)
    B, N, F, H, R, K, C, depth = dims
    dev = h0.device
    _check_cuda("h0", h0, (B, N, F), dev)
    _check_cuda("xs", xs, (3, B, N), dev)
    _check_cuda("v0", v0, (3, B, N), dev)
    _check_leaves(leaves, dims, dev)
    if F != H or len(upd) != depth:
        raise ValueError(f"{name}: needs hidden width == feature width and one gate per layer")
    lib = build.load()
    upd_t = torch.tensor(list(upd), dtype=torch.float32, device=dev)
    return lib, dims, upd_t, _edge_mask(mask, dims, dev)


ROUTES = ("CUDA cores", "tensor cores")  # a kernel's two routes, by tensor_core_route


def fwd_tensor_core_route(dims) -> bool:
    """Whether K1 takes its tensor-core kernel at ``dims`` (``(B, N, F, H, R,
    K, C, depth)``; the kernel source's ``fwd_tc_route``: ``tc_dims``'s widths,
    H * K = C = 256 and H, R at most 64, and two blocks an SM, which at
    aspirin's widths is N at most 21), else its CUDA-core kernel: an index into
    ``ROUTES``."""
    return bool(build.load().sake_resid_fwd_tc_route(*dims))


def bwd_tensor_core_route(dims) -> bool:
    """Whether K2 takes its tensor-core kernel at ``dims`` (the kernel
    source's ``tc_dims``: H * K = C = 256, H and R at most 64, N at most 22),
    else its CUDA-core kernel: an index into ``ROUTES``."""
    return bool(build.load().sake_resid_bwd_tc_route(*dims))


def tc_product(a, w, warps: int):
    """One tensor-core product of K1's or K2's route alone, in 3xTF32 in a
    block of ``warps`` warps (8: K1's, 16: K2's; ``csrc/mma_tf32x3.cuh``):
    ``a (n, k) @ w (k, m)``. k = m = 256 (the x-mixing and its transpose, n at
    most 24) on ``mm_tc``; k and m at most 64 (o_f, o1 and their pullbacks) on
    ``mm_tc_small``. CPU tensors take the plain models of ``kernels/tf32.py``
    (``mm_tc``'s chunked sums, ``mm_tc_small``'s passes summed apart); a CUDA
    tensor launches the kernel or raises."""
    if a.device.type == "cpu":
        wide = a.shape[-1] == w.shape[-1] == 256
        return mm_tf32x3_chunked_plain(a, w) if wide else mm_tf32x3_plain(a, w)
    name = "tc_product"
    _require_cuda(name, a)
    (n, k), m = a.shape, w.shape[-1]
    _check_cuda("a", a, (n, k), a.device)
    _check_cuda("w", w, (k, m), a.device)
    if w.data_ptr() % 16:  # mm_tc copies w 16 bytes at a time
        raise ValueError(f"{name}: w must start at a 16-byte aligned address")
    out = torch.empty(n, m, device=a.device, dtype=torch.float32)
    lib = build.load()
    build.check(lib, lib.sake_resid_tc_product(warps, a.data_ptr(), w.data_ptr(),
                                               out.data_ptr(), n, k, m, _stream(a.device)),
                name)
    return out


def resid_fwd(leaves: dict, h0, xs, v0, upd: Sequence[float], mask=None, *,
              cluster: bool = False, bf16: bool = False) -> FwdOut:
    """K1: the layer stack's forward with residuals. ``leaves`` from
    :func:`leaves.wide_stack`; ``h0 (B, N, F)``; ``xs``, ``v0 (3, B, N)``;
    ``upd``: per-layer update gates; ``mask``: ``(B, N, N, 1)`` edge mask
    or None. One block a molecule, on the route its shape takes
    (:func:`fwd_tensor_core_route`), each launch counted in
    ``resid_fwd.launches`` and under its route in ``resid_fwd.routes``.
    ``cluster``: launch the cluster kernel (#4's, one molecule per
    cluster of two CTAs), counted in ``resid_fwd.cluster_launches``; at N = 29
    it took 0.33-0.64x the one-block kernel's time on an H100 at every batch
    from 64 to 256 (``tools/probe_resid.py --phases sweep``). ``bf16``: the bf16
    tier (:func:`layer_fwd_resid`'s, streams in ``stream_dtype``) on the same
    routes, its kernels' edge weights rounded here (:func:`edge_bf16_leaves`).
    CPU tensors take the plain version."""
    if h0.device.type == "cpu":
        return resid_fwd_plain(leaves, h0, xs, v0, upd, mask=mask, bf16=bf16)
    route = "cluster" if cluster else "block"
    out = (_launch_fwd(leaves, h0, xs, v0, upd, mask, route, bf16=True) if bf16
           else _launch_fwd(leaves, h0, xs, v0, upd, mask, route))
    if cluster:
        resid_fwd.cluster_launches += 1
    else:
        resid_fwd.launches += 1
    resid_fwd.tiers[TIERS[bf16]] += 1
    return out


# K1's entries and carves by route, and the route argument of its bf16 tier's
# entry
_FWD_ENTRIES = {"CUDA cores": ("sake_resid_fwd", "sake_resid_fwd_smem_bytes"),
                "tensor cores": ("sake_resid_fwd_tc", "sake_resid_fwd_tc_smem_bytes"),
                "cluster": ("sake_resid_fwd_cluster", "sake_resid_fwd_cluster_smem_bytes")}
_FWD16_ROUTES = {"CUDA cores": 0, "tensor cores": 1, "cluster": 2}


def _launch_fwd(leaves, h0, xs, v0, upd, mask, route="block", bf16=False):
    """Checks, allocation and launch of K1 on ``route``: "block" (:func:`resid_fwd`'s
    one block a molecule, on the route the shape takes, counted under it in
    ``resid_fwd.routes``), "CUDA cores" or "tensor cores" (that one-block kernel,
    not counted; the tensor-core one refuses a shape off its route) or "cluster"
    (its cluster kernel). ``bf16``: the bf16 tier's kernel of that route
    (``sake_resid_fwd16``)."""
    lib, dims, upd_t, m = _fwd_args("resid_fwd", leaves, h0, xs, v0, upd, mask)
    B, N, F, H, R, K, C, depth = dims
    counted = route == "block"
    if counted:
        route = ROUTES[fwd_tensor_core_route(dims)]
    if bf16:
        leaves = edge_bf16_leaves(leaves)
    if route == "tensor cores":
        _check_tc_leaves("resid_fwd", leaves)
    entry, carve = _FWD_ENTRIES[route]
    _check_smem(lib, carve, dims, "resid_fwd")
    empty = lambda *s, dtype=torch.float32: torch.empty(s, device=h0.device, dtype=dtype)
    out = FwdOut(
        empty(depth, B, N, F), empty(depth, 3, B, N), empty(depth, 3, B, N),
        empty(B, N, F), empty(3, B, N), empty(3, B, N),
        {n: empty(*s, dtype=stream_dtype(n, bf16))
         for n, s in _resid_shapes(dims, leaves).items()},
    )
    args = (
        h0.data_ptr(), xs.data_ptr(), v0.data_ptr(), upd_t.data_ptr(), _ptr(m),
        _ptrs([leaves[n] for n in LEAF_NAMES]), _strides(leaves),
        out.bh.data_ptr(), out.bx.data_ptr(), out.bv.data_ptr(),
        out.h_fin.data_ptr(), out.x_fin.data_ptr(), out.v_fin.data_ptr(),
        _ptrs([out.resid[n] for n in RESIDS]),
    )
    if bf16:  # the body's f32 pooled vectors, one layer at a time
        pool16 = empty(3, B, N, C)
        err = lib.sake_resid_fwd16(_FWD16_ROUTES[route], *args, pool16.data_ptr(), *dims,
                                   _stream(h0.device))
    else:
        err = getattr(lib, entry)(*args, *dims, _stream(h0.device))
    build.check(lib, err, f"resid_fwd ({route}{', bf16' if bf16 else ''})")
    if counted:
        resid_fwd.routes[route] += 1
    return out


# the kernels' launches by tier (both routes), beside their totals
TIERS = ("f32", "bf16")
resid_fwd.launches = 0
resid_fwd.routes = dict.fromkeys(ROUTES, 0)
resid_fwd.cluster_launches = 0
resid_fwd.tiers = dict.fromkeys(TIERS, 0)


def resid_infer(leaves: dict, h0, xs, v0, upd: Sequence[float], mask=None, *,
                bf16: bool = False):
    """The layer stack's forward without residuals or boundary states (JAX
    ``infer_kernel`` ``:1732``): K1's source built without its streams, on
    #4's cluster route at every batch (``csrc/resid_fwd.cu``'s
    ``resid_fwd_cl_kernel<false>``: one molecule per cluster of two CTAs, the
    x-mixing and edge products in 3xTF32 up to N = 32), each launch counted in
    ``resid_infer.launches``. Returns the final ``h (B, N, F)`` and ``x (3, B,
    N)``. ``bf16``: the bf16 tier's products (its kernel
    ``sake_resid_infer_cluster16``). CPU tensors take the plain version."""
    if h0.device.type == "cpu":
        return resid_infer_plain(leaves, h0, xs, v0, upd, mask=mask, bf16=bf16)
    out = (_launch_infer(leaves, h0, xs, v0, upd, mask, bf16=True) if bf16
           else _launch_infer(leaves, h0, xs, v0, upd, mask))
    resid_infer.launches += 1
    return out


def _launch_infer(leaves, h0, xs, v0, upd, mask, bf16=False):
    """Checks, allocation and launch of :func:`resid_infer`'s kernel. A
    refused launch raises."""
    lib, dims, upd_t, m = _fwd_args("resid_infer", leaves, h0, xs, v0, upd, mask)
    if bf16:
        leaves = edge_bf16_leaves(leaves)
    _check_smem(lib, "sake_resid_fwd_cluster_smem_bytes", dims, "resid_infer")
    B, N, F, H, R, K, C, depth = dims
    empty = lambda *s: torch.empty(s, device=h0.device, dtype=torch.float32)
    h_fin, x_fin = empty(B, N, F), empty(3, B, N)
    pool = empty(3, B, N, C)  # one layer's pooled vectors, reused layer after layer
    entry = lib.sake_resid_infer_cluster16 if bf16 else lib.sake_resid_infer_cluster
    err = entry(
        h0.data_ptr(), xs.data_ptr(), v0.data_ptr(), upd_t.data_ptr(), _ptr(m),
        _ptrs([leaves[n] for n in LEAF_NAMES]), _strides(leaves),
        h_fin.data_ptr(), x_fin.data_ptr(), pool.data_ptr(), *dims, _stream(h0.device),
    )
    build.check(lib, err, "resid_infer")
    return h_fin, x_fin


resid_infer.launches = 0


def _bwd_launch(name, leaves, fwd, upd, dh, dx, dv, mask, leaves_t, want_rows, add=None,
                route="block"):
    """Checks, allocation and launch of K2 (``want_rows=False``) or of its
    instantiation that also writes the cotangent rows. ``add``: None, or
    ``(add_h (depth, B, N, F), add_x (depth, 3, B, N), add_v (depth, 3, B,
    N))`` that the rows instantiation adds to the cotangents leaving each
    layer (the second-order backward's Hessian term). ``route``: "block" (one
    block a molecule; K2 on the route its shape takes, counted under it in
    ``resid_bwd.routes``), "CUDA cores" or "tensor cores" (K2 on that kernel,
    not counted; the tensor-core one refuses a shape off its route), or
    "cluster" for the rows kernel's cluster route (no addend). The rows
    instantiation's one-block kernel has no tensor-core route. The tier is
    that of ``fwd``'s streams (:func:`stream_tier`): the bf16 tier's kernels
    (``sake_resid_bwd16``, ``sake_resid_bwd_rows16``,
    ``sake_resid_bwd_rows_cluster16``) take the four edge weights rounded
    here."""
    _require_cuda(name, dh)
    dims = _dims(leaves, fwd.bh[0])
    B, N, F, H, R, K, C, depth = dims
    dev = dh.device
    bf16 = stream_tier(fwd)
    _check_leaves(leaves, dims, dev)
    _check_cuda("bh", fwd.bh, (depth, B, N, F), dev)
    _check_cuda("bx", fwd.bx, (depth, 3, B, N), dev)
    _check_cuda("bv", fwd.bv, (depth, 3, B, N), dev)
    _check_resid(fwd.resid, dims, leaves, dev, bf16)
    _check_cuda("dh", dh, (B, N, F), dev)
    _check_cuda("dx", dx, (3, B, N), dev)
    _check_cuda("dv", dv, (3, B, N), dev)
    if F != H or len(upd) != depth:
        raise ValueError(f"{name}: needs hidden width == feature width and one gate per layer")
    lib = build.load()
    counted = route == "block" and not want_rows
    if counted:
        route = ROUTES[bwd_tensor_core_route(dims)]
    if route == "cluster":
        if not want_rows or add is not None:
            raise ValueError(f"{name}: the cluster route writes the rows and takes no addend")
        _check_smem(lib, "sake_resid_bwd_cluster_smem_bytes", dims, name)
    elif route in ROUTES and want_rows:
        raise ValueError(f"{name}: the rows kernel takes the block or the cluster route")
    elif route == "tensor cores":
        _check_smem(lib, "sake_resid_bwd_tc_smem_bytes", dims, name)
    else:
        _check_smem(lib, "sake_resid_bwd_smem_bytes", dims, name)
    if leaves_t is None:
        leaves_t = transposed(leaves)
    if bf16:
        leaves, leaves_t = edge_bf16_leaves(leaves), edge_bf16_leaves(leaves_t)
    for leaf, shape in _leaf_shapes(F, H, R, K, C).items():
        _check_cuda(f"{leaf}.T", leaves_t[leaf], (depth, *shape[::-1]), dev)
    if route == "tensor cores":
        _check_tc_leaves(name, leaves, leaves_t)
    m = _edge_mask(mask, dims, dev)
    dh_out, dx_out, dv_out = torch.empty_like(dh), torch.empty_like(dx), torch.empty_like(dv)
    rows = ({n: torch.empty(s, device=dev) for n, s in _row_shapes(dims, leaves).items()}
            if want_rows else None)
    upd_t = torch.tensor(list(upd), dtype=torch.float32, device=dev)
    args = [
        fwd.bh.data_ptr(), fwd.bx.data_ptr(), fwd.bv.data_ptr(), upd_t.data_ptr(), _ptr(m),
        _ptrs([leaves[n] for n in LEAF_NAMES]), _ptrs([leaves_t[n] for n in LEAF_NAMES]),
        _strides(leaves), _ptrs([fwd.resid[n] for n in RESIDS]),
        dh.data_ptr(), dx.data_ptr(), dv.data_ptr(),
        dh_out.data_ptr(), dx_out.data_ptr(), dv_out.data_ptr(),
    ]
    if want_rows and add is not None:
        for n, a, s in zip(("add_h", "add_x", "add_v"), add,
                           ((depth, B, N, F), (depth, 3, B, N), (depth, 3, B, N))):
            _check_cuda(n, a, s, dev)
    row_ptrs = _ptrs([rows[n] for n in ROWS]) if want_rows else None
    adds = [_ptr(a) for a in (add or (None,) * 3)]
    if bf16 and route == "cluster":
        err = lib.sake_resid_bwd_rows_cluster16(*args, row_ptrs, *dims, _stream(dev))
    elif bf16 and want_rows:
        err = lib.sake_resid_bwd_rows16(*args, row_ptrs, *adds, *dims, _stream(dev))
    elif bf16:
        err = lib.sake_resid_bwd16(int(route == "tensor cores"), *args, *dims, _stream(dev))
    elif route == "cluster":
        err = lib.sake_resid_bwd_rows_cluster(*args, row_ptrs, *dims, _stream(dev))
    elif want_rows:
        err = lib.sake_resid_bwd_rows(*args, row_ptrs, *adds, *dims, _stream(dev))
    elif route == "tensor cores":
        err = lib.sake_resid_bwd_tc(*args, *dims, _stream(dev))
    else:
        err = lib.sake_resid_bwd(*args, *dims, _stream(dev))
    tier = ", bf16" if bf16 else ""
    build.check(lib, err, f"{name}{tier}" if route == "block" else f"{name} ({route}{tier})")
    if counted:
        resid_bwd.routes[route] += 1
    return dh_out, dx_out, dv_out, rows


def resid_bwd(leaves: dict, fwd: FwdOut, upd: Sequence[float], dh, dx, dv, mask=None,
              *, leaves_t: Optional[dict] = None):
    """K2: pullback of the layer stack from the cotangents of the final
    ``(h (B, N, F), x (3, B, N), v (3, B, N))`` to those of the initial
    state, reading K1's residuals, on the route its shape takes
    (:func:`bwd_tensor_core_route`), each launch counted in
    ``resid_bwd.launches``, under its route in ``resid_bwd.routes`` and under
    its tier in ``resid_bwd.tiers``. CPU
    tensors take the plain version. ``leaves_t``: ``leaves.transposed(leaves)``,
    built here when not given; pass it to build it once for several launches.
    The tier is that of ``fwd``'s streams."""
    if dh.device.type == "cpu":
        return resid_bwd_plain(leaves, fwd, upd, dh, dx, dv, mask=mask)
    out = _bwd_launch("resid_bwd", leaves, fwd, upd, dh, dx, dv, mask, leaves_t, False)
    resid_bwd.launches += 1
    resid_bwd.tiers[TIERS[stream_tier(fwd)]] += 1
    return out[:3]


resid_bwd.launches = 0
resid_bwd.routes = dict.fromkeys(ROUTES, 0)
resid_bwd.tiers = dict.fromkeys(TIERS, 0)


def resid_bwd_rows(leaves: dict, fwd: FwdOut, upd: Sequence[float], dh, dx, dv, mask=None,
                   *, leaves_t: Optional[dict] = None, cluster: bool = False):
    """K2's pullback, also writing every layer's cotangent rows (``ROWS``,
    ``{name: (depth, B, N*N | N, ch)}``) for :func:`param_grads`: the
    pullback half of the JAX training ``bwd_kernel`` (``:1598``). Returns
    ``(dh, dx, dv, rows)``. ``cluster``: launch the cluster kernel (#5's rows
    kernel, one molecule per cluster of two CTAs), counted in
    ``resid_bwd_rows.cluster_launches``; at N = 29 it took 0.39-0.76x the
    one-block kernel's time on an H100 at every batch from 64 to 256. On bf16
    streams (the bf16 tier) both routes take their tier's kernel
    (``csrc/resid_bwd16.cu``, ``csrc/resid_bwd_cl.cu``). CPU tensors take the
    plain version."""
    if dh.device.type == "cpu":
        return resid_bwd_rows_plain(leaves, fwd, upd, dh, dx, dv, mask=mask)
    out = _bwd_launch("resid_bwd_rows", leaves, fwd, upd, dh, dx, dv, mask, leaves_t, True,
                      route="cluster" if cluster else "block")
    if cluster:
        resid_bwd_rows.cluster_launches += 1
    else:
        resid_bwd_rows.launches += 1
    return out


resid_bwd_rows.launches = 0
resid_bwd_rows.cluster_launches = 0


def param_grads(leaves: dict, fwd: FwdOut, rows: dict) -> dict:
    """Every leaf's gradient per layer, summed over the batch
    (``{name: (depth, r, c)}``), from K1's residuals and boundary states and
    the rows of :func:`resid_bwd_rows`: the parameter-gradient half of the
    JAX training ``bwd_kernel`` (``:1598``), its wide leaves on the f64
    tensor cores and its narrow ones in f64 on the CUDA cores
    (``csrc/param_grads.cu``). In the tier of ``fwd``'s streams: the bf16
    tier's kernel (``sake_param_grads16``) rounds both operands of the four
    edge leaves' contractions. CPU tensors take the plain version."""
    if fwd.bh.device.type == "cpu":
        return param_grads_plain(leaves, fwd, rows)
    out = _launch_param_grads(leaves, fwd, rows)
    param_grads.launches += 1
    return out


def _launch_param_grads(leaves: dict, fwd: FwdOut, rows: dict) -> dict:
    _require_cuda("param_grads", fwd.bh)
    dims = _dims(leaves, fwd.bh[0])
    B, N, F, H, R, K, C, depth = dims
    dev = fwd.bh.device
    _check_leaves(leaves, dims, dev)
    _check_cuda("bh", fwd.bh, (depth, B, N, F), dev)
    bf16 = stream_tier(fwd)
    _check_resid(fwd.resid, dims, leaves, dev, bf16)
    _check_all("rows", rows, _row_shapes(dims, leaves), dev)
    shapes = _leaf_shapes(F, H, R, K, C)
    n_chunks, partial, out, sizes = _grad_scratch(dims, dev)
    lib = build.load()
    err = (lib.sake_param_grads16 if bf16 else lib.sake_param_grads)(
        fwd.bh.data_ptr(), _ptrs([leaves[n] for n in LEAF_NAMES]), _strides(leaves),
        _ptrs([fwd.resid[n] for n in RESIDS]), _ptrs([rows[n] for n in ROWS]),
        partial.data_ptr(), out.data_ptr(), n_chunks, *dims, _stream(dev),
    )
    build.check(lib, err, "param_grads (bf16)" if bf16 else "param_grads")
    return {n: a.view(depth, *shapes[n]) for n, a in zip(LEAF_NAMES, out.split(sizes))}


param_grads.launches = 0


def resid_train_bwd(leaves: dict, fwd: FwdOut, upd: Sequence[float], dh, dx, dv, mask=None,
                    *, leaves_t: Optional[dict] = None, cluster: bool = False):
    """The training pullback (JAX ``bwd_kernel`` ``:1598``):
    :func:`resid_bwd_rows` (``cluster`` as there) then :func:`param_grads`.
    Returns ``(dh, dx, dv, {name: (depth, r, c)})``."""
    dh, dx, dv, rows = resid_bwd_rows(leaves, fwd, upd, dh, dx, dv, mask, leaves_t=leaves_t,
                                      cluster=cluster)
    return dh, dx, dv, param_grads(leaves, fwd, rows)


def _readout_seed(params: ModelParams, h_fin, node_mask):
    """Raw energy per molecule and its cotangent on ``h_fin``."""
    with torch.enable_grad():
        hf = h_fin.detach().requires_grad_(True)
        out = readout(params, hf)
        if node_mask is not None:
            out = out * node_mask[..., None]
        e = out.sum(dim=(-2, -1))
        (dh,) = torch.autograd.grad(e.sum(), hf)
    return e.detach(), dh.contiguous()


@torch.no_grad()
def resid_energy_forces(
    params: ModelParams,
    h: torch.Tensor,  # (B, N, F_in)
    x: torch.Tensor,  # (B, N, 3)
    mask: Optional[torch.Tensor] = None,  # (B, N, N) edge mask
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    batch_tile: int = 8,
    matmul_dtype=None,
    precision=None,
    edge_matmul_dtype=None,
    edge_precision=None,
    resid_dtype=torch.float32,
    pad_atoms: bool = False,
    chunk: Optional[int] = 512,
    resid_lowp=None,
    pool_dtype=None,
    spatial_mode: Optional[str] = None,
    pool_matmul_dtype=None,
    pool_precision=None,
    batch_parallel: bool = False,
    interpret: bool = False,
):
    """Raw (uncolored) ``E (B,)`` and ``F = -dE/dx (B, N, 3)`` through K1,
    the readout seed and K2. ``chunk`` bounds how many molecules' residuals
    are alive at once (f32: about 5.3 MB per aspirin molecule at depth 6).

    The JAX keywords: ``edge_matmul_dtype`` and ``resid_dtype`` both bf16
    (with ``resid_lowp`` None or the default set, ``RESID_LOWP``) run the bf16
    tier, the JAX package's production setting (:func:`layer_fwd_resid`'s
    ``bf16``; its streams bf16, r and t excepted); f32 (or None) runs the f32
    tier. Every other combination raises (``_bf16_edge_tier``): bf16 node
    products (``matmul_dtype``), ``pool_dtype``, ``pool_matmul_dtype``, another
    ``resid_lowp``, one of the two without the other, and the TPU-only
    ``spatial_mode``. Accepted with no counterpart are ``batch_tile``,
    ``pad_atoms`` and ``batch_parallel`` (one molecule per block, N as it
    comes), the precisions (every f32 product is f32) and ``interpret`` (CPU
    tensors take the plain versions)."""
    bf16 = _bf16_edge_tier("resid_energy_forces", matmul_dtype=matmul_dtype,
                           edge_matmul_dtype=edge_matmul_dtype, resid_dtype=resid_dtype,
                           resid_lowp=resid_lowp, lowp=RESID_LOWP, pool_dtype=pool_dtype,
                           pool_matmul_dtype=pool_matmul_dtype)
    if spatial_mode is not None:
        raise NotImplementedError("resid_energy_forces: spatial_mode is a TPU-only probe")
    B = h.shape[0]
    upd = [1.0 if u else 0.0 for u in per_layer(update, len(params.layers))]
    leaves = wide_stack(params, n_heads)
    leaves_t = transposed(leaves) if x.is_cuda else None  # K2's layout, once per call
    h0 = embed(params, h.float())
    node_mask = torch.diagonal(mask, dim1=-2, dim2=-1) if mask is not None else None
    step = chunk or B
    es, fs = [], []
    for s in range(0, B, step):
        sl = slice(s, s + step)
        xs = x[sl].permute(2, 0, 1).float().contiguous()
        zeros = torch.zeros_like(xs)
        m4 = mask[sl][..., None] if mask is not None else None
        fwd = resid_fwd(leaves, h0[sl].contiguous(), xs, zeros, upd, mask=m4, bf16=bf16)
        e, dh_fin = _readout_seed(
            params, fwd.h_fin, node_mask[sl] if node_mask is not None else None
        )
        _, dx, _ = resid_bwd(leaves, fwd, upd, dh_fin, zeros, zeros, mask=m4,
                             leaves_t=leaves_t)
        es.append(e)
        fs.append(-dx.permute(1, 2, 0))
    return torch.cat(es), torch.cat(fs)


# --------------------------------------------------------------------------
# First-order training: the hidden-state function with a kernel backward.
# --------------------------------------------------------------------------


_EDGE_TENSORS = len(CFConvParams._fields)
_LAYER_TENSORS = _EDGE_TENSORS + len(LayerParams._fields) - 1


def _unflat_params(flat, depth: int) -> ModelParams:
    layers = []
    for l in range(depth):
        t = flat[2 + l * _LAYER_TENSORS : 2 + (l + 1) * _LAYER_TENSORS]
        layers.append(LayerParams(CFConvParams(*t[:_EDGE_TENSORS]), *t[_EDGE_TENSORS:]))
    return ModelParams(flat[0], flat[1], tuple(layers), *flat[2 + depth * _LAYER_TENSORS :])


def make_hidden_fn(*, n_heads: int = 4, update: Sequence[bool] | bool = True,
                   batch_tile: int = 8, matmul_dtype=None, precision=None,
                   edge_matmul_dtype=None, edge_precision=None, resid_dtype=torch.float32,
                   resid_lowp=None, pad_atoms: bool = False, want_x: bool = False,
                   interpret: bool = False):
    """Build ``hidden(params: ModelParams, h (B, N, F_in), x (B, N, 3), mask
    (B, N, N) or None) -> h_fin (B, N, F)``, the JAX ``make_hidden_fn``
    (``:1376-1915``) on the port's kernels.

    With autograd recording (grad enabled and some input requiring grad) it
    is a ``torch.autograd.Function``: the forward runs K1 (:func:`resid_fwd`,
    with the mask) and keeps its boundaries and residuals; the backward runs
    :func:`resid_train_bwd` and the embedding pullback (both with
    ``cluster=True``: the cluster kernels), so gradients reach
    every layer leaf, the embedding, ``h`` and ``x``. The readout leaves get
    zeros (the head that reads ``h_fin`` gives them theirs) and ``mask``
    none. Otherwise (the JAX primal-outside-autodiff rule, ``:1819-1821``)
    it runs :func:`resid_infer`, which writes no residuals.

    ``edge_matmul_dtype`` and ``resid_dtype`` both bf16 (``resid_lowp`` None or
    ``RESID_LOWP``) run every kernel in the bf16 tier, as JAX's ``qm9_kernel``
    trains (:func:`resid_energy_forces` says which combinations raise). Not
    ported yet, and raising when asked for: ``want_x`` (the forecast shape with
    a position output). Accepted with no counterpart: ``batch_tile`` and
    ``pad_atoms`` (one molecule per block, N as it comes), the precisions
    (every f32 product is f32) and ``interpret`` (CPU tensors take the plain
    versions).
    """
    if want_x:
        raise NotImplementedError("make_hidden_fn: want_x is not ported yet")
    bf16 = _bf16_edge_tier("make_hidden_fn", matmul_dtype=matmul_dtype,
                           edge_matmul_dtype=edge_matmul_dtype, resid_dtype=resid_dtype,
                           resid_lowp=resid_lowp, lowp=RESID_LOWP)

    def prep(params, h, x, mask):
        upd = [1.0 if u else 0.0 for u in per_layer(update, len(params.layers))]
        leaves = wide_stack(params, n_heads)
        h0 = embed(params, h).contiguous()
        xs = x.permute(2, 0, 1).contiguous()
        m4 = mask[..., None].float().contiguous() if mask is not None else None
        return leaves, upd, h0, xs, m4

    class Hidden(torch.autograd.Function):
        @staticmethod
        def forward(ctx, mask, h, x, *flat):
            params = _unflat_params(flat, (len(flat) - 6) // _LAYER_TENSORS)
            leaves, upd, h0, xs, m4 = prep(params, h, x, mask)
            fwd = resid_fwd(leaves, h0, xs, torch.zeros_like(xs), upd, mask=m4, cluster=True,
                            bf16=bf16)
            # h_fin is this function's output: keep the rest, not a cycle through it
            ctx.fwd, ctx.leaves, ctx.upd, ctx.m4 = fwd._replace(h_fin=None), leaves, upd, m4
            ctx.readout = flat[-4:]
            ctx.save_for_backward(h, params.w_embed)
            return fwd.h_fin

        @staticmethod
        def backward(ctx, dh_fin):
            h, w_embed = ctx.saved_tensors
            B, N, F = dh_fin.shape
            zeros = torch.zeros(3, B, N, device=dh_fin.device, dtype=dh_fin.dtype)
            dh0, dx, _, g = resid_train_bwd(ctx.leaves, ctx.fwd, ctx.upd,
                                            dh_fin.contiguous(), zeros, zeros, ctx.m4,
                                            cluster=True)
            # embedding pullback, h0 = h @ w_embed + b_embed (plain torch, as in JAX)
            h2, dh2 = h.reshape(B * N, -1), dh0.reshape(B * N, F)
            d_params = [h2.T @ dh2, dh2.sum(dim=0)]
            for l in range(len(ctx.upd)):
                lp = unsplit_layer_grads({n: g[n][l] for n in LEAF_NAMES})
                d_params += [*lp.edge, *lp[1:]]
            return (None, (dh2 @ w_embed.T).reshape(h.shape), dx.permute(1, 2, 0),
                    *d_params, *[torch.zeros_like(t) for t in ctx.readout])

    def hidden(params: ModelParams, h, x, mask=None):
        flat = flat_params(params)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (h, x, *flat)):
            return Hidden.apply(mask, h, x, *flat)
        with torch.no_grad():
            leaves, upd, h0, xs, m4 = prep(params, h, x, mask)
            return resid_infer(leaves, h0, xs, torch.zeros_like(xs), upd, mask=m4, bf16=bf16)[0]

    return hidden

