"""Functional SAKE model in PyTorch — the port's plain reference.

Port of ``sake_tpu/kernels/functional.py``: the same parameter NamedTuples
(``CFConvParams``/``LayerParams``/``ModelParams``), the same constants and
the same node-factorized layer math on coordinate planes. Forces come from
``torch.autograd.grad`` instead of the JAX package's hand-staged VJP; the
two agree to f32 reassociation (``tests/test_torch_functional.py``).

``matmul_dtype=torch.bfloat16`` is the JAX ``_make_mm`` rule: every product
``mm(a, w)`` multiplies ``bf16(a)`` by ``bf16(w)`` and sums in f32 (the
products of two bf16 values are exact in f32). Its pullback under autograd
is the JAX one, ``d_a = bf16(g @ bf16(w)^T)``: the backward of the two
casts rounds the cotangent. Biases, ``r``, ``r * w_o_r``, the RBF, the
activations, the softmax and the pooled sums stay f32, as in JAX. The
x-mixing product then takes the JAX per-head form (``bf16(h_e) @
w_xmix[:, k, :]`` scaled by ``att_k``), since the wide ``h_e (x) att``
product would round a tensor JAX never forms.

Constants that must match the JAX package exactly:

- EPSILON inside the square root of the pairwise distance;
- self pairs (and masked pairs) pushed down by ``INF = 1e5`` on the
  logits, never to ``-inf``;
- celu with alpha 2 written as ``2 * (exp(x/2) - 1)``;
- unit displacements ``d / (r + 1e-5)``;
- pooled sums divided by ``N`` unmasked, by the sender count when masked.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

EPSILON = 1e-5
INF = 1e5


class CFConvParams(NamedTuple):
    """ContinuousFilterConv: mlp_in, RBF (means/betas), mlp_out (2 Dense)."""

    w_in: torch.Tensor  # (2F, R)
    b_in: torch.Tensor  # (R,)
    rbf_means: torch.Tensor  # (R,)
    rbf_betas: torch.Tensor  # (R,)
    w_out0: torch.Tensor  # (2F + R + 1, H)
    b_out0: torch.Tensor  # (H,)
    w_out1: torch.Tensor  # (H, H)
    b_out1: torch.Tensor  # (H,)


class LayerParams(NamedTuple):
    edge: CFConvParams
    w_sem: torch.Tensor  # (H, K)
    b_sem: torch.Tensor  # (K,)
    w_xmix: torch.Tensor  # (H*K, C), rows hidden-major / head-minor
    w_post0: torch.Tensor  # (C, H)
    b_post0: torch.Tensor
    w_post1: torch.Tensor  # (H, H)
    b_post1: torch.Tensor
    w_node0: torch.Tensor  # (F + H*K + H, H)
    b_node0: torch.Tensor
    w_node1: torch.Tensor  # (H, F)
    b_node1: torch.Tensor
    # update head (zero placeholders when the layer has no update)
    w_vmix: torch.Tensor  # (C, 1)
    w_vel0: torch.Tensor  # (F, H)
    b_vel0: torch.Tensor
    w_vel1: torch.Tensor  # (H, 1)


class ModelParams(NamedTuple):
    w_embed: torch.Tensor  # (F_in, H)
    b_embed: torch.Tensor
    layers: tuple  # tuple[LayerParams, ...]
    w_out0: torch.Tensor  # (H, H)
    b_out0: torch.Tensor
    w_out1: torch.Tensor  # (H, out)
    b_out1: torch.Tensor


def params_to(p: ModelParams, device) -> ModelParams:
    """A copy of ``p`` with every tensor on ``device``."""
    mv = lambda t: t.to(device)
    layers = tuple(
        LayerParams(CFConvParams(*map(mv, lp.edge)), *map(mv, lp[1:])) for lp in p.layers
    )
    return ModelParams(mv(p.w_embed), mv(p.b_embed), layers,
                       *map(mv, (p.w_out0, p.b_out0, p.w_out1, p.b_out1)))


def _f32_only(name, *dtypes):
    """Raise on the JAX package's bf16 tier: any of ``dtypes`` other than
    None or f32 (the port computes in f32 only)."""
    if any(d not in (None, torch.float32) for d in dtypes):
        raise NotImplementedError(f"{name}: the port computes in f32 only")


def _bf16_edge_tier(name, *, matmul_dtype, edge_matmul_dtype, resid_dtype, resid_lowp,
                    lowp, **f32_only) -> bool:
    """The counterpart of :func:`_f32_only` for ``resid_ef``'s one bf16 tier,
    the JAX package's production setting: True for ``edge_matmul_dtype`` and
    ``resid_dtype`` both bf16, False for both None or f32, with ``resid_lowp``
    None or equal to ``lowp`` (the default low-precision set) either way. Every
    other combination raises, naming it: bf16 node products (``matmul_dtype``),
    the keywords of ``f32_only`` other than None or f32 (``pool_dtype``,
    ``pool_matmul_dtype``), another ``resid_lowp``, and bf16 edge products
    with f32 residual streams or the reverse."""
    if matmul_dtype not in (None, torch.float32):
        raise NotImplementedError(f"{name}: matmul_dtype={matmul_dtype} (bf16 node products) "
                                  "is not ported; the port's bf16 tier is edge_matmul_dtype "
                                  "and resid_dtype bf16")
    for kw, d in f32_only.items():
        if d not in (None, torch.float32):
            raise NotImplementedError(f"{name}: {kw}={d} is not ported")
    if resid_lowp is not None and set(resid_lowp) != set(lowp):
        raise NotImplementedError(f"{name}: resid_lowp={sorted(resid_lowp)} is not ported; "
                                  "only the default set (every residual but r and t)")
    tiers = []
    for kw, d in (("edge_matmul_dtype", edge_matmul_dtype), ("resid_dtype", resid_dtype)):
        if d not in (None, torch.float32, torch.bfloat16):
            raise NotImplementedError(f"{name}: {kw}={d} is not ported")
        tiers.append(d is torch.bfloat16)
    if tiers[0] != tiers[1]:
        raise NotImplementedError(
            f"{name}: edge_matmul_dtype={edge_matmul_dtype} with resid_dtype={resid_dtype} is "
            "not ported; bf16 edge products and bf16 residual streams go together")
    return tiers[0]


def is_bf16(name, matmul_dtype) -> bool:
    """True for ``torch.bfloat16``, False for None or f32; any other
    ``matmul_dtype`` raises."""
    if matmul_dtype is torch.bfloat16:
        return True
    _f32_only(name, matmul_dtype)
    return False


def bf16_round(t):
    """``t`` rounded to bf16 (nearest, ties to even), as f32."""
    return t.to(torch.bfloat16).float()


def _make_mm(matmul_dtype):
    """``mm(a, w)``: ``a @ w`` in f32, or the JAX bf16 product (operands
    rounded to bf16, f32 sums); any ``matmul_dtype`` but None, f32 and bf16
    raises."""
    if not is_bf16("matmul_dtype", matmul_dtype):
        return torch.matmul
    return lambda a, w: bf16_round(a) @ bf16_round(w)


def _silu(x):
    return x * torch.sigmoid(x)


def _celu2(x):
    """celu with alpha=2, as ``2 * (exp(x/2) - 1)`` below zero."""
    return torch.where(x > 0, x, 2.0 * (torch.exp(x / 2.0) - 1.0))


def per_layer(update: Sequence[bool] | bool, depth: int) -> list:
    if isinstance(update, bool):
        return [update] * depth
    update = list(update)
    if len(update) != depth:
        raise ValueError(f"update schedule has {len(update)} entries, depth {depth}")
    return update


def pairwise_geometry_planes(x_planes):
    """3 planes ``(B, N, 1)`` -> (``d_k[b,i,j] = x_k[b,j] - x_k[b,i]`` as
    3 x ``(B, N, N, 1)``, EPSILON-regularized distance ``r (B, N, N, 1)``)."""
    d = [p[:, None, :, :] - p[:, :, None, :] for p in x_planes]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return d, torch.sqrt(torch.relu(r2) + EPSILON)


def layer_forward_planes(
    p: LayerParams,
    h: torch.Tensor,  # (B, N, F)
    x_planes,  # 3 x (B, N, 1)
    v_planes,  # 3 x (B, N, 1) or None
    *,
    n_heads: int,
    update: bool,
    mask: Optional[torch.Tensor] = None,  # (B, N, N) edge mask
    matmul_dtype=None,
):
    """One dense SAKE layer on coordinate planes."""
    B, N, F = h.shape
    H = p.edge.w_out0.shape[-1]
    K = n_heads
    mm = _make_mm(matmul_dtype)
    mask4 = mask[..., None] if mask is not None else None

    d_planes, r = pairwise_geometry_planes(x_planes)

    # --- edge model (CFConv), node-factorized ---------------------------
    a_j = mm(h, p.edge.w_in[:F])
    a_i = mm(h, p.edge.w_in[F:])
    pre = a_j[:, None, :, :] + a_i[:, :, None, :] + p.edge.b_in
    rbf = torch.exp(-p.edge.rbf_betas * (torch.exp(-r) - p.edge.rbf_means) ** 2)
    filtered = rbf * pre  # (B, N, N, R)
    R = filtered.shape[-1]
    o_j = mm(h, p.edge.w_out0[:F])
    o_i = mm(h, p.edge.w_out0[F : 2 * F])
    o_f = mm(filtered, p.edge.w_out0[2 * F : 2 * F + R])
    o_r = r * p.edge.w_out0[2 * F + R]
    e0 = o_j[:, None, :, :] + o_i[:, :, None, :] + o_f + o_r + p.edge.b_out0
    h_e = mm(_silu(e0), p.edge.w_out1) + p.edge.b_out1  # (B, N, N, H)

    # --- semantic attention (softmax over senders j) --------------------
    logits = _celu2(mm(h_e, p.w_sem) + p.b_sem)
    eye = torch.eye(N, dtype=logits.dtype, device=logits.device)
    logits = logits - INF * eye[None, :, :, None]
    if mask4 is not None:
        logits = logits - INF * (1.0 - mask4)
    att = torch.softmax(logits, dim=-2)  # (B, N, N, K)
    if mask4 is not None:
        att = att * mask4
        denom = att.sum(dim=-2, keepdim=True)
        att = att / torch.where(denom == 0.0, torch.ones_like(denom), denom)

    w_agg = p.w_node0[F : F + H * K]  # rows hidden-major / head-minor: h*K + k
    if matmul_dtype is torch.bfloat16:
        # the JAX per-head form: x-mixing of bf16(h_e) scaled by att_k, the
        # attended sum a_k = sum_j h_e att_k rounded into the node MLP
        C = p.w_xmix.shape[-1]
        w_xmix_hk, w_agg_hk = p.w_xmix.reshape(H, K, C), w_agg.reshape(H, K, -1)
        coeff_pre, agg_term = 0.0, 0.0
        for k in range(K):
            att_k = att[..., k : k + 1]
            coeff_pre = coeff_pre + att_k * mm(h_e, w_xmix_hk[:, k, :])
            agg_term = agg_term + mm((h_e * att_k).sum(dim=-2), w_agg_hk[:, k, :])
        coeff = torch.tanh(coeff_pre)
    else:
        # attended edges, hidden-major / head-minor: column h*K + k
        h_e_att = (h_e[..., :, None] * att[..., None, :]).reshape(B, N, N, H * K)
        coeff = torch.tanh(h_e_att @ p.w_xmix)  # (B, N, N, C)
        agg_term = h_e_att.sum(dim=-2) @ w_agg
    if mask4 is not None:
        coeff = coeff * mask4

    # --- spatial attention, pooled (no (N, N, C, 3) tensor) -------------
    inv_r = 1.0 / (r + 1e-5)
    pooled = [(coeff * (d_planes[k] * inv_r)).sum(dim=-2) for k in range(3)]
    if mask4 is not None:
        count = mask4.sum(dim=-2)  # (B, N, 1)
        norm_pool = [pk / (count + 1e-8) for pk in pooled]
    else:
        norm_pool = [pk / float(N) for pk in pooled]
    pool_sq = norm_pool[0] ** 2 + norm_pool[1] ** 2 + norm_pool[2] ** 2
    h_comb = _silu(mm(_silu(mm(pool_sq, p.w_post0) + p.b_post0), p.w_post1) + p.b_post1)

    # --- node update: concat-free first Dense ----------------------------
    node_pre = (
        mm(h, p.w_node0[:F])
        + agg_term
        + mm(h_comb, p.w_node0[F + H * K :])
        + p.b_node0
    )
    h_out = h + _silu(mm(_silu(node_pre), p.w_node1) + p.b_node1)

    if not update:
        return h_out, x_planes, v_planes

    # --- velocity/position update ----------------------------------------
    dv_denom = mask4.sum(dim=-2) + 1e-10 if mask4 is not None else float(N)
    delta = [mm(pk, p.w_vmix) / dv_denom for pk in pooled]
    if v_planes is not None:
        gate = 2.0 * torch.sigmoid(mm(_silu(mm(h_out, p.w_vel0) + p.b_vel0), p.w_vel1))
        v_new = [gate * vk + dk for vk, dk in zip(v_planes, delta)]
    else:
        v_new = delta
    x_new = [xk + vk for xk, vk in zip(x_planes, v_new)]
    return h_out, x_new, v_new


def embed(p: ModelParams, h, matmul_dtype=None):
    return _make_mm(matmul_dtype)(h, p.w_embed) + p.b_embed


def readout(p: ModelParams, h, matmul_dtype=None):
    mm = _make_mm(matmul_dtype)
    return mm(_silu(mm(h, p.w_out0) + p.b_out0), p.w_out1) + p.b_out1


def model_forward_planes(p, h, x_planes, v_planes=None, *, n_heads=4,
                         update: Sequence[bool] | bool = True, mask=None, matmul_dtype=None):
    h = embed(p, h, matmul_dtype)
    for lp, upd in zip(p.layers, per_layer(update, len(p.layers))):
        h, x_planes, v_planes = layer_forward_planes(
            lp, h, x_planes, v_planes, n_heads=n_heads, update=upd, mask=mask,
            matmul_dtype=matmul_dtype,
        )
    return readout(p, h, matmul_dtype), x_planes, v_planes


def model_forward(
    p: ModelParams,
    h: torch.Tensor,  # (B, N, F_in)
    x: torch.Tensor,  # (B, N, 3)
    v: Optional[torch.Tensor] = None,
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    mask: Optional[torch.Tensor] = None,
    matmul_dtype=None,
):
    """``(out (B, N, out), x (B, N, 3), v (B, N, 3) or None)``.
    ``matmul_dtype``: None (or f32) or ``torch.bfloat16`` (the JAX bf16
    products, see the module docstring); any other raises."""
    is_bf16("model_forward", matmul_dtype)
    x_planes = [x[..., k : k + 1] for k in range(3)]
    v_planes = [v[..., k : k + 1] for k in range(3)] if v is not None else None
    out, xp, vp = model_forward_planes(
        p, h, x_planes, v_planes, n_heads=n_heads, update=update, mask=mask,
        matmul_dtype=matmul_dtype,
    )
    v_out = torch.cat(vp, dim=-1) if vp is not None else None
    return out, torch.cat(xp, dim=-1), v_out


def flat_params(p: ModelParams) -> list:
    """The tensors of ``p`` in a fixed order: embedding, each layer's
    ``CFConvParams`` then its other fields, readout."""
    out = [p.w_embed, p.b_embed]
    for lp in p.layers:
        out += [*lp.edge, *lp[1:]]
    return out + [p.w_out0, p.b_out0, p.w_out1, p.b_out1]


def energy_and_forces_fn(
    p: ModelParams,
    h: torch.Tensor,
    x: torch.Tensor,  # (B, N, 3)
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    mask: Optional[torch.Tensor] = None,
    matmul_dtype=None,
):
    """Raw energy ``e (B,)`` (readout summed over atoms and outputs, no
    node mask — as the JAX function) and forces ``f = -dE/dx (B, N, 3)``.
    ``matmul_dtype`` as in :func:`model_forward`.

    Differentiable in ``p``, ``h`` and ``x``, as the JAX function: when
    autograd records (grad enabled and some input requiring grad) the force
    keeps its graph (``create_graph``), so a loss of ``(e, f)`` has
    second-order gradients. Otherwise both come back detached."""
    is_bf16("energy_and_forces_fn", matmul_dtype)
    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in (h, x, *flat_params(p)))
    with torch.enable_grad():
        xg = x if x.requires_grad else x.detach().requires_grad_(True)
        out, _, _ = model_forward(p, h, xg, n_heads=n_heads, update=update, mask=mask,
                                  matmul_dtype=matmul_dtype)
        e = out.sum(dim=(-2, -1))
        (g,) = torch.autograd.grad(e.sum(), xg, create_graph=record)
    if not record:
        return e.detach(), -g
    return e, -g
