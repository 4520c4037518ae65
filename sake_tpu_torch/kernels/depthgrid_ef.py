"""The wide layer formulation and the depth-grid E + F kernels (#23, #24).

Port of ``sake_tpu/kernels/depthgrid_ef.py``:

- :func:`layer_forward_wide` (JAX ``:146-258``), one dense SAKE layer on the
  wide-stacked leaves of :func:`leaves.wide_stack` (always updating, gated by
  ``upd``), the per-head loop replaced by the wide head expansion. It is the
  plain torch layer that the retrace mode of ``train2_ef.make_ef_train2``
  differentiates (``torch.func.jvp`` for #16, ``torch.func.vjp`` of that for
  #17), and the layer of the plain versions here.
- :func:`depthgrid_energy_forces` (JAX ``:313-508``): embed, #23
  (:func:`depthgrid_fwd`; JAX ``fwd_kernel`` ``:360``, pallas_call ``:400``),
  the readout seed, #24 (:func:`depthgrid_bwd`; JAX ``bwd_kernel`` ``:438``,
  pallas_call ``:487``), ``F = -dx``. The JAX kernels put depth on the grid's
  inner axis and carry the state in VMEM scratch between grid steps; CUDA
  blocks of one grid run in no order, so here each layer is one launch of
  ``csrc/remat_ef.cu`` (the bodies of #21 and #22 in ``fori_ef``), the carried
  state and cotangent in device memory between launches. Each wrapper takes
  its plain version (:func:`depthgrid_fwd_plain`, :func:`depthgrid_bwd_plain`:
  the wide layer and its ``torch.func.vjp``) only for CPU tensors; on a CUDA
  tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sake_tpu_torch.kernels.fori_ef import (
    ROUTES,
    Bounds,
    _bwd_setup,
    _fwd_setup,
    _launch_bwd,
    _launch_fwd,
    remat_energy_forces,
    stack_plain,
)
from sake_tpu_torch.kernels.functional import (
    EPSILON,
    INF,
    ModelParams,
    _celu2,
    _f32_only,
    _silu,
    bf16_round,
)
from sake_tpu_torch.kernels.leaves import head_expansion_matrices, layer_leaves
from sake_tpu_torch.kernels.resid_ef import _edge_mm, _planes, _unplanes


def layer_forward_wide(p: dict, h, xp, vp, upd, *, n_real=None, bf16=False, mm=None):
    """One dense SAKE layer on one layer's wide leaves ``p``.

    ``h (B, N, F)``, ``xp``/``vp`` three ``(B, N, 1)`` planes, ``upd`` in
    [0, 1] gating the x/v update. ``n_real``: when the last ``N - n_real``
    atoms are padding, pad senders are masked out of the attention and the
    mean divisors use ``n_real``. Returns ``(h_out, xp_out, vp_out)``. As in
    JAX, the attended edges are ``(h_e @ E_rep) * (att @ E_tile)`` with the
    0/1 head expansion matrices. ``bf16``: JAX's ``mm_edge`` in bf16 (resid_ef's
    bf16 tier): o_f, o1, the semantic logits, both head expansions and the
    x-mixing take both operands rounded to bf16, f32 sums; node products f32.
    ``mm``: ``mm(a, leaf)`` in place of the four edge products ``a @ p[leaf]``
    (``EDGE_MM_LEAVES``, by their weight; default ``_edge_mm(bf16)``)."""
    B, N, F = h.shape
    K = p["w_sem"].shape[-1]
    H = p["w_o_j"].shape[-1]
    e_rep, e_tile = (m.to(h) for m in head_expansion_matrices(H, K, device=h.device))
    n_eff = float(n_real if n_real is not None else N)

    d0 = [pk[:, None, :, :] - pk[:, :, None, :] for pk in xp]
    r = torch.sqrt(torch.relu(d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2]) + EPSILON)

    # edge model (CFConv), node-factorized
    a_j = h @ p["w_in_j"] + p["b_in"]
    a_i = h @ p["w_in_i"]
    pre = a_j[:, None, :, :] + a_i[:, :, None, :]
    rbf = torch.exp(-p["rbf_b"] * (torch.exp(-r) - p["rbf_m"]) ** 2)
    rd = bf16_round if bf16 else (lambda t: t)
    me = mm or (lambda a, leaf: _edge_mm(bf16)(a, p[leaf]))
    o_f = me(rbf * pre, "w_o_f")
    e0 = (h @ p["w_o_j"])[:, None] + (h @ p["w_o_i"])[:, :, None] + o_f + r * p["w_o_r"][0] \
        + p["b_o0"]
    h_e = me(_silu(e0), "w_o1") + p["b_o1"]

    # semantic attention over senders j
    logits = _celu2(me(h_e, "w_sem") + p["b_sem"])
    logits = logits - INF * torch.eye(N, dtype=h.dtype, device=h.device)[None, :, :, None]
    if n_real is not None and n_real < N:
        pad = (torch.arange(N, device=h.device) >= n_real).to(h.dtype)
        logits = logits - INF * pad[None, None, :, None]
    att = torch.softmax(logits, dim=-2)

    # attended edges, wide (hidden-major / head-minor)
    h_e_att = (rd(h_e) @ e_rep) * (rd(att) @ e_tile)
    coeff = torch.tanh(me(h_e_att, "w_xmix"))

    # pooled spatial attention
    inv_r = 1.0 / (r + 1e-5)
    pooled = [(coeff * (d0[k] * inv_r)).sum(dim=-2) for k in range(3)]
    norm = [pk / n_eff for pk in pooled]
    pool_sq = norm[0] ** 2 + norm[1] ** 2 + norm[2] ** 2
    h_comb = _silu(_silu(pool_sq @ p["w_post0"] + p["b_post0"]) @ p["w_post1"] + p["b_post1"])

    # node update
    node_pre = (h @ p["w_node_h"] + h_e_att.sum(dim=-2) @ p["w_node_agg"]
                + h_comb @ p["w_node_comb"] + p["b_node0"])
    h_out = h + _silu(_silu(node_pre) @ p["w_node1"] + p["b_node1"])

    # velocity / position update, arithmetically gated
    delta = [pk @ p["w_vmix"] / n_eff for pk in pooled]
    gate = 2.0 * torch.sigmoid(_silu(h_out @ p["w_vel0"] + p["b_vel0"]) @ p["w_vel1"])
    v_new = [gate * vk + dk for vk, dk in zip(vp, delta)]
    x_new = [xk + vk for xk, vk in zip(xp, v_new)]
    xp_out = [xk + upd * (xn - xk) for xk, xn in zip(xp, x_new)]
    vp_out = [vk + upd * (vn - vk) for vk, vn in zip(vp, v_new)]
    return h_out, xp_out, vp_out


def depthgrid_fwd_plain(leaves: dict, h0, xs, upd: Sequence[float]) -> Bounds:
    """Plain version of :func:`depthgrid_fwd`: :func:`layer_forward_wide`
    over depth (:func:`fori_ef.stack_plain`)."""
    return stack_plain(layer_forward_wide, leaves, h0, xs, upd)


def depthgrid_bwd_plain(leaves: dict, bnd: Bounds, upd: Sequence[float], dh_fin):
    """Plain version of :func:`depthgrid_bwd` (JAX ``bwd_kernel`` ``:438``):
    per layer in reverse, ``torch.func.vjp`` of :func:`layer_forward_wide`
    from the layer's boundary, from ``(dh_fin, 0, 0)``. Returns ``(dh0, dx (3,
    B, N), dv (3, B, N))``."""
    zeros = _planes(torch.zeros_like(bnd.bx[0]))
    cot = (dh_fin, zeros, zeros)
    for l in reversed(range(len(upd))):
        p, u = layer_leaves(leaves, l), upd[l]
        _, vjp = torch.func.vjp(lambda h, xp, vp: layer_forward_wide(p, h, xp, vp, u),
                                bnd.bh[l], _planes(bnd.bx[l]), _planes(bnd.bv[l]))
        cot = vjp(cot)
    return cot[0], _unplanes(cot[1]), _unplanes(cot[2])


def depthgrid_fwd(leaves: dict, h0, xs, upd: Sequence[float]) -> Bounds:
    """#23: the layer stack's forward from ``(h0 (B, N, F), xs (3, B, N), v
    = 0)``, one launch per layer, the state carried in device memory from
    launch to launch; each launch writes the state entering its layer.
    Returns :class:`fori_ef.Bounds`. CPU tensors take the plain version. On the
    card each launch takes the kernel the shape selects
    (``fori_ef.fwd_tensor_core_route``), counted in ``depthgrid_fwd.launches``
    and under its route in ``depthgrid_fwd.routes``."""
    if h0.device.type == "cpu":
        return depthgrid_fwd_plain(leaves, h0, xs, upd)
    lib, dims, upd_t, out, pool, route = _fwd_setup("depthgrid_fwd", leaves, h0, xs, upd)
    h, x, v = out.h_fin, xs.clone(), torch.zeros_like(xs)  # the carry, in place
    h.copy_(h0)
    for l in range(dims[7]):
        _launch_fwd(lib, dims, l, l + 1, h, x, v, upd_t, leaves, out, pool, h, x, v,
                    "depthgrid_fwd")
        depthgrid_fwd.launches += 1
        depthgrid_fwd.routes[route] += 1
    return out


depthgrid_fwd.launches = 0
depthgrid_fwd.routes = dict.fromkeys(ROUTES, 0)


def depthgrid_bwd(leaves: dict, bnd: Bounds, upd: Sequence[float], dh_fin, *,
                  leaves_t: Optional[dict] = None):
    """#24: the pullback of ``(dh_fin (B, N, F), 0, 0)``, one launch per layer
    in reverse, each re-running its layer from the boundary in ``bnd`` (#23's
    output), the cotangent carried in device memory from launch to launch.
    Returns ``(dh0, dx (3, B, N), dv (3, B, N))``. CPU tensors take the plain
    version. Each launch counts in ``depthgrid_bwd.launches`` and in
    ``depthgrid_bwd.routes`` under its route (``fori_ef.tensor_core_route``)."""
    if dh_fin.device.type == "cpu":
        return depthgrid_bwd_plain(leaves, bnd, upd, dh_fin)
    lib, dims, upd_t, leaves_t, res, route = _bwd_setup("depthgrid_bwd", leaves, bnd, upd,
                                                        dh_fin, leaves_t)
    dh, dx = dh_fin.clone(), torch.zeros_like(bnd.bx[0])  # the carry, in place
    dv = torch.zeros_like(dx)
    for l in reversed(range(dims[7])):
        _launch_bwd(lib, dims, l, l, bnd, upd_t, leaves, leaves_t, res, dh, dx, dv, dh, dx, dv,
                    "depthgrid_bwd")
        depthgrid_bwd.launches += 1
        depthgrid_bwd.routes[route] += 1
    return dh, dx, dv


depthgrid_bwd.launches = 0
depthgrid_bwd.routes = dict.fromkeys(ROUTES, 0)


@torch.no_grad()
def depthgrid_energy_forces(
    params: ModelParams,
    h: torch.Tensor,  # (B, N, F_in)
    x: torch.Tensor,  # (B, N, 3)
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    batch_tile: int = 8,
    matmul_dtype=None,
    precision=None,
    edge_matmul_dtype=None,
    edge_precision=None,
    interpret: bool = False,
    chunk: Optional[int] = 512,
):
    """Raw (uncolored) ``E (B,)`` and ``F = -dE/dx (B, N, 3)`` through #23,
    the readout seed and #24, per chunk of ``chunk`` molecules (the one-layer
    residual scratch of #24, about 0.87 MB per aspirin molecule). The JAX
    keywords under the policy of :func:`fori_ef.fori_energy_forces`: the bf16
    tier raises; ``batch_tile``, the precisions and ``interpret`` have no
    counterpart."""
    _f32_only("depthgrid_energy_forces", matmul_dtype, edge_matmul_dtype)
    return remat_energy_forces(depthgrid_fwd, depthgrid_bwd, params, h, x, n_heads, update,
                               chunk)
