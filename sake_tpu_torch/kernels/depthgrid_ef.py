"""The wide layer formulation of the depth-grid kernels.

Port of ``sake_tpu/kernels/depthgrid_ef.py:146-258``: :func:`layer_forward_wide`,
one dense SAKE layer on the wide-stacked leaves of :func:`leaves.wide_stack`
(always updating, gated by ``upd``), the per-head loop replaced by the wide
head expansion. It is the plain torch layer that the retrace mode of
``train2_ef.make_ef_train2`` differentiates (``torch.func.jvp`` for #16,
``torch.func.vjp`` of that for #17); the kernels of that mode run the
residual-saving bodies, so this function is also an independent check of
them. The depth-grid energy kernels themselves (#23, #24) are not ported
yet.
"""

from __future__ import annotations

import torch

from sake_tpu_torch.kernels.functional import EPSILON, INF, _celu2, _silu
from sake_tpu_torch.kernels.leaves import head_expansion_matrices


def layer_forward_wide(p: dict, h, xp, vp, upd, *, n_real=None):
    """One dense SAKE layer on one layer's wide leaves ``p``.

    ``h (B, N, F)``, ``xp``/``vp`` three ``(B, N, 1)`` planes, ``upd`` in
    [0, 1] gating the x/v update. ``n_real``: when the last ``N - n_real``
    atoms are padding, pad senders are masked out of the attention and the
    mean divisors use ``n_real``. Returns ``(h_out, xp_out, vp_out)``. As in
    JAX, the attended edges are ``(h_e @ E_rep) * (att @ E_tile)`` with the
    0/1 head expansion matrices."""
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
    o_f = (rbf * pre) @ p["w_o_f"]
    e0 = (h @ p["w_o_j"])[:, None] + (h @ p["w_o_i"])[:, :, None] + o_f + r * p["w_o_r"][0] \
        + p["b_o0"]
    h_e = _silu(e0) @ p["w_o1"] + p["b_o1"]

    # semantic attention over senders j
    logits = _celu2(h_e @ p["w_sem"] + p["b_sem"])
    logits = logits - INF * torch.eye(N, dtype=h.dtype, device=h.device)[None, :, :, None]
    if n_real is not None and n_real < N:
        pad = (torch.arange(N, device=h.device) >= n_real).to(h.dtype)
        logits = logits - INF * pad[None, None, :, None]
    att = torch.softmax(logits, dim=-2)

    # attended edges, wide (hidden-major / head-minor)
    h_e_att = (h_e @ e_rep) * (att @ e_tile)
    coeff = torch.tanh(h_e_att @ p["w_xmix"])

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
