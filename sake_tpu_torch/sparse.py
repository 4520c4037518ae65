"""Cutoff-sparse (neighbour-list) SAKE: O(N·K) edge work.

Port of ``sake_tpu/sparse.py``: the geometry helpers (``_min_image``,
``_gather``, :func:`densify_neighbors`), the all-pairs
:func:`neighbor_list` and the grid-binned :func:`cell_neighbor_list`, and the
plain sparse model (:func:`sparse_layer_forward`,
:func:`sparse_model_forward`, :func:`make_sparse_energy_forces`). The model
is the masked dense SAKE layer evaluated on gathered neighbours: for any
neighbour graph G, ``sparse_model_forward(idx, mask)`` equals the dense
``kernels.functional.model_forward(mask=densify_neighbors(G))``.

Differences from the JAX package:

- ``lax.top_k`` becomes ``torch.topk``: the two order tied scores
  differently, and masked slots hold arbitrary in-range indices, so two
  lists agree as sets of live ``(receiver, sender)`` pairs, not slot by slot;
- ``lax.map`` over row chunks and ``vmap`` over the batch become Python
  loops; ``jnp.argsort`` (stable) becomes ``torch.argsort(stable=True)``, so
  the atoms a full cell drops are the same ones;
- ``remat`` checkpoints each layer with ``torch.utils.checkpoint``
  (non-reentrant, so a force loss can differentiate through it twice);
- ``matmul_dtype`` is accepted for the JAX signature; the port's sparse
  path is f32 and any other value raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from sake_tpu_torch.kernels.functional import (
    EPSILON,
    INF,
    LayerParams,
    ModelParams,
    _celu2,
    _silu,
    embed,
    flat_params,
    per_layer,
    readout,
)


def _f32_only(**dtypes):
    """Raise for any of ``dtypes`` (name -> dtype or None) other than f32:
    the port's sparse path and its kernels are f32 only (the bf16 tier is
    queued in ROADMAP)."""
    for name, dt in dtypes.items():
        if dt not in (None, torch.float32):
            raise NotImplementedError(f"{name}: the port's sparse path is f32 only")


def _min_image(diff: torch.Tensor, box) -> torch.Tensor:
    """Orthorhombic minimum image: wrap displacement components into
    ``[-L/2, L/2)``. ``round`` (half to even, as ``jnp.round``) is piecewise
    constant, so gradients flow through ``diff`` untouched."""
    box = torch.as_tensor(box, dtype=diff.dtype, device=diff.device)
    return diff - box * torch.round(diff / box)


def neighbor_list(
    x: torch.Tensor,  # (B, N, 3)
    cutoff: float,
    max_neighbors: int,
    *,
    node_mask: Optional[torch.Tensor] = None,  # (B, N) 1 = real atom
    row_chunk: int = 1024,
    box=None,  # (3,) orthorhombic periodic box, or None for open boundaries
    with_overflow: bool = False,
):
    """K nearest senders within ``cutoff``, static shapes.

    Returns ``(idx (B, N, K) int64, nbr_mask (B, N, K) float32)``; invalid
    slots (outside the cutoff, self, padded atoms, or beyond the K nearest)
    have mask 0 and an arbitrary in-range index. Receiver rows go in chunks
    of ``row_chunk`` (one chunk when it does not divide N), so peak memory is
    O(N·row_chunk). With ``box``, distances use the minimum image (requires
    ``cutoff <= min(box) / 2``). ``with_overflow=True`` also returns the
    per-batch count of in-cutoff senders dropped beyond K (0: the list is
    exact)."""
    B, N, _ = x.shape
    K = min(max_neighbors, N)
    rc = row_chunk if N % row_chunk == 0 else N
    c2 = float(cutoff) ** 2
    j_ids = torch.arange(N, device=x.device)
    idx_c, m_c = [], []
    dropped = torch.zeros(B, dtype=torch.int64, device=x.device)
    for s in range(0, N, rc):
        i_ids = j_ids[s : s + rc]
        diff = x[:, s : s + rc, None, :] - x[:, None, :, :]  # (B, rc, N, 3)
        if box is not None:
            diff = _min_image(diff, box)
        d2 = (diff * diff).sum(-1)
        valid = (d2 < c2) & (i_ids[None, :, None] != j_ids[None, None, :])
        if node_mask is not None:
            valid = valid & (node_mask[:, None, :] > 0)
        score = torch.where(valid, -d2, torch.full_like(d2, -float("inf")))
        vals, idx = torch.topk(score, K, dim=-1)
        dropped = dropped + torch.relu(valid.sum(-1) - K).sum(-1)
        idx_c.append(idx)
        m_c.append((vals > -float("inf")).float())
    idx = torch.cat(idx_c, dim=1)
    nbr_mask = torch.cat(m_c, dim=1)
    if node_mask is not None:  # padded receivers have no neighbours
        nbr_mask = nbr_mask * node_mask[:, :, None]
    if with_overflow:
        return idx, nbr_mask, dropped.to(torch.int32)
    return idx, nbr_mask


_STENCIL = [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


def cell_neighbor_list(
    x: torch.Tensor,  # (B, N, 3)
    cutoff: float,
    max_neighbors: int,
    *,
    box,  # (3,) or scalar orthorhombic box: static (sizes the grid)
    cell_capacity: int = 32,
    node_mask: Optional[torch.Tensor] = None,  # (B, N)
    row_chunk: int = 4096,
    with_overflow: bool = False,
    periodic: bool = True,
):
    """Grid-binned neighbour build, O(N·27·capacity) work: the same return
    contract as :func:`neighbor_list`, built by binning atoms into a grid of
    cells of side >= ``cutoff`` and scanning the 27-cell stencil around each
    receiver (JAX ``sparse.py:129-296``).

    ``box`` is a Python number or triple: the grid ``floor(L / cutoff)`` is
    shape-determining. Atoms are ranked within their cell by a stable sort
    and a left ``searchsorted``; atoms past ``cell_capacity`` are dropped
    from the table and counted. Below 3 cells a side it falls back to
    :func:`neighbor_list` (the stencil would alias cells). ``periodic=False``
    builds an open-boundary list: ``box`` is only the grid's extent,
    distances are Euclidean, out-of-extent atoms clip into the boundary
    cells and the stencil clips at the grid faces. ``with_overflow=True``
    also returns per batch the capacity-dropped atoms plus the in-cutoff
    candidates truncated beyond K."""
    B, N, _ = x.shape
    dev = x.device
    K = min(max_neighbors, N)
    box3 = tuple(float(v) for v in np.broadcast_to(np.asarray(box, dtype=np.float64), (3,)))
    ncell = tuple(max(int(L / float(cutoff)), 1) for L in box3)
    if min(ncell) < 3:
        return neighbor_list(x, cutoff, max_neighbors, node_mask=node_mask,
                             box=box if periodic else None, with_overflow=with_overflow)

    n_cells = ncell[0] * ncell[1] * ncell[2]
    cap = int(cell_capacity)
    c2 = float(cutoff) ** 2
    widths = torch.tensor([L / n for L, n in zip(box3, ncell)], dtype=x.dtype, device=dev)
    ncell_t = torch.tensor(ncell, dtype=torch.int64, device=dev)
    bx = torch.tensor(box3, dtype=x.dtype, device=dev)
    offs = torch.tensor(_STENCIL, dtype=torch.int64, device=dev)
    rc = row_chunk if N % row_chunk == 0 else N
    ids = torch.arange(N, device=dev)
    kc = min(K, 27 * cap)  # the candidate set can be smaller than K

    def cell_ids(c):
        return (c[..., 0] * ncell[1] + c[..., 1]) * ncell[2] + c[..., 2]

    idx_b, m_b, ovf_b = [], [], []
    for b in range(B):
        xb = x[b]
        xw = xb - bx * torch.floor(xb / bx) if periodic else xb
        ci = torch.minimum(torch.clamp(torch.floor(xw / widths).long(), min=0), ncell_t - 1)
        cid = cell_ids(ci)
        if node_mask is not None:  # padded atoms -> the trash cell
            cid = torch.where(node_mask[b] > 0, cid, torch.full_like(cid, n_cells))
        order = torch.argsort(cid, stable=True)
        scid = cid[order]
        rank = ids - torch.searchsorted(scid, scid, side="left")
        real = scid < n_cells
        ok = (rank < cap) & real
        slot = torch.where(ok, scid * cap + rank, torch.full_like(scid, n_cells * cap))
        table = torch.full((n_cells * cap + 1,), N, dtype=torch.int64, device=dev)
        table[slot] = order  # the trash slot's value is cut off below
        table = table[: n_cells * cap].reshape(n_cells, cap)
        overflow = ((rank >= cap) & real).sum()
        xpad = torch.cat([xw, torch.full((1, 3), 2.0 * max(box3) + cutoff, dtype=x.dtype,
                                         device=dev)])
        idx_c, m_c = [], []
        trunc = torch.zeros((), dtype=torch.int64, device=dev)
        for s in range(0, N, rc):
            nb_raw = ci[s : s + rc, None, :] + offs[None]  # (rc, 27, 3)
            if periodic:
                nb = torch.remainder(nb_raw, ncell_t)
            else:
                nb = torch.minimum(torch.clamp(nb_raw, min=0), ncell_t - 1)
            cand = table[cell_ids(nb)]  # (rc, 27, cap)
            if not periodic:  # stencil cells off the grid hold no candidates
                in_grid = ((nb_raw >= 0) & (nb_raw < ncell_t)).all(dim=-1)
                cand = torch.where(in_grid[..., None], cand, torch.full_like(cand, N))
            cand = cand.reshape(cand.shape[0], 27 * cap)
            diff = xw[s : s + rc, None, :] - xpad[cand]
            if periodic:
                diff = _min_image(diff, bx)
            d2 = (diff * diff).sum(-1)
            valid = (cand != ids[s : s + rc, None]) & (cand < N) & (d2 < c2)
            score = torch.where(valid, -d2, torch.full_like(d2, -float("inf")))
            vals, sel = torch.topk(score, kc, dim=-1)
            m = vals > -float("inf")
            idx = torch.where(m, torch.gather(cand, 1, sel), torch.zeros_like(sel))
            m = m.float()
            trunc = trunc + torch.relu(valid.sum(-1) - kc).sum()
            if kc < K:
                idx = torch.nn.functional.pad(idx, (0, K - kc))
                m = torch.nn.functional.pad(m, (0, K - kc))
            idx_c.append(idx)
            m_c.append(m)
        idx_b.append(torch.cat(idx_c))
        m_b.append(torch.cat(m_c))
        ovf_b.append(overflow + trunc)
    idx = torch.stack(idx_b)
    nbr_mask = torch.stack(m_b)
    if node_mask is not None:
        nbr_mask = nbr_mask * node_mask[:, :, None]
    if with_overflow:
        return idx, nbr_mask, torch.stack(ovf_b).to(torch.int32)
    return idx, nbr_mask


def densify_neighbors(idx, nbr_mask, n: int):
    """(B, N, K) neighbour list -> (B, N, n) dense edge mask (for the checks
    against the masked dense path)."""
    onehot = torch.nn.functional.one_hot(idx.long(), n).to(nbr_mask.dtype)
    return (onehot * nbr_mask[..., None]).sum(dim=2)


def _gather(a: torch.Tensor, idx: torch.Tensor):
    """``a (B, N, D)``, ``idx (B, N, K)`` -> ``a[b, idx[b, i, k], :]`` as
    ``(B, N, K, D)``."""
    B, N, K = idx.shape
    flat = torch.gather(a, 1, idx.reshape(B, N * K, 1).long().expand(B, N * K, a.shape[-1]))
    return flat.reshape(B, N, K, a.shape[-1])


def sparse_layer_forward(
    p: LayerParams,
    h: torch.Tensor,  # (B, N, F)
    x_planes,  # 3 x (B, N, 1)
    v_planes,  # 3 x (B, N, 1) or None
    idx: torch.Tensor,  # (B, N, K)
    nbr_mask: torch.Tensor,  # (B, N, K)
    *,
    n_heads: int,
    update: bool,
    matmul_dtype=None,
    box=None,
):
    """One SAKE layer on gathered neighbours (JAX ``sparse.py:313-444``): the
    masked dense layer with the sender axis replaced by the K-neighbour
    axis. Self pairs must carry mask 0 (:func:`neighbor_list` excludes
    them)."""
    _f32_only(matmul_dtype=matmul_dtype)
    B, N, F = h.shape
    Kh = n_heads
    H = p.edge.w_out0.shape[-1]
    R = p.edge.w_in.shape[-1]
    m4 = nbr_mask[..., None]  # (B, N, Kn, 1)

    xg = [_gather(pk, idx) for pk in x_planes]
    d_planes = [gj - pi[:, :, None, :] for gj, pi in zip(xg, x_planes)]
    if box is not None:
        bx = torch.as_tensor(box, dtype=torch.float32, device=h.device)
        d_planes = [_min_image(dk, bx[k]) for k, dk in enumerate(d_planes)]
    r = torch.sqrt(torch.relu(d_planes[0] ** 2 + d_planes[1] ** 2 + d_planes[2] ** 2) + EPSILON)

    a_j = _gather(h @ p.edge.w_in[:F], idx)
    a_i = h @ p.edge.w_in[F:]
    pre = a_j + a_i[:, :, None, :] + p.edge.b_in
    rbf = torch.exp(-p.edge.rbf_betas * (torch.exp(-r) - p.edge.rbf_means) ** 2)
    filtered = rbf * pre
    o_j = _gather(h @ p.edge.w_out0[:F], idx)
    o_i = h @ p.edge.w_out0[F : 2 * F]
    o_f = filtered @ p.edge.w_out0[2 * F : 2 * F + R]
    e0 = o_j + o_i[:, :, None, :] + o_f + r * p.edge.w_out0[2 * F + R] + p.edge.b_out0
    h_e = _silu(e0) @ p.edge.w_out1 + p.edge.b_out1

    logits = _celu2(h_e @ p.w_sem + p.b_sem)
    logits = logits - INF * (1.0 - m4)
    att = torch.softmax(logits, dim=-2)
    att = att * m4
    denom = att.sum(dim=-2, keepdim=True)
    att = att / torch.where(denom == 0.0, torch.ones_like(denom), denom)

    # attended edges, hidden-major / head-minor: column h*Kh + k (the JAX
    # per-head loop over w_xmix.reshape(H, Kh, C) computes the same sums)
    he_att = (h_e[..., :, None] * att[..., None, :]).reshape(B, N, -1, H * Kh)
    coeff = torch.tanh(he_att @ p.w_xmix) * m4
    agg_node = he_att.sum(dim=-2) @ p.w_node0[F : F + H * Kh]

    inv_r = 1.0 / (r + 1e-5)
    pooled = [(coeff * (d_planes[k] * inv_r)).sum(dim=-2) for k in range(3)]
    count = m4.sum(dim=-2)  # (B, N, 1)
    norm_pool = [pk / (count + 1e-8) for pk in pooled]
    pool_sq = norm_pool[0] ** 2 + norm_pool[1] ** 2 + norm_pool[2] ** 2
    h_comb = _silu(_silu(pool_sq @ p.w_post0 + p.b_post0) @ p.w_post1 + p.b_post1)

    node_pre = h @ p.w_node0[:F] + agg_node + h_comb @ p.w_node0[F + H * Kh :] + p.b_node0
    h_out = h + _silu(_silu(node_pre) @ p.w_node1 + p.b_node1)
    if not update:
        return h_out, x_planes, v_planes

    dv_denom = count + 1e-10
    delta = [pk @ p.w_vmix / dv_denom for pk in pooled]
    if v_planes is not None:
        gate = 2.0 * torch.sigmoid(_silu(h_out @ p.w_vel0 + p.b_vel0) @ p.w_vel1)
        v_new = [gate * vk + dk for vk, dk in zip(v_planes, delta)]
    else:
        v_new = delta
    x_new = [xk + vk for xk, vk in zip(x_planes, v_new)]
    return h_out, x_new, v_new


def sparse_model_forward(
    p: ModelParams,
    h: torch.Tensor,  # (B, N, F_in)
    x: torch.Tensor,  # (B, N, 3)
    idx: torch.Tensor,  # (B, N, K)
    nbr_mask: torch.Tensor,  # (B, N, K)
    v=None,
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    matmul_dtype=None,
    remat: bool = False,
    box=None,
):
    """The model on a fixed neighbour list (JAX ``sparse.py:484-526``):
    ``(out (B, N, F_out), x_out (B, N, 3), v_out or None)``. ``remat=True``
    checkpoints each layer, so a force or training backward holds O(N·K)
    memory per layer only while it runs."""
    _f32_only(matmul_dtype=matmul_dtype)
    xp = [x[..., k : k + 1] for k in range(3)]
    vp = [v[..., k : k + 1] for k in range(3)] if v is not None else None
    hc = embed(p, h)
    for lp, upd in zip(p.layers, per_layer(update, len(p.layers))):
        def step(lp_, hc_, xp_, vp_, upd=upd):
            return sparse_layer_forward(lp_, hc_, xp_, vp_, idx, nbr_mask, n_heads=n_heads,
                                        update=upd, box=box)

        if remat:
            hc, xp, vp = checkpoint(step, lp, hc, xp, vp, use_reentrant=False)
        else:
            hc, xp, vp = step(lp, hc, xp, vp)
    out = readout(p, hc)
    return out, torch.cat(xp, dim=-1), (torch.cat(vp, dim=-1) if vp is not None else None)


def make_sparse_energy_forces(
    h: torch.Tensor,  # (B, N, F_in) fixed species features
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    matmul_dtype=None,
    remat: bool = True,
    node_mask: Optional[torch.Tensor] = None,  # (B, N)
    box=None,
):
    """``(params, x, idx, nbr_mask) -> (e (B,), f (B, N, 3))`` on the plain
    sparse model: the force field of ``md.neighborlist_verlet_rollout``.
    Forces come from one backward of the batch-summed energy (graph b's
    forces depend on x[b] only). When autograd records (grad enabled and
    some input requiring grad) the force keeps its graph, so a loss of
    ``(e, f)`` has second-order gradients; otherwise both are detached."""
    _f32_only(matmul_dtype=matmul_dtype)
    nm = None if node_mask is None else node_mask[..., None]

    def energy_forces(p: ModelParams, x, idx, nbr_mask):
        record = torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, x, *flat_params(p)))
        with torch.enable_grad():
            xg = x if x.requires_grad else x.detach().requires_grad_(True)
            out, _, _ = sparse_model_forward(p, h, xg, idx, nbr_mask, n_heads=n_heads,
                                             update=update, remat=remat, box=box)
            if nm is not None:
                out = out * nm
            e_b = out.sum(dim=(-2, -1))
            (g,) = torch.autograd.grad(e_b.sum(), xg, create_graph=record)
        if not record:
            return e_b.detach(), -g
        return e_b, -g

    return energy_forces
