"""Molecular-dynamics rollouts.

Port of ``sake_tpu/md.py``: :func:`velocity_verlet_rollout`,
:func:`neighborlist_verlet_rollout` and :func:`learned_integrator_rollout`.
Each ``lax.scan`` becomes a Python loop over the same steps; the results
are stacked as the JAX package stacks them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def velocity_verlet_rollout(energy_forces_fn: Callable, params, x0, v0, masses, dt: float,
                            n_steps: int, sample_every: int = 1):
    """Velocity-Verlet integration of ``f = -dE/dx`` with ``energy_forces_fn
    (params, x) -> (e, f)``. Returns ``(xs, vs, es)`` stacked every
    ``sample_every`` steps: ``xs (n_samples, ..., N, 3)``, ``es (n_samples,
    ...)``."""
    inv_m = (1.0 / masses)[..., None]
    _, f = energy_forces_fn(params, x0)
    x, v = x0, v0
    xs, vs, es = [], [], []
    for _ in range(n_steps // sample_every):
        for _ in range(sample_every):
            v_half = v + 0.5 * dt * f * inv_m
            x = x + dt * v_half
            _, f = energy_forces_fn(params, x)
            v = v_half + 0.5 * dt * f * inv_m
        e, _ = energy_forces_fn(params, x)
        xs.append(x)
        vs.append(v)
        es.append(e)
    return torch.stack(xs), torch.stack(vs), torch.stack(es)


def neighborlist_verlet_rollout(
    energy_forces_fn: Callable,
    params,
    x0,  # (B, N, 3)
    v0,  # (B, N, 3)
    masses,  # (N,) or (B, N)
    dt: float,
    n_steps: int,
    *,
    cutoff: float,
    max_neighbors: int,
    rebuild_every: int = 20,
    skin: float = 0.0,
    node_mask: Optional[torch.Tensor] = None,
    box=None,  # (3,) orthorhombic periodic box
    cell_capacity: Optional[int] = None,  # the O(N) cell-list build
    cell_extent=None,  # (3,) grid extent of the cell-list build on an open system
    with_overflow: bool = False,
):
    """Velocity-Verlet on a cutoff force field ``energy_forces_fn(params, x,
    idx, nbr_mask) -> (e, f)`` with neighbour-list rebuilds (JAX
    ``md.py:65-182``): every ``rebuild_every`` steps the list is rebuilt at
    ``cutoff + skin`` from the current positions (wrapped into ``box`` when
    periodic), by the all-pairs build or, with ``cell_capacity``, the cell
    list (over ``box``, or the open grid ``cell_extent``). The model runs
    once per step: forces carry across rebuilds (exact under the skin
    criterion) and the sampled energy is the interval's last step's.
    Returns ``(xs, vs, es)`` once per interval, and with ``with_overflow``
    also ``overflows (n_intervals, B)``, the neighbours each rebuild
    dropped (nonzero: the trajectory ran on a truncated graph)."""
    from sake_tpu_torch.sparse import cell_neighbor_list, neighbor_list

    if cell_capacity is not None and box is None and cell_extent is None:
        raise ValueError(
            "cell_capacity requires a periodic `box` (the cell grid is sized from it) or an "
            "open-boundary `cell_extent`; with neither, drop cell_capacity to use the "
            "O(N^2)-work all-pairs build")
    if cell_extent is not None and box is not None:
        raise ValueError("pass either `box` (periodic) or `cell_extent` (open grid), not both")

    if cell_capacity is not None:
        def build_list(x_):
            return cell_neighbor_list(x_, cutoff + skin, max_neighbors,
                                      box=box if box is not None else cell_extent,
                                      periodic=box is not None, cell_capacity=cell_capacity,
                                      node_mask=node_mask, with_overflow=True)
    else:
        def build_list(x_):
            return neighbor_list(x_, cutoff + skin, max_neighbors, node_mask=node_mask,
                                 box=box, with_overflow=True)

    inv_m = (1.0 / masses)[..., None]
    idx, m, _ = build_list(x0.detach())
    _, f = energy_forces_fn(params, x0, idx, m)
    x, v = x0, v0
    xs, vs, es, ovfs = [], [], [], []
    for _ in range(n_steps // rebuild_every):
        if box is not None:
            bx = torch.as_tensor(box, dtype=x.dtype, device=x.device)
            x = x - bx * torch.floor(x / bx)  # minimum-image forces: f unchanged
        idx, m, ovf = build_list(x.detach())
        for _ in range(rebuild_every):
            v_half = v + 0.5 * dt * f * inv_m
            x = x + dt * v_half
            e, f = energy_forces_fn(params, x, idx, m)
            v = v_half + 0.5 * dt * f * inv_m
        xs.append(x)
        vs.append(v)
        es.append(e)
        ovfs.append(ovf)
    out = (torch.stack(xs), torch.stack(vs), torch.stack(es))
    return (*out, torch.stack(ovfs)) if with_overflow else out


def learned_integrator_rollout(apply_fn: Callable, params, h, x0, v0, n_steps: int):
    """Autoregressive rollout of an ``update=True`` model ``apply_fn(params,
    h, x, v) -> (out, x_new, v_new)``: each application advances (x, v) by
    one macro-step. Returns ``(xs, vs)`` with leading axis ``n_steps``."""
    x, v = x0, (v0 if v0 is not None else torch.zeros_like(x0))
    xs, vs = [], []
    for _ in range(n_steps):
        _, x, v = apply_fn(params, h, x, v)
        xs.append(x)
        vs.append(v)
    return torch.stack(xs), torch.stack(vs)
