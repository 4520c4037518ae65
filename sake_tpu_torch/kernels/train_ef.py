"""Differentiable (second-order) energy + force evaluation on the kernel path.

Port of ``sake_tpu/kernels/train_ef.py``: :func:`make_trainable_energy_forces`
builds ``ef(params, h, x) -> (e, f)`` whose primal runs the E + F kernels and
whose backward is the exact pullback of the cotangents ``(g_e, g_f)``
through the plain functional model, by the identity

  ``<(g_e, g_f), d(E, F)> = d[ sum_b g_e[b] E[b] - <g_f, grad_x sum_b E_b> ]``

(the mixed second derivative is the gradient of a directional derivative,
which autograd differentiates natively). The backward is built from
differentiable torch operations, so the gradients it returns are
differentiable again, to any order the functional model reaches; the
kernels accelerate the primal only, as in JAX, where the backward is XLA and
no Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch

from sake_tpu_torch.kernels.depthgrid_ef import depthgrid_energy_forces
from sake_tpu_torch.kernels.fori_ef import fori_energy_forces
from sake_tpu_torch.kernels.functional import (
    ModelParams,
    _f32_only,
    flat_params,
    model_forward,
)
from sake_tpu_torch.kernels.resid_ef import _LAYER_TENSORS, _unflat_params, resid_energy_forces


def make_trainable_energy_forces(
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    batch_tile: int = 8,
    matmul_dtype=None,
    precision=None,
    edge_matmul_dtype=None,
    edge_precision=None,
    primal: str = "fori",
    pad_atoms: bool = False,
    interpret: bool = False,
):
    """Build ``ef(params: ModelParams, h (B, N, F_in), x (B, N, 3)) -> (e (B,),
    f (B, N, 3))``, raw energies and ``f = -dE/dx``, differentiable w.r.t.
    ``params``, ``h`` and ``x``.

    ``primal`` picks the kernels of the forward: ``"fori"`` (#21 + #22,
    :func:`fori_ef.fori_energy_forces`), ``"resid"`` (K1 + K2,
    :func:`resid_ef.resid_energy_forces`) or ``"depthgrid"`` (#23 + #24,
    :func:`depthgrid_ef.depthgrid_energy_forces`); any other name raises
    ``ValueError``. The keywords pass to the primal under its policy: the
    bf16 tier raises, the rest have no counterpart."""
    _f32_only("make_trainable_energy_forces", matmul_dtype, edge_matmul_dtype)
    kernel_kw = dict(n_heads=n_heads, update=update, batch_tile=batch_tile,
                     matmul_dtype=matmul_dtype, precision=precision,
                     edge_matmul_dtype=edge_matmul_dtype, edge_precision=edge_precision,
                     interpret=interpret)
    if primal == "fori":
        def primal_fn(params, h, x):
            return fori_energy_forces(params, h, x, pad_atoms=pad_atoms, **kernel_kw)
    elif primal == "resid":
        def primal_fn(params, h, x):
            return resid_energy_forces(params, h, x, pad_atoms=pad_atoms, **kernel_kw)
    elif primal == "depthgrid":
        def primal_fn(params, h, x):
            return depthgrid_energy_forces(params, h, x, **kernel_kw)
    else:
        raise ValueError(f"unknown primal {primal!r}")

    def e_per_graph(params: ModelParams, h, x):
        out, _, _ = model_forward(params, h, x, n_heads=n_heads, update=update)
        return out.sum(dim=(-2, -1))  # (B,)

    class EF(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, x, *flat):
            depth = (len(flat) - 6) // _LAYER_TENSORS
            ctx.depth = depth
            ctx.save_for_backward(h, x, *flat)
            return primal_fn(_unflat_params(flat, depth), h, x)

        @staticmethod
        def backward(ctx, g_e, g_f):
            # grad mode is on here exactly when the caller asked for a graph of
            # the gradients (create_graph): then differentiate the saved inputs
            # themselves, so the gradients stay functions of them (and of the
            # cotangents, which enter as grad_outputs: constants of this
            # pullback, live in the caller's graph)
            create = torch.is_grad_enabled()
            with torch.enable_grad():
                ins = [t if create and t.requires_grad else t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors]
                h, x, *flat = ins
                e = e_per_graph(_unflat_params(flat, ctx.depth), h, x)
                (grad_x,) = torch.autograd.grad(e.sum(), x, create_graph=True)
                # <g_e, dE> + <g_f, dF> with F = -grad_x
                grads = torch.autograd.grad((e, grad_x), ins, grad_outputs=(g_e, -g_f),
                                            create_graph=create, allow_unused=True)
            return tuple(torch.zeros_like(t) if g is None else g
                         for t, g in zip(ctx.saved_tensors, grads))

    def ef(params: ModelParams, h, x):
        return EF.apply(h, x, *flat_params(params))

    return ef
