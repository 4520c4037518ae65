"""The SAKE model, its energy readout and the graph property head.

Port of ``sake_tpu/models.py`` (``SAKEModel``, ``energy_readout``,
``energy_and_forces``, ``GraphPropertyHead``). ``SAKEModel`` holds
linen-named submodules (``embedding_in``, ``layer_0`` ...
``layer_{depth-1}``, ``embedding_out``); its ``forward`` runs
``kernels/functional.model_forward`` and its ``energy_and_forces`` goes
through ``kernels/dispatch`` (the K1 + K2 CUDA kernels on a GPU). Modules
are built on the CUDA card unless ``device`` names another.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sake_tpu_torch.blocks import MLP, Dense
from sake_tpu_torch.kernels.dispatch import dispatch_energy_forces
from sake_tpu_torch.kernels.functional import ModelParams, _silu, model_forward, per_layer
from sake_tpu_torch.layers import DenseSAKELayer, unbatched
from sake_tpu_torch.utils import coloring, resolve_device


class SAKEModel(nn.Module):
    """Stack of dense SAKE layers with in/out embeddings.

    ``in_features`` is the width of the node features ``h`` (flax infers
    it at ``init``). ``velocity_input``: the model is called with a velocity
    ``v`` (flax learns it at ``init``, where a ``v`` makes every update layer,
    layer 0 included, create its velocity gate); without it only the layers
    after the first update receive one. ``generator`` seeds the
    initialization; ``device=None`` means the CUDA card.
    """

    def __init__(self, hidden_features: int, out_features: int = 1, depth: int = 4,
                 n_heads: int = 4, update: Sequence[bool] | bool = True, *,
                 in_features: int, velocity_input: bool = False, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.n_heads = n_heads
        self.depth = depth
        self.updates = per_layer(update, depth)
        self.embedding_in = Dense(in_features, hidden_features, **kw)
        for i, upd in enumerate(self.updates):
            self.add_module(
                f"layer_{i}",
                DenseSAKELayer(hidden_features, hidden_features, hidden_features,
                               n_heads=n_heads, update=upd,
                               velocity=velocity_input or any(self.updates[:i]), **kw),
            )
        self.embedding_out = MLP(hidden_features, (hidden_features, out_features), **kw)

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.depth)]

    def functional_params(self) -> ModelParams:
        out = self.embedding_out
        return ModelParams(
            self.embedding_in.kernel, self.embedding_in.bias,
            tuple(layer.params() for layer in self.layers()),
            out.dense_0.kernel, out.dense_0.bias, out.dense_1.kernel, out.dense_1.bias,
        )

    def forward(self, h, x, v=None, mask=None):
        """``(out (B, N, out), x (B, N, 3), v)``; an unbatched ``h (N, F)``,
        ``x (N, 3)`` (and ``v``, ``mask (N, N)``) gives unbatched outputs, as
        the linen module does."""
        return unbatched(
            lambda h_, x_, v_, m_: model_forward(self.functional_params(), h_, x_, v_,
                                                 n_heads=self.n_heads, update=self.updates,
                                                 mask=m_),
            h, x, v, mask)

    def energy_and_forces(self, h, x, mask=None):
        """Raw (uncolored) ``E (B,)`` and ``F = -dE/dx (B, N, 3)``, summed over
        atoms and outputs, through the dispatch (K1 + K2 on CUDA tensors)."""
        return dispatch_energy_forces(self.functional_params(), h, x, mask,
                                      n_heads=self.n_heads, update=self.updates)


def energy_readout(h_out, mask=None, mean=0.0, std=1.0):
    """``E = std * sum_i h_i + mean`` with optional node ``mask (..., N)``."""
    if mask is not None:
        h_out = h_out * mask[..., None]
    return coloring(h_out.sum(dim=(-2, -1)), mean, std)


def energy_and_forces(model: nn.Module, h, x, mask=None, mean=0.0, std=1.0):
    """Energy and ``F = -dE/dx`` by autograd through ``model.forward`` (the
    plain path; ``SAKEModel.energy_and_forces`` is the kernel path), as the
    JAX function: ``E`` is the readout summed over the batch (shape ``()``),
    and when autograd records (grad enabled and the model's parameters,
    ``h`` or ``x`` requiring grad) both stay differentiable w.r.t. them
    (``create_graph``), so a loss of ``F`` has second-order gradients.
    Otherwise both come back detached."""
    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in (h, x, *model.parameters()))
    with torch.enable_grad():
        xg = x if x.requires_grad else x.detach().requires_grad_(True)
        h_out, _, _ = model(h, xg, mask=mask)
        e = energy_readout(h_out, mask=mask, mean=mean, std=std).sum()
        (g,) = torch.autograd.grad(e, xg, create_graph=record)
    if not record:
        return e.detach(), -g
    return e, -g


def graph_property_head(mlp: dict | None, h, mask=None):
    """Masked sum over atoms of ``h (B, N, F)``, then, when ``mlp`` is
    given, ``silu(. @ dense_0) @ dense_1`` with ``mlp`` a linen-named
    ``{"dense_i": {"kernel", "bias"}}`` dict."""
    if mask is not None:
        h = h * mask[..., None]
    pooled = h.sum(dim=-2)
    if mlp is None:
        return pooled
    d0, d1 = mlp["dense_0"], mlp["dense_1"]
    return _silu(pooled @ d0["kernel"] + d0["bias"]) @ d1["kernel"] + d1["bias"]


class GraphPropertyHead(nn.Module):
    """Masked sum-pool over node features followed by an optional MLP
    (submodule ``head``, as in the linen tree): the QM9 property readout."""

    def __init__(self, in_features: int, out_features: int = 1, hidden_features: int = 64,
                 use_mlp: bool = True, *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.use_mlp = use_mlp
        if use_mlp:
            self.head = MLP(in_features, (hidden_features, out_features),
                            device=resolve_device(device), generator=generator)

    def mlp_params(self) -> dict | None:
        """The MLP's weights as :func:`graph_property_head` takes them."""
        if not self.use_mlp:
            return None
        return {name: {"kernel": d.kernel, "bias": d.bias} for name, d in self.head.named_children()}

    def forward(self, h, mask=None):
        return graph_property_head(self.mlp_params(), h, mask)
