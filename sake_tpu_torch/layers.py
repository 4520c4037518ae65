"""The dense SAKE layer as an ``nn.Module``.

Port of ``sake_tpu/layers.py:DenseSAKELayer``. Submodule and parameter
names mirror the linen tree (``edge_model``, ``node_mlp``,
``post_norm_mlp``, ``semantic_mlp``, ``x_mixing``, ``velocity_mlp_hidden``,
``velocity_mlp_out``, ``v_mixing``, ``log_gamma``); ``forward`` runs the
functional math of ``kernels/functional.py``. As in the linen tree, the
velocity gate MLP exists only on an update layer that receives a velocity
(``velocity=True``): flax creates it at first use, and a layer whose input
velocity is None never uses it. ``log_gamma`` is a parameter
for checkpoint compatibility; the dense forward does not read it.
"""

from __future__ import annotations

import torch
from torch import nn

from sake_tpu_torch.blocks import MLP, ContinuousFilterConv, Dense
from sake_tpu_torch.kernels.functional import CFConvParams, LayerParams, layer_forward_planes


class DenseSAKELayer(nn.Module):
    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 n_heads: int = 4, update: bool = True, kernel_features: int = 50,
                 *, velocity: bool = True, device=None, generator=None):
        super().__init__()
        h, F = hidden_features, in_features
        C = n_heads * h
        kw = dict(device=device, generator=generator)
        self.n_heads, self.update = n_heads, update
        self.velocity = update and velocity
        self.edge_model = ContinuousFilterConv(2 * F, h, kernel_features, **kw)
        self.node_mlp = MLP(F + h * n_heads + h, (h, out_features), **kw)
        self.post_norm_mlp = MLP(C, (h, h), **kw)
        self.semantic_mlp = Dense(h, n_heads, **kw)
        self.x_mixing = Dense(h * n_heads, C, use_bias=False, **kw)
        if update:
            self.v_mixing = Dense(C, 1, use_bias=False, **kw)
        if self.velocity:
            self.velocity_mlp_hidden = Dense(out_features, h, **kw)
            self.velocity_mlp_out = Dense(h, 1, use_bias=False, **kw)
        self.log_gamma = nn.Parameter(
            -torch.log(torch.linspace(1.0, 5.0, n_heads)).to(device)
        )

    def params(self) -> LayerParams:
        """The functional parameters (views of this module's weights)."""
        e = self.edge_model
        h = e.mlp_out.dense_1.kernel.shape[-1]
        C = self.x_mixing.kernel.shape[-1]
        F = self.node_mlp.dense_1.kernel.shape[-1]
        z = lambda *s: torch.zeros(s, device=e.mlp_in.kernel.device)
        vel = (self.v_mixing.kernel if self.update else z(C, 1),)
        if self.velocity:
            vel += (self.velocity_mlp_hidden.kernel, self.velocity_mlp_hidden.bias,
                    self.velocity_mlp_out.kernel)
        else:
            vel += (z(F, h), z(h), z(h, 1))
        return LayerParams(
            CFConvParams(e.mlp_in.kernel, e.mlp_in.bias, e.kernel.means, e.kernel.betas,
                         e.mlp_out.dense_0.kernel, e.mlp_out.dense_0.bias,
                         e.mlp_out.dense_1.kernel, e.mlp_out.dense_1.bias),
            self.semantic_mlp.kernel, self.semantic_mlp.bias, self.x_mixing.kernel,
            self.post_norm_mlp.dense_0.kernel, self.post_norm_mlp.dense_0.bias,
            self.post_norm_mlp.dense_1.kernel, self.post_norm_mlp.dense_1.bias,
            self.node_mlp.dense_0.kernel, self.node_mlp.dense_0.bias,
            self.node_mlp.dense_1.kernel, self.node_mlp.dense_1.bias,
            *vel,
        )

    def forward(self, h, x, v=None, mask=None):
        """``h (B, N, F)``, ``x``/``v (B, N, 3)``, edge ``mask (B, N, N)``, or
        the same without the batch axis (``h (N, F)``), as the linen layer."""

        def batched(h_, x_, v_, m_):
            xp = [x_[..., k : k + 1] for k in range(3)]
            vp = [v_[..., k : k + 1] for k in range(3)] if v_ is not None else None
            h_, xp, vp = layer_forward_planes(self.params(), h_, xp, vp, n_heads=self.n_heads,
                                              update=self.update, mask=m_)
            return h_, torch.cat(xp, dim=-1), (torch.cat(vp, dim=-1) if vp is not None else None)

        return unbatched(batched, h, x, v, mask)


def unbatched(fn, h, x, v, mask):
    """``fn(h, x, v, mask) -> (h, x, v)`` on batched inputs, applied to an
    unbatched ``h (N, F)`` (with ``x (N, 3)``, ``v``, ``mask (N, N)``) by
    adding a batch axis and stripping it from the outputs; batched inputs
    pass through."""
    if h.dim() != 2:
        return fn(h, x, v, mask)
    add = lambda t: None if t is None else t[None]
    out = fn(h[None], x[None], add(v), add(mask))
    return tuple(None if t is None else t[0] for t in out)
