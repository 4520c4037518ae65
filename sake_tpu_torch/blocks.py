"""Parameter containers with flax's names and initialization.

Port of ``sake_tpu/blocks.py`` (``MLP``, ``ContinuousFilterConv``). A
``Dense`` holds ``kernel (in, out)`` and ``bias (out,)`` as flax does, so a
linen tree loads by name (``kernels/adapter.load_linen_params``) and the
functional math reads the weights without transposes. Initialization is
flax's default: ``lecun_normal`` (truncated normal on [-2, 2], std
``sqrt(1/fan_in) / 0.8796``) and a zero bias. The random numbers differ
from JAX's for the same seed; tests hand both packages the same weights.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from sake_tpu_torch.radial import ExpNormalSmearing

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: torch.Generator | None = None):
    fan_in = w.shape[0]
    with torch.no_grad():
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)
    return w


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, use_bias: bool = True, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.kernel = nn.Parameter(
            lecun_normal_(torch.empty(in_features, out_features), generator).to(device)
        )
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if use_bias else None)


class MLP(nn.Module):
    """Dense stack named ``dense_0``, ``dense_1``, ...; the functional math
    applies the activations between and after them."""

    def __init__(self, in_features: int, features: Sequence[int],
                 *, device=None, generator=None):
        super().__init__()
        dims = [in_features, *features]
        for i in range(len(features)):
            self.add_module(
                f"dense_{i}",
                Dense(dims[i], dims[i + 1], device=device, generator=generator),
            )


class ContinuousFilterConv(nn.Module):
    """The SAKE edge model's parameters: ``mlp_in`` (2F -> R), the RBF
    ``kernel`` (means, betas) and ``mlp_out`` (2F + R + 1 -> H -> H)."""

    def __init__(self, in_features: int, out_features: int, kernel_features: int = 50,
                 *, device=None, generator=None):
        super().__init__()
        self.mlp_in = Dense(in_features, kernel_features, device=device, generator=generator)
        self.kernel = ExpNormalSmearing(num_rbf=kernel_features, device=device)
        self.mlp_out = MLP(in_features + kernel_features + 1,
                           (out_features, out_features), device=device, generator=generator)
