"""Radial basis: the ExpNormalSmearing parameters.

Port of ``sake_tpu/radial.py:45-69``. The module holds ``means`` and
``betas`` with the PhysNet initial values (fixed (0, 5) cutoff, so
alpha = 1); the layer math that applies them, ``exp(-betas * (exp(-r) -
means)^2)``, lives in ``kernels/functional.py``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def exp_normal_init(num_rbf: int, cutoff_lower: float = 0.0, cutoff_upper: float = 5.0):
    """Initial ``(means, betas)``: means evenly spaced in exp(-r) space from
    exp(-(upper - lower)) to 1, betas ``(2/num_rbf * (1 - start))^-2``."""
    start = math.exp(-(cutoff_upper - cutoff_lower))
    means = torch.linspace(start, 1.0, num_rbf)
    betas = torch.full((num_rbf,), (2.0 / num_rbf * (1.0 - start)) ** -2)
    return means, betas


class ExpNormalSmearing(nn.Module):
    """Parameter container: ``means`` and ``betas`` (flax names)."""

    def __init__(self, num_rbf: int = 50, cutoff_lower: float = 0.0,
                 cutoff_upper: float = 5.0, device=None):
        super().__init__()
        means, betas = exp_normal_init(num_rbf, cutoff_lower, cutoff_upper)
        self.means = nn.Parameter(means.to(device))
        self.betas = nn.Parameter(betas.to(device))
