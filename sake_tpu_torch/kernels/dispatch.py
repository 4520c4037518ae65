"""The public E+F entry point of the port.

Port of ``sake_tpu/kernels/dispatch.py``. Every batch goes to the resid_ef
pair (K1 + K2 on CUDA tensors, their plain versions on CPU tensors). The
JAX package's ``one_ef`` branch for large batches and its 2048 threshold
are not carried over: whether a fused single kernel pays on the H100 is
still to be measured.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sake_tpu_torch.kernels.functional import ModelParams
from sake_tpu_torch.kernels.resid_ef import resid_energy_forces


def dispatch_energy_forces(
    params: ModelParams,
    h: torch.Tensor,  # (B, N, F_in)
    x: torch.Tensor,  # (B, N, 3)
    mask: Optional[torch.Tensor] = None,  # (B, N, N) edge mask
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
):
    """Raw ``(E (B,), F (B, N, 3))`` in f32; with an edge mask the energy
    sums the readout over the mask's atoms (its diagonal)."""
    return resid_energy_forces(params, h, x, mask, n_heads=n_heads, update=update)
