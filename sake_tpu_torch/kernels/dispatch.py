"""The public E+F entry point of the port: one function that picks the kernel
path by batch size.

Port of ``sake_tpu/kernels/dispatch.py``: batches of ``ONE_EF_MIN_BATCH``
molecules or more go to :func:`one_ef.one_energy_forces` (#3, the whole
batch in one launch), smaller ones to :func:`resid_ef.resid_energy_forces`
(K1 + K2 per chunk of 512). ``None`` turns the one_ef branch off, and it is
off: on an H100 (``chip_smoke.py``, PERF.md) #3 took 1.31-1.35x the time of
K1 + K2 at 2048, 4096 and 8192 molecules, so the JAX threshold of 2048 is not
inherited. On CPU tensors both paths run their plain versions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sake_tpu_torch.kernels.functional import ModelParams
from sake_tpu_torch.kernels.one_ef import one_energy_forces
from sake_tpu_torch.kernels.resid_ef import resid_energy_forces

ONE_EF_MIN_BATCH: Optional[int] = None


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
    if ONE_EF_MIN_BATCH is not None and h.shape[0] >= ONE_EF_MIN_BATCH:
        return one_energy_forces(params, h, x, mask, n_heads=n_heads, update=update)
    return resid_energy_forces(params, h, x, mask, n_heads=n_heads, update=update)
