"""MD17 energy + forces: the serving entry.

Port of the evaluation side of ``sake_tpu/tasks/md17.py`` (``MD17Config``,
``make_model``, ``make_energy_force_fn`` at ``:93-111``). Training is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sake_tpu_torch.models import SAKEModel
from sake_tpu_torch.utils import coloring


@dataclass
class MD17Config:
    """The model fields of the JAX ``MD17Config``; its data and training
    fields arrive with the training port."""

    hidden_features: int = 64
    depth: int = 6
    n_heads: int = 4


def species_onehot(z: np.ndarray, n_classes: int) -> torch.Tensor:
    """One-hot species the way ``jax.nn.one_hot(z, n_classes)`` builds it:
    an atomic number outside ``[0, n_classes)`` gets an all-zero row. The
    JAX task calls it with ``n_classes = z.max()``, so aspirin's oxygens
    (z = 8 of 8 classes) are all-zero rows; ``torch.nn.functional.one_hot``
    would raise instead."""
    z = np.asarray(z)
    out = np.zeros((len(z), n_classes), np.float32)
    ok = (z >= 0) & (z < n_classes)
    out[np.nonzero(ok)[0], z[ok]] = 1.0
    return torch.as_tensor(out)


def make_model(cfg: MD17Config, in_features: int, *, device=None,
               generator: torch.Generator | None = None) -> SAKEModel:
    return SAKEModel(cfg.hidden_features, 1, cfg.depth, n_heads=cfg.n_heads,
                     in_features=in_features, device=device, generator=generator)


def make_energy_force_fn(model: SAKEModel, species: torch.Tensor, e_mean: float,
                         e_std: float):
    """``energy_and_forces(x (B, N, 3)) -> (E (B, 1), F (B, N, 3))``, colored
    (``E = raw * std + mean``, so ``F = std * F_raw``), through
    ``SAKEModel.energy_and_forces`` and the dispatch."""

    def energy_and_forces(x: torch.Tensor):
        sp = species.to(device=x.device, dtype=torch.float32)
        h = sp.expand(x.shape[0], *sp.shape)
        e, f = model.energy_and_forces(h, x)
        return coloring(e, e_mean, e_std)[:, None], f * e_std

    return energy_and_forces
