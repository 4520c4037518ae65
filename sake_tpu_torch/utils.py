"""Small numerics utilities: de-standardization and bootstrap metrics.

Port of ``sake_tpu/utils.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when it is None. The entry points run on
    the card unless the caller asks for the CPU: without a card and without
    a device they raise, never falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def coloring(x, mean, std):
    """De-standardize predictions: ``std * x + mean``."""
    return std * x + mean


def mae(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean absolute error."""
    return (x - y).abs().mean()


def mae_with_replacement(x: torch.Tensor, y: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """MAE on a bootstrap resample drawn with ``numpy.random.RandomState(seed)``.
    The JAX package draws with ``jax.random.choice(PRNGKey(seed))``: the
    same distribution, other indices, so single resamples differ."""
    idxs = np.random.RandomState(seed).randint(0, x.shape[0], size=x.shape[0])
    idxs = torch.as_tensor(idxs, device=x.device)
    return mae(x[idxs], y[idxs])


def bootstrap_mae(x, y, n_samples: int = 10, ci: float = 0.95):
    """Bootstrap-resampled MAE with a percentile confidence interval:
    ``(original, low, high)``. The original MAE equals the JAX package's;
    the interval comes from other resamples (see
    :func:`mae_with_replacement`)."""
    original = mae(x, y).item()
    results = [mae_with_replacement(x, y, i).item() for i in range(n_samples)]
    low = np.percentile(results, 100.0 * 0.5 * (1.0 - ci))
    high = np.percentile(results, (1.0 - (1.0 - ci) * 0.5) * 100.0)
    return original, low, high
