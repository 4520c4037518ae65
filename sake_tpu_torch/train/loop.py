"""Epoch loops.

Port of ``sake_tpu/train/loop.py``. The JAX package scans whole epochs on
the device; PyTorch runs eagerly, so an epoch here is a Python loop over
batches (:func:`run_epoch`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def shuffle_batches(rng: np.random.RandomState, data: dict, batch_size: int) -> list:
    """Shuffle the leading sample axis of every tensor in ``data`` and cut
    it into ``batch_size`` batches, dropping the ragged tail. The
    permutation comes from ``rng`` (the JAX package draws it from a
    ``PRNGKey``: other bits, the same distribution)."""
    n = len(next(iter(data.values())))
    n_batches = n // batch_size
    perm = rng.permutation(n)[: n_batches * batch_size].reshape(n_batches, batch_size)
    dev = next(iter(data.values())).device
    return [{k: a[idx] for k, a in data.items()}
            for idx in torch.as_tensor(perm, device=dev)]


def run_epoch(step_fn: Callable, state, batches) -> tuple:
    """``step_fn(state, batch) -> (state, loss)`` over the batches; returns
    the state and the per-step losses as one tensor (read at the epoch's
    end, so the loop never waits on the device)."""
    losses = []
    for batch in batches:
        state, loss = step_fn(state, batch)
        losses.append(loss.detach())
    return state, torch.stack(losses)
