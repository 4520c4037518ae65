"""Optimizer chains with NaN containment, with optax's semantics.

Port of ``sake_tpu/train/optim.py``: a warmup-cosine schedule, adam or
adamw with optional global-norm clipping and NaN scrubbing, wrapped in
``apply_if_finite``. The update rules are optax's, written out on lists of
tensors (``torch.optim``'s defaults differ: AdamW decays as
``p *= 1 - lr * wd`` before the step, and its weight decay defaults to
1e-2):

- adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
  ``u = mu_hat / (sqrt(nu_hat) + eps)`` with bias corrections ``1 - b^t``
  and eps 1e-8 outside the square root;
- adamw adds ``wd * p`` to ``u`` before the learning rate scales it:
  ``p -= lr * (u + wd * p)``;
- ``apply_if_finite``: a step whose gradients are not all finite leaves the
  parameters and the inner state as they were and adds one to the count of
  consecutive non-finite steps; past ``max_consecutive_errors`` such steps
  the update is applied anyway (the state is poisoned, and callers abort on
  :func:`notfinite_count`).

Counts and the finite test stay on the tensors' device, so a step waits
for nothing on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _linear(init: float, end: float, steps: int) -> Schedule:
    def schedule(count):
        frac = 1.0 - count.clamp(0, steps).float() / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = count.float().clamp(max=float(decay_steps))
        cosine = 0.5 * (1.0 + torch.cos(math.pi * c / float(decay_steps)))
        return init * ((1.0 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_schedule(peak_lr: float, total_steps: int, warmup_frac: float = 0.1,
                           end_lr: float = 0.0) -> Schedule:
    """Linear warmup from 0 to ``peak_lr``, then cosine decay to ``end_lr``
    (``optax.warmup_cosine_decay_schedule``)."""
    warmup_steps = max(1, int(total_steps * warmup_frac))
    alpha = 0.0 if peak_lr == 0.0 else end_lr / peak_lr
    warm = _linear(0.0, peak_lr, warmup_steps)
    decay = _cosine(peak_lr, total_steps - warmup_steps, alpha)

    def schedule(count):
        return torch.where(count < warmup_steps, warm(count), decay(count - warmup_steps))

    return schedule


@dataclass
class AdamState:
    count: torch.Tensor  # int32, updates applied
    mu: list
    nu: list


class Adam:
    """Adam, or AdamW when ``weight_decay`` is set, after optional NaN
    scrubbing (``optax.zero_nans``) and global-norm clipping
    (``optax.clip_by_global_norm``)."""

    def __init__(self, learning_rate: Union[float, Schedule], *, weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None, zero_nans: bool = False,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate, self.weight_decay = learning_rate, weight_decay
        self.clip_norm, self.zero_nans = clip_norm, zero_nans
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: list) -> AdamState:
        dev = params[0].device
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(self, grads: list, state: AdamState, params: list):
        """``(updates, new_state)``: add the updates to the parameters."""
        if self.zero_nans:
            grads = [torch.where(torch.isnan(g), torch.zeros_like(g), g) for g in grads]
        if self.clip_norm is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = norm < self.clip_norm
            grads = [torch.where(keep, g, g / norm * self.clip_norm) for g in grads]
        b1, b2 = self.b1, self.b2
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=count.device)
        bc1, bc2 = 1 - f32(b1) ** count, 1 - f32(b2) ** count
        lr = (self.learning_rate(state.count) if callable(self.learning_rate)
              else f32(self.learning_rate))
        updates = []
        for m, v, p in zip(mu, nu, params):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            updates.append(u * -lr)
        return updates, AdamState(count, mu, nu)


@dataclass
class IfFiniteState:
    notfinite_count: torch.Tensor  # int32, consecutive non-finite steps
    last_finite: torch.Tensor  # bool
    total_notfinite: torch.Tensor  # int32
    inner_state: AdamState


class ApplyIfFinite:
    """``optax.apply_if_finite`` around an :class:`Adam`."""

    def __init__(self, inner: Adam, max_consecutive_errors: int):
        self.inner, self.max_consecutive_errors = inner, max_consecutive_errors

    def init(self, params: list) -> IfFiniteState:
        zero = torch.zeros((), dtype=torch.int32, device=params[0].device)
        return IfFiniteState(zero, torch.ones((), dtype=torch.bool, device=zero.device), zero,
                             self.inner.init(params))

    def update(self, grads: list, state: IfFiniteState, params: list):
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        nfc = torch.where(finite, torch.zeros_like(state.notfinite_count),
                          state.notfinite_count + 1)
        apply = finite | (nfc > self.max_consecutive_errors)
        updates, new = self.inner.update(grads, state.inner_state, params)
        old = state.inner_state
        keep = lambda a, b: torch.where(apply, a, b)
        inner = AdamState(keep(new.count, old.count),
                          [keep(a, b) for a, b in zip(new.mu, old.mu)],
                          [keep(a, b) for a, b in zip(new.nu, old.nu)])
        updates = [torch.where(apply, u, torch.zeros_like(u)) for u in updates]
        total = torch.where(finite, state.total_notfinite, state.total_notfinite + 1)
        return updates, IfFiniteState(nfc, finite, total, inner)


def make_optimizer(learning_rate, *, weight_decay: float = 0.0,
                   clip_norm: Optional[float] = None, zero_nans: bool = False,
                   if_finite_patience: Optional[int] = 5):
    """Adam(W) chain with NaN containment; ``if_finite_patience=None`` drops
    the ``apply_if_finite`` wrapper."""
    tx = Adam(learning_rate, weight_decay=weight_decay, clip_norm=clip_norm,
              zero_nans=zero_nans)
    if if_finite_patience is not None:
        tx = ApplyIfFinite(tx, if_finite_patience)
    return tx


def notfinite_count(opt_state) -> int:
    """Consecutive non-finite update count of an ``apply_if_finite`` state;
    0 without the wrapper."""
    if isinstance(opt_state, IfFiniteState):
        return int(opt_state.notfinite_count)
    return 0
