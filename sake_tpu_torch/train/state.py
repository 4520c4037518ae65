"""Train state: step, parameters and optimizer state.

Port of ``sake_tpu/train/state.py``. ``params`` is any tree of tensors
(dicts, lists, tuples and NamedTuples of tensors); the optimizer sees its
leaves in :func:`tree_leaves` order. Unlike the JAX state, which is
immutable, :meth:`TrainState.apply_gradients` updates the parameter tensors
in place, so a step holds no second copy of the weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts (sorted by key, as JAX flattens them),
    lists, tuples and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in tree_leaves(item)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


@dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any
    tx: Any

    @classmethod
    def create(cls, *, params, tx) -> "TrainState":
        return cls(step=0, params=params, opt_state=tx.init(tree_leaves(params)), tx=tx)

    def apply_gradients(self, grads) -> "TrainState":
        """One optimizer step; ``grads`` has the structure of ``params``."""
        leaves = tree_leaves(self.params)
        with torch.no_grad():
            updates, self.opt_state = self.tx.update(tree_leaves(grads), self.opt_state, leaves)
            for p, u in zip(leaves, updates):
                p.add_(u)
        self.step += 1
        return self
