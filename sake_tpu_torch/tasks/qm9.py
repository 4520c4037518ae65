"""QM9 property regression on padded batches with node and edge masks.

Port of ``sake_tpu/tasks/qm9.py``: one-hot charge features, a masked sum
readout and an MLP head, ``apply_if_finite`` with an abort threshold on
consecutive non-finite steps, flat or size-bucketed batches, and the padded
full-split evaluation. Two branches train the same model:

- the plain branch runs ``QM9Model`` (``SAKEModel`` -> ``GraphPropertyHead``)
  through the functional model, with torch autograd;
- the kernel branch (``use_kernel_backbone``) runs the backbone through
  ``kernels/resid_ef.make_hidden_fn``: the masked K1 forward, the training
  pullback and the parameter-gradient kernel on a card, the forward
  without residuals in the evaluation, then the readout and the head in
  plain torch.

One device: ``data_parallel`` is accepted and ignored. ``kernel_batch_tile``
and ``kernel_interpret`` are accepted for the JAX configurations' sake; the
port's kernels take one molecule per block and have no interpret mode.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from sake_tpu_torch.data.qm9 import QM9Data, dimenet_split, load_qm9
from sake_tpu_torch.kernels.adapter import kernel_params_from_linen, linen_tree
from sake_tpu_torch.kernels.functional import readout
from sake_tpu_torch.kernels.resid_ef import make_hidden_fn
from sake_tpu_torch.models import GraphPropertyHead, SAKEModel, graph_property_head
from sake_tpu_torch.train import (
    TrainState,
    make_optimizer,
    notfinite_count,
    run_epoch,
    shuffle_batches,
    tree_leaves,
)
from sake_tpu_torch.train.metrics import MetricLogger, bootstrap_mae
from sake_tpu_torch.utils import coloring, resolve_device


@dataclass
class QM9Config:
    hidden_features: int = 64
    depth: int = 6
    n_heads: int = 4
    update: Union[bool, List[bool]] = True
    use_mlp_head: bool = True
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    batch_size: int = 64
    n_epochs: int = 10
    epochs_per_block: int = 1
    n_samples: int = 4096  # synthetic-size fallback
    data_dir: Optional[str] = None
    target: Union[str, int, None] = None
    subtract_thermo: bool = True
    # group training batches by atom count padded up to this multiple;
    # None keeps the flat 29-atom padding (evaluation is always flat)
    bucket_pad_multiple: Optional[int] = None
    data_parallel: bool = True
    max_notfinite: int = 10
    seed: int = 2666
    use_kernel_backbone: bool = False
    kernel_batch_tile: int = 4
    kernel_interpret: bool = False


class QM9Model(nn.Module):
    """SAKE backbone + masked-sum property head, with the linen tree's names
    (``backbone``, ``head``)."""

    def __init__(self, cfg: QM9Config, in_features: int, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.backbone = SAKEModel(cfg.hidden_features, cfg.hidden_features, cfg.depth,
                                  n_heads=cfg.n_heads, update=cfg.update,
                                  in_features=in_features, **kw)
        self.head = GraphPropertyHead(cfg.hidden_features, 1, cfg.hidden_features,
                                      use_mlp=cfg.use_mlp_head, **kw)

    def forward(self, species, x, edge_mask, node_mask):
        y, _, _ = self.backbone(species, x, mask=edge_mask)
        return self.head(y, mask=node_mask)


def prepare_split(data: QM9Data, idx, n_classes: int, y_mean: float, y_std: float,
                  device) -> dict:
    """One split's tensors: one-hot ``species``, ``x``, the masks and the
    standardized target ``y``."""
    charges = data.charges[idx]
    node_mask = (charges > 0).astype(np.float32)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return {
        "species": torch.nn.functional.one_hot(put(charges.astype(np.int64)),
                                               n_classes).float(),
        "x": put(data.x[idx]),
        "node_mask": put(node_mask),
        "edge_mask": put(node_mask[:, :, None] * node_mask[:, None, :]),
        "y": put((data.y[idx] - y_mean) / y_std),
    }


def make_forward(cfg: QM9Config, model: QM9Model):
    """``(params, forward)`` of the configured branch: the training
    parameters as a tree of leaf tensors and ``forward(params, species, x,
    edge_mask, node_mask) -> (B, 1)``. The kernel branch converts the
    model's weights by their linen names (``{"kp": ModelParams, "head":
    ...}``, as the JAX task does)."""
    if not cfg.use_kernel_backbone:
        def forward(p, species, x, edge_mask, node_mask):
            return model(species, x, edge_mask, node_mask)

        return dict(model.named_parameters()), forward

    hidden = make_hidden_fn(n_heads=cfg.n_heads, update=cfg.update)
    params = kernel_params_from_linen(linen_tree(model),
                                      device=next(model.parameters()).device)
    for t in tree_leaves(params):
        t.requires_grad_(True)

    def forward(p, species, x, edge_mask, node_mask):
        h_fin = hidden(p["kp"], species, x, edge_mask)
        return graph_property_head(p["head"], readout(p["kp"], h_fin), node_mask)

    return params, forward


def make_train_step(forward):
    """``step(state, batch) -> (state, loss)``: the mean squared error of the
    standardized target, its gradient and one optimizer step."""

    def step(state: TrainState, batch: dict):
        leaves = tree_leaves(state.params)
        with torch.enable_grad():
            pred = forward(state.params, batch["species"], batch["x"], batch["edge_mask"],
                           batch["node_mask"])
            loss = ((pred - batch["y"]) ** 2).mean()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return state.apply_gradients(grads), loss.detach()

    return step


def batchify_bucketed(split: dict, rng: np.random.RandomState, mult: int,
                      batch_size: int) -> list:
    """Shape-uniform batches grouped by atom count padded up to ``mult``
    (one list per padded size, smallest first)."""
    n_stored = split["x"].shape[1]
    sizes = split["node_mask"].sum(dim=-1).cpu().numpy().astype(int)
    pad_to = np.minimum(np.maximum(mult, (sizes + mult - 1) // mult * mult), n_stored)
    perm = rng.permutation(len(sizes))
    groups = []
    for n_pad in sorted(set(pad_to.tolist())):
        idx = perm[pad_to[perm] == n_pad]
        nb = len(idx) // batch_size
        if nb == 0:
            continue
        idx = torch.as_tensor(idx[: nb * batch_size].reshape(nb, batch_size),
                              device=split["x"].device)

        def cut(a, rows):
            a = a[rows]
            if a.ndim >= 2 and a.shape[1] == n_stored:
                a = a[:, :n_pad]
            if a.ndim >= 3 and a.shape[2] == n_stored:
                a = a[:, :, :n_pad]
            return a.contiguous()

        groups.append([{k: cut(a, rows) for k, a in split.items()} for rows in idx])
    return groups


def predict(forward, params, split: dict, batch_size: int) -> torch.Tensor:
    """Predictions for the whole split in batches of one shape: the ragged
    tail is padded with copies of its first row, whose predictions are
    dropped."""
    n = len(split["x"])
    bs = min(max(batch_size, 64), n)
    preds = []
    with torch.no_grad():
        for s in range(0, n, bs):
            sl = {k: a[s : s + bs] for k, a in split.items()}
            nb = len(sl["x"])
            if nb < bs:
                sl = {k: torch.cat([a, a[:1].expand(bs - nb, *a.shape[1:])])
                      for k, a in sl.items()}
            preds.append(forward(params, sl["species"], sl["x"], sl["edge_mask"],
                                 sl["node_mask"])[:nb])
    return torch.cat(preds)


def run(cfg: QM9Config, logger: Optional[MetricLogger] = None, *, device=None):
    """Train for ``cfg.n_epochs`` and evaluate the valid and test splits;
    returns ``(state, results)``. ``device=None`` means the CUDA card."""
    device = resolve_device(device)
    logger = logger or MetricLogger()
    data = load_qm9(cfg.data_dir, cfg.n_samples, seed=cfg.seed, target=cfg.target,
                    subtract_thermo=cfg.subtract_thermo)
    tr_idx, vl_idx, te_idx = dimenet_split(len(data.x))
    n_classes = int(data.charges.max()) + 1
    y_mean, y_std = float(data.y[tr_idx].mean()), float(data.y[tr_idx].std())
    train, valid, test = (prepare_split(data, idx, n_classes, y_mean, y_std, device)
                          for idx in (tr_idx, vl_idx, te_idx))

    model = QM9Model(cfg, n_classes, device=device,
                     generator=torch.Generator().manual_seed(cfg.seed))
    params, forward = make_forward(cfg, model)
    tx = make_optimizer(cfg.learning_rate, weight_decay=cfg.weight_decay, if_finite_patience=5)
    state = TrainState.create(params=params, tx=tx)
    step = make_train_step(forward)

    rng = np.random.RandomState(cfg.seed)
    t0 = time.time()
    for epoch_i in range(cfg.n_epochs):
        if cfg.bucket_pad_multiple:
            groups = batchify_bucketed(train, rng, cfg.bucket_pad_multiple, cfg.batch_size)
            batches = [b for group in groups for b in group]
        else:
            batches = shuffle_batches(rng, train, cfg.batch_size)
        state, losses = run_epoch(step, state, batches)
        nfc = notfinite_count(state.opt_state)
        if nfc > cfg.max_notfinite:
            raise RuntimeError(f"too many non-finite steps ({nfc})")
        logger.log(state.step, epoch=epoch_i + 1, train_loss=float(losses[-1]),
                   wall=round(time.time() - t0, 2))

    results = {}
    for name, split in (("valid", valid), ("test", test)):
        pred = predict(forward, state.params, split, cfg.batch_size)
        mae, low, high = bootstrap_mae(coloring(pred, y_mean, y_std),
                                       coloring(split["y"], y_mean, y_std))
        results[f"{name}_mae"] = mae
        results[f"{name}_mae_ci"] = (low, high)
    logger.log(state.step, **{k: v for k, v in results.items() if not isinstance(v, tuple)})
    return state, results


if __name__ == "__main__":
    run(QM9Config(n_epochs=3, n_samples=2048))
