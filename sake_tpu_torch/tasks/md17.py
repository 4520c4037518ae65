"""MD17 energy + force fitting: serving and force-loss training.

Port of ``sake_tpu/tasks/md17.py``: ``MD17Config``, ``make_model``,
``make_energy_force_fn`` (``:93-111``), ``make_step_fn`` (``:114-125``) and
``run`` (``:128-280``). The loss is F-MAE + ``energy_loss_weight`` * E-MAE,
so its gradient is a second derivative of the model. Two branches train
the same model from one seeded init:

- the plain branch differentiates the f32 functional model twice with
  torch autograd (``kernels/functional.energy_and_forces_fn``);
- the kernel branch (``use_kernel_ef``) trains ``ModelParams`` through
  ``kernels/train2_ef.make_ef_train2``, whose primal and backward are CUDA
  kernels on a card: in the config's default ``aug_mode="fused"`` (#11 and
  #12, the JAX default and the ``md17_kernel`` workload) or in
  ``aug_mode="shared"`` (#7-#10).

Both branches evaluate on the f32 functional path and report bootstrap
MAE in kcal/mol. Epochs are Python loops over batches, reshuffled with a
seed of the optimizer step (the JAX package draws the permutation from
``PRNGKey(step)``: the same rule, other bits). Not ported yet: checkpoints
(``checkpoint_dir`` raises) and ``select_best_checkpoint``.
``kernel_batch_tile``, ``aug_batch_tile`` and ``kernel_interpret`` are
accepted for the JAX configurations' sake; the port's kernels take one
molecule per block and have no interpret mode.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sake_tpu_torch.data.md17 import load_md17
from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
from sake_tpu_torch.kernels.functional import energy_and_forces_fn, flat_params
from sake_tpu_torch.kernels.train2_ef import make_ef_train2
from sake_tpu_torch.models import SAKEModel
from sake_tpu_torch.train import (
    TrainState,
    make_optimizer,
    run_epoch,
    shuffle_batches,
    tree_leaves,
    warmup_cosine_schedule,
)
from sake_tpu_torch.train.metrics import KCAL_PER_MOL, MetricLogger, bootstrap_mae
from sake_tpu_torch.utils import coloring, resolve_device


@dataclass
class MD17Config:
    molecule: str = "aspirin"
    hidden_features: int = 64
    depth: int = 6
    n_heads: int = 4
    learning_rate: float = 1e-4
    batch_size: int = 4
    n_train: int = 1000
    n_valid: int = 1000
    n_epochs: int = 100
    epochs_per_block: int = 10
    energy_loss_weight: float = 1e-3
    data_dir: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every_blocks: int = 1
    seed: int = 2666
    use_kernel_ef: bool = False
    kernel_batch_tile: int = 4
    aug_batch_tile: int = 2
    aug_mode: str = "fused"
    kernel_interpret: bool = False


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


def make_step_fn(ef_fn, energy_loss_weight: float):
    """``step(state, batch) -> (state, loss)``: F-MAE + ``energy_loss_weight``
    * E-MAE of ``ef_fn(params, x) -> (E (B, 1), F (B, N, 3))``, its gradient
    w.r.t. every parameter and one optimizer step."""

    def loss_fn(params, batch):
        e_pred, f_pred = ef_fn(params, batch["x"])
        e_loss = (e_pred - batch["e"]).abs().mean()
        f_loss = (f_pred - batch["f"]).abs().mean()
        return f_loss + energy_loss_weight * e_loss

    def step(state: TrainState, batch: dict):
        leaves = tree_leaves(state.params)
        with torch.enable_grad():
            loss = loss_fn(state.params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return state.apply_gradients(grads), loss.detach()

    return step


def make_branch(cfg: MD17Config, model: SAKEModel, species: torch.Tensor, e_mean: float,
                e_std: float):
    """``(params, ef_fn, ef_eval)`` of the configured branch. ``params`` are
    the training parameters: the model's own (by name) on the plain branch,
    ``ModelParams`` converted from its linen-named weights on the kernel
    branch. ``ef_fn(params, x)`` is the colored ``(E (B, 1), F)`` the loss
    differentiates; ``ef_eval`` is the f32 functional path both branches
    evaluate on (JAX ``:181-202``)."""
    n_atoms = len(species)

    def h_of(x):
        sp = species.to(device=x.device, dtype=torch.float32)
        return sp.expand(x.shape[0], n_atoms, sp.shape[-1])

    def colored(e, f):
        return coloring(e, e_mean, e_std)[..., None], f * e_std

    if cfg.use_kernel_ef:
        ef_raw = make_ef_train2(
            n_heads=cfg.n_heads, update=True, batch_tile=cfg.kernel_batch_tile,
            aug_batch_tile=cfg.aug_batch_tile, pad_atoms=True, aug_mode=cfg.aug_mode,
            interpret=cfg.kernel_interpret,
        )
        params = model_params_from_linen(linen_tree(model),
                                         device=next(model.parameters()).device)
        for t in flat_params(params):
            t.requires_grad_(True)

        def ef_fn(kp, x):
            return colored(*ef_raw(kp, h_of(x), x))

        def ef_eval(kp, x):
            with torch.no_grad():
                return colored(*energy_and_forces_fn(kp, h_of(x), x, n_heads=cfg.n_heads))

        return params, ef_fn, ef_eval

    def ef_fn(_, x):
        return colored(*energy_and_forces_fn(model.functional_params(), h_of(x), x,
                                             n_heads=cfg.n_heads))

    def ef_eval(_, x):
        with torch.no_grad():
            return ef_fn(None, x)

    return dict(model.named_parameters()), ef_fn, ef_eval


def run(cfg: MD17Config, logger: Optional[MetricLogger] = None, *, device=None):
    """Train for ``cfg.n_epochs`` and evaluate the validation split; returns
    ``(state, results)`` with the bootstrap E and F MAE in kcal/mol.
    ``device=None`` means the CUDA card."""
    if cfg.checkpoint_dir:
        raise NotImplementedError("md17.run: checkpoints are not ported yet")
    device = resolve_device(device)
    logger = logger or MetricLogger()
    data = load_md17(cfg.molecule, cfg.data_dir, n_samples=cfg.n_train + 2 * cfg.n_valid)
    n_tr = cfg.n_train
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    train = {"x": put(data.x[:n_tr]), "e": put(data.e[:n_tr]), "f": put(data.f[:n_tr])}
    x_vl = put(data.x[n_tr : n_tr + cfg.n_valid])
    e_vl = put(data.e[n_tr : n_tr + cfg.n_valid])
    f_vl = put(data.f[n_tr : n_tr + cfg.n_valid])

    e_mean, e_std = float(data.e[:n_tr].mean()), float(data.e[:n_tr].std())
    species = species_onehot(data.z, int(data.z.max()))
    model = make_model(cfg, species.shape[-1], device=device,
                       generator=torch.Generator().manual_seed(cfg.seed))
    params, ef_fn, ef_eval = make_branch(cfg, model, species, e_mean, e_std)
    total_steps = (n_tr // cfg.batch_size) * cfg.n_epochs
    tx = make_optimizer(warmup_cosine_schedule(cfg.learning_rate, total_steps))
    state = TrainState.create(params=params, tx=tx)
    step_fn = make_step_fn(ef_fn, cfg.energy_loss_weight)

    t0 = time.time()
    for block in range(cfg.n_epochs // cfg.epochs_per_block):
        for _ in range(cfg.epochs_per_block):
            batches = shuffle_batches(np.random.RandomState(state.step), train, cfg.batch_size)
            state, losses = run_epoch(step_fn, state, batches)
        logger.log(state.step, epoch=(block + 1) * cfg.epochs_per_block,
                   train_loss=float(losses.mean()), wall=round(time.time() - t0, 2))

    # eval: bootstrap MAE in kcal/mol (reference: md17/eval.py:78-85)
    e_pred, f_pred = ef_eval(state.params, x_vl)
    e_mae = bootstrap_mae(e_pred * KCAL_PER_MOL, e_vl * KCAL_PER_MOL)
    f_mae = bootstrap_mae(f_pred.reshape(-1, 3) * KCAL_PER_MOL,
                          f_vl.reshape(-1, 3) * KCAL_PER_MOL)
    results = {
        "e_mae_kcalmol": e_mae[0],
        "e_mae_ci": (e_mae[1], e_mae[2]),
        "f_mae_kcalmol": f_mae[0],
        "f_mae_ci": (f_mae[1], f_mae[2]),
    }
    logger.log(state.step, **{k: v for k, v in results.items() if not isinstance(v, tuple)})
    return state, results


if __name__ == "__main__":
    import sys

    molecule = sys.argv[1] if len(sys.argv) > 1 else "aspirin"
    run(MD17Config(molecule=molecule, n_epochs=20, epochs_per_block=5))
