"""Large-system force-matching training on the cutoff-sparse path.

Port of ``sake_tpu/tasks/sparse_train.py``: ``SparseTrainConfig`` and
:func:`run`. The MD17 objective (force MAE + ``energy_coef`` * energy MAE,
F = -dE/dx) over an amorphous box of ``n_atoms``, against the forces and
energies of a teacher (the same architecture from another seed), with adam
(``train/optim.Adam``, optax's rule). Two branches:

- plain: double autograd through ``sparse.sparse_model_forward(remat=True)``;
- ``use_kernel``: ``kernels/sparse_ef.make_sparse_kernel_force_loss``, whose
  edge op runs #13 and #14 in the force pass and #14 with the leaf
  gradients and #15 in the parameter gradient.

Differences from the JAX task: the weights come from seeded inits (JAX's
``PRNGKey(seed)`` gives other numbers); the kernels run the f32 tier (the
JAX task's chip default is bf16 edge products, ``:124``); steps run one by
one and ``steps_per_block`` is the logging interval; ``block_rows``,
``bn2`` and ``kernel_interpret`` only shape the TPU kernels and are
ignored.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sake_tpu_torch.kernels.functional import flat_params
from sake_tpu_torch.sparse import make_sparse_energy_forces, neighbor_list
from sake_tpu_torch.tasks.sparse_md import make_params
from sake_tpu_torch.train.metrics import MetricLogger
from sake_tpu_torch.train.optim import Adam
from sake_tpu_torch.utils import resolve_device


@dataclass
class SparseTrainConfig:
    # system
    n_atoms: int = 1024
    n_species: int = 5
    density: float = 0.05
    # model
    hidden_features: int = 64
    depth: int = 6
    n_heads: int = 4
    # neighbour list
    cutoff: float = 5.0
    max_neighbors: int = 48
    # objective
    energy_coef: float = 1e-3
    # training
    learning_rate: float = 1e-4
    n_steps: int = 100
    steps_per_block: int = 10  # steps between log lines
    # execution
    use_kernel: bool = False
    block_rows: int = 32
    bn2: Optional[int] = None
    kernel_interpret: bool = False
    seed: int = 0


def synthesize(cfg: SparseTrainConfig, device):
    """``(h (1, N, n_species), x (1, N, 3))`` as the JAX task draws them."""
    rng = np.random.RandomState(cfg.seed)
    side = (cfg.n_atoms / cfg.density) ** (1.0 / 3.0)
    x = torch.as_tensor((rng.rand(1, cfg.n_atoms, 3) * side).astype(np.float32), device=device)
    species = torch.as_tensor(rng.randint(0, cfg.n_species, (1, cfg.n_atoms)), device=device)
    return torch.nn.functional.one_hot(species, cfg.n_species).float(), x


def make_loss(cfg: SparseTrainConfig, h, x, idx, m, f_t, e_t):
    """``loss(params) -> scalar`` of the configured branch."""
    if cfg.use_kernel:
        from sake_tpu_torch.kernels.sparse_ef import make_sparse_kernel_force_loss

        loss_fn = make_sparse_kernel_force_loss(h, energy_coef=cfg.energy_coef,
                                                n_heads=cfg.n_heads, update=False)
        return lambda p: loss_fn(p, x, idx, m, f_t, e_t)
    ef = make_sparse_energy_forces(h, n_heads=cfg.n_heads, update=False, remat=True)

    def loss(p):
        e_b, f = ef(p, x, idx, m)
        return (f - f_t).abs().mean() + cfg.energy_coef * (e_b - e_t).abs().mean()

    return loss


def setup(cfg: SparseTrainConfig, device):
    """``(params, loss)``: the student's weights (requiring grad) and the
    branch's loss against the teacher's labels."""
    h, x = synthesize(cfg, device)
    kp = make_params(cfg, cfg.n_species, cfg.seed, device)
    teacher = make_params(cfg, cfg.n_species, cfg.seed + 1, device)
    idx, m = neighbor_list(x, cfg.cutoff, cfg.max_neighbors)
    # teacher labels (the plain tier, computed once)
    e_t, f_t = make_sparse_energy_forces(h, n_heads=cfg.n_heads, update=False,
                                         remat=True)(teacher, x, idx, m)
    for t in flat_params(kp):
        t.requires_grad_(True)
    return kp, make_loss(cfg, h, x, idx, m, f_t, e_t)


def make_step(cfg: SparseTrainConfig, kp, loss):
    """``step() -> loss``: one adam step on ``kp``'s tensors, in place."""
    leaves = flat_params(kp)
    tx = Adam(cfg.learning_rate)
    state = [tx.init(leaves)]

    def step():
        lval = loss(kp)
        # update=False leaves the update head unused: its gradient is zero
        grads = torch.autograd.grad(lval, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        updates, state[0] = tx.update(grads, state[0], leaves)
        with torch.no_grad():
            for p, u in zip(leaves, updates):
                p.add_(u)
        return lval.detach()

    return step


def run(cfg: SparseTrainConfig, logger: Optional[MetricLogger] = None, *, device=None):
    """Train ``cfg.n_steps`` adam steps; returns ``(params, result)``.
    ``device=None`` means the CUDA card."""
    device = resolve_device(device)
    logger = logger or MetricLogger()
    kp, loss = setup(cfg, device)
    step_fn = make_step(cfg, kp, loss)
    losses = []
    t0 = time.time()
    for step in range(cfg.n_steps):
        losses.append(step_fn())
        if (step + 1) % cfg.steps_per_block == 0 or step + 1 == cfg.n_steps:
            block = torch.stack(losses[-cfg.steps_per_block:])
            logger.log(step + 1, train_loss=float(block.mean()),
                       wall=round(time.time() - t0, 2))
    flat = torch.stack(losses).cpu().numpy()
    wall = time.time() - t0
    result = {
        "first_loss": float(flat[0]),
        "final_loss": float(flat[-1]),
        "loss_decreased": bool(flat[-1] < flat[0]),
        "finite": bool(np.isfinite(flat).all()),
        "steps_per_s": round(len(flat) / wall, 3),
        "atom_updates_per_s": round(len(flat) * cfg.n_atoms / wall, 1),
        "wall_s": round(wall, 1),
    }
    return kp, result
