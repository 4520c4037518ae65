"""Large-system MD on the cutoff-sparse path.

Port of ``sake_tpu/tasks/sparse_md.py``: ``SparseMDConfig``,
:func:`_synthesize_box` (the same numpy draws as the JAX task, so the box,
positions, species and velocities are the JAX ones bit for bit) and
:func:`run`, which integrates velocity-Verlet with neighbour-list rebuilds
(``md.neighborlist_verlet_rollout``) on a SAKE force field over thousands of
atoms: the plain sparse model (``sparse.make_sparse_energy_forces``) or,
with ``use_kernel``, the edge kernels #13 and #14
(``kernels/sparse_ef.make_sparse_kernel_energy_forces``).

The weights come from a seeded init (the JAX task's ``PRNGKey(seed)``
init gives other numbers from the same seed); throughput and stability do
not depend on them. Differences from the JAX task:

- the kernels run the f32 tier (the JAX task runs bf16 edge products on the
  chip, ``:110-112``; the bf16 tier is queued in ROADMAP);
- ``compile_s`` is the time of the first rollout, which builds the kernels
  on first use; the reported rate is the second rollout's, as in JAX;
- ``checkpoint_dir`` raises: checkpoints are not ported (ROADMAP Queue 1
  item 6); ``kernel_block_rows`` and ``kernel_interpret`` only shape the
  TPU kernels and are ignored.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sake_tpu_torch.md import neighborlist_verlet_rollout
from sake_tpu_torch.models import SAKEModel
from sake_tpu_torch.sparse import make_sparse_energy_forces
from sake_tpu_torch.train.metrics import MetricLogger
from sake_tpu_torch.utils import resolve_device


@dataclass
class SparseMDConfig:
    # system
    n_atoms: int = 4096
    n_species: int = 5
    density: float = 0.05  # atoms per unit volume (sets the box side)
    periodic: bool = False  # minimum-image PBC over the density-derived box
    mass: float = 12.0
    v0_scale: float = 0.05  # initial Maxwell-ish velocity scale
    # model
    hidden_features: int = 64
    depth: int = 6
    n_heads: int = 4
    checkpoint_dir: Optional[str] = None  # restore trained params (not ported)
    # neighbour list
    cutoff: float = 5.0
    max_neighbors: int = 64
    skin: float = 0.5
    rebuild_every: int = 10
    # None = O(N^2) all-pairs build; an int selects the O(N·27·cap) cell-list
    # build (periodic boxes only)
    cell_capacity: Optional[int] = None
    # integration
    dt: float = 1e-3
    n_steps: int = 100
    remat: bool = True
    # the edge-kernel force field (kernels/sparse_ef.py); the plain sparse
    # model otherwise
    use_kernel: bool = False
    kernel_block_rows: int = 32
    kernel_interpret: bool = False
    seed: int = 0


def _synthesize_box(cfg: SparseMDConfig, device=None):
    """``(h (1, N, n_species), x (1, N, 3), v0 (1, N, 3), box)``: a uniform
    amorphous box at ``cfg.density``, drawn as the JAX task draws it.
    ``box`` is the side as a float32 triple of Python floats when periodic,
    else None."""
    rng = np.random.RandomState(cfg.seed)
    side = (cfg.n_atoms / cfg.density) ** (1.0 / 3.0)
    box = tuple([float(np.float32(side))] * 3) if cfg.periodic else None
    x = torch.as_tensor((rng.rand(1, cfg.n_atoms, 3) * side).astype(np.float32), device=device)
    species = rng.randint(0, cfg.n_species, (1, cfg.n_atoms))
    h = torch.nn.functional.one_hot(torch.as_tensor(species, device=device),
                                    cfg.n_species).float()
    v0 = torch.as_tensor((rng.randn(1, cfg.n_atoms, 3) * cfg.v0_scale).astype(np.float32),
                         device=device)
    return h, x, v0, box


def make_params(cfg, n_species: int, seed: int, device):
    """A seeded ``SAKEModel(update=False)``'s weights as ``ModelParams``
    (no gradient)."""
    model = SAKEModel(cfg.hidden_features, 1, cfg.depth, n_heads=cfg.n_heads, update=False,
                      in_features=n_species, device=device,
                      generator=torch.Generator().manual_seed(seed))
    model.requires_grad_(False)
    return model.functional_params()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: SparseMDConfig, logger: Optional[MetricLogger] = None, *, device=None):
    """Roll out ``cfg.n_steps`` steps (twice: the first builds, the second
    is timed). Returns ``((xs, vs, es), results)``. ``device=None`` means
    the CUDA card."""
    if cfg.checkpoint_dir is not None:
        raise NotImplementedError("sparse_md.run: checkpoints are not ported yet (ROADMAP "
                                  "Queue 1 item 6)")
    device = resolve_device(device)
    logger = logger or MetricLogger()
    h, x, v0, box = _synthesize_box(cfg, device)
    kp = make_params(cfg, cfg.n_species, cfg.seed, device)
    masses = torch.full((cfg.n_atoms,), cfg.mass, device=device)
    if cfg.use_kernel:
        from sake_tpu_torch.kernels.sparse_ef import make_sparse_kernel_energy_forces

        ef = make_sparse_kernel_energy_forces(h, n_heads=cfg.n_heads, update=False, box=box)
    else:
        ef = make_sparse_energy_forces(h, n_heads=cfg.n_heads, update=False, remat=cfg.remat,
                                       box=box)

    def rollout():
        with torch.no_grad():
            return neighborlist_verlet_rollout(
                ef, kp, x, v0, masses, cfg.dt, cfg.n_steps, cutoff=cfg.cutoff,
                max_neighbors=cfg.max_neighbors, rebuild_every=cfg.rebuild_every,
                skin=cfg.skin, box=box,
                cell_capacity=cfg.cell_capacity if cfg.periodic else None, with_overflow=True)

    t0 = time.time()
    rollout()
    _sync(device)
    compile_s = time.time() - t0
    t1 = time.time()
    xs, vs, es, ovfs = rollout()
    _sync(device)
    run_s = time.time() - t1

    es = es[:, 0].cpu().numpy()
    steps_per_s = cfg.n_steps / run_s
    results = {
        "steps_per_s": round(steps_per_s, 2),
        "atom_steps_per_s": round(steps_per_s * cfg.n_atoms, 1),
        "compile_s": round(compile_s, 1),
        "energy_first": float(es[0]),
        "energy_last": float(es[-1]),
        "energy_drift_abs": float(abs(es[-1] - es[0])),
        "finite": bool(torch.isfinite(xs).all()),
        # dropped neighbours at the worst rebuild: nonzero means the trajectory
        # ran on a truncated graph
        "max_nbr_overflow": int(ovfs.max()),
        "n_atoms": cfg.n_atoms,
    }
    logger.log(cfg.n_steps, **results)
    return (xs, vs, es), results
