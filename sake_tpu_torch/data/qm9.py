"""QM9 property-regression dataset (padded batches + masks).

Port of ``sake_tpu/data/qm9.py`` (all of it, pure numpy: the same seed
gives the same arrays as the JAX package). Loads the packaged QM9 .npz
(arrays: per-molecule padded charges ``i``, positions ``x``, targets ``y``)
when a local copy exists; otherwise synthesizes a structurally identical
dataset (29-atom padding, padded coordinate zeros, graph-level scalar
targets from a surrogate function), so nothing is downloaded.

Splits follow the DimeNet-comparable convention: 110k train / 10k valid /
rest test at seed 42, scaled down proportionally for synthetic runs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

QM9_MAX_ATOMS = 29
QM9_CHARGES = (1, 6, 7, 8, 9)  # H C N O F
# thermochemical energy offsets subtracted per element
# (reference: scripts/qm9_full/run.py:15-18 pattern)
ATOM_REF_ENERGY = {1: -0.500273, 6: -37.846772, 7: -54.583861,
                   8: -75.064579, 9: -99.718730}


@dataclass
class QM9Data:
    charges: np.ndarray  # (B, N) int, 0 = padding
    x: np.ndarray  # (B, N, 3)
    y: np.ndarray  # (B, 1)


def synthesize_qm9(n_samples: int = 4096, seed: int = 0) -> QM9Data:
    rng = np.random.RandomState(seed)
    n = QM9_MAX_ATOMS
    sizes = rng.randint(8, n + 1, size=n_samples)
    charges = np.zeros((n_samples, n), np.int32)
    x = np.zeros((n_samples, n, 3), np.float32)
    y = np.zeros((n_samples, 1), np.float32)
    zvals = np.array(QM9_CHARGES)
    probs = np.array([0.5, 0.35, 0.05, 0.08, 0.02])
    for b, s in enumerate(sizes):
        z = rng.choice(zvals, size=s, p=probs)
        pos = rng.randn(s, 3) * 1.8
        charges[b, :s] = z
        x[b, :s] = pos
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1) + np.eye(s)
        # smooth surrogate target: pairwise-decay + composition terms
        y[b] = (np.exp(-d).sum() - d.shape[0]) * 0.5 + 0.1 * z.sum()
    return QM9Data(charges=charges, x=x, y=y.astype(np.float32))


def atomization_offsets(charges: np.ndarray) -> np.ndarray:
    """Per-molecule sum of element reference energies ``(B, 1)`` — the
    thermochemical offset subtracted from total-energy targets when the
    dataset ships no precomputed ``<target>_thermo`` arrays."""
    table = np.zeros(max(ATOM_REF_ENERGY) + 1, np.float64)
    for z, e in ATOM_REF_ENERGY.items():
        table[z] = e
    return table[charges].sum(axis=-1, keepdims=True).astype(np.float32)


# energy-like targets where atomization offsets apply when no thermo
# column exists (reference subtracts shipped per-target thermo arrays,
# scripts/qm9_full/run.py:15-18; U0/U/H/G are the total-energy ones)
_ENERGY_TARGETS = ("U0", "U", "H", "G")


def load_qm9(
    data_dir: str | None = None,
    n_samples: int = 4096,
    seed: int = 0,
    target: "str | int | None" = None,
    subtract_thermo: bool = True,
) -> QM9Data:
    """Load QM9 from ``data_dir`` or synthesize.

    Two on-disk formats are accepted:

    - ``qm9.npz`` with keys ``i``/``x``/``y`` (the qm9_tpu release file,
      ``scripts/qm9_tpu/run.sh:1-7``); an int ``target`` selects a column
      of a multi-target ``y``.
    - ``train.npz``-style with ``charges``/``positions`` and NAMED target
      keys (``scripts/qm9_full/run.py:10-18``); a str ``target`` selects
      the key, and ``<target>_thermo`` is subtracted when present
      (``run.py:15-18``). When absent and the target is a total energy
      (U0/U/H/G), per-element reference energies (``ATOM_REF_ENERGY``)
      are subtracted instead.
    """
    for fname in ("qm9.npz", "train.npz"):
        path = os.path.join(data_dir or ".", fname)
        if data_dir and os.path.exists(path):
            z = np.load(path)
            break
    else:
        return synthesize_qm9(n_samples, seed)

    charges = np.asarray(
        z["i"] if "i" in z else z["charges"], np.int32
    )
    x = np.asarray(z["x"] if "x" in z else z["positions"], np.float32)
    if isinstance(target, str):
        y = np.asarray(z[target], np.float32).reshape(len(x), -1)
        if subtract_thermo:
            tkey = target + "_thermo"
            if tkey in z:
                y = y - np.asarray(z[tkey], np.float32).reshape(len(x), -1)
            elif target in _ENERGY_TARGETS:
                y = y - atomization_offsets(charges)
    else:
        y = np.asarray(z["y"], np.float32).reshape(len(x), -1)
        if target is not None:
            y = y[:, int(target) : int(target) + 1]
    return QM9Data(charges=charges, x=x, y=y)


def dimenet_split(n_total: int, seed: int = 42, n_train=110_000, n_valid=10_000):
    """The reference's re-split (``scripts/qm9_tpu/run.py:12-22``), scaled
    down proportionally when the dataset is smaller than full QM9."""
    if n_total < n_train + n_valid + 1:
        n_train = int(n_total * 0.84)
        n_valid = int(n_total * 0.08)
    rng = np.random.RandomState(seed)
    idxs = rng.permutation(n_total)
    return (
        idxs[:n_train],
        idxs[n_train : n_train + n_valid],
        idxs[n_train + n_valid :],
    )
