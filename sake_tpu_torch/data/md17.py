"""MD17 molecular-dynamics energy/force data.

Port of ``sake_tpu/data/md17.py:20-102``: loads ``<molecule>_dft.npz``
(keys R/E/z/F) when present, else synthesizes conformations around a
random template geometry with energies and forces from a pairwise
Morse-like surrogate. Pure numpy; the same seed gives the same arrays as
the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

# Atomic numbers for aspirin C9H8O4 (21 atoms).
ASPIRIN_Z = np.array([6] * 9 + [8] * 4 + [1] * 8, dtype=np.int32)

MD17_Z = {
    "aspirin": ASPIRIN_Z,
    "benzene": np.array([6] * 6 + [1] * 6, dtype=np.int32),
    "ethanol": np.array([6] * 2 + [8] + [1] * 6, dtype=np.int32),
    "malonaldehyde": np.array([6] * 3 + [8] * 2 + [1] * 4, dtype=np.int32),
    "naphthalene": np.array([6] * 10 + [1] * 8, dtype=np.int32),
    "salicylic": np.array([6] * 7 + [8] * 3 + [1] * 6, dtype=np.int32),
    "toluene": np.array([6] * 7 + [1] * 8, dtype=np.int32),
    "uracil": np.array([6] * 4 + [7] * 2 + [8] * 2 + [1] * 4, dtype=np.int32),
}


@dataclass
class MD17Data:
    x: np.ndarray  # (B, N, 3) positions, Angstrom
    e: np.ndarray  # (B, 1) energies
    f: np.ndarray  # (B, N, 3) forces
    z: np.ndarray  # (N,) atomic numbers


def _surrogate_energy_forces(x: np.ndarray, z: np.ndarray):
    zi = z[:, None] * z[None, :]
    d = x[:, :, None, :] - x[:, None, :, :]
    r = np.sqrt((d**2).sum(-1) + 1e-12)
    np.einsum("bii->bi", r)[...] = 1.0
    r0 = 1.5 + 0.01 * (z[:, None] + z[None, :])
    a = 1.2
    expterm = np.exp(-a * (r - r0))
    pair_e = 0.05 * np.sqrt(zi) * (expterm**2 - 2 * expterm)
    np.einsum("bii->bi", pair_e)[...] = 0.0
    e = 0.5 * pair_e.sum((-1, -2), keepdims=False)[:, None]
    dEdr = 0.05 * np.sqrt(zi) * (-2 * a) * (expterm**2 - expterm)
    np.einsum("bii->bi", dEdr)[...] = 0.0
    f = -(dEdr[..., None] * (d / r[..., None])).sum(axis=2)
    return e.astype(np.float32), f.astype(np.float32)


def synthesize_md17(n_samples: int = 3000, z: np.ndarray = ASPIRIN_Z,
                    temperature: float = 0.1, seed: int = 0) -> MD17Data:
    rng = np.random.RandomState(seed)
    n = len(z)
    template = rng.randn(n, 3) * 2.0
    x = template[None] + temperature * rng.randn(n_samples, n, 3)
    e, f = _surrogate_energy_forces(x, z.astype(np.float64))
    return MD17Data(x=x.astype(np.float32), e=e, f=f, z=z)


def load_md17(molecule: str = "aspirin", data_dir: str | None = None,
              n_samples: int = 3000, seed: int = 2666) -> MD17Data:
    """Load ``<molecule>_dft.npz`` from ``data_dir`` (shuffled with the
    seed-2666 permutation) or synthesize."""
    path = os.path.join(data_dir or ".", f"{molecule}_dft.npz")
    if data_dir and os.path.exists(path):
        data = np.load(path)
        idxs = np.random.RandomState(2666).permutation(len(data["R"]))
        return MD17Data(
            x=np.asarray(data["R"])[idxs].astype(np.float32),
            e=np.asarray(data["E"])[idxs].astype(np.float32),
            f=np.asarray(data["F"])[idxs].astype(np.float32),
            z=np.asarray(data["z"]).astype(np.int32),
        )
    return synthesize_md17(n_samples=n_samples, z=MD17_Z.get(molecule, ASPIRIN_Z), seed=seed)
