"""The port's serving slice against the JAX package: aspirin MD17 E + F,
colored, through ``tasks/md17.make_energy_force_fn`` -> ``SAKEModel`` ->
``kernels/dispatch`` (plain K1/K2 stacks on the CPU) vs the JAX linen path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.data.md17 import load_md17 as jax_load_md17
from sake_tpu.data.md17 import synthesize_md17 as jax_synthesize
from sake_tpu.tasks.md17 import MD17Config as JaxMD17Config
from sake_tpu.tasks.md17 import make_energy_force_fn as jax_make_ef
from sake_tpu.tasks.md17 import make_model as jax_make_model
from sake_tpu_torch.data.md17 import ASPIRIN_Z, MD17_Z, load_md17, synthesize_md17
from sake_tpu_torch.kernels.adapter import load_linen_params
from sake_tpu_torch.tasks.md17 import (
    MD17Config,
    make_energy_force_fn,
    make_model,
    species_onehot,
)

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("molecule", ["aspirin", "uracil"])
def test_data_matches_jax(molecule):
    a = load_md17(molecule, n_samples=6)
    b = jax_load_md17(molecule, n_samples=6)
    for name in ("x", "e", "f", "z"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(MD17_Z["aspirin"], ASPIRIN_Z)


def test_species_onehot_reproduces_jax_quirk():
    z = ASPIRIN_Z
    got = species_onehot(z, int(z.max())).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.one_hot(z, z.max())))
    assert not got[z == 8].any()  # oxygens: out of range -> all-zero rows
    assert got[z == 6, 6].all() and got[z == 1, 1].all()


def test_slice_matches_jax_linen_path():
    """B = 5 aspirin conformations (not a multiple of 8), hidden 16, depth 2,
    colored with the data's e_mean/e_std."""
    data = jax_synthesize(n_samples=9, seed=3)
    x = data.x[:5]
    e_mean, e_std = float(data.e.mean()), float(data.e.std())
    species_j = jax.nn.one_hot(data.z, data.z.max())
    cfg_j = JaxMD17Config(hidden_features=16, depth=2)
    model_j = jax_make_model(cfg_j)
    params = model_j.init(jax.random.PRNGKey(7),
                          jnp.broadcast_to(species_j, (x.shape[1], species_j.shape[-1])),
                          jnp.asarray(x[0]))
    e_ref, f_ref = jax_make_ef(model_j, species_j, e_mean, e_std)(params, jnp.asarray(x))

    species = species_onehot(data.z, int(data.z.max()))
    model = make_model(MD17Config(hidden_features=16, depth=2), in_features=species.shape[-1],
                       device="cpu")
    load_linen_params(model, jax.tree.map(np.asarray, params))
    e, f = make_energy_force_fn(model, species, e_mean, e_std)(torch.as_tensor(x))
    assert e.shape == (5, 1) and f.shape == (5, 21, 3)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), **TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), **TOL)


def test_seeded_init_is_reproducible():
    data = synthesize_md17(n_samples=2, seed=0)
    species = species_onehot(data.z, int(data.z.max()))
    cfg = MD17Config(hidden_features=8, depth=2)
    outs = []
    for _ in range(2):
        model = make_model(cfg, species.shape[-1], device="cpu",
                           generator=torch.Generator().manual_seed(11))
        outs.append(make_energy_force_fn(model, species, 0.0, 1.0)(torch.as_tensor(data.x)))
    for a, b in zip(*outs):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means CUDA: without a card the entry points raise
    instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_model(MD17Config(hidden_features=8, depth=1), 4)
