"""The port's single-launch E + F (``kernels/one_ef.one_energy_forces``, #3)
and the dispatch that routes large batches to it, against the JAX package.

On CPU tensors ``one_energy_forces`` runs its plain version (the resid
path's plain stacks); the CUDA kernel is checked against that on the card by
``chip_smoke.py``. References: JAX autodiff of the linen model or of the
functional model (masked, with the node-masked readout), as
``tests/test_kernels.py:908-961`` uses, and one tiny case against the JAX
package's own ``one_energy_forces`` run by the Pallas interpreter.

Tolerance: ``rtol=2e-4, atol=2e-5``, the JAX test's own (f32 sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.kernels.functional import model_forward as jax_model_forward
from sake_tpu.kernels.one_ef import one_energy_forces as jax_one_ef
from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels import dispatch, one_ef
from sake_tpu_torch.kernels.adapter import model_params_from_linen

TOL = dict(rtol=2e-4, atol=2e-5)
B, N, F_IN, HID = 5, 7, 5, 16


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(21)
    h = rng.randn(B, N, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(B, N, 3)).astype(np.float32)
    nm = (np.arange(N)[None] < rng.randint(3, N + 1, size=B)[:, None]).astype(np.float32)
    nm[1] = 0.0  # one fully padded molecule
    return dict(h=h, x=x, mask=nm[:, :, None] * nm[:, None, :], node_mask=nm)


def _model(update, depth, h, x, seed=0):
    model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=depth, update=update)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(h), jnp.asarray(x))
    return model, params


def _jax_ef(model, params, h, x):
    def energy(x_):
        out, _, _ = model.apply(params, jnp.asarray(h), x_)
        return out.sum(), out.sum(axis=(-2, -1))

    (_, e), g = jax.value_and_grad(energy, has_aux=True)(jnp.asarray(x))
    return np.asarray(e), -np.asarray(g)


@pytest.mark.parametrize("update,depth,kw", [
    (True, 2, {}),
    (True, 2, dict(pad_atoms=True, batch_tile=4, vmem_limit=1 << 20, batch_parallel=True)),
    ([False, True, False], 3, dict(pad_atoms=True)),
])
def test_one_energy_forces_matches_jax(setup, update, depth, kw):
    """Unmasked, with the JAX tiling arguments (accepted, no counterpart),
    and the mixed update schedule of ``test_kernels.py:926-942``."""
    s = setup
    model, params = _model(update, depth, s["h"], s["x"])
    e_ref, f_ref = _jax_ef(model, params, s["h"], s["x"])
    tp = model_params_from_linen(jax.tree.map(np.asarray, params))
    e, f = one_ef.one_energy_forces(tp, _t(s["h"]), _t(s["x"]), update=update, **kw)
    assert e.shape == (B,) and f.shape == (B, N, 3)
    np.testing.assert_allclose(e.numpy(), e_ref, **TOL)
    np.testing.assert_allclose(f.numpy(), f_ref, **TOL)


def test_one_energy_forces_masked_matches_jax(setup):
    """With an edge mask: the masked layers and the energy summed over the
    mask's diagonal atoms, against JAX autodiff of the masked functional
    model with that readout (a fully padded molecule included)."""
    s = setup
    model, params = _model(True, 2, s["h"], s["x"])
    kp = jax_from_linen(params)
    nm = jnp.asarray(s["node_mask"])

    def energy(x_):
        out, _, _ = jax_model_forward(kp, jnp.asarray(s["h"]), x_, n_heads=4,
                                      mask=jnp.asarray(s["mask"]))
        e = (out * nm[..., None]).sum(axis=(-2, -1))
        return e.sum(), e

    (_, e_ref), g = jax.value_and_grad(energy, has_aux=True)(jnp.asarray(s["x"]))
    tp = model_params_from_linen(jax.tree.map(np.asarray, params))
    e, f = one_ef.one_energy_forces(tp, _t(s["h"]), _t(s["x"]), _t(s["mask"]))
    w = s["node_mask"][..., None]
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), **TOL)
    np.testing.assert_allclose(f.numpy() * w, -np.asarray(g) * w, **TOL)
    assert np.isfinite(f.numpy()).all()


def test_one_energy_forces_matches_jax_interpret():
    """A tiny case (hidden 8, depth 1, B = 2, N = 5) against the JAX
    package's own ``one_energy_forces``, its Pallas kernel run by the
    interpreter."""
    rng = np.random.RandomState(2)
    h = rng.randn(2, 5, F_IN).astype(np.float32)
    x = rng.randn(2, 5, 3).astype(np.float32)
    model = JaxSAKEModel(hidden_features=8, out_features=1, depth=1)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(h), jnp.asarray(x))
    e_ref, f_ref = jax_one_ef(jax_from_linen(params), jnp.asarray(h), jnp.asarray(x),
                              batch_tile=2, interpret=True)
    tp = model_params_from_linen(jax.tree.map(np.asarray, params))
    e, f = one_ef.one_energy_forces(tp, _t(h), _t(x), batch_tile=2, interpret=True)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), **TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), **TOL)


def test_one_energy_forces_rejects_the_bf16_tier(setup):
    model, params = _model(True, 1, setup["h"], setup["x"])
    tp = model_params_from_linen(jax.tree.map(np.asarray, params))
    with pytest.raises(NotImplementedError):
        one_ef.one_energy_forces(tp, _t(setup["h"]), _t(setup["x"]),
                                 edge_matmul_dtype=torch.bfloat16)


def test_dispatch_energy_forces(setup, monkeypatch):
    """The batch-aware dispatch (``test_kernels.py:964``): one_ef from
    ``ONE_EF_MIN_BATCH`` molecules, resid_ef below, the mask and options
    passed through; ``None`` turns the one_ef branch off. Then a real run
    through it on the CPU against JAX autodiff."""
    calls = []
    monkeypatch.setattr(dispatch, "one_energy_forces",
                        lambda *a, **kw: calls.append(("one", a, kw)) or ("e", "f"))
    monkeypatch.setattr(dispatch, "resid_energy_forces",
                        lambda *a, **kw: calls.append(("resid", a, kw)) or ("e", "f"))
    fake = lambda b: (torch.zeros(b, 7, 5), torch.zeros(b, 7, 3))
    threshold = dispatch.ONE_EF_MIN_BATCH
    assert threshold in (2048, 4096, 8192, None)
    if threshold is not None:
        dispatch.dispatch_energy_forces("p", *fake(threshold))
        dispatch.dispatch_energy_forces("p", *fake(threshold - 1), "m", update=[True, False])
        (k0, a0, _), (k1, a1, kw1) = calls
        assert k0 == "one" and a0[0] == "p" and a0[1].shape[0] == threshold
        assert k1 == "resid" and a1[3] == "m" and kw1 == dict(n_heads=4, update=[True, False])
    monkeypatch.setattr(dispatch, "ONE_EF_MIN_BATCH", None)
    calls.clear()
    dispatch.dispatch_energy_forces("p", *fake(1 << 15))
    assert calls[0][0] == "resid"
    monkeypatch.setattr(dispatch, "ONE_EF_MIN_BATCH", 4)  # a real run through the one_ef branch
    monkeypatch.setattr(dispatch, "one_energy_forces", one_ef.one_energy_forces)
    s = setup
    model, params = _model(True, 2, s["h"], s["x"])
    e_ref, f_ref = _jax_ef(model, params, s["h"], s["x"])
    tp = model_params_from_linen(jax.tree.map(np.asarray, params))
    e, f = dispatch.dispatch_energy_forces(tp, _t(s["h"]), _t(s["x"]))
    np.testing.assert_allclose(e.numpy(), e_ref, **TOL)
    np.testing.assert_allclose(f.numpy(), f_ref, **TOL)
