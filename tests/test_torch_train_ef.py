"""The port's ``kernels/train_ef.make_trainable_energy_forces`` (force-loss
training on the E + F kernels, the backward through the plain functional
model), the exported kernel API and MD on the port's fori forces, against
the JAX package.

The kernel primals run their plain versions on CPU tensors; on the card
``chip_smoke.py`` checks the kernels and this function's gradients against
plain double autograd. References here: JAX double autodiff of the linen
model (``tests/test_kernels.py:182-228``) and one derivative more, and
``velocity_verlet_rollout`` on the JAX energy and forces
(``tests/test_md.py:53-90``).

Tolerances are the JAX tests' own: ``rtol=1e-3, atol=1e-5`` on the
embedding and readout gradients, ``rtol=2e-3, atol=2e-5`` per layer (and on
the h and x gradients and the third derivative, which run through the same
layers); MD positions ``rtol=1e-4, atol=1e-5``, velocities ``rtol=1e-3,
atol=1e-4``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels import resid_ef, train_ef
from sake_tpu_torch.kernels.adapter import model_params_from_linen, params_from_jax
from sake_tpu_torch.kernels.functional import flat_params

HEAD_TOL = dict(rtol=1e-3, atol=1e-5)
LAYER_TOL = dict(rtol=2e-3, atol=2e-5)
B, N, F_IN, HID, DEPTH = 4, 7, 5, 16, 2


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(11)
    h = rng.randn(B, N, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(B, N, 3)).astype(np.float32)
    model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=DEPTH)
    params = jax.jit(model.init)(jax.random.PRNGKey(6), jnp.asarray(h), jnp.asarray(x))
    return dict(model=model, params=params, tp=model_params_from_linen(_np_tree(params)), h=h,
                x=x, f_t=rng.randn(B, N, 3).astype(np.float32),
                e_t=rng.randn(B).astype(np.float32), w=rng.randn(B, N, 3).astype(np.float32))


def _loss(e, f, e_t, f_t, mean=lambda a: a.mean(), absval=abs):
    """The JAX test's loss (``test_kernels.py:196-198``)."""
    return mean((f - f_t) ** 2) + 1e-3 * mean(absval(e - e_t))


def _linen_loss(model, h, e_t, f_t):
    def loss(params, x):
        def energy(x_):
            out, _, _ = model.apply(params, h, x_)
            return out.sum(axis=(-2, -1)).sum(), out.sum(axis=(-2, -1))

        (_, e), neg_f = jax.value_and_grad(energy, has_aux=True)(x)
        return _loss(e, -neg_f, e_t, f_t, jnp.mean, jnp.abs)

    return loss


def _port_grads(g_linen):
    """JAX gradients w.r.t. the linen tree as the port's flat parameter list."""
    return [t.numpy() for t in flat_params(params_from_jax(_np_tree(jax_from_linen(g_linen))))]


@pytest.fixture(scope="module")
def lax_ref(setup):
    """JAX double autodiff of the linen model: the loss, its gradients w.r.t.
    the parameters and x, and the gradient of ``<dL/dx, w>`` w.r.t. the
    parameters (one derivative more)."""
    s = setup
    h, x = jnp.asarray(s["h"]), jnp.asarray(s["x"])
    loss = _linen_loss(s["model"], h, jnp.asarray(s["e_t"]), jnp.asarray(s["f_t"]))
    value, (g_p, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(s["params"], x)
    w = jnp.asarray(s["w"])
    g3 = jax.jit(jax.grad(lambda p: jnp.vdot(jax.grad(loss, argnums=1)(p, x), w)))(s["params"])
    return dict(loss=float(value), g_p=_port_grads(g_p), g_x=np.asarray(g_x),
                g3=_port_grads(g3))


def _tol(i, n):
    """Embedding (first two) and readout (last four) leaves take the head
    tolerance, the layers theirs."""
    return HEAD_TOL if i < 2 or i >= n - 4 else LAYER_TOL


def _port_loss(s, ef):
    flat = [t.detach().clone().requires_grad_(True) for t in flat_params(s["tp"])]
    p = resid_ef._unflat_params(flat, DEPTH)
    xt = _t(s["x"]).requires_grad_(True)
    e, f = ef(p, _t(s["h"]), xt)
    assert e.shape == (B,) and f.shape == (B, N, 3)
    assert type(e.grad_fn).__name__ == "EFBackward"  # the Function's backward, not autograd's
    return _loss(e, f, _t(s["e_t"]), _t(s["f_t"])), flat, xt


@pytest.mark.parametrize("primal", ["fori", "resid", "depthgrid"])
def test_trainable_gradients_match_jax_double_autodiff(setup, lax_ref, primal):
    """The force-loss gradients of every parameter and of x through each
    primal against JAX double autodiff of linen."""
    s = setup
    ef = train_ef.make_trainable_energy_forces(primal=primal, batch_tile=2, pad_atoms=True)
    loss, flat, xt = _port_loss(s, ef)
    np.testing.assert_allclose(float(loss.detach()), lax_ref["loss"], rtol=1e-5)
    got = torch.autograd.grad(loss, [*flat, xt])
    assert len(got) == len(lax_ref["g_p"]) + 1
    for i, (g, w) in enumerate(zip(got, lax_ref["g_p"])):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"leaf {i}", **_tol(i, len(flat)))
    np.testing.assert_allclose(got[-1].numpy(), lax_ref["g_x"], **LAYER_TOL)


def test_trainable_backward_is_differentiable_again(setup, lax_ref):
    """One derivative more through the backward: the gradient w.r.t. the
    parameters of ``<dL/dx, w>``, a third derivative of the energy, against
    JAX on the same scalar."""
    s = setup
    ef = train_ef.make_trainable_energy_forces()
    loss, flat, xt = _port_loss(s, ef)
    (g_x,) = torch.autograd.grad(loss, xt, create_graph=True)
    got = torch.autograd.grad((g_x * _t(s["w"])).sum(), flat)
    for i, (g, w) in enumerate(zip(got, lax_ref["g3"])):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"leaf {i}", **LAYER_TOL)


def test_unknown_primal_raises():
    with pytest.raises(ValueError, match="unknown primal"):
        train_ef.make_trainable_energy_forces(primal="split")


def test_kernel_exports_match_jax():
    """``sake_tpu_torch.kernels`` exports the JAX ``sake_tpu.kernels.__all__``,
    every name in its order."""
    import sake_tpu.kernels as jax_kernels
    import sake_tpu_torch.kernels as kernels

    assert kernels.__all__ == jax_kernels.__all__
    for name in kernels.__all__:
        assert callable(getattr(kernels, name)), name


def test_md_rollout_on_fori_forces_matches_jax():
    """``md.velocity_verlet_rollout`` on the port's ``fori_energy_forces``
    against JAX's on the linen energy and forces (``test_md.py:53-90``: B =
    4, N = 5, hidden 8, depth 2, 4 steps of dt 1e-3)."""
    from sake_tpu.md import velocity_verlet_rollout as jax_rollout
    from sake_tpu.models import energy_and_forces
    from sake_tpu_torch.kernels import fori_energy_forces
    from sake_tpu_torch.md import velocity_verlet_rollout

    rng = np.random.RandomState(0)
    b, n, f_in = 4, 5, 3
    h = rng.randn(b, n, f_in).astype(np.float32)
    x0 = rng.randn(b, n, 3).astype(np.float32)
    v0 = (rng.randn(b, n, 3) * 0.05).astype(np.float32)
    model = JaxSAKEModel(hidden_features=8, out_features=1, depth=2)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(h[0]), jnp.asarray(x0[0]))
    hj = jnp.asarray(h)
    xs_l, vs_l, _ = jax.jit(lambda p, x, v: jax_rollout(
        lambda p_, x_: energy_and_forces(model.apply, p_, hj, x_), p, x, v, jnp.ones((n,)),
        dt=1e-3, n_steps=4))(params, jnp.asarray(x0), jnp.asarray(v0))
    tp = model_params_from_linen(_np_tree(params))
    ht = _t(h)
    xs_k, vs_k, _ = velocity_verlet_rollout(
        lambda p_, x_: fori_energy_forces(p_, ht, x_, batch_tile=2, pad_atoms=True), tp, _t(x0),
        _t(v0), torch.ones(n), dt=1e-3, n_steps=4)
    np.testing.assert_allclose(xs_k.numpy(), np.asarray(xs_l), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(vs_k.numpy(), np.asarray(vs_l), rtol=1e-3, atol=1e-4)
