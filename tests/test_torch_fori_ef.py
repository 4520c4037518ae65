"""The port's boundary-keeping E + F (``kernels/fori_ef.fori_energy_forces``,
#21 + #22, and ``kernels/depthgrid_ef.depthgrid_energy_forces``, #23 + #24)
against the JAX package.

On CPU tensors the wrappers run their plain versions (``fori_fwd_plain``,
``fori_bwd_plain``: ``layer_fwd_resid`` and ``layer_bwd_resid`` re-run per
layer; ``depthgrid_fwd_plain``, ``depthgrid_bwd_plain``: the wide layer and
its ``torch.func.vjp``); the CUDA kernels are checked against those on the
card by ``chip_smoke.py`` and by the ``gpu``-marked test here. References:
``jax.value_and_grad`` of the linen model, and one tiny case of each JAX
entry point run by the Pallas interpreter (``fori_energy_forces`` with
``pad_atoms``, ``depthgrid_energy_forces``).

Tolerance: ``rtol=2e-4, atol=2e-5``, the JAX test's own
(``tests/test_kernels.py:17``; f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels import depthgrid_ef, fori_ef
from sake_tpu_torch.kernels.adapter import model_params_from_linen
from sake_tpu_torch.kernels.functional import embed
from sake_tpu_torch.kernels.leaves import layer_leaves, wide_stack

TOL = dict(rtol=2e-4, atol=2e-5)
B, N, F_IN, HID, K = 4, 7, 5, 16, 4
UPD = [1.0, 0.4]
ENTRY = {"fori": fori_ef.fori_energy_forces,
         "depthgrid": depthgrid_ef.depthgrid_energy_forces}


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(11)
    h = rng.randn(B, N, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(B, N, 3)).astype(np.float32)
    return dict(h=h, x=x, dh=rng.randn(B, N, HID).astype(np.float32))


_MODELS = {}


def _model(update, depth, h, x, seed=6):
    """The linen model and its seeded weights, built once per module."""
    key = (str(update), depth)
    if key not in _MODELS:
        model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=depth, update=update)
        params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(h), jnp.asarray(x))
        _MODELS[key] = model, params
    return _MODELS[key]


def _jax_ef(model, params, h, x):
    @jax.jit
    def ef(p, h_, x_):
        def energy(xx):
            out, _, _ = model.apply(p, h_, xx)
            return out.sum(), out.sum(axis=(-2, -1))

        (_, e), g = jax.value_and_grad(energy, has_aux=True)(x_)
        return e, -g

    e, f = ef(params, jnp.asarray(h), jnp.asarray(x))
    return np.asarray(e), np.asarray(f)


def _stack_inputs(s, tp):
    """The kernels' inputs: the embedded ``h0 (B, N, F)`` and ``xs (3, B, N)``."""
    return (embed(tp, _t(s["h"])).contiguous(), _t(s["x"].transpose(2, 0, 1)).contiguous())


@pytest.mark.parametrize("entry", ["fori", "depthgrid"])
@pytest.mark.parametrize("update,depth", [(True, 2), ([False, True, False], 3)])
def test_energy_forces_match_linen(setup, entry, update, depth):
    """E and F against ``jax.value_and_grad`` of the linen model, every layer
    updating and the mixed schedule of ``test_kernels.py:250-270``; the JAX
    tiling keywords are accepted."""
    s = setup
    model, params = _model(update, depth, s["h"], s["x"])
    e_ref, f_ref = _jax_ef(model, params, s["h"], s["x"])
    tp = model_params_from_linen(_np_tree(params))
    e, f = ENTRY[entry](tp, _t(s["h"]), _t(s["x"]), update=update, batch_tile=2,
                        precision="highest", edge_precision="highest")
    assert e.shape == (B,) and f.shape == (B, N, 3)
    np.testing.assert_allclose(e.numpy(), e_ref, **TOL)
    np.testing.assert_allclose(f.numpy(), f_ref, **TOL)


def test_fori_matches_jax_interpret_padded(setup):
    """``pad_atoms=True`` against the JAX padded call (N = 7 padded to 8, pad
    senders masked, pad receivers cropped) run by the Pallas interpreter: the
    port pads nothing and gives the same E and F."""
    from sake_tpu.kernels.fori_ef import fori_energy_forces as jax_fori

    s = setup
    _, params = _model(True, 2, s["h"], s["x"])
    e_j, f_j = jax_fori(jax_from_linen(params), jnp.asarray(s["h"]), jnp.asarray(s["x"]),
                        batch_tile=2, pad_atoms=True, interpret=True)
    tp = model_params_from_linen(_np_tree(params))
    e, f = fori_ef.fori_energy_forces(tp, _t(s["h"]), _t(s["x"]), pad_atoms=True)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), **TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), **TOL)


def test_depthgrid_matches_jax_interpret(setup):
    """Against the JAX ``depthgrid_energy_forces`` run by the Pallas
    interpreter (#23 and #24 on the depth grid)."""
    from sake_tpu.kernels.depthgrid_ef import depthgrid_energy_forces as jax_depthgrid

    s = setup
    _, params = _model(True, 2, s["h"], s["x"])
    e_j, f_j = jax_depthgrid(jax_from_linen(params), jnp.asarray(s["h"]), jnp.asarray(s["x"]),
                             batch_tile=2, interpret=True)
    tp = model_params_from_linen(_np_tree(params))
    e, f = depthgrid_ef.depthgrid_energy_forces(tp, _t(s["h"]), _t(s["x"]), batch_tile=2)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), **TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), **TOL)


def _wide_stack_vjp(leaves, h0, xs, upd, dh):
    """Torch autograd of a ``layer_forward_wide`` stack from ``(h0, xs, v =
    0)``: the final ``h`` and the cotangents of ``(h0, xs, v0)`` under ``(dh,
    0, 0)``."""
    h0 = h0.clone().requires_grad_(True)
    xs = xs.clone().requires_grad_(True)
    v0 = torch.zeros_like(xs).requires_grad_(True)
    h, xp, vp = h0, [xs[k][..., None] for k in range(3)], [v0[k][..., None] for k in range(3)]
    for l, u in enumerate(upd):
        h, xp, vp = depthgrid_ef.layer_forward_wide(layer_leaves(leaves, l), h, xp, vp, u)
    grads = torch.autograd.grad((h * dh).sum(), (h0, xs, v0))
    return h.detach(), grads


@pytest.mark.parametrize("which", ["fori", "depthgrid"])
def test_plain_pullbacks_match_autograd_of_wide_stack(setup, which):
    """``fori_bwd_plain`` (re-run ``layer_fwd_resid``, ``layer_bwd_resid``)
    and ``depthgrid_bwd_plain`` (``torch.func.vjp`` of the wide layer) on the
    boundaries of their forwards, against torch autograd of a
    ``layer_forward_wide`` stack, at a fractional update gate: ``dh0``,
    ``dx``, ``dv``; and the forwards' final ``h``."""
    s = setup
    _, params = _model(True, 2, s["h"], s["x"])
    tp = model_params_from_linen(_np_tree(params))
    leaves = wide_stack(tp, K)
    h0, xs = _stack_inputs(s, tp)
    h_ref, want = _wide_stack_vjp(leaves, h0, xs, UPD, _t(s["dh"]))
    fwd, bwd = ((fori_ef.fori_fwd_plain, fori_ef.fori_bwd_plain) if which == "fori"
                else (depthgrid_ef.depthgrid_fwd_plain, depthgrid_ef.depthgrid_bwd_plain))
    with torch.no_grad():
        bnd = fwd(leaves, h0, xs, UPD)
        got = bwd(leaves, bnd, UPD, _t(s["dh"]))
    torch.testing.assert_close(bnd.h_fin, h_ref, **TOL)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)


def test_fori_and_depthgrid_plain_boundaries_agree(setup):
    """The two forwards' boundaries (``layer_fwd_resid`` against the wide
    layer) agree: every layer's h, x, v and the final h."""
    s = setup
    _, params = _model(True, 2, s["h"], s["x"])
    tp = model_params_from_linen(_np_tree(params))
    leaves = wide_stack(tp, K)
    h0, xs = _stack_inputs(s, tp)
    with torch.no_grad():
        a = fori_ef.fori_fwd_plain(leaves, h0, xs, UPD)
        b = depthgrid_ef.depthgrid_fwd_plain(leaves, h0, xs, UPD)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, **TOL)


@pytest.mark.parametrize("entry", ["fori", "depthgrid"])
def test_chunks_give_the_whole_batch(setup, entry):
    """A chunk of 3 molecules (a chunk of 3 and a ragged one of 1) gives the
    unchunked E and F."""
    s = setup
    _, params = _model(True, 2, s["h"], s["x"])
    tp = model_params_from_linen(_np_tree(params))
    e1, f1 = ENTRY[entry](tp, _t(s["h"]), _t(s["x"]), chunk=3)
    e2, f2 = ENTRY[entry](tp, _t(s["h"]), _t(s["x"]), chunk=None)
    torch.testing.assert_close(e1, e2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(f1, f2, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("entry", ["fori", "depthgrid"])
def test_entry_points_reject_the_bf16_tier(setup, entry):
    s = setup
    _, params = _model(True, 2, s["h"], s["x"])
    tp = model_params_from_linen(_np_tree(params))
    for kw in (dict(matmul_dtype=torch.bfloat16), dict(edge_matmul_dtype=torch.bfloat16)):
        with pytest.raises(NotImplementedError):
            ENTRY[entry](tp, _t(s["h"]), _t(s["x"]), **kw)


def test_wrappers_count_only_card_launches(setup):
    """On CPU tensors #21-#24's wrappers take their plain versions and leave
    their launch counts alone."""
    s = setup
    _, params = _model(True, 2, s["h"], s["x"])
    tp = model_params_from_linen(_np_tree(params))
    counted = (fori_ef.fori_fwd, fori_ef.fori_bwd, depthgrid_ef.depthgrid_fwd,
               depthgrid_ef.depthgrid_bwd)
    before = [c.launches for c in counted]
    for entry in ENTRY.values():
        entry(tp, _t(s["h"]), _t(s["x"]))
    assert [c.launches for c in counted] == before


@pytest.mark.gpu
def test_remat_kernels_match_plain_on_the_card(setup):
    """#21-#24 against their plain versions on the card, at hidden 8 (50 rbf
    channels > H*K = 32) and 16, a fractional update gate, and each count
    moving by its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sake_tpu_torch.kernels.functional import params_to

    dev = torch.device("cuda")
    rng = np.random.RandomState(4)
    for hid in (8, HID):
        model = JaxSAKEModel(hidden_features=hid, out_features=1, depth=2)
        params = model.init(jax.random.PRNGKey(0), jnp.asarray(setup["h"]),
                            jnp.asarray(setup["x"]))
        leaves = wide_stack(params_to(model_params_from_linen(_np_tree(params)), dev), K)
        h0 = torch.as_tensor(rng.randn(B, N, hid).astype(np.float32), device=dev)
        xs = _t(setup["x"].transpose(2, 0, 1)).contiguous().to(dev)
        dh = torch.as_tensor(rng.randn(B, N, hid).astype(np.float32), device=dev)
        pf = fori_ef.fori_fwd_plain(leaves, h0, xs, UPD)
        pb = fori_ef.fori_bwd_plain(leaves, pf, UPD, dh)
        for fwd, bwd, n in ((fori_ef.fori_fwd, fori_ef.fori_bwd, 1),
                            (depthgrid_ef.depthgrid_fwd, depthgrid_ef.depthgrid_bwd, 2)):
            before = (fwd.launches, bwd.launches)
            kf, kb = fwd(leaves, h0, xs, UPD), bwd(leaves, pf, UPD, dh)
            torch.cuda.synchronize()
            assert (fwd.launches, bwd.launches) == (before[0] + n, before[1] + n)
            for a, b in zip([*kf, *kb], [*pf, *pb]):
                torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
