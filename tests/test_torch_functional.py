"""Port parity: ``sake_tpu_torch`` functional model, adapter, leaf layout
and module init against the JAX package on the same weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels import energy_and_forces_fn as jax_ef
from sake_tpu.kernels import model_forward as jax_model_forward
from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.kernels.depthgrid_ef import _LEAF_NAMES as JAX_LEAF_NAMES
from sake_tpu.kernels.depthgrid_ef import wide_stack as jax_wide_stack
from sake_tpu.kernels.split_ef import head_expansion_matrices as jax_head_exp
from sake_tpu.layers import DenseSAKELayer as JaxDenseSAKELayer
from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels.adapter import (
    load_linen_params,
    model_params_from_linen,
    params_from_jax,
)
from sake_tpu_torch.kernels.functional import (
    LayerParams,
    ModelParams,
    energy_and_forces_fn,
    model_forward,
)
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, head_expansion_matrices, wide_stack
from sake_tpu_torch.layers import DenseSAKELayer
from sake_tpu_torch.models import SAKEModel, energy_and_forces
from sake_tpu_torch.radial import exp_normal_init

TOL = dict(rtol=2e-4, atol=2e-5)
B, N, F_IN, HID, DEPTH = 4, 7, 5, 16, 3


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_setup(update=True, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(B, N, F_IN).astype(np.float32)
    x = rng.randn(B, N, 3).astype(np.float32)
    model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=DEPTH, update=update)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(h), jnp.asarray(x))
    return model, params, h, x


@pytest.fixture(scope="module")
def setup():
    return _jax_setup()


@pytest.fixture(scope="module")
def edge_mask():
    rng = np.random.RandomState(1)
    node_mask = (rng.rand(B, N) > 0.3).astype(np.float32)
    return node_mask, node_mask[:, :, None] * node_mask[:, None, :]


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("masked", [False, True])
def test_model_forward_matches_jax(setup, edge_mask, masked):
    _, params, h, x = setup
    node_mask, mask = edge_mask
    kp = jax_from_linen(params)
    tp = model_params_from_linen(_np_tree(params))
    m = mask if masked else None
    rh, rx, rv = jax_model_forward(kp, jnp.asarray(h), jnp.asarray(x),
                                   mask=None if m is None else jnp.asarray(m))
    oh, ox, ov = model_forward(tp, _t(h), _t(x), mask=None if m is None else _t(m))
    w = node_mask[..., None] if masked else 1.0
    np.testing.assert_allclose(oh.numpy() * w, np.asarray(rh) * w, **TOL)
    np.testing.assert_allclose(ox.numpy() * w, np.asarray(rx) * w, **TOL)
    np.testing.assert_allclose(ov.numpy() * w, np.asarray(rv) * w, **TOL)


@pytest.mark.parametrize(
    "update,masked",
    [(True, False), (True, True), ([False, True, False], False), ([True, False, True], True)],
)
def test_energy_and_forces_matches_jax(edge_mask, update, masked):
    _, params, h, x = _jax_setup(update=update, seed=2)
    node_mask, mask = edge_mask
    kp = jax_from_linen(params)
    tp = model_params_from_linen(_np_tree(params))
    m = mask if masked else None
    e_ref, f_ref = jax_ef(kp, jnp.asarray(h), jnp.asarray(x), update=update,
                          mask=None if m is None else jnp.asarray(m))
    e, f = energy_and_forces_fn(tp, _t(h), _t(x), update=update,
                                mask=None if m is None else _t(m))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), **TOL)
    w = node_mask[..., None] if masked else 1.0
    np.testing.assert_allclose(f.numpy() * w, np.asarray(f_ref) * w, **TOL)


def test_adapter_leaf_shapes_and_params_from_jax(setup):
    _, params, _, _ = setup
    kp = jax_from_linen(params)
    tp = model_params_from_linen(_np_tree(params))
    tp2 = params_from_jax(_np_tree(kp))
    flat_j = jax.tree.leaves(kp)
    flat_t, flat_t2 = jax.tree.leaves(tp), jax.tree.leaves(tp2)
    assert len(flat_j) == len(flat_t) == len(flat_t2)
    for a, b, c in zip(flat_j, flat_t, flat_t2):
        assert tuple(a.shape) == tuple(b.shape) == tuple(c.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(b.numpy(), c.numpy())
    assert isinstance(tp, ModelParams) and isinstance(tp.layers[0], LayerParams)


def test_update_less_layers_get_zero_placeholders():
    _, params, _, _ = _jax_setup(update=[False, True, False])
    tp = model_params_from_linen(_np_tree(params))
    kp = jax_from_linen(params)
    for lt, lj in zip(tp.layers, kp.layers):
        for name in ("w_vmix", "w_vel0", "b_vel0", "w_vel1"):
            np.testing.assert_array_equal(getattr(lt, name).numpy(), np.asarray(getattr(lj, name)))
    assert not tp.layers[0].w_vmix.any() and tp.layers[1].w_vmix.any()


def test_wide_stack_layout_matches_jax(setup):
    _, params, _, _ = setup
    kp = jax_from_linen(params)
    leaves = wide_stack(model_params_from_linen(_np_tree(params)), n_heads=4)
    assert tuple(leaves) == LEAF_NAMES == tuple(JAX_LEAF_NAMES)
    for name, ref in zip(JAX_LEAF_NAMES, jax_wide_stack(kp, 4)):
        np.testing.assert_array_equal(leaves[name].numpy(), np.asarray(ref))


def test_head_expansion_is_hidden_major_outer_product():
    H, K = 6, 4
    e_rep, e_tile = head_expansion_matrices(H, K)
    jr, jt = jax_head_exp(H, K)
    np.testing.assert_array_equal(e_rep.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(e_tile.numpy(), np.asarray(jt))
    rng = np.random.RandomState(0)
    he, att = _t(rng.randn(5, H).astype(np.float32)), _t(rng.rand(5, K).astype(np.float32))
    outer = (he[:, :, None] * att[:, None, :]).reshape(5, H * K)
    np.testing.assert_array_equal((he @ e_rep * (att @ e_tile)).numpy(), outer.numpy())


def _param_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_param_shapes(v, name))
        else:
            out[name] = tuple(np.shape(v))
    return out


@pytest.mark.parametrize("update", [True, [False, True, False]])
def test_port_init_names_shapes_and_rbf(update):
    _, params, h, x = _jax_setup(update=update)
    model = SAKEModel(HID, 1, DEPTH, update=update, in_features=F_IN, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == _param_shapes(_np_tree(params)["params"])
    means, betas = exp_normal_init(50)
    start = np.exp(-5.0)
    np.testing.assert_allclose(means.numpy(), np.linspace(start, 1.0, 50), rtol=1e-6)
    np.testing.assert_allclose(betas.numpy(), (2.0 / 50 * (1.0 - start)) ** -2, rtol=1e-6)
    jp = _np_tree(params)["params"]["layer_0"]["edge_model"]["kernel"]
    np.testing.assert_allclose(model.layer_0.edge_model.kernel.means.detach().numpy(),
                               jp["means"], rtol=1e-6)
    np.testing.assert_allclose(model.layer_0.edge_model.kernel.betas.detach().numpy(),
                               jp["betas"], rtol=1e-6)
    # flax defaults: zero biases, lecun-normal kernels bounded by 2 std
    k = model.layer_0.x_mixing.kernel.detach()
    assert k.abs().max() <= 2.0 * np.sqrt(1.0 / k.shape[0]) / 0.8796 + 1e-6
    assert not model.embedding_in.bias.any()


def test_module_with_linen_weights_matches_linen_apply(setup, edge_mask):
    model_j, params, h, x = setup
    _, mask = edge_mask
    model = SAKEModel(HID, 1, DEPTH, in_features=F_IN, device="cpu")
    load_linen_params(model, _np_tree(params))
    rh, rx, rv = model_j.apply(params, jnp.asarray(h), jnp.asarray(x), None, jnp.asarray(mask))
    with torch.no_grad():
        oh, ox, ov = model(_t(h), _t(x), mask=_t(mask))
    w = np.diagonal(mask, axis1=1, axis2=2)[..., None]
    np.testing.assert_allclose(oh.numpy() * w, np.asarray(rh) * w, **TOL)
    np.testing.assert_allclose(ox.numpy() * w, np.asarray(rx) * w, **TOL)
    np.testing.assert_allclose(ov.numpy() * w, np.asarray(rv) * w, **TOL)


@pytest.mark.parametrize("update,with_v", [(True, True), (True, False), (False, False)])
def test_layer_module_matches_linen_layer(edge_mask, update, with_v):
    """The port's ``DenseSAKELayer`` with linen weights against the linen
    layer, with and without an input velocity."""
    rng = np.random.RandomState(4)
    h = rng.randn(B, N, HID).astype(np.float32)
    x = rng.randn(B, N, 3).astype(np.float32)
    v = rng.randn(B, N, 3).astype(np.float32) if with_v else None
    layer_j = JaxDenseSAKELayer(out_features=HID, hidden_features=HID, update=update)
    jv = None if v is None else jnp.asarray(v)
    params = layer_j.init(jax.random.PRNGKey(3), jnp.asarray(h), jnp.asarray(x), jv)
    rh, rx, rv = layer_j.apply(params, jnp.asarray(h), jnp.asarray(x), jv)
    layer = DenseSAKELayer(HID, HID, HID, update=update, velocity=with_v)
    load_linen_params(layer, _np_tree(params))
    with torch.no_grad():
        oh, ox, ov = layer(_t(h), _t(x), None if v is None else _t(v))
    np.testing.assert_allclose(oh.numpy(), np.asarray(rh), **TOL)
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), **TOL)
    if update:
        np.testing.assert_allclose(ov.numpy(), np.asarray(rv), **TOL)


def test_module_energy_and_forces_paths_agree(setup):
    """``models.energy_and_forces`` (autograd through ``forward``; E is the
    batch total, as in JAX) and ``SAKEModel.energy_and_forces`` (the
    dispatch; raw E per molecule) give the same E and F."""
    _, params, h, x = setup
    model = SAKEModel(HID, 1, DEPTH, in_features=F_IN, device="cpu")
    load_linen_params(model, _np_tree(params))
    with torch.no_grad():
        e_ref, f_ref = energy_and_forces(model, _t(h), _t(x), mean=0.5, std=2.0)
    e, f = model.energy_and_forces(_t(h), _t(x))
    assert e_ref.shape == () and e.shape == (B,)
    np.testing.assert_allclose((e.numpy() * 2.0 + 0.5).sum(), e_ref.numpy(), **TOL)
    np.testing.assert_allclose(f.numpy() * 2.0, f_ref.numpy(), **TOL)


def test_energy_and_forces_force_loss_gradients_match_jax(setup):
    """A force loss ``sum F^2`` through ``models.energy_and_forces`` on the
    module, by torch autograd, against ``jax.grad`` of the same loss through
    the JAX ``energy_and_forces`` on the linen model: E (the batch total), F
    and every parameter's gradient (those the loss does not reach are zero
    in JAX and unused in torch). Before the repair E was per molecule and
    F carried no graph, so the loss had no gradient."""
    from sake_tpu.models import energy_and_forces as jax_energy_and_forces

    model_j, params, h, x = setup

    def loss_j(p):
        e, f = jax_energy_and_forces(model_j.apply, p, jnp.asarray(h), jnp.asarray(x),
                                     mean=0.5, std=2.0)
        return (f ** 2).sum(), (e, f)

    (l_ref, (e_ref, f_ref)), g_ref = jax.value_and_grad(loss_j, has_aux=True)(params)
    model = SAKEModel(HID, 1, DEPTH, in_features=F_IN, device="cpu")
    load_linen_params(model, _np_tree(params))
    e, f = energy_and_forces(model, _t(h), _t(x), mean=0.5, std=2.0)
    assert e.shape == () and e.requires_grad and f.requires_grad
    np.testing.assert_allclose(float(e.detach()), float(e_ref), **TOL)
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(f_ref), rtol=2e-4, atol=2e-4)
    loss = (f ** 2).sum()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=2e-4)
    names, prms = zip(*model.named_parameters())
    got = torch.autograd.grad(loss, prms, allow_unused=True)
    want = _np_tree(g_ref)["params"]
    reached = 0
    for name, prm, g in zip(names, prms, got):
        node = want
        for part in name.split("."):
            node = node[part]
        g = torch.zeros_like(prm) if g is None else g
        reached += bool(np.abs(node).max() > 0)
        np.testing.assert_allclose(g.numpy(), node, rtol=2e-3, atol=1e-5, err_msg=name)
    assert reached > len(names) // 2


def test_unbatched_module_call_matches_linen():
    """README's quick start: ``SAKEModel(...)(h (N, F), x (N, 3))`` without
    a batch axis returns ``(N, out)``, as the linen module does (before the
    repair the port raised); the layer module takes it too."""
    rng = np.random.RandomState(6)
    h = rng.randn(5, F_IN).astype(np.float32)
    x = rng.randn(5, 3).astype(np.float32)
    model_j = JaxSAKEModel(hidden_features=HID, out_features=1, depth=2)
    params = model_j.init(jax.random.PRNGKey(1), jnp.asarray(h), jnp.asarray(x))
    rh, rx, _ = model_j.apply(params, jnp.asarray(h), jnp.asarray(x))
    model = SAKEModel(HID, 1, 2, in_features=F_IN, device="cpu")
    load_linen_params(model, _np_tree(params))
    with torch.no_grad():
        oh, ox, ov = model(_t(h), _t(x))
        lh, lx, lv = model.layer_0(_t(rng.randn(5, HID).astype(np.float32)), _t(x))
    assert oh.shape == (5, 1) and ox.shape == (5, 3) and ov.shape == (5, 3)
    assert lh.shape == (5, HID) and lx.shape == (5, 3) and lv.shape == (5, 3)
    np.testing.assert_allclose(oh.numpy(), np.asarray(rh), **TOL)
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), **TOL)


def _jax_port_pairs():
    from sake_tpu.kernels import dispatch as jd
    from sake_tpu.kernels import functional as jf
    from sake_tpu.kernels import one_ef as jo
    from sake_tpu.kernels import resid_ef as jr
    from sake_tpu.kernels import train2_ef as jt
    from sake_tpu_torch.kernels import dispatch, functional, one_ef, resid_ef, train2_ef

    return {
        "resid_energy_forces": (jr.resid_energy_forces, resid_ef.resid_energy_forces),
        "make_hidden_fn": (jr.make_hidden_fn, resid_ef.make_hidden_fn),
        "dispatch_energy_forces": (jd.dispatch_energy_forces, dispatch.dispatch_energy_forces),
        "model_forward": (jf.model_forward, functional.model_forward),
        "energy_and_forces_fn": (jf.energy_and_forces_fn, functional.energy_and_forces_fn),
        "one_energy_forces": (jo.one_energy_forces, one_ef.one_energy_forces),
        "make_ef_train2": (jt.make_ef_train2, train2_ef.make_ef_train2),
    }


@pytest.mark.parametrize("name", ["resid_energy_forces", "make_hidden_fn",
                                  "dispatch_energy_forces", "model_forward",
                                  "energy_and_forces_fn", "one_energy_forces",
                                  "make_ef_train2"])
def test_dense_entry_points_take_every_jax_keyword(name):
    """Every parameter name of the JAX entry point is a parameter of the
    port's (which may have more, such as ``device``); the call the JAX tasks
    make with their tiling keywords builds. Before the repair
    ``resid_energy_forces`` lacked 14, ``make_hidden_fn`` raised on
    ``batch_tile`` and the functional entries lacked ``matmul_dtype``."""
    import inspect

    jax_fn, port_fn = _jax_port_pairs()[name]
    want = set(inspect.signature(jax_fn).parameters)
    got = set(inspect.signature(port_fn).parameters)
    assert want <= got, sorted(want - got)
    if name == "make_hidden_fn":  # tasks/qm9.py:142-150's call
        from sake_tpu_torch.kernels import resid_ef

        resid_ef.make_hidden_fn(n_heads=4, update=False, batch_tile=4, pad_atoms=True,
                                interpret=False, precision=None, edge_precision=None)


def _velocity_setup(seed=7):
    """A JAX ``SAKEModel(8, 1, depth=2, n_heads=2)`` initialised with a
    velocity, as ``tasks/nbody.py`` and ``tasks/forecast.py`` initialise it,
    and seeded inputs."""
    rng = np.random.RandomState(seed)
    h = rng.randn(B, N, F_IN).astype(np.float32)
    x = rng.randn(B, N, 3).astype(np.float32)
    v = rng.randn(B, N, 3).astype(np.float32)
    model_j = JaxSAKEModel(hidden_features=8, out_features=1, depth=2, n_heads=2)
    params = model_j.init(jax.random.PRNGKey(seed), jnp.asarray(h), jnp.asarray(x),
                          jnp.asarray(v))
    return model_j, params, h, x, v


def test_velocity_input_model_matches_linen_apply():
    """A model that takes a velocity: with ``velocity_input=True`` layer 0
    has its velocity gate, as flax creates it at ``init`` with a ``v``, and
    ``forward(h, x, v)`` matches linen's ``apply`` in f32."""
    model_j, params, h, x, v = _velocity_setup()
    assert "velocity_mlp_hidden" in params["params"]["layer_0"]
    model = SAKEModel(8, 1, 2, n_heads=2, in_features=F_IN, velocity_input=True, device="cpu")
    load_linen_params(model, _np_tree(params))
    rh, rx, rv = model_j.apply(params, jnp.asarray(h), jnp.asarray(x), jnp.asarray(v))
    with torch.no_grad():
        oh, ox, ov = model(_t(h), _t(x), _t(v))
    for got, want in ((oh, rh), (ox, rx), (ov, rv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_load_linen_params_raises_on_a_leaf_the_module_lacks():
    """Loading the velocity model's tree into a module built without
    ``velocity_input`` names the gate leaves it lacks, where it used to skip
    them and gate layer 0's velocity at 2 sigmoid(0) = 1."""
    _, params, *_ = _velocity_setup()
    model = SAKEModel(8, 1, 2, n_heads=2, in_features=F_IN, device="cpu")
    with pytest.raises(ValueError, match="layer_0.velocity_mlp_hidden.kernel"):
        load_linen_params(model, _np_tree(params))
