"""Port parity for the modules that hold the K1/K2 kernels: the plain
``layer_fwd_resid``/``layer_bwd_resid`` against the JAX package's (called as
plain jnp, as ``tests/test_kernels.py`` does) and against torch autograd,
the layer stacks, and the dispatch contract. The CUDA kernels themselves
run only on a GPU (``chip_smoke.py``; the ``gpu`` tests below)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.kernels.depthgrid_ef import _LEAF_NAMES, wide_stack as jax_wide_stack
from sake_tpu.kernels.resid_ef import (
    _EDGE_RESIDS,
    _NODE_RESIDS,
    _edge_channels,
    _node_channels,
    layer_bwd_resid as jax_layer_bwd,
    layer_fwd_resid as jax_layer_fwd,
)
from sake_tpu.kernels.split_ef import head_expansion_matrices
from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels import resid_ef
from sake_tpu_torch.kernels.adapter import model_params_from_linen
from sake_tpu_torch.kernels.dispatch import dispatch_energy_forces
from sake_tpu_torch.kernels.functional import (
    energy_and_forces_fn,
    layer_forward_planes,
    params_to,
)
from sake_tpu_torch.kernels.leaves import layer_leaves, wide_stack

TOL = dict(rtol=2e-4, atol=2e-5)
BWD_TOL = dict(rtol=1e-3, atol=1e-4)
B, N, F_IN, HID, K = 4, 7, 5, 16, 4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    h_raw = rng.randn(B, N, F_IN).astype(np.float32)
    x = rng.randn(B, N, 3).astype(np.float32)
    model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=2)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(h_raw), jnp.asarray(x))
    kp = jax_from_linen(params)
    tp = model_params_from_linen(jax.tree.map(np.asarray, params))
    # the layer runs post-embedding
    h = (h_raw @ np.asarray(kp.w_embed) + np.asarray(kp.b_embed)).astype(np.float32)
    vp = [rng.randn(B, N, 1).astype(np.float32) for _ in range(3)]
    node_mask = (rng.rand(B, N) > 0.3).astype(np.float32)
    mask4 = (node_mask[:, :, None] * node_mask[:, None, :])[..., None]
    seeds = (
        rng.randn(B, N, HID).astype(np.float32),
        [rng.randn(B, N, 1).astype(np.float32) for _ in range(3)],
        [rng.randn(B, N, 1).astype(np.float32) for _ in range(3)],
    )
    p_j = {name: leaf[0] for name, leaf in zip(_LEAF_NAMES, jax_wide_stack(kp, K))}
    p_t = layer_leaves(wide_stack(tp, K), 0)
    return dict(h=h, x=x, vp=vp, mask4=mask4, node_mask=node_mask, seeds=seeds,
                p_j=p_j, p_t=p_t, tp=tp, kp=kp, h_raw=h_raw)


def _jax_layer_kwargs():
    e_rep, e_tile = head_expansion_matrices(HID, K)
    mm = lambda a, w: jnp.dot(a, w, preferred_element_type=jnp.float32)
    return dict(e_rep=e_rep, e_tile=e_tile, mm=mm)


def _inputs(s):
    xp = [s["x"][..., k : k + 1] for k in range(3)]
    return s["h"], xp, s["vp"]


def _t(a):
    return torch.as_tensor(np.asarray(a))


CASES = [(n_real, upd, masked)
         for n_real in (None, 5) for upd in (1.0, 0.0, 0.3) for masked in (False, True)
         if not (masked and n_real is not None)]  # padding rides the mask when masked


@pytest.mark.parametrize("n_real,upd,masked", CASES)
def test_layer_fwd_resid_matches_jax(setup, n_real, upd, masked):
    h, xp, vp = _inputs(setup)
    m = setup["mask4"] if masked else None
    h2_j, xp2_j, vp2_j, res_j = jax_layer_fwd(
        setup["p_j"], jnp.asarray(h), [jnp.asarray(a) for a in xp],
        [jnp.asarray(a) for a in vp], upd, n_real=n_real,
        mask=None if m is None else jnp.asarray(m), **_jax_layer_kwargs(),
    )
    h2, xp2, vp2, res = resid_ef.layer_fwd_resid(
        setup["p_t"], _t(h), [_t(a) for a in xp], [_t(a) for a in vp], upd,
        n_real=n_real, mask=None if m is None else _t(m),
    )
    np.testing.assert_allclose(h2.numpy(), np.asarray(h2_j), **TOL)
    for k in range(3):
        np.testing.assert_allclose(xp2[k].numpy(), np.asarray(xp2_j[k]), **TOL)
        np.testing.assert_allclose(vp2[k].numpy(), np.asarray(vp2_j[k]), **TOL)
    assert resid_ef.EDGE_RESIDS == _EDGE_RESIDS and resid_ef.NODE_RESIDS == _NODE_RESIDS
    p = setup["p_t"]
    C = p["w_xmix"].shape[-1]
    widths = {**resid_ef.edge_channels(p["w_in_j"].shape[-1], HID, K, C),
              **resid_ef.node_channels(p, C)}
    assert {n: widths[n] for n in _EDGE_RESIDS} == _edge_channels(
        p["w_in_j"].shape[-1], HID, K, C)
    for name in _EDGE_RESIDS + _NODE_RESIDS:
        got = res[name].reshape(B, -1, widths[name]).numpy()
        np.testing.assert_allclose(got, np.asarray(res_j[name]), err_msg=name, **TOL)


def test_node_channels_match_jax(setup):
    p = setup["p_t"]
    C = p["w_xmix"].shape[-1]
    assert resid_ef.node_channels(p, C) == _node_channels(setup["kp"].layers[0], C)


@pytest.mark.parametrize("n_real,upd,masked", CASES)
def test_layer_bwd_resid_matches_jax(setup, n_real, upd, masked):
    h, xp, vp = _inputs(setup)
    dh, dxp, dvp = setup["seeds"]
    m = setup["mask4"] if masked else None
    kw = _jax_layer_kwargs()
    mj = None if m is None else jnp.asarray(m)
    jx = lambda l: [jnp.asarray(a) for a in l]
    _, _, _, res_j = jax_layer_fwd(setup["p_j"], jnp.asarray(h), jx(xp), jx(vp), upd,
                                   n_real=n_real, mask=mj, **kw)
    want = jax_layer_bwd(setup["p_j"], res_j, jnp.asarray(h), jx(xp), jx(vp), upd,
                         jnp.asarray(dh), jx(dxp), jx(dvp), n_real=n_real, mask=mj, **kw)
    tt = lambda l: [_t(a) for a in l]
    mt = None if m is None else _t(m)
    _, _, _, res = resid_ef.layer_fwd_resid(setup["p_t"], _t(h), tt(xp), tt(vp), upd,
                                            n_real=n_real, mask=mt)
    got = resid_ef.layer_bwd_resid(setup["p_t"], res, _t(h), tt(xp), tt(vp), upd,
                                   _t(dh), tt(dxp), tt(dvp), n_real=n_real, mask=mt)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **BWD_TOL)
    for k in range(3):
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(want[1][k]), **BWD_TOL)
        np.testing.assert_allclose(got[2][k].numpy(), np.asarray(want[2][k]), **BWD_TOL)


@pytest.mark.parametrize("n_real,upd,masked", CASES)
def test_layer_bwd_resid_matches_autograd(setup, n_real, upd, masked):
    """Against torch autograd: of the port's functional layer where one
    exists (upd in {0, 1}, no padding), else of ``layer_fwd_resid``."""
    h, xp, vp = _inputs(setup)
    dh, dxp, dvp = setup["seeds"]
    m = _t(setup["mask4"]) if masked else None
    p = setup["p_t"]
    hg = _t(h).requires_grad_(True)
    xg = [_t(a).requires_grad_(True) for a in xp]
    vg = [_t(a).requires_grad_(True) for a in vp]
    if upd in (0.0, 1.0) and n_real is None:
        lp = setup["tp"].layers[0]
        h2, x2, v2 = layer_forward_planes(lp, hg, xg, vg, n_heads=K, update=bool(upd),
                                          mask=None if m is None else m[..., 0])
    else:
        h2, x2, v2, _ = resid_ef.layer_fwd_resid(p, hg, xg, vg, upd, n_real=n_real, mask=m)
    outs = [h2, *x2, *v2]
    cots = [_t(dh), *[_t(a) for a in dxp], *[_t(a) for a in dvp]]
    want = torch.autograd.grad(outs, [hg, *xg, *vg], cots, allow_unused=True)
    with torch.no_grad():
        _, _, _, res = resid_ef.layer_fwd_resid(p, _t(h), [_t(a) for a in xp],
                                                [_t(a) for a in vp], upd, n_real=n_real, mask=m)
        got = resid_ef.layer_bwd_resid(p, res, _t(h), [_t(a) for a in xp],
                                       [_t(a) for a in vp], upd, _t(dh),
                                       [_t(a) for a in dxp], [_t(a) for a in dvp],
                                       n_real=n_real, mask=m)
    flat = [got[0], *got[1], *got[2]]
    for g, w in zip(flat, want):
        w = torch.zeros_like(g) if w is None else w
        np.testing.assert_allclose(g.numpy(), w.numpy(), **BWD_TOL)


def test_stacks_and_dispatch_match_functional(setup):
    """The plain K1/K2 stacks (the CPU side of the wrappers) through the
    dispatch and through ``resid_energy_forces`` with a ragged chunk give
    the functional model's E and F, with an update schedule."""
    tp, h_raw, x = setup["tp"], _t(setup["h_raw"]), _t(setup["x"])
    for update in (True, [False, True]):
        e_ref, f_ref = energy_and_forces_fn(tp, h_raw, x, update=update)
        for e, f in (dispatch_energy_forces(tp, h_raw, x, update=update),
                     resid_ef.resid_energy_forces(tp, h_raw, x, update=update, chunk=3)):
            np.testing.assert_allclose(e.numpy(), e_ref.numpy(), **TOL)
            np.testing.assert_allclose(f.numpy(), f_ref.numpy(), **TOL)


def test_dispatch_masked_on_cpu_uses_plain_path(setup):
    tp, h_raw, x = setup["tp"], _t(setup["h_raw"]), _t(setup["x"])
    mask = _t(setup["mask4"][..., 0])
    launches = (resid_ef.resid_fwd.launches, resid_ef.resid_bwd.launches)
    e, f = dispatch_energy_forces(tp, h_raw, x, mask)
    assert (resid_ef.resid_fwd.launches, resid_ef.resid_bwd.launches) == launches
    # reference: autograd of the masked functional model with a node-masked readout
    from sake_tpu_torch.kernels.functional import model_forward

    nm = _t(setup["node_mask"])
    xg = x.clone().requires_grad_(True)
    out, _, _ = model_forward(tp, h_raw, xg, mask=mask)
    e_ref = (out * nm[..., None]).sum(dim=(-2, -1))
    (g,) = torch.autograd.grad(e_ref.sum(), xg)
    w = nm[..., None].numpy()
    np.testing.assert_allclose(e.numpy(), e_ref.detach().numpy(), **TOL)
    np.testing.assert_allclose(f.numpy() * w, -g.numpy() * w, **TOL)


def test_wrappers_reject_other_devices(setup):
    leaves = wide_stack(setup["tp"], K)
    h = torch.zeros(1, N, HID, device="meta")
    with pytest.raises(ValueError):
        resid_ef.resid_fwd(leaves, h, h, h, [1.0, 1.0])


@pytest.mark.gpu
def test_cuda_dispatch_contract(setup):
    """On CUDA tensors the dispatch launches K1 and K2 (no silent plain
    path), with or without an edge mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    tp = params_to(setup["tp"], dev)
    h_raw, x = _t(setup["h_raw"]).to(dev), _t(setup["x"]).to(dev)
    for mask in (None, _t(setup["mask4"][..., 0])):
        before = (resid_ef.resid_fwd.launches, resid_ef.resid_bwd.launches)
        e, f = dispatch_energy_forces(tp, h_raw, x, None if mask is None else mask.to(dev))
        assert (resid_ef.resid_fwd.launches, resid_ef.resid_bwd.launches) == (
            before[0] + 1, before[1] + 1)
        e_ref, f_ref = resid_ef.resid_energy_forces(setup["tp"], _t(setup["h_raw"]),
                                                    _t(setup["x"]), mask)
        np.testing.assert_allclose(e.cpu().numpy(), e_ref.numpy(), **BWD_TOL)
        np.testing.assert_allclose(f.cpu().numpy(), f_ref.numpy(), **BWD_TOL)
