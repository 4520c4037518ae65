"""The port's first-order training pieces against the JAX package: the plain
parameter gradients of ``layer_bwd_resid`` (JAX called as plain jnp, as
``tests/test_kernels.py`` calls it), the training pullback over the stack
(``resid_train_bwd``: cotangent rows, then their contraction), and
``make_hidden_fn`` against ``jax.grad`` of the linen ``SAKEModel`` (the
oracle of ``tests/test_kernels.py:550-622``). On CPU tensors the wrappers
run their plain versions; the CUDA kernels are checked on the card by
``chip_smoke.py``.

Tolerances: parameter gradients of one layer ``rtol=1e-3, atol=1e-4`` (the
input-cotangent tier of ``test_torch_resid_ef.py``); gradients through the
whole ``hidden`` stack ``rtol=2e-3, atol=2e-4`` and its no-grad forward
``rtol=2e-4, atol=2e-5`` (the JAX test's own tiers). f32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels.depthgrid_ef import _LEAF_NAMES, wide_stack as jax_wide_stack
from sake_tpu.kernels.resid_ef import (
    layer_bwd_resid as jax_layer_bwd,
    layer_fwd_resid as jax_layer_fwd,
)
from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.kernels.split_ef import head_expansion_matrices
from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels import resid_ef
from sake_tpu_torch.kernels.adapter import model_params_from_linen
from sake_tpu_torch.kernels.functional import readout
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, layer_leaves, split_layer, wide_stack

GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
STACK_TOL = dict(rtol=2e-3, atol=2e-4)
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
B, N, F_IN, HID, K, DEPTH = 4, 7, 5, 16, 4, 2


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(3)
    h_raw = rng.randn(B, N, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(B, N, 3)).astype(np.float32)
    model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=DEPTH)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(h_raw), jnp.asarray(x))
    kp = jax_from_linen(params)
    sizes = np.array([N, 4, 6, 3])  # one molecule without padding
    node_mask = (np.arange(N)[None, :] < sizes[:, None]).astype(np.float32)
    edge_mask = node_mask[:, :, None] * node_mask[:, None, :]
    h = (h_raw @ np.asarray(kp.w_embed) + np.asarray(kp.b_embed)).astype(np.float32)
    seeds = (rng.randn(B, N, HID).astype(np.float32),
             [rng.randn(B, N, 1).astype(np.float32) for _ in range(3)],
             [rng.randn(B, N, 1).astype(np.float32) for _ in range(3)])
    return dict(
        model=model, params=params, kp=kp, h_raw=h_raw, x=x, h=h, seeds=seeds,
        vp=[rng.randn(B, N, 1).astype(np.float32) for _ in range(3)],
        node_mask=node_mask, edge_mask=edge_mask, w=rng.randn(B).astype(np.float32),
        p_j={name: leaf[0] for name, leaf in zip(_LEAF_NAMES, jax_wide_stack(kp, K))},
        tp=model_params_from_linen(_np_tree(params)),
    )


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _jax_kwargs():
    e_rep, e_tile = head_expansion_matrices(HID, K)
    return dict(e_rep=e_rep, e_tile=e_tile,
                mm=lambda a, w: jnp.dot(a, w, preferred_element_type=jnp.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_layer_param_grads_match_jax(setup, masked):
    s = setup
    xp = [s["x"][..., k : k + 1] for k in range(3)]
    dh, dxp, dvp = s["seeds"]
    m = s["edge_mask"][..., None] if masked else None
    jx = lambda l: [jnp.asarray(a) for a in l]
    mj = None if m is None else jnp.asarray(m)
    _, _, _, res_j = jax_layer_fwd(s["p_j"], jnp.asarray(s["h"]), jx(xp), jx(s["vp"]), 1.0,
                                   mask=mj, **_jax_kwargs())
    want = jax_layer_bwd(s["p_j"], res_j, jnp.asarray(s["h"]), jx(xp), jx(s["vp"]), 1.0,
                         jnp.asarray(dh), jx(dxp), jx(dvp), mask=mj,
                         want_param_grads=True, **_jax_kwargs())[3]
    p = layer_leaves(wide_stack(s["tp"], K), 0)
    tt = lambda l: [_t(a) for a in l]
    mt = None if m is None else _t(m)
    _, _, _, res = resid_ef.layer_fwd_resid(p, _t(s["h"]), tt(xp), tt(s["vp"]), 1.0, mask=mt)
    got = resid_ef.layer_bwd_resid(p, res, _t(s["h"]), tt(xp), tt(s["vp"]), 1.0, _t(dh),
                                   tt(dxp), tt(dvp), mask=mt, want_param_grads=True)[3]
    assert list(got) == list(LEAF_NAMES) and set(want) == set(LEAF_NAMES)
    for name in LEAF_NAMES:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("masked,upd", [(False, 1.0), (True, 1.0), (True, 0.3)])
def test_layer_param_grads_match_autograd(setup, masked, upd):
    """Against torch autograd of the port's ``layer_fwd_resid`` w.r.t. its
    29 leaves."""
    s = setup
    p0 = layer_leaves(wide_stack(s["tp"], K), 0)
    p = {n: a.clone().requires_grad_(True) for n, a in p0.items()}
    h, xp, vp = _t(s["h"]), [_t(s["x"][..., k : k + 1]) for k in range(3)], [_t(a) for a in s["vp"]]
    m = _t(s["edge_mask"][..., None]) if masked else None
    dh, dxp, dvp = (_t(s["seeds"][0]), [_t(a) for a in s["seeds"][1]],
                    [_t(a) for a in s["seeds"][2]])
    h2, x2, v2, _ = resid_ef.layer_fwd_resid(p, h, xp, vp, upd, mask=m)
    want = torch.autograd.grad([h2, *x2, *v2], [p[n] for n in LEAF_NAMES],
                               [dh, *dxp, *dvp], allow_unused=True)
    with torch.no_grad():
        _, _, _, res = resid_ef.layer_fwd_resid(p0, h, xp, vp, upd, mask=m)
        got = resid_ef.layer_bwd_resid(p0, res, h, xp, vp, upd, dh, dxp, dvp, mask=m,
                                       want_param_grads=True)[3]
    for name, w in zip(LEAF_NAMES, want):
        w = torch.zeros_like(got[name]) if w is None else w
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_train_bwd_stack_matches_autograd(setup, masked):
    """``resid_train_bwd`` on CPU tensors (the plain rows, then their plain
    contraction ``param_grads_plain``) against torch autograd of the plain
    K1 stack, with an update schedule and a nonzero velocity."""
    s = setup
    leaves0 = wide_stack(s["tp"], K)
    leaves = {n: a.clone().requires_grad_(True) for n, a in leaves0.items()}
    h0 = _t(s["h"]).requires_grad_(True)
    xs = _t(s["x"].transpose(2, 0, 1)).contiguous().requires_grad_(True)
    v0 = _t(np.concatenate(s["vp"], -1).transpose(2, 0, 1)).contiguous()
    m = _t(s["edge_mask"][..., None]) if masked else None
    upd = [1.0, 0.3]
    dh = _t(s["seeds"][0])
    dx = _t(np.concatenate(s["seeds"][1], -1).transpose(2, 0, 1)).contiguous()
    fwd = resid_ef.resid_fwd_plain(leaves, h0, xs, v0, upd, mask=m)
    want = torch.autograd.grad([fwd.h_fin, fwd.x_fin], [h0, xs, *leaves.values()], [dh, dx])
    with torch.no_grad():
        fwd0 = resid_ef.resid_fwd(leaves0, h0.detach(), xs.detach(), v0, upd, mask=m)
        got_dh, got_dx, _, grads = resid_ef.resid_train_bwd(leaves0, fwd0, upd, dh, dx,
                                                            torch.zeros_like(dx), mask=m)
    np.testing.assert_allclose(got_dh.numpy(), want[0].numpy(), **GRAD_TOL)
    np.testing.assert_allclose(got_dx.numpy(), want[1].numpy(), **GRAD_TOL)
    for name, w in zip(leaves, want[2:]):
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(), err_msg=name, **GRAD_TOL)


def test_rows_and_contraction_split_the_pullback(setup):
    """The two halves of the training pullback: the plain rows have the
    widths the kernel writes, and their contraction reproduces the
    per-layer ``want_param_grads=True``."""
    s = setup
    leaves = wide_stack(s["tp"], K)
    xs = _t(s["x"].transpose(2, 0, 1)).contiguous()
    m = _t(s["edge_mask"][..., None])
    fwd = resid_ef.resid_fwd(leaves, _t(s["h"]), xs, torch.zeros_like(xs), [1.0, 1.0], mask=m)
    dh = _t(s["seeds"][0])
    z = torch.zeros_like(xs)
    _, _, _, rows = resid_ef.resid_bwd_rows(leaves, fwd, [1.0, 1.0], dh, z, z, mask=m)
    dims = resid_ef._dims(leaves, _t(s["h"]))
    assert {n: tuple(a.shape) for n, a in rows.items()} == resid_ef._row_shapes(dims, leaves)
    grads = resid_ef.param_grads(leaves, fwd, rows)
    per_layer = resid_ef._bwd_plain(leaves, fwd, [1.0, 1.0], dh, z, z, m, True)[3]
    for name in LEAF_NAMES:
        want = torch.stack([per_layer[l][0][name] for l in range(DEPTH)])
        torch.testing.assert_close(grads[name], want, rtol=1e-6, atol=1e-7)


def test_unsplit_inverts_split(setup):
    lp = setup["tp"].layers[1]
    back = resid_ef.unsplit_layer_grads(split_layer(lp, HID, K))
    for a, b in zip([*back.edge, *back[1:]], [*lp.edge, *lp[1:]]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _loss_parts(setup, masked):
    s = setup
    mask = s["edge_mask"] if masked else None
    node_m = s["node_mask"] if masked else None
    return mask, node_m


@pytest.mark.parametrize("masked", [False, True])
def test_hidden_grads_match_linen(setup, masked):
    """Gradients of a weighted energy loss through ``hidden`` and the readout
    against ``jax.grad`` of the linen model, for every parameter (the linen
    gradient converted through the adapter)."""
    s = setup
    mask, node_m = _loss_parts(s, masked)
    w = s["w"]

    def loss_linen(p_):
        out, _, _ = s["model"].apply(p_, jnp.asarray(s["h_raw"]), jnp.asarray(s["x"]),
                                     mask=None if mask is None else jnp.asarray(mask))
        if node_m is not None:
            out = out * jnp.asarray(node_m)[..., None]
        return (out.sum(axis=(-2, -1)) * w).sum()

    l_ref, g_ref = jax.value_and_grad(loss_linen)(s["params"])
    want = resid_ef.flat_params(model_params_from_linen(_np_tree(g_ref)))

    tp = model_params_from_linen(_np_tree(s["params"]))
    flat = [t.requires_grad_(True) for t in resid_ef.flat_params(tp)]
    hidden = resid_ef.make_hidden_fn(n_heads=K)
    h_fin = hidden(tp, _t(s["h_raw"]), _t(s["x"]), None if mask is None else _t(mask))
    assert type(h_fin.grad_fn).__name__ == "HiddenBackward"  # the custom backward
    out = readout(tp, h_fin)
    if node_m is not None:
        out = out * _t(node_m)[..., None]
    loss = (out.sum(dim=(-2, -1)) * _t(w)).sum()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-4)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    assert len(got) == len(want)
    for i, (g, wt) in enumerate(zip(got, want)):
        g = torch.zeros_like(wt) if g is None else g
        np.testing.assert_allclose(g.numpy(), wt.numpy(), err_msg=f"leaf {i}", **STACK_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_hidden_no_grad_takes_infer_path(setup, masked):
    """Outside autograd ``hidden`` runs the forward without residuals; its
    readout matches the linen forward."""
    s = setup
    mask, _ = _loss_parts(s, masked)
    out_l, _, _ = s["model"].apply(s["params"], jnp.asarray(s["h_raw"]), jnp.asarray(s["x"]),
                                   mask=None if mask is None else jnp.asarray(mask))
    tp = model_params_from_linen(_np_tree(s["params"]))
    hidden = resid_ef.make_hidden_fn(n_heads=K)
    with torch.no_grad():
        h_fin = hidden(tp, _t(s["h_raw"]), _t(s["x"]), None if mask is None else _t(mask))
    assert h_fin.grad_fn is None
    np.testing.assert_allclose(readout(tp, h_fin).numpy(), np.asarray(out_l), **FWD_TOL)


@pytest.mark.parametrize("kw", [dict(want_x=True), dict(matmul_dtype=torch.bfloat16),
                                dict(edge_matmul_dtype=torch.bfloat16),
                                dict(resid_dtype=torch.bfloat16)])
def test_make_hidden_fn_rejects_unported_options(kw):
    with pytest.raises(NotImplementedError):
        resid_ef.make_hidden_fn(**kw)
