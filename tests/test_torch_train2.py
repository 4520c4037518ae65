"""The port's second-order (force-loss) training pieces against the JAX
package: the differentiable ``energy_and_forces_fn``, the plain tangent
forward ``layer_jvp_resid``, the tangent pullback and its contraction, the
layer stacks the kernels replace, the fused mode's plain versions (#11, #12)
and ``make_ef_train2`` in its modes against JAX double autodiff (``ef_lax``
of ``tests/test_kernels.py:871-877``) and against the JAX fused mode run in
interpret mode.
JAX layer functions run as plain jnp, as ``tests/test_kernels.py`` calls
them; the port's wrappers run their plain versions on CPU tensors, and the
CUDA kernels are checked on the card by ``chip_smoke.py``.

Tolerances (f32 throughout):
- second-order gradients through a whole model (the repaired
  ``energy_and_forces_fn``, ``make_ef_train2``): ``rtol=2e-3, atol=1e-5``,
  the JAX test's own (``tests/test_kernels.py:901-904``);
- ``layer_jvp_resid``: ``rtol=atol=2e-5`` on values scaled by each
  tensor's largest magnitude (``tests/test_kernels.py:843-848``);
- the tangent pullback and its parameter-gradient tangents: ``rtol=1e-3,
  atol=1e-4``, the tier of the first-order pullback;
- the stacks against ``torch.func.jvp`` and each other: ``rtol=1e-4,
  atol=1e-6`` (the same arithmetic in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.kernels.depthgrid_ef import _LEAF_NAMES, wide_stack as jax_wide_stack
from sake_tpu.kernels.functional import energy_and_forces_fn as jax_ef_fn
from sake_tpu.kernels.functional import model_forward as jax_model_forward
from sake_tpu.kernels.resid_ef import (
    _make_mmt_prec,
    contract_param_pair_tangents,
    layer_bwd_resid as jax_layer_bwd,
    layer_fwd_resid as jax_layer_fwd,
    layer_jvp_resid as jax_layer_jvp,
)
from sake_tpu.kernels.split_ef import head_expansion_matrices
from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels import resid_ef, train2_ef
from sake_tpu_torch.kernels.adapter import model_params_from_linen, params_from_jax
from sake_tpu_torch.kernels.functional import energy_and_forces_fn, flat_params
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, layer_leaves, wide_stack

MODEL_TOL = dict(rtol=2e-3, atol=1e-5)
JVP_TOL = dict(rtol=2e-5, atol=2e-5)
PULL_TOL = dict(rtol=1e-3, atol=1e-4)
STACK_TOL = dict(rtol=1e-4, atol=1e-6)
B, N, F_IN, HID, K, DEPTH = 4, 7, 5, 16, 4, 2


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(5)
    h_raw = rng.randn(B, N, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(B, N, 3)).astype(np.float32)
    model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=DEPTH)
    params = model.init(jax.random.PRNGKey(2), jnp.asarray(h_raw), jnp.asarray(x))
    kp = jax_from_linen(params)
    nm = (rng.rand(B, N) > 0.25).astype(np.float32)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    planes = lambda: [f(B, N, 1) for _ in range(3)]
    return dict(
        kp=kp, h_raw=h_raw, x=x, h=f(B, N, HID), xp=[x[..., k : k + 1] for k in range(3)],
        vp=planes(), th=f(B, N, HID), txp=planes(), tvp=planes(),
        ct=(f(B, N, HID), planes(), planes()),
        edge_mask=(nm[:, :, None] * nm[:, None, :])[..., None],
        e_t=f(B), f_t=f(B, N, 3),
        p_j={name: leaf[1] for name, leaf in zip(_LEAF_NAMES, jax_wide_stack(kp, K))},
        tp=model_params_from_linen(_np_tree(params)),
    )


def _jax_kw():
    e_rep, e_tile = head_expansion_matrices(HID, K)
    return dict(e_rep=e_rep, e_tile=e_tile,
                mm=lambda a, w: jnp.dot(a, w, preferred_element_type=jnp.float32))


def _jl(xs):
    return [jnp.asarray(a) for a in xs]


def _tl(xs):
    return [_t(a) for a in xs]


def _mask(s, masked, conv):
    return conv(s["edge_mask"]) if masked else None


def _port_layer(s):
    return layer_leaves(wide_stack(s["tp"], K), 1)


def _loss_parts(s):
    return s["e_t"], s["f_t"]


def test_energy_and_forces_fn_is_differentiable_as_jax(setup):
    """``jax.grad`` of a force + energy loss through the JAX
    ``energy_and_forces_fn`` w.r.t. params, h and x, against torch autograd
    through the port's (the function was detached before)."""
    s = setup
    e_t, f_t = _loss_parts(s)

    def loss_j(p, h_, x_):
        e, f = jax_ef_fn(p, h_, x_, n_heads=K)
        return ((e - e_t) ** 2).sum() + 0.5 * ((f - f_t) ** 2).sum()

    l_ref, g_ref = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
        s["kp"], jnp.asarray(s["h_raw"]), jnp.asarray(s["x"]))
    want = flat_params(_jax_params(g_ref[0]))
    tp = s["tp"]
    flat = [t.detach().clone().requires_grad_(True) for t in flat_params(tp)]
    tp = resid_ef._unflat_params(flat, DEPTH)
    h = _t(s["h_raw"]).requires_grad_(True)
    x = _t(s["x"]).requires_grad_(True)
    e, f = energy_and_forces_fn(tp, h, x, n_heads=K)
    loss = ((e - _t(e_t)) ** 2).sum() + 0.5 * ((f - _t(f_t)) ** 2).sum()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-5)
    # layer 0's velocity weights are zero placeholders the functional model never reads
    got = torch.autograd.grad(loss, [h, x, *flat], allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g for g, t in zip(got, [h, x, *flat])]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(g_ref[1]), **MODEL_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(g_ref[2]), **MODEL_TOL)
    for i, (g, w) in enumerate(zip(got[2:], want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"leaf {i}", **MODEL_TOL)
    with torch.no_grad():  # outside autograd both come back detached, as before
        e0, f0 = energy_and_forces_fn(tp, h, x, n_heads=K)
    assert e0.grad_fn is None and f0.grad_fn is None
    torch.testing.assert_close(f0, f.detach(), rtol=0, atol=0)


def _jax_params(g):
    """A JAX ``ModelParams`` of gradients -> the port's ``ModelParams``."""
    return params_from_jax(jax.tree.map(np.asarray, g))


@pytest.mark.parametrize("masked", [False, True])
def test_layer_jvp_resid_matches_jax(setup, masked):
    """The port's plain ``layer_jvp_resid`` against the JAX one on the JAX
    residuals, every tangent output and tangent residual."""
    s = setup
    kw = _jax_kw()
    mj = _mask(s, masked, jnp.asarray)
    _, _, _, res_j = jax_layer_fwd(s["p_j"], jnp.asarray(s["h"]), _jl(s["xp"]), _jl(s["vp"]),
                                   0.7, mask=mj, **kw)
    want = jax_layer_jvp(s["p_j"], res_j, jnp.asarray(s["h"]), _jl(s["xp"]), _jl(s["vp"]),
                         jnp.asarray(s["th"]), _jl(s["txp"]), _jl(s["tvp"]), 0.7, mask=mj, **kw)
    got = resid_ef.layer_jvp_resid(
        _port_layer(s), {n: _t(a) for n, a in res_j.items()}, _t(s["h"]), _tl(s["xp"]),
        _tl(s["vp"]), _t(s["th"]), _tl(s["txp"]), _tl(s["tvp"]), 0.7,
        mask=_mask(s, masked, _t))
    assert set(got[3]) == set(want[3]) == set(resid_ef.RESIDS)
    pairs = [(got[0], want[0]), *zip(got[1], want[1]), *zip(got[2], want[2]),
             *((got[3][n], want[3][n]) for n in resid_ef.RESIDS)]
    for a, b in pairs:
        scale = float(jnp.abs(b).max()) + 1e-8
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale, **JVP_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_layer_jvp_resid_matches_torch_jvp(setup, masked):
    """The hand-derived tangent against ``torch.func.jvp`` of the port's
    ``layer_fwd_resid``, outputs and residuals."""
    s = setup
    p, m = _port_layer(s), _mask(s, masked, _t)
    f = lambda h_, x_, v_: resid_ef.layer_fwd_resid(p, h_, x_, v_, 0.7, mask=m)
    out, tout = torch.func.jvp(f, (_t(s["h"]), _tl(s["xp"]), _tl(s["vp"])),
                               (_t(s["th"]), _tl(s["txp"]), _tl(s["tvp"])))
    got = resid_ef.layer_jvp_resid(p, out[3], _t(s["h"]), _tl(s["xp"]), _tl(s["vp"]),
                                   _t(s["th"]), _tl(s["txp"]), _tl(s["tvp"]), 0.7, mask=m)
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(tout)):
        scale = float(b.abs().max()) + 1e-8
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale, **JVP_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_tangent_pullback_matches_jax(setup, masked):
    """``layer_bwd_resid_jvp`` and ``layer_param_grads_tangent`` against
    ``jax.jvp`` of the JAX ``layer_bwd_resid(want_param_grads="pairs")``
    plus ``contract_param_pair_tangents``, as the JAX training backward
    forms them (``train2_ef.py:1583-1604``)."""
    s = setup
    kw = _jax_kw()
    mj, mt = _mask(s, masked, jnp.asarray), _mask(s, masked, _t)
    hj, xpj, vpj = jnp.asarray(s["h"]), _jl(s["xp"]), _jl(s["vp"])
    _, _, _, res_j = jax_layer_fwd(s["p_j"], hj, xpj, vpj, 0.7, mask=mj, **kw)
    tj = (jnp.asarray(s["th"]), _jl(s["txp"]), _jl(s["tvp"]))
    *_, tres_j = jax_layer_jvp(s["p_j"], res_j, hj, xpj, vpj, *tj, 0.7, mask=mj, **kw)
    cth, ctx, ctv = s["ct"]
    mm_t = _make_mmt_prec(None, None)

    def bwd_fn(resid_, h_, xp_, vp_):
        return jax_layer_bwd(s["p_j"], resid_, h_, xp_, vp_, 0.7, jnp.asarray(cth), _jl(ctx),
                             _jl(ctv), mask=mj, want_param_grads="pairs", mm_t=mm_t, **kw)

    (dh_j, dxp_j, dvp_j, _, pairs_p), (hc_j, xc_j, vc_j, dwc_t, pairs_t) = jax.jvp(
        bwd_fn, (res_j, hj, xpj, vpj), (tres_j, *tj))
    dw_t = dict(dwc_t)
    dw_t.update(contract_param_pair_tangents(pairs_p, pairs_t, mm_t, mm_t))

    p = _port_layer(s)
    res, tres = ({n: _t(a) for n, a in d.items()} for d in (res_j, tres_j))
    h, th = _t(s["h"]), _t(s["th"])
    (dh, dxp, dvp, rows), (hc, xc, vc, t_rows) = resid_ef.layer_bwd_resid_jvp(
        p, res, h, _tl(s["xp"]), _tl(s["vp"]), 0.7, _t(cth), _tl(ctx), _tl(ctv), tres, th,
        _tl(s["txp"]), _tl(s["tvp"]), mask=mt)
    got_w = resid_ef.layer_param_grads_tangent(p, res, h, rows, tres, th, t_rows)
    pairs = [(dh, dh_j), *zip(dxp, dxp_j), *zip(dvp, dvp_j), (hc, hc_j), *zip(xc, xc_j),
             *zip(vc, vc_j)]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"output {i}", **PULL_TOL)
    assert set(got_w) == set(dw_t) == set(LEAF_NAMES)
    for name in LEAF_NAMES:
        np.testing.assert_allclose(got_w[name].numpy(), np.asarray(dw_t[name]), err_msg=name,
                                   **PULL_TOL)


def _stack_inputs(s):
    leaves = wide_stack(s["tp"], K)
    xs = _t(s["x"].transpose(2, 0, 1)).contiguous()
    h0 = _t(s["h"])
    upd = [1.0, 0.4]
    fwd = resid_ef.resid_fwd(leaves, h0, xs, torch.zeros_like(xs), upd)
    tx0 = _t(np.concatenate(s["txp"], -1).transpose(2, 0, 1)).contiguous()
    return leaves, h0, xs, upd, fwd, tx0


def test_resid_jvp_stack_matches_torch_jvp(setup):
    """``resid_jvp`` (plain on CPU tensors) against ``torch.func.jvp`` of the
    K1 stack along ``x``: every tangent boundary, residual and final state."""
    leaves, h0, xs, upd, fwd, tx0 = _stack_inputs(setup)
    zeros = torch.zeros_like(xs)
    _, want = torch.func.jvp(lambda x_: resid_ef.resid_fwd_plain(leaves, h0, x_, zeros, upd),
                             (xs,), (tx0,))
    got = train2_ef.resid_jvp(leaves, fwd, upd, tx0)
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        torch.testing.assert_close(a, b, **STACK_TOL)


def test_aug_bwd_stack_matches_double_autograd(setup):
    """``resid_aug_bwd`` (the tangent chain, the primal chain with the
    Hessian terms, both contractions) against torch's double backward of
    ``S = <dh_fin, h_fin> + <dth_fin, dh_fin/dx . tx0>`` built from the K1
    stack."""
    s = setup
    leaves0, h0, xs, upd, fwd, tx0 = _stack_inputs(s)
    rng = np.random.RandomState(9)
    dh_fin = _t(rng.randn(B, N, HID).astype(np.float32))
    dth_fin = _t(rng.randn(B, N, HID).astype(np.float32))
    leaves = {n: a.clone().requires_grad_(True) for n, a in leaves0.items()}
    hg, xg = h0.clone().requires_grad_(True), xs.clone().requires_grad_(True)
    zeros = torch.zeros_like(xs)
    h_fin = resid_ef.resid_fwd_plain(leaves, hg, xg, zeros, upd).h_fin
    (jv,) = torch.autograd.grad(h_fin, xg, dth_fin, create_graph=True)  # J^T dth_fin
    s_ = (h_fin * dh_fin).sum() + (jv * tx0).sum()
    want = torch.autograd.grad(s_, [hg, xg, *leaves.values()])
    tfwd = train2_ef.resid_jvp(leaves0, fwd, upd, tx0)
    dh0, dx0, dth0, grads = train2_ef.resid_aug_bwd(leaves0, fwd, tfwd, upd, dh_fin, dth_fin)
    torch.testing.assert_close(dh0, want[0], **PULL_TOL)
    torch.testing.assert_close(dx0, want[1], **PULL_TOL)
    for name, w in zip(leaves, want[2:]):
        torch.testing.assert_close(grads[name], w, **PULL_TOL, msg=name)
    want_dth0 = train2_ef.resid_tbwd_plain(leaves0, fwd, tfwd, upd, dth_fin, zeros, zeros)[0]
    torch.testing.assert_close(dth0, want_dth0, rtol=0, atol=0)


@pytest.mark.parametrize("shared_chunk", [None, 3])
@pytest.mark.parametrize("aug_mode,fused_primal", [("shared", None), ("fused", None),
                                                   ("fused", False), ("shared", True)])
def test_make_ef_train2_matches_jax_double_autodiff(setup, shared_chunk, aug_mode,
                                                    fused_primal):
    """Loss and gradients (every parameter, h and x) of the JAX test's loss
    through ``make_ef_train2`` against JAX double autodiff of the functional
    model (``ef_lax``), in both modes and with either primal under either
    backward (``fused_primal`` None: the mode's own). ``shared_chunk=3``
    cuts B = 4 into a chunk of 3 and a ragged chunk of 1."""
    s = setup
    e_t, f_t = _loss_parts(s)

    def ef_lax(p, h_, x_):
        def e_fn(xx):
            out, _, _ = jax_model_forward(p, h_, xx, n_heads=K, update=True)
            return out.sum(axis=(-2, -1)).sum(), out.sum(axis=(-2, -1))

        g, e = jax.grad(e_fn, has_aux=True)(x_)
        return e, -g

    def loss_j(p, h_, x_):
        e, f = ef_lax(p, h_, x_)
        return ((e - e_t) ** 2).sum() + 0.5 * ((f - f_t) ** 2).sum()

    l_ref, g_ref = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
        s["kp"], jnp.asarray(s["h_raw"]), jnp.asarray(s["x"]))
    want = flat_params(_jax_params(g_ref[0]))

    ef = train2_ef.make_ef_train2(n_heads=K, update=True, aug_mode=aug_mode,
                                  fused_primal=fused_primal, shared_chunk=shared_chunk,
                                  batch_tile=2, pad_atoms=True)
    flat = [t.detach().clone().requires_grad_(True) for t in flat_params(s["tp"])]
    tp = resid_ef._unflat_params(flat, DEPTH)
    h = _t(s["h_raw"]).requires_grad_(True)
    x = _t(s["x"]).requires_grad_(True)
    e, f = ef(tp, h, x)
    assert type(e.grad_fn).__name__ == "EFBackward"  # the kernel backward, not autograd's
    loss = ((e - _t(e_t)) ** 2).sum() + 0.5 * ((f - _t(f_t)) ** 2).sum()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-5)
    got = torch.autograd.grad(loss, [h, x, *flat])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(g_ref[1]), **MODEL_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(g_ref[2]), **MODEL_TOL)
    assert len(got) - 2 == len(want)
    for i, (g, w) in enumerate(zip(got[2:], want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"leaf {i}", **MODEL_TOL)
    with torch.no_grad():  # outside autograd: the primal only, no saved streams
        e0, f0 = ef(tp, h, x)
    torch.testing.assert_close(e0, e.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(f0, f.detach(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw,err", [
    (dict(aug_mode="resid", matmul_dtype=torch.bfloat16), NotImplementedError),
    (dict(aug_mode="retrace", resid_dtype=torch.bfloat16), NotImplementedError),
    (dict(aug_mode="shared", edge_matmul_dtype=torch.bfloat16), NotImplementedError),
    (dict(aug_mode="shared", resid_dtype=torch.bfloat16), NotImplementedError),
    (dict(aug_mode="shared", spatial_mode="mxu"), NotImplementedError),
    (dict(aug_mode="twice"), ValueError),
])
def test_make_ef_train2_rejects_unported_modes(kw, err):
    with pytest.raises(err):
        train2_ef.make_ef_train2(**kw)


def test_kernel_wrappers_count_only_card_launches(setup):
    """On CPU tensors every wrapper of the slice takes its plain version and
    leaves its launch count alone."""
    from sake_tpu_torch.kernels import one_ef

    leaves, h0, xs, upd, fwd, tx0 = _stack_inputs(setup)
    tp, g_e = setup["tp"], torch.ones(B)
    counted = (train2_ef.shared_fwd, train2_ef.shared_bwd, train2_ef.resid_jvp,
               train2_ef.resid_tbwd, train2_ef.resid_bwd_aug, train2_ef.param_grads_aug,
               train2_ef.fused_primal, train2_ef.fused_bwd_block, train2_ef.fused_bwd_grads,
               one_ef.one_energy_forces)
    before = [c.launches for c in counted]
    fwd2 = train2_ef.shared_fwd(leaves, h0, xs, upd)
    train2_ef.shared_bwd(leaves, fwd2, upd, torch.ones_like(h0))
    tfwd = train2_ef.resid_jvp(leaves, fwd, upd, tx0)
    train2_ef.resid_aug_bwd(leaves, fwd, tfwd, upd, torch.ones_like(h0), torch.ones_like(h0))
    train2_ef.fused_primal(tp, leaves, h0, xs, upd)
    *_, tfwd2, rows, rows_t, t_rows, part = train2_ef.fused_bwd_block(tp, leaves, fwd, upd, tx0,
                                                                      g_e)
    train2_ef.fused_bwd_grads(tp, leaves, fwd, tfwd2, rows, rows_t, t_rows, part)
    train2_ef.fused_bwd(tp, leaves, fwd, upd, tx0, g_e)
    one_ef.one_energy_forces(tp, _t(setup["h_raw"]), _t(setup["x"]), n_heads=K)
    assert [c.launches for c in counted] == before


def test_fused_primal_plain_is_the_shared_primal(setup):
    """#11's plain version gives the shared primal's streams, energy and dx
    (#7, the readout seed, #8)."""
    leaves, h0, xs, upd, fwd, _ = _stack_inputs(setup)
    tp = setup["tp"]
    got, e, dx = train2_ef.fused_primal(tp, leaves, h0, xs, upd)
    e_ref, dh_fin = resid_ef._readout_seed(tp, fwd.h_fin, None)
    dx_ref = train2_ef.shared_bwd(leaves, fwd, upd, dh_fin)
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(fwd)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(e, e_ref, rtol=0, atol=0)
    torch.testing.assert_close(dx, dx_ref, rtol=0, atol=0)


def test_fused_bwd_parts_match_the_whole(setup):
    """#12's two launches in their plain versions (the block's tangent
    forward, closed-form per-molecule readout gradients and both chains,
    then the contraction and the sum over molecules) against
    ``fused_bwd_plain`` (``head_grads`` by autograd and the shared-mode
    stacks)."""
    leaves, _, _, upd, fwd, tx0 = _stack_inputs(setup)
    tp = setup["tp"]
    g_e = _t(np.random.RandomState(3).randn(B).astype(np.float32))
    dh0, dx0, tfwd, rows, rows_t, t_rows, part = train2_ef.fused_bwd_block(
        tp, leaves, fwd, upd, tx0, g_e)
    grads, ro = train2_ef.fused_bwd_grads(tp, leaves, fwd, tfwd, rows, rows_t, t_rows, part)
    want = train2_ef.fused_bwd_plain(tp, leaves, fwd, upd, tx0, g_e)
    torch.testing.assert_close(dh0, want[0], **STACK_TOL)
    torch.testing.assert_close(dx0, want[1], **STACK_TOL)
    assert [a.shape for a in ro] == [t.shape for t in (tp.w_out0, tp.b_out0, tp.w_out1,
                                                       tp.b_out1)]
    for a, b in zip(ro, want[2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    for name in LEAF_NAMES:
        torch.testing.assert_close(grads[name], want[3][name], **STACK_TOL, msg=name)


def test_make_ef_train2_fused_matches_jax_fused_interpret():
    """A tiny case (hidden 8, depth 1, B = 2, N = 5) against the JAX
    package's own ``make_ef_train2(aug_mode="fused", interpret=True)``, the
    Pallas kernels #11 and #12 run by the interpreter: loss and every
    gradient at the double-autodiff tier."""
    from sake_tpu.kernels.train2_ef import make_ef_train2 as jax_make_ef_train2

    rng = np.random.RandomState(8)
    h_raw = rng.randn(2, 5, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(2, 5, 3)).astype(np.float32)
    e_t, f_t = rng.randn(2).astype(np.float32), rng.randn(2, 5, 3).astype(np.float32)
    model = JaxSAKEModel(hidden_features=8, out_features=1, depth=1)
    params = model.init(jax.random.PRNGKey(4), jnp.asarray(h_raw), jnp.asarray(x))
    kp = jax_from_linen(params)
    ef_j = jax_make_ef_train2(n_heads=K, batch_tile=2, aug_batch_tile=2, aug_mode="fused",
                              chunk=None, shared_chunk=None, interpret=True)

    def loss_j(p, h_, x_):
        e, f = ef_j(p, h_, x_)
        return ((e - e_t) ** 2).sum() + 0.5 * ((f - f_t) ** 2).sum()

    l_ref, g_ref = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
        kp, jnp.asarray(h_raw), jnp.asarray(x))
    ef = train2_ef.make_ef_train2(n_heads=K, aug_mode="fused")
    flat = [t.detach().clone().requires_grad_(True)
            for t in flat_params(model_params_from_linen(_np_tree(params)))]
    tp = resid_ef._unflat_params(flat, 1)
    h, xt = _t(h_raw).requires_grad_(True), _t(x).requires_grad_(True)
    e, f = ef(tp, h, xt)
    loss = ((e - _t(e_t)) ** 2).sum() + 0.5 * ((f - _t(f_t)) ** 2).sum()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-5)
    got = torch.autograd.grad(loss, [h, xt, *flat])
    want = [np.asarray(g_ref[1]), np.asarray(g_ref[2]),
            *(w.numpy() for w in flat_params(_jax_params(g_ref[0])))]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"leaf {i}", **MODEL_TOL)


@pytest.mark.gpu
def test_tangent_pullback_kernel_fits_narrow_heads(setup):
    """#12 (whose phase 2 runs the tangent pullback's body) against its
    plain version on the card with 50 rbf channels at hidden 8 (R > H*K =
    32) and hidden 16 (R < H*K = 64). The tangent pullback's shared-memory
    carve once sized its d_pre buffer by H*K alone, which overflows when R >
    H*K."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sake_tpu_torch.kernels.functional import params_to

    dev = torch.device("cuda")
    rng = np.random.RandomState(4)
    for hid in (8, HID):
        model = JaxSAKEModel(hidden_features=hid, out_features=1, depth=DEPTH)
        params = model.init(jax.random.PRNGKey(0), jnp.asarray(setup["h_raw"]),
                            jnp.asarray(setup["x"]))
        tp = params_to(model_params_from_linen(_np_tree(params)), dev)
        leaves = wide_stack(tp, K)
        h0 = torch.as_tensor(rng.randn(B, N, hid).astype(np.float32), device=dev)
        xs = _t(setup["x"].transpose(2, 0, 1)).contiguous().to(dev)
        upd = [1.0, 0.4]
        fwd = resid_ef.resid_fwd_plain(leaves, h0, xs, torch.zeros_like(xs), upd)
        tx0 = torch.as_tensor(rng.randn(3, B, N).astype(np.float32), device=dev)
        g_e = torch.as_tensor(rng.randn(B).astype(np.float32), device=dev)
        got = train2_ef.fused_bwd(tp, leaves, fwd, upd, tx0, g_e)
        want = train2_ef.fused_bwd_plain(tp, leaves, fwd, upd, tx0, g_e)
        for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
            torch.testing.assert_close(a, b, **PULL_TOL)
