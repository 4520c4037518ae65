"""The bf16 tier of ``make_ef_train2``'s fused mode (JAX ``edge_matmul_dtype``
and ``resid_dtype`` bf16, the tier ``md17_kernel`` trains in): the port's plain
versions against the JAX package's on the CPU, the streams' dtypes, the entries
the kernel wrappers launch, and the modes that still raise.

Tolerances. As in ``tests/test_torch_resid_bf16.py``: every comparison measures,
on its own inputs, how far the bf16 tier lies from the f32 tier (``d``, max
|diff| / max |ref| per tensor) and holds the port's bf16 tier to the JAX bf16
tier within ``min(cap, QUARTER * d)`` per tensor, ``cap`` stated per test below;
so a port that computes f32, or skips a rounding that moves a tensor, fails.
Tensors the tier does not move (``d`` under ``UNMOVED``) are held at
``F32_CAP``. The f32 reference is JAX's f32 layer function on the same inputs
for the layer tests, and the port's f32 fused mode (which
``tests/test_torch_train2.py`` holds to JAX's) for ``make_ef_train2``. The JAX
fused mode runs in interpret mode, once, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.kernels.depthgrid_ef import _LEAF_NAMES, _make_mm_prec
from sake_tpu.kernels.depthgrid_ef import wide_stack as jax_wide_stack
from sake_tpu.kernels.resid_ef import _RESID_LOWP, _make_mmt_prec, contract_param_pair_tangents
from sake_tpu.kernels.resid_ef import layer_bwd_resid as jax_layer_bwd
from sake_tpu.kernels.resid_ef import layer_fwd_resid as jax_layer_fwd
from sake_tpu.kernels.resid_ef import layer_jvp_resid as jax_layer_jvp
from sake_tpu.kernels.split_ef import head_expansion_matrices
from sake_tpu.kernels.train2_ef import make_ef_train2 as jax_make_ef_train2
from sake_tpu_torch.kernels import build, resid_ef, train2_ef
from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen, params_from_jax
from sake_tpu_torch.kernels.functional import bf16_round, flat_params
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, layer_leaves, transposed, wide_stack
from sake_tpu_torch.models import SAKEModel

QUARTER = 0.25  # of the tier's own distance, per tensor
UNMOVED = 1e-5  # a tier distance below this: the tensor is not moved here (f32 noise)
F32_CAP = 3e-6  # the unmoved tensors (f32 reassociation)
JVP_CAP = 1e-5  # one layer's tangent state and tangent residuals
PULL_CAP = 2e-4  # one layer's tangent pullback: cotangents and Hessian terms (7.9e-5 measured)
DW_CAP = 5e-4  # one layer's parameter-gradient tangents (flipped bf16 roundings show here)
GRAD_CAP = 1e-4  # make_ef_train2's loss gradients, through the fused mode's roundings

B, N, F_IN, HID, K = 4, 7, 5, 16, 4
BF16 = dict(edge_matmul_dtype=torch.bfloat16, resid_dtype=torch.bfloat16)
JAX_BF16 = dict(edge_matmul_dtype=jnp.bfloat16, resid_dtype=jnp.bfloat16, resid_lowp=_RESID_LOWP)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _hold(got, want_bf16, want_f32, cap, label):
    """``got`` within ``min(cap, QUARTER * d)`` of ``want_bf16``, ``d`` the tiers'
    distance; an unmoved tensor within ``F32_CAP``. Returns ``d``."""
    got = np.asarray(got).reshape(np.shape(want_bf16))
    d = _rel(want_bf16, want_f32)
    tol = min(cap, QUARTER * d) if d >= UNMOVED else F32_CAP
    assert _rel(got, want_bf16) <= tol, (label, _rel(got, want_bf16), tol, d)
    return d


def _t(a):
    return torch.as_tensor(np.array(a))


def _models(hid, depth, heads=K, seed=0):
    """A seeded model's parameters for both packages (the port's module built
    once, its linen tree converted by each package's adapter)."""
    model = SAKEModel(hid, 1, depth, n_heads=heads, in_features=F_IN, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    tree = linen_tree(model)
    kp = jax_from_linen({"params": jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()),
                                                tree)})
    return kp, model_params_from_linen(tree, device="cpu")


def _low(res):
    """JAX residuals as the tier's streams hold them: rounded to bf16 but r and t."""
    return {n: v.astype(jnp.bfloat16).astype(jnp.float32) if n in _RESID_LOWP else v
            for n, v in res.items()}


def _port_res(res):
    return {n: _t(v).reshape(B, N * N if n in resid_ef.EDGE_RESIDS else N, -1)
            for n, v in res.items()}


@pytest.fixture(scope="module")
def layer_setup():
    """One layer's inputs, and per mask the JAX bf16 tier's residuals and
    tangent residuals as its streams hold them (rounded), with the JAX tangent
    forward and tangent pullback in both tiers on those same streams."""
    rng = np.random.RandomState(1)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    planes = lambda: [f(B, N, 1) for _ in range(3)]
    kp, tp = _models(HID, 2)
    h, xp, vp = f(B, N, HID), planes(), planes()
    th, txp, tvp = f(B, N, HID), planes(), planes()
    ct = (f(B, N, HID), planes(), planes())
    node_mask = (rng.rand(B, N) > 0.3).astype(np.float32)
    mask4 = (node_mask[:, :, None] * node_mask[:, None, :])[..., None]
    p_j = {name: leaf[1] for name, leaf in zip(_LEAF_NAMES, jax_wide_stack(kp, K))}
    e_rep, e_tile = head_expansion_matrices(HID, K)
    mm = lambda a, w: jnp.dot(a, w, preferred_element_type=jnp.float32)
    kw = dict(e_rep=e_rep, e_tile=e_tile, mm=mm)
    edge = {True: dict(mm_edge=_make_mm_prec(jnp.bfloat16, None)), False: {}}
    mmt = {True: _make_mmt_prec(jnp.bfloat16, None), False: _make_mmt_prec(None, None)}
    J = lambda l: [jnp.asarray(a) for a in l]
    hj, xpj, vpj = jnp.asarray(h), J(xp), J(vp)
    tj = (jnp.asarray(th), J(txp), J(tvp))
    out = {}
    for masked in (False, True):
        mj = jnp.asarray(mask4) if masked else None
        res = _low(jax_layer_fwd(p_j, hj, xpj, vpj, 0.7, mask=mj, **kw, **edge[True])[3])
        jvp = {tier: jax_layer_jvp(p_j, res, hj, xpj, vpj, *tj, 0.7, mask=mj, **kw, **edge[tier])
               for tier in (True, False)}
        tres = _low(jvp[True][3])
        pull = {}
        for tier in (True, False):
            def bwd_fn(resid_, h_, xp_, vp_, tier=tier):
                return jax_layer_bwd(p_j, resid_, h_, xp_, vp_, 0.7, jnp.asarray(ct[0]),
                                     J(ct[1]), J(ct[2]), mask=mj, want_param_grads="pairs",
                                     mm_t=mmt[False], mm_edge_t=mmt[tier], **kw, **edge[tier])

            (dh, dxp, dvp, _, pairs_p), (hc, xc, vc, dwc_t, pairs_t) = jax.jvp(
                bwd_fn, (res, hj, xpj, vpj), (tres, *tj))
            dw_t = dict(dwc_t)
            dw_t.update(contract_param_pair_tangents(pairs_p, pairs_t, mmt[False], mmt[tier]))
            pull[tier] = ([dh, *dxp, *dvp, hc, *xc, *vc], dw_t)
        out[masked] = dict(res=res, tres=tres, jvp=jvp, pull=pull)
    return dict(h=h, xp=xp, vp=vp, th=th, txp=txp, tvp=tvp, ct=ct, mask4=mask4,
                p_t=layer_leaves(wide_stack(tp, K), 1), jax=out)


def test_jvp_of_a_bf16_rounding_rounds_the_tangent():
    """``torch.func.jvp`` of ``bf16_round`` rounds the tangent, as JAX's jvp of
    ``astype(bfloat16)`` does: the tangent pullback's edge products then round
    their value and tangent operands apart."""
    x, t = torch.randn(257, generator=torch.Generator().manual_seed(0)), torch.randn(257)
    o, to = torch.func.jvp(bf16_round, (x,), (t,))
    assert torch.equal(o, bf16_round(x)) and torch.equal(to, bf16_round(t))
    assert not torch.equal(to, t)
    _, tj = jax.jvp(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32),
                    (jnp.asarray(x.numpy()),), (jnp.asarray(t.numpy()),))
    np.testing.assert_array_equal(to.numpy(), np.asarray(tj))


@pytest.mark.parametrize("masked", [False, True])
def test_layer_jvp_resid_bf16_matches_jax(layer_setup, masked):
    """The tangent forward in the tier on the tier's streams: every tangent
    output and tangent residual against JAX's with ``mm_edge`` in bf16."""
    s = layer_setup
    j = s["jax"][masked]
    T = lambda l: [_t(a) for a in l]
    got = resid_ef.layer_jvp_resid(s["p_t"], _port_res(j["res"]), _t(s["h"]), T(s["xp"]),
                                   T(s["vp"]), _t(s["th"]), T(s["txp"]), T(s["tvp"]), 0.7,
                                   mask=_t(s["mask4"]) if masked else None, bf16=True)
    wb, wf = j["jvp"][True], j["jvp"][False]
    flat = lambda o: [o[0], *o[1], *o[2]]
    for i, (g, b, f) in enumerate(zip(flat(got), flat(wb), flat(wf))):
        _hold(g.numpy(), b, f, JVP_CAP, f"tangent state {i}")
    moved = [n for n in resid_ef.RESIDS
             if _hold(got[3][n].numpy(), wb[3][n], wf[3][n], JVP_CAP, n) >= UNMOVED]
    assert {"e0", "h_e", "sem_pre", "att", "coeff"} <= set(moved)


@pytest.mark.parametrize("masked", [False, True])
def test_tangent_pullback_bf16_matches_jax(layer_setup, masked):
    """``layer_bwd_resid_jvp`` and ``layer_param_grads_tangent`` in the tier
    against ``jax.jvp`` of JAX's ``layer_bwd_resid(want_param_grads="pairs")``
    with ``mm_edge`` and ``mm_edge_t`` in bf16, then
    ``contract_param_pair_tangents``, both packages on the same rounded primal
    and tangent streams."""
    s = layer_setup
    j = s["jax"][masked]
    T = lambda l: [_t(a) for a in l]
    res, tres = _port_res(j["res"]), _port_res(j["tres"])
    h, th = _t(s["h"]), _t(s["th"])
    (dh, dxp, dvp, rows), (hc, xc, vc, t_rows) = resid_ef.layer_bwd_resid_jvp(
        s["p_t"], res, h, T(s["xp"]), T(s["vp"]), 0.7, _t(s["ct"][0]), T(s["ct"][1]),
        T(s["ct"][2]), tres, th, T(s["txp"]), T(s["tvp"]),
        mask=_t(s["mask4"]) if masked else None, bf16=True)
    got_w = resid_ef.layer_param_grads_tangent(s["p_t"], res, h, rows, tres, th, t_rows,
                                               bf16=True)
    (wb, dwb), (wf, dwf) = j["pull"][True], j["pull"][False]
    for i, (g, b, f) in enumerate(zip([dh, *dxp, *dvp, hc, *xc, *vc], wb, wf)):
        _hold(g.numpy(), b, f, PULL_CAP, f"output {i}")
    assert set(got_w) == set(dwb) == set(LEAF_NAMES)
    moved = [n for n in LEAF_NAMES
             if _hold(got_w[n].numpy(), dwb[n], dwf[n], DW_CAP, n) >= UNMOVED]
    assert set(resid_ef.EDGE_MM_LEAVES) <= set(moved)


@pytest.fixture(scope="module")
def train_setup():
    """A tiny case (hidden 8, depth 1, B = 2, N = 5): the loss and its gradients
    through JAX's ``make_ef_train2(aug_mode="fused")`` in the tier, #11 and #12
    run by the Pallas interpreter, and through the port's f32 fused mode."""
    rng = np.random.RandomState(8)
    h_raw = rng.randn(2, 5, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(2, 5, 3)).astype(np.float32)
    e_t, f_t = rng.randn(2).astype(np.float32), rng.randn(2, 5, 3).astype(np.float32)
    kp, tp = _models(8, 1, seed=4)
    ef_j = jax_make_ef_train2(n_heads=K, batch_tile=2, aug_batch_tile=2, aug_mode="fused",
                              chunk=None, shared_chunk=None, interpret=True, **JAX_BF16)

    def loss_j(p, h_, x_):
        e, f = ef_j(p, h_, x_)
        return ((e - e_t) ** 2).sum() + 0.5 * ((f - f_t) ** 2).sum()

    l_ref, g_ref = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
        kp, jnp.asarray(h_raw), jnp.asarray(x))
    want = [np.asarray(l_ref), np.asarray(g_ref[1]), np.asarray(g_ref[2]),
            *(w.numpy() for w in flat_params(params_from_jax(jax.tree.map(np.asarray,
                                                                          g_ref[0]))))]
    s = dict(h=h_raw, x=x, e_t=e_t, f_t=f_t, tp=tp, want=want)
    s["f32"] = _port_loss_grads(s, {})
    return s


def _port_loss_grads(s, tier):
    """The loss and its gradients w.r.t. h, x and every flat leaf through the
    port's fused mode (the plain versions on CPU tensors)."""
    ef = train2_ef.make_ef_train2(n_heads=K, aug_mode="fused", **tier)
    flat = [t.detach().clone().requires_grad_(True) for t in flat_params(s["tp"])]
    h, x = _t(s["h"]).requires_grad_(True), _t(s["x"]).requires_grad_(True)
    e, f = ef(resid_ef._unflat_params(flat, 1), h, x)
    loss = ((e - _t(s["e_t"])) ** 2).sum() + 0.5 * ((f - _t(s["f_t"])) ** 2).sum()
    return [loss.detach().numpy(), *(g.numpy() for g in torch.autograd.grad(loss, [h, x, *flat]))]


@pytest.mark.parametrize("fused_primal", [None, True])
def test_make_ef_train2_fused_bf16_matches_jax_interpret(train_setup, fused_primal):
    """The loss and every gradient (h, x, each leaf) of the tier's fused mode on
    CPU tensors against JAX's fused mode in the tier in interpret mode."""
    s = train_setup
    got = _port_loss_grads(s, dict(BF16, fused_primal=fused_primal))
    assert len(got) == len(s["want"]) == len(s["f32"])
    moved = 0
    for i, (g, b, f) in enumerate(zip(got, s["want"], s["f32"])):
        moved += _hold(g, b, f, GRAD_CAP, "loss" if i == 0 else f"gradient {i - 1}") >= UNMOVED
    assert moved > len(got) // 2  # the tier moves most of them


def test_tier_streams_are_bf16_but_r_and_t():
    """#11's plain primal and #12's plain tangent forward in the tier write the
    low-precision streams as bf16 tensors and r and t as f32 (``stream_dtype``);
    the f32 tier writes f32 throughout."""
    _, tp = _models(8, 2)
    leaves = wide_stack(tp, K)
    g = torch.Generator().manual_seed(3)
    h0, xs = torch.randn(2, 5, 8, generator=g), torch.randn(3, 2, 5, generator=g)
    tx0, g_e = torch.randn(3, 2, 5, generator=g), torch.randn(2, generator=g)
    for bf16 in (True, False):
        fwd, _, _ = train2_ef.fused_primal(tp, leaves, h0, xs, [1.0, 1.0], bf16=bf16)
        tfwd = train2_ef.fused_bwd_block(tp, leaves, fwd, [1.0, 1.0], tx0, g_e)[2]
        for f in (fwd, tfwd):
            assert resid_ef.stream_tier(f) == bf16
            assert {n: v.dtype for n, v in f.resid.items()} == {
                n: resid_ef.stream_dtype(n, bf16) for n in resid_ef.RESIDS}
            assert f.bh.dtype == f.bx.dtype == torch.float32


@pytest.mark.parametrize("kw,match", [
    (dict(aug_mode="shared", matmul_dtype=torch.bfloat16, **BF16), "matmul_dtype"),
    (dict(aug_mode="resid", edge_matmul_dtype=torch.bfloat16), "go together"),
    (dict(aug_mode="retrace", resid_lowp=("r",), **BF16), "resid_lowp"),
    (dict(aug_mode="fused", fused_primal=False, spatial_mode="pool", **BF16), "spatial_mode"),
])
def test_non_fused_modes_raise_on_the_tier(kw, match):
    """Every mode takes the tier; each still raises on the keyword combinations
    that are not ported, naming them."""
    with pytest.raises(NotImplementedError, match=match):
        train2_ef.make_ef_train2(**kw)


def _stub(calls):
    """A library whose launch entries record their names and succeed; the smem
    entries answer 0."""
    names = ("sake_fused_primal", "sake_fused_primal16", "sake_fused_bwd", "sake_fused_bwd16",
             "sake_param_grads_aug", "sake_param_grads_aug16", "sake_resid_jvp16",
             "sake_resid_tbwd16")
    return SimpleNamespace(
        **{n: (lambda *a, n=n: calls.append(n) or 0) for n in names},
        **{f"sake_{k}_smem_bytes": (lambda *d: 0)
           for k in ("fused_ef", "fused_primal16", "fused_bwd", "fused_bwd16", "resid_jvp",
                     "resid_tbwd")},
        sake_error_string=lambda err: b"refused")


def test_tier_wrappers_launch_the_tier_entries(monkeypatch):
    """On CUDA tensors (meta tensors here) #11, #12's block and #12's contraction
    launch their tier entries on the tier's streams and the f32 entries on f32
    streams, each counted under its tier; so do #9 and #10's tangent chain on
    the tier's streams."""
    calls = []
    monkeypatch.setattr(build, "load", lambda: _stub(calls))
    monkeypatch.setattr(train2_ef, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(resid_ef, "_stream", lambda dev: None)
    meta = lambda *s: torch.empty(*s, device="meta")
    depth, Bm, Nm, F0 = 2, 3, 21, 32
    leaves = {n: meta(depth, *s) for n, s in resid_ef._leaf_shapes(64, 64, 50, 4, 256).items()}
    params = SimpleNamespace(w_out0=meta(64, F0), b_out0=meta(F0), w_out1=meta(F0, 1),
                             b_out1=meta(1))
    h0, xs = meta(Bm, Nm, 64), meta(3, Bm, Nm)
    upd, g_e = [1.0] * depth, meta(Bm)
    before = {c.__name__: dict(c.tiers) for c in (train2_ef.fused_primal,
                                                  train2_ef.fused_bwd_block,
                                                  train2_ef.fused_bwd_grads)}
    for bf16 in (True, False):
        fwd, _, _ = train2_ef.fused_primal(params, leaves, h0, xs, upd, bf16=bf16)
        assert resid_ef.stream_tier(fwd) == bf16
        _, _, tfwd, rows, rows_t, t_rows, part = train2_ef.fused_bwd_block(
            params, leaves, fwd, upd, xs, g_e)
        assert resid_ef.stream_tier(tfwd) == bf16
        train2_ef.fused_bwd_grads(params, leaves, fwd, tfwd, rows, rows_t, t_rows, part)
    assert calls == ["sake_fused_primal16", "sake_fused_bwd16", "sake_param_grads_aug16",
                     "sake_fused_primal", "sake_fused_bwd", "sake_param_grads_aug"]
    for c in (train2_ef.fused_primal, train2_ef.fused_bwd_block, train2_ef.fused_bwd_grads):
        assert c.tiers["bf16"] - before[c.__name__]["bf16"] == 1
        assert c.tiers["f32"] - before[c.__name__]["f32"] == 1
    fwd16 = train2_ef.fused_primal(params, leaves, h0, xs, upd, bf16=True)[0]
    calls.clear()
    tfwd16 = train2_ef.resid_jvp(leaves, fwd16, upd, xs)
    assert resid_ef.stream_tier(tfwd16)
    train2_ef.resid_tbwd(leaves, fwd16, tfwd16, upd, h0, xs, xs, leaves_t=transposed(leaves))
    assert calls == ["sake_resid_jvp16", "sake_resid_tbwd16"]
