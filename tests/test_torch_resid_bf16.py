"""The bf16 tier of ``resid_ef`` (JAX ``edge_matmul_dtype`` and ``resid_dtype``
bf16, the production setting of every JAX task that runs these kernels):
the port's plain versions against the JAX package's on the CPU, the routes
its kernels take, and the combinations that still raise.

Tolerances. Every comparison measures, on its own inputs, how far the JAX
bf16 tier lies from the f32 tier (``d``, max |diff| / max |ref| per tensor;
the f32 tier is the port's plain f32 version, which the f32 tests hold to
JAX's f32 within 2e-4) and holds the port's bf16 tier to the JAX bf16 tier
within ``min(cap, QUARTER * d)`` per tensor, ``cap`` stated per test below;
so a port that computes f32, or skips a rounding that moves a tensor, fails.
Tensors the tier does not move here (``d`` under ``UNMOVED``: r, t, rbf,
the velocity gate, the readout's zero gradients, ...) are held at ``F32_CAP``.
The JAX kernels run in interpret mode, each once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.kernels.depthgrid_ef import _LEAF_NAMES, _make_mm_prec
from sake_tpu.kernels.depthgrid_ef import wide_stack as jax_wide_stack
from sake_tpu.kernels.dispatch import _LOWP_X
from sake_tpu.kernels.resid_ef import _RESID_LOWP, _make_mmt_prec
from sake_tpu.kernels.resid_ef import layer_bwd_resid as jax_layer_bwd
from sake_tpu.kernels.resid_ef import layer_fwd_resid as jax_layer_fwd
from sake_tpu.kernels.resid_ef import make_hidden_fn as jax_make_hidden_fn
from sake_tpu.kernels.resid_ef import resid_energy_forces as jax_resid_energy_forces
from sake_tpu.kernels.split_ef import head_expansion_matrices
from sake_tpu_torch.kernels import build, dispatch, resid_ef
from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
from sake_tpu_torch.kernels.functional import readout
from sake_tpu_torch.kernels.leaves import layer_leaves, transposed, wide_stack
from sake_tpu_torch.models import SAKEModel

QUARTER = 0.25  # of the tier's own distance, per tensor
UNMOVED = 1e-5  # a tier distance below this: the tensor is not moved here (f32 noise)
F32_CAP = 3e-6  # the unmoved tensors (f32 reassociation)
FWD_CAP = 5e-6  # one layer's outputs and residuals
BWD_CAP = 2e-5  # one layer's input cotangents
DW_CAP = 5e-4  # one layer's parameter gradients (flipped bf16 roundings show here)
EF_CAP = 1e-5  # E and F of resid_energy_forces, h_fin of make_hidden_fn
GRAD_CAP = 1.5e-3  # make_hidden_fn's gradients, through two layers of flips

B, N, F_IN, HID, K = 4, 7, 5, 16, 4
BF16 = dict(edge_matmul_dtype=torch.bfloat16, resid_dtype=torch.bfloat16)
JAX_BF16 = dict(edge_matmul_dtype=jnp.bfloat16, resid_dtype=jnp.bfloat16, resid_lowp=_RESID_LOWP)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _hold(got, want_bf16, want_f32, cap, label):
    """``got`` within ``min(cap, QUARTER * d)`` of ``want_bf16``, ``d`` the JAX
    tiers' distance; an unmoved tensor within ``F32_CAP``."""
    got = np.asarray(got).reshape(np.shape(want_bf16))
    d = _rel(want_bf16, want_f32)
    tol = min(cap, QUARTER * d) if d >= UNMOVED else F32_CAP
    assert _rel(got, want_bf16) <= tol, (label, _rel(got, want_bf16), tol, d)
    return d


def _t(a):
    return torch.as_tensor(np.array(a))


def _models(hid, depth, heads=K, seed=0):
    """A seeded model's parameters for both packages: the JAX ``ModelParams``
    and the port's (the port's module built once, its linen tree converted by
    each package's adapter; a linen ``init`` would cost seconds)."""
    model = SAKEModel(hid, 1, depth, n_heads=heads, in_features=F_IN, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    tree = linen_tree(model)
    kp = jax_from_linen({"params": jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()),
                                                tree)})
    return kp, model_params_from_linen(tree, device="cpu")


@pytest.fixture(scope="module")
def layer_setup():
    rng = np.random.RandomState(0)
    h_raw = rng.randn(B, N, F_IN).astype(np.float32)
    x = rng.randn(B, N, 3).astype(np.float32)
    kp, tp = _models(HID, 2)
    h = (h_raw @ np.asarray(kp.w_embed) + np.asarray(kp.b_embed)).astype(np.float32)
    vp = [rng.randn(B, N, 1).astype(np.float32) for _ in range(3)]
    node_mask = (rng.rand(B, N) > 0.3).astype(np.float32)
    mask4 = (node_mask[:, :, None] * node_mask[:, None, :])[..., None]
    seeds = (rng.randn(B, N, HID).astype(np.float32),
             [rng.randn(B, N, 1).astype(np.float32) for _ in range(3)],
             [rng.randn(B, N, 1).astype(np.float32) for _ in range(3)])
    p_j = {name: leaf[0] for name, leaf in zip(_LEAF_NAMES, jax_wide_stack(kp, K))}
    p_t = layer_leaves(wide_stack(tp, K), 0)
    e_rep, e_tile = head_expansion_matrices(HID, K)
    mm = lambda a, w: jnp.dot(a, w, preferred_element_type=jnp.float32)
    xp = [x[..., k : k + 1] for k in range(3)]
    J = lambda l: [jnp.asarray(a) for a in l]
    T = lambda l: [_t(a) for a in l]
    out = {}
    for masked in (False, True):
        mj, mt = (jnp.asarray(mask4), _t(mask4)) if masked else (None, None)
        fwd = {True: jax_layer_fwd(p_j, jnp.asarray(h), J(xp), J(vp), 0.3, e_rep=e_rep,
                                   e_tile=e_tile, mm=mm, mask=mj,
                                   mm_edge=_make_mm_prec(jnp.bfloat16, None)),
               False: resid_ef.layer_fwd_resid(p_t, _t(h), T(xp), T(vp), 0.3, mask=mt)}
        # the pullback reads the bf16 tier's streams: its residuals, rounded
        res = {n: v.astype(jnp.bfloat16).astype(jnp.float32) if n in _RESID_LOWP else v
               for n, v in fwd[True][3].items()}
        res_t = {n: _t(v).reshape(B, N * N if n in resid_ef.EDGE_RESIDS else N, -1)
                 for n, v in res.items()}
        bwd = {True: jax_layer_bwd(
            p_j, res, jnp.asarray(h), J(xp), J(vp), 0.3, jnp.asarray(seeds[0]), J(seeds[1]),
            J(seeds[2]), e_rep=e_rep, e_tile=e_tile, mm=mm, mask=mj, want_param_grads=True,
            mm_edge=_make_mm_prec(jnp.bfloat16, None),
            mm_edge_t=_make_mmt_prec(jnp.bfloat16, None)),
            False: resid_ef.layer_bwd_resid(p_t, res_t, _t(h), T(xp), T(vp), 0.3,
                                            _t(seeds[0]), T(seeds[1]), T(seeds[2]), mask=mt,
                                            want_param_grads=True)}
        out[masked] = dict(fwd=fwd, res=res_t, bwd=bwd)
    return dict(h=h, xp=xp, vp=vp, mask4=mask4, seeds=seeds, p_t=p_t, jax=out)


def _flat_state(o):
    return [o[0], *o[1], *o[2]]


@pytest.mark.parametrize("masked", [False, True])
def test_layer_fwd_resid_bf16_matches_jax(layer_setup, masked):
    s = layer_setup
    m = _t(s["mask4"]) if masked else None
    got = resid_ef.layer_fwd_resid(s["p_t"], _t(s["h"]), [_t(a) for a in s["xp"]],
                                   [_t(a) for a in s["vp"]], 0.3, mask=m, bf16=True)
    want = s["jax"][masked]["fwd"]
    moved = 0
    for i, (g, wb, wf) in enumerate(zip(_flat_state(got), _flat_state(want[True]),
                                        _flat_state(want[False]))):
        moved += _hold(g.numpy(), wb, wf, FWD_CAP, f"state {i}") >= UNMOVED
    for n in resid_ef.RESIDS:
        moved += _hold(got[3][n].numpy(), want[True][3][n], want[False][3][n].numpy(), FWD_CAP,
                       n) >= UNMOVED
    assert moved >= 17  # h, x, v and the residuals after the first edge product


@pytest.mark.parametrize("want_grads", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_layer_bwd_resid_bf16_matches_jax(layer_setup, masked, want_grads):
    s = layer_setup
    j = s["jax"][masked]
    dh, dxp, dvp = s["seeds"]
    got = resid_ef.layer_bwd_resid(
        s["p_t"], j["res"], _t(s["h"]), [_t(a) for a in s["xp"]], [_t(a) for a in s["vp"]], 0.3,
        _t(dh), [_t(a) for a in dxp], [_t(a) for a in dvp],
        mask=_t(s["mask4"]) if masked else None, want_param_grads=want_grads, bf16=True)
    wb, wf = j["bwd"][True], j["bwd"][False]
    for i, (g, b, f) in enumerate(zip(_flat_state(got), _flat_state(wb), _flat_state(wf))):
        _hold(g.numpy(), b, f.numpy(), BWD_CAP, f"cotangent {i}")
    assert len(got) == (4 if want_grads else 3)
    if want_grads:
        assert set(got[3]) == set(resid_ef.LEAF_NAMES)
        moved = [n for n in resid_ef.LEAF_NAMES
                 if _hold(got[3][n].numpy(), wb[3][n], wf[3][n].numpy(), DW_CAP, n) >= UNMOVED]
        assert set(resid_ef.EDGE_MM_LEAVES) <= set(moved)


@pytest.fixture(scope="module")
def ef_setup():
    """resid_energy_forces at B = 2, N = 5, hidden 16, depth 2, 2 heads: JAX's in
    interpret mode in both tiers."""
    heads = 2
    rng = np.random.RandomState(0)
    h = rng.randn(2, 5, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(2, 5, 3)).astype(np.float32)
    kp, tp = _models(HID, 2, heads)
    want = {True: [np.asarray(a) for a in jax_resid_energy_forces(
        kp, jnp.asarray(h), jnp.asarray(x), n_heads=heads, batch_tile=2, interpret=True,
        **JAX_BF16)],
        False: [a.numpy() for a in resid_ef.resid_energy_forces(tp, _t(h), _t(x),
                                                                 n_heads=heads)]}
    return dict(h=h, x=x, tp=tp, heads=heads, want=want)


def test_resid_energy_forces_bf16_matches_jax_interpret(ef_setup):
    s = ef_setup
    e, f = resid_ef.resid_energy_forces(s["tp"], _t(s["h"]), _t(s["x"]), n_heads=s["heads"],
                                        resid_lowp=resid_ef.RESID_LOWP, **BF16)
    for label, g, i in (("E", e, 0), ("F", f, 1)):
        assert _hold(g.numpy(), s["want"][True][i], s["want"][False][i], EF_CAP, label) >= UNMOVED


def test_dispatch_passes_the_bf16_tier_through(ef_setup, monkeypatch):
    """JAX's dispatch keywords reach resid_energy_forces unchanged (the default
    stays f32), and computes the tier."""
    s = ef_setup
    kw = dict(BF16, resid_lowp=dispatch.LOWP_X, pad_atoms=True, batch_tile=2)
    assert set(dispatch.LOWP_X) == set(_LOWP_X) == set(resid_ef.RESID_LOWP)
    seen = []
    real = dispatch.resid_energy_forces
    monkeypatch.setattr(dispatch, "resid_energy_forces",
                        lambda *a, **k: seen.append(k) or real(*a, **k))
    e, f = dispatch.dispatch_energy_forces(s["tp"], _t(s["h"]), _t(s["x"]), n_heads=s["heads"],
                                           **kw)
    e32, _ = dispatch.dispatch_energy_forces(s["tp"], _t(s["h"]), _t(s["x"]), n_heads=s["heads"])
    assert seen[0] == dict(n_heads=s["heads"], update=True, **kw)
    assert "edge_matmul_dtype" not in seen[1] and "resid_dtype" not in seen[1]
    _hold(f.numpy(), s["want"][True][1], s["want"][False][1], EF_CAP, "F")
    _hold(e32.numpy(), s["want"][False][0], s["want"][False][0], EF_CAP, "E f32")


def test_make_hidden_fn_bf16_matches_jax_grad():
    """The QM9 entry in the tier (masked, 2 molecules of 5 and 3 atoms): h_fin and
    the gradient of every leaf of a weighted readout loss against ``jax.grad``
    through JAX's make_hidden_fn in interpret mode."""
    rng = np.random.RandomState(3)
    b, n = 2, 5
    h = rng.randn(b, n, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(b, n, 3)).astype(np.float32)
    nm = (np.arange(n)[None, :] < np.array([5, 3])[:, None]).astype(np.float32)
    mask = nm[:, :, None] * nm[:, None, :]
    w = rng.randn(b).astype(np.float32)
    kp, tp = _models(HID, 2, seed=1)

    hidden_j = jax_make_hidden_fn(batch_tile=2, pad_atoms=True, interpret=True, **JAX_BF16)

    def loss_j(p):
        hf = hidden_j(p, jnp.asarray(h), jnp.asarray(x), jnp.asarray(mask))
        out = jax.nn.silu(hf @ p.w_out0 + p.b_out0) @ p.w_out1 + p.b_out1
        return ((out * jnp.asarray(nm)[..., None]).sum(axis=(-2, -1)) * jnp.asarray(w)).sum(), hf

    (_, hf_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(kp)

    def port_run(tier):
        flat = [t.detach().clone().requires_grad_(True) for t in resid_ef.flat_params(tp)]
        hidden = resid_ef.make_hidden_fn(
            n_heads=K, **(dict(BF16, resid_lowp=resid_ef.RESID_LOWP) if tier else {}))
        hf = hidden(resid_ef._unflat_params(flat, 2), _t(h), _t(x), _t(mask))
        out = readout(resid_ef._unflat_params(flat, 2), hf) * _t(nm)[..., None]
        loss = (out.sum(dim=(-2, -1)) * _t(w)).sum()
        return hf, torch.autograd.grad(loss, flat, allow_unused=True), hidden, flat

    want = {True: (np.asarray(hf_j), [np.asarray(a) for a in jax.tree.leaves(g_j)])}
    hf32, g32, _, _ = port_run(False)
    want[False] = (hf32.detach().numpy(), [None if g is None else g.numpy() for g in g32])
    hf, got, hidden, flat = port_run(True)
    _hold(hf.detach().numpy(), want[True][0], want[False][0], EF_CAP, "h_fin")
    assert len(got) == len(want[True][1])
    moved = 0
    for i, (g, wb, wf) in enumerate(zip(got, want[True][1], want[False][1])):
        g = np.zeros_like(wb) if g is None else g.numpy()
        wf = np.zeros_like(wb) if wf is None else wf
        moved += _hold(g, wb, wf, GRAD_CAP, f"leaf {i}") >= UNMOVED
    assert moved >= 40  # every layer leaf and the embedding
    with torch.no_grad():  # evaluation: the forward without streams, same tier
        hf_eval = hidden(resid_ef._unflat_params(flat, 2), _t(h), _t(x), _t(mask))
    torch.testing.assert_close(hf_eval, hf.detach(), rtol=0, atol=0)


def _port_model(hid, depth):
    return _models(hid, depth)[1]


def test_bf16_streams_are_bf16_tensors():
    """In the tier every residual stream but r and t is a bf16 tensor (half the
    bytes), on the plain stack and therefore through its pullback."""
    leaves = wide_stack(_port_model(8, 2), K)
    g = torch.Generator().manual_seed(0)
    h0, xs = torch.randn(2, 4, 8, generator=g), torch.randn(3, 2, 4, generator=g)
    for tier in (False, True):
        fwd = resid_ef.resid_fwd(leaves, h0, xs, torch.zeros_like(xs), [1.0, 0.0], bf16=tier)
        assert resid_ef.stream_tier(fwd) is tier
        for n, t in fwd.resid.items():
            assert t.dtype == (torch.bfloat16 if tier and n not in ("r", "t") else torch.float32)
        dh, dx, dv = resid_ef.resid_bwd(leaves, fwd, [1.0, 0.0], h0, xs, xs)
        assert dh.dtype == dx.dtype == torch.float32 and bool(torch.isfinite(dx).all())
    assert resid_ef.RESID_LOWP == frozenset(_RESID_LOWP)


def _tiny_model():
    return _port_model(8, 1)


UNPORTED = [
    dict(BF16, matmul_dtype=torch.bfloat16),
    dict(BF16, pool_dtype=torch.bfloat16),
    dict(BF16, pool_matmul_dtype=torch.bfloat16),
    dict(BF16, resid_lowp={"h_e", "coeff"}),
    dict(edge_matmul_dtype=torch.bfloat16),
    dict(resid_dtype=torch.bfloat16),
    dict(edge_matmul_dtype=torch.bfloat16, resid_dtype=torch.float32),
    dict(edge_matmul_dtype=torch.float16, resid_dtype=torch.float16),
]


@pytest.mark.parametrize("kw", UNPORTED)
def test_unported_bf16_combinations_raise(kw):
    """Every bf16 combination but the tier raises, naming what it was given; the
    entries of the other modules keep raising on the tier itself."""
    tp = _tiny_model()
    h, x = torch.zeros(1, 3, F_IN), torch.randn(1, 3, 3)
    with pytest.raises(NotImplementedError, match="resid_energy_forces: .*(dtype|lowp)"):
        resid_ef.resid_energy_forces(tp, h, x, **kw)
    if "pool_dtype" not in kw and "pool_matmul_dtype" not in kw:
        with pytest.raises(NotImplementedError, match="make_hidden_fn: .*(dtype|lowp)"):
            resid_ef.make_hidden_fn(**kw)


def test_other_modules_keep_raising_on_the_tier():
    from sake_tpu_torch.kernels import depthgrid_ef, fori_ef, one_ef, train_ef

    tp = _tiny_model()
    h, x = torch.zeros(1, 3, F_IN), torch.randn(1, 3, 3)
    edge = dict(edge_matmul_dtype=torch.bfloat16)  # these take no resid_dtype
    for call in (lambda: one_ef.one_energy_forces(tp, h, x, **BF16),
                 lambda: fori_ef.fori_energy_forces(tp, h, x, **edge),
                 lambda: depthgrid_ef.depthgrid_energy_forces(tp, h, x, **edge),
                 lambda: train_ef.make_trainable_energy_forces(**edge)):
        with pytest.raises(NotImplementedError):
            call()


def _stub(calls):
    """A library whose launch entries record (name, route argument) and succeed;
    the smem and route entries answer as at aspirin's widths."""
    from types import SimpleNamespace

    def entry(name, routed):
        return lambda *a: calls.append((name, a[0] if routed else None)) or 0

    names = ("sake_resid_fwd16", "sake_resid_bwd16", "sake_resid_infer_cluster16",
             "sake_resid_bwd_rows_cluster16", "sake_param_grads16", "sake_resid_bwd_rows16")
    return SimpleNamespace(
        **{n: entry(n, i < 2) for i, n in enumerate(names)},
        **{f"sake_resid_{k}_smem_bytes": (lambda *d: 0)
           for k in ("fwd", "fwd_tc", "fwd_cluster", "bwd", "bwd_tc", "bwd_cluster")},
        sake_resid_fwd_tc_route=lambda *d: int(d[1] <= 21),
        sake_resid_bwd_tc_route=lambda *d: int(d[1] <= 22),
        sake_error_string=lambda err: b"refused")


@pytest.mark.parametrize("N", [21, 22, 29])
def test_tier_wrappers_launch_the_tier_entries(monkeypatch, N):
    """On CUDA tensors (meta tensors here) the tier's wrappers launch the tier's
    entries on every route the f32 tier has: K1 on its tensor-core route up to
    21 atoms, K2 up to 22, the CUDA cores beyond; #4, #5, #6 on their cluster
    kernels; the one-block rows kernel; the contraction; with bf16 streams and
    the edge weights rounded."""
    calls = []
    monkeypatch.setattr(build, "load", lambda: _stub(calls))
    monkeypatch.setattr(resid_ef, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(resid_ef, "_stream", lambda dev: None)
    leaves = {n: torch.empty(2, *s, device="meta")
              for n, s in resid_ef._leaf_shapes(64, 64, 50, 4, 256).items()}
    h0, xs = torch.empty(3, N, 64, device="meta"), torch.empty(3, 3, N, device="meta")
    upd = [1.0, 1.0]
    fwd = resid_ef.resid_fwd(leaves, h0, xs, xs, upd, bf16=True)
    assert resid_ef.stream_tier(fwd) and fwd.resid["r"].dtype == torch.float32
    resid_ef.resid_bwd(leaves, fwd, upd, h0, xs, xs, leaves_t=transposed(leaves))
    m4 = torch.empty(3, N, N, 1, device="meta")
    fc = resid_ef.resid_fwd(leaves, h0, xs, xs, upd, m4, cluster=True, bf16=True)
    _, _, _, rows = resid_ef.resid_bwd_rows(leaves, fc, upd, h0, xs, xs, m4, cluster=True)
    resid_ef.resid_bwd_rows(leaves, fc, upd, h0, xs, xs, m4)
    resid_ef.param_grads(leaves, fc, rows)
    resid_ef.resid_infer(leaves, h0, xs, xs, upd, m4, bf16=True)
    assert calls == [("sake_resid_fwd16", 1 if N <= 21 else 0),
                     ("sake_resid_bwd16", 1 if N <= 22 else 0),
                     ("sake_resid_fwd16", 2), ("sake_resid_bwd_rows_cluster16", None),
                     ("sake_resid_bwd_rows16", None), ("sake_param_grads16", None),
                     ("sake_resid_infer_cluster16", None)]
