"""The bf16 tier (JAX ``edge_matmul_dtype`` and ``resid_dtype`` bf16) in
``make_ef_train2``'s shared, resid and retrace modes and in fused mode with the
shared primal (``fused_primal=False``): the port's plain versions against the
JAX package's on the CPU, the streams' dtypes, the entries the kernel wrappers
launch, and the combinations that still raise.

Tolerances. As in ``tests/test_torch_train2_bf16.py``: every comparison
measures, on its own inputs, how far the bf16 tier lies from the f32 tier
(``d``, max |diff| / max |ref| per tensor) and holds the port's bf16 tier to
the JAX bf16 tier within ``min(cap, QUARTER * d)`` per tensor, ``cap`` stated
below; so a port that computes f32, or rounds where JAX does not, fails.
Tensors the tier does not move (``d`` under ``UNMOVED``) are held at
``F32_CAP``. The f32 reference is JAX's f32 jvp for #18, JAX's f32 augmented
layer for #16 and #17, and the port's f32 mode for ``make_ef_train2`` (which
``tests/test_torch_train2.py`` and ``tests/test_torch_train2_aug.py`` hold to
JAX's). Sizes: #18, #16 and #17 at B 4, N 7, F_in 5, hidden 16, depth 2, 4
heads, #17 also in two batch tiles of ``ABT`` molecules; ``make_ef_train2`` at
the tiny case of the fused tier's test (hidden 8, depth 1, B 2, N 5), each JAX
mode run by the Pallas interpreter once, in a module fixture.

Why ``make_ef_train2`` stays at the tiny case: at B 4, N 7, hidden 16 and depth
2 a rounding that flips in one layer's cotangents moves the next layer's sums
by a bf16 step, so the tier's result is chaotic at the scale of its own
distance from f32. There, moving x by 1e-6 of itself moves the port's retrace
gradients by up to 0.54 of that distance in the max norm and 0.25 in the rms
norm (shared mode: 0.19 and 0.13). Against JAX the largest share is 1.13 and
0.32, so no per-tensor bound of a quarter of the distance can hold. The batch
tile is checked at one layer (``test_retrace_bwd_plain_bf16_rounds_per_batch_tile``),
where the noise is small beside what a wrong tile model moves.

Retrace mode rounds where JAX's autodiff does (jax.vjp of jax.jvp of the
layer): each cotangent that flows into a rounded operand after its sum, and an
edge weight's gradient as its two products' rounded terms added in f32 per
batch tile (XLA keeps the add of two bf16 terms at f32 in a jitted trace, so
the JAX reference of #17 here is jitted, as the Pallas kernel is).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels.depthgrid_ef import _LEAF_NAMES, _make_mm_prec
from sake_tpu.kernels.depthgrid_ef import wide_stack as jax_wide_stack
from sake_tpu.kernels.resid_ef import layer_fwd_resid as jax_layer_fwd
from sake_tpu.kernels.split_ef import head_expansion_matrices
from sake_tpu.kernels.train2_ef import _aug_layer
from sake_tpu.kernels.train2_ef import make_ef_train2 as jax_make_ef_train2
from sake_tpu_torch.kernels import build, resid_ef, train2_ef
from sake_tpu_torch.kernels.adapter import params_from_jax
from sake_tpu_torch.kernels.depthgrid_ef import layer_forward_wide
from sake_tpu_torch.kernels.functional import flat_params
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, layer_leaves, wide_stack

from test_torch_train2_bf16 import (
    BF16,
    DW_CAP,
    F_IN,
    JAX_BF16,
    K,
    PULL_CAP,
    _hold,
    _models,
    _t,
)

QUARTER, UNMOVED = 0.25, 1e-5  # as in tests/test_torch_train2_bf16.py
JVP_CAP = 1e-5  # #18's tangent state and its residuals before they are stored
GRAD_CAP = 1e-4  # make_ef_train2's loss gradients

B, N, HID, DEPTH = 4, 7, 16, 2
UPD = [1.0, 0.4]
MODES = [dict(aug_mode="shared"), dict(aug_mode="resid"), dict(aug_mode="retrace"),
         dict(aug_mode="fused", fused_primal=False)]
ABT = 2  # the batch tile of #17's two-tile check (JAX aug_batch_tile)


def _planes(a):
    return [a[..., k : k + 1] for k in range(3)]


@pytest.fixture(scope="module")
def aug_setup():
    """#18's inputs and JAX's ``jax.jvp`` of ``layer_fwd_resid`` over depth in
    both tiers: per layer the primal and tangent residuals (as the jvp gives
    them, before ``_pipe``'s ``fwd_kernel`` stores them), the tangent
    boundaries and the final tangent state."""
    rng = np.random.RandomState(5)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    kp, tp = _models(HID, DEPTH, seed=2)
    h, x, tx = f(B, N, HID), 1.5 * f(B, N, 3), f(B, N, 3)
    e_rep, e_tile = head_expansion_matrices(HID, K)
    stacked = jax_wide_stack(kp, K)
    layers = [{n: a[l] for n, a in zip(_LEAF_NAMES, stacked)} for l in range(DEPTH)]
    mm = lambda a, w: jnp.dot(a, w, preferred_element_type=jnp.float32)

    def run(tier):
        kw = dict(e_rep=e_rep, e_tile=e_tile, mm=mm)
        if tier:
            kw["mm_edge"] = _make_mm_prec(jnp.bfloat16, None)
        zeros = jnp.zeros((B, N, 1), jnp.float32)
        st = (jnp.asarray(h), _planes(jnp.asarray(x)), [zeros] * 3)
        tst = (jnp.zeros((B, N, HID), jnp.float32), _planes(jnp.asarray(tx)), [zeros] * 3)
        out = []
        for u, p in zip(UPD, layers):
            bnd = [tst[0], jnp.concatenate(tst[1], -1), jnp.concatenate(tst[2], -1)]
            (h2, xp, vp, res), (th, txp, tvp, tres) = jax.jvp(
                lambda h_, x_, v_: jax_layer_fwd(p, h_, x_, v_, u, **kw), st, tst)
            out.append(dict(bnd=bnd, res=res, tres=tres))
            st, tst = (h2, xp, vp), (th, txp, tvp)
        return out, [tst[0], jnp.concatenate(tst[1], -1)]

    return dict(leaves=wide_stack(tp, K), h=h, x=x, tx=tx,
                jax={tier: jax.tree.map(np.asarray, run(tier)) for tier in (True, False)})


def _as(a, like):
    """A JAX tensor in the port's layout of ``like``: (B, N, 3) planes as
    (3, B, N), (B, N, N, ch) edges as (B, N*N, ch)."""
    a = np.asarray(a)
    if a.shape != tuple(like.shape):
        a = a.transpose(2, 0, 1) if a.ndim == 3 and a.shape[-1] == 3 else a.reshape(like.shape)
    return a


def test_aug_fwd_plain_bf16_matches_jax_jvp(aug_setup):
    """The plain #18 in the tier against ``jax.jvp`` of JAX's ``layer_fwd_resid``
    with ``mm_edge`` in bf16: the jvp of the port's ``layer_fwd_resid(bf16=True)``
    over depth gives every primal and tangent residual of every layer, the
    tangent boundaries and the final tangent state of JAX's; the tangent is
    computed from the primal's f32 values, not from the stored streams (as #9
    does in shared mode). ``aug_fwd_plain`` returns those values with the
    residuals stored as the tier stores them, bf16 tensors but r and t."""
    s = aug_setup
    h0 = _t(s["h"])
    xs, tx0 = (_t(s[k].transpose(2, 0, 1)).contiguous() for k in ("x", "tx"))
    fwd, tfwd = train2_ef._jvp_stack(
        lambda p, h, xp, vp, u: resid_ef.layer_fwd_resid(p, h, xp, vp, u, bf16=True),
        s["leaves"], h0, xs, UPD, tx0)
    (jb, fin_b), (jf, fin_f) = s["jax"][True], s["jax"][False]
    moved = set()
    for l in range(DEPTH):
        for i, (g, b, f) in enumerate(zip((tfwd.bh[l], tfwd.bx[l], tfwd.bv[l]),
                                          jb[l]["bnd"], jf[l]["bnd"])):
            _hold(g.numpy(), _as(b, g), _as(f, g), JVP_CAP, f"layer {l} tangent boundary {i}")
        for got, key in ((fwd, "res"), (tfwd, "tres")):
            for n in resid_ef.RESIDS:
                g = got.resid[n][l]
                if _hold(g.numpy(), _as(jb[l][key][n], g), _as(jf[l][key][n], g), JVP_CAP,
                         f"layer {l} {key} {n}") >= UNMOVED:
                    moved.add((key, n))
    for g, b, f in zip((tfwd.h_fin, tfwd.x_fin), fin_b, fin_f):
        _hold(g.numpy(), _as(b, g), _as(f, g), JVP_CAP, "final tangent state")
    assert {(k, n) for k in ("res", "tres") for n in ("e0", "h_e", "coeff")} <= moved
    stored = train2_ef.aug_fwd_plain(s["leaves"], h0, xs, UPD, tx0, bf16=True)
    for got, want in zip(stored, (fwd, tfwd)):
        assert torch.equal(got.bh, want.bh) and torch.equal(got.h_fin, want.h_fin)
        for n in resid_ef.RESIDS:
            assert got.resid[n].dtype == resid_ef.stream_dtype(n, True)
            assert torch.equal(got.resid[n], want.resid[n].to(got.resid[n].dtype))


@pytest.fixture(scope="module")
def train_setup():
    """The tiny case of ``tests/test_torch_train2_bf16.py``: the loss and its
    gradients through JAX's ``make_ef_train2`` in the tier in each mode of
    ``MODES``, its Pallas sites run by the interpreter, and through the port's
    f32 modes."""
    rng = np.random.RandomState(8)
    h_raw = rng.randn(2, 5, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(2, 5, 3)).astype(np.float32)
    e_t, f_t = rng.randn(2).astype(np.float32), rng.randn(2, 5, 3).astype(np.float32)
    kp, tp = _models(8, 1, seed=4)
    s = dict(h=h_raw, x=x, e_t=e_t, f_t=f_t, tp=tp, want={}, f32={})
    for i, mode in enumerate(MODES):
        ef_j = jax_make_ef_train2(n_heads=K, batch_tile=2, aug_batch_tile=2, chunk=None,
                                  shared_chunk=None, aug_chunk=None, interpret=True,
                                  **mode, **JAX_BF16)

        def loss_j(p, h_, x_):
            e, f = ef_j(p, h_, x_)
            return ((e - e_t) ** 2).sum() + 0.5 * ((f - f_t) ** 2).sum()

        l_ref, g_ref = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
            kp, jnp.asarray(h_raw), jnp.asarray(x))
        s["want"][i] = [np.asarray(l_ref), np.asarray(g_ref[1]), np.asarray(g_ref[2]),
                        *(w.numpy() for w in flat_params(params_from_jax(
                            jax.tree.map(np.asarray, g_ref[0]))))]
        s["f32"][i] = _port_loss_grads(s, mode)
    return s


def _port_loss_grads(s, kw):
    """The loss and its gradients w.r.t. h, x and every flat leaf through the
    port's ``make_ef_train2`` (the plain versions on CPU tensors)."""
    ef = train2_ef.make_ef_train2(n_heads=K, **kw)
    flat = [t.detach().clone().requires_grad_(True) for t in flat_params(s["tp"])]
    h, x = _t(s["h"]).requires_grad_(True), _t(s["x"]).requires_grad_(True)
    e, f = ef(resid_ef._unflat_params(flat, 1), h, x)
    loss = ((e - _t(s["e_t"])) ** 2).sum() + 0.5 * ((f - _t(s["f_t"])) ** 2).sum()
    return [loss.detach().numpy(), *(g.numpy() for g in torch.autograd.grad(loss, [h, x, *flat]))]


@pytest.mark.parametrize("mode", range(len(MODES)), ids=[
    "-".join(f"{k}={v}" for k, v in m.items()) for m in MODES])
def test_make_ef_train2_bf16_matches_jax_interpret(train_setup, mode):
    """The loss and every gradient (h, x, each leaf) of the tier's mode on CPU
    tensors against JAX's same mode in the tier in interpret mode."""
    s = train_setup
    got = _port_loss_grads(s, dict(MODES[mode], **BF16))
    want, f32 = s["want"][mode], s["f32"][mode]
    assert len(got) == len(want) == len(f32)
    moved = 0
    for i, (g, b, f) in enumerate(zip(got, want, f32)):
        moved += _hold(g, b, f, GRAD_CAP, "loss" if i == 0 else f"gradient {i - 1}") >= UNMOVED
    assert moved > len(got) // 2  # the tier moves most of them


@pytest.fixture(scope="module")
def retrace_setup():
    """One layer's primal and tangent inputs and output cotangents, and JAX's
    jitted ``jax.vjp`` of its augmented layer (``train2_ef._aug_layer``, the
    jvp of ``layer_forward_wide``) in both tiers: the outputs and the
    cotangents of the inputs and of every leaf, over the whole batch
    (``jax``) and per batch tile of ``ABT`` molecules as JAX's retrace
    ``bwd_kernel`` runs it (``tiles``: every leaf's cotangent summed over the
    tiles in f32, in order, as the kernel's f32 output blocks add them)."""
    rng = np.random.RandomState(6)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    planes = lambda: [f(B, N, 1) for _ in range(3)]
    kp, tp = _models(HID, DEPTH, seed=3)
    state = (f(B, N, HID), [1.5 * a for a in planes()], planes(), f(B, N, HID), planes(),
             planes())
    zeros = [np.zeros((B, N, 1), np.float32)] * 3  # the entry's seeds: h and th only
    cot = (f(B, N, HID), zeros, zeros, f(B, N, HID), zeros, zeros)
    p_j = {n: a[1] for n, a in zip(_LEAF_NAMES, jax_wide_stack(kp, K))}
    e_rep, e_tile = head_expansion_matrices(HID, K)
    mm = lambda a, w: jnp.dot(a, w, preferred_element_type=jnp.float32)
    J = lambda t: [jnp.asarray(a) for a in t] if isinstance(t, list) else jnp.asarray(t)
    cut = lambda st, t: [[b[t:t + ABT] for b in a] if isinstance(a, list) else a[t:t + ABT]
                         for a in st]

    def run(tier, tiled=False):
        mm_edge = _make_mm_prec(jnp.bfloat16, None) if tier else None

        def aug(p, *st):
            out = _aug_layer(p, 0.7, e_rep, e_tile, mm, mm_edge, None)(*st)
            return tuple(list(o) if isinstance(o, (list, tuple)) else o for o in out)

        @jax.jit
        def go(p, st, c):
            out, vjp = jax.vjp(aug, p, *st)
            return out, vjp(c)

        if not tiled:
            return jax.tree.map(np.asarray, go(p_j, tuple(J(a) for a in state),
                                               tuple(J(a) for a in cot)))
        tiles = [jax.tree.map(np.asarray, go(p_j, tuple(J(a) for a in cut(state, t)),
                                             tuple(J(a) for a in cut(cot, t))))
                 for t in range(0, B, ABT)]
        (_, (dp, *dst)), rest = tiles[0], tiles[1:]
        for _, (dp_t, *_) in rest:
            dp = {n: dp[n] + dp_t[n] for n in dp}
        return dp, jax.tree.map(lambda *a: np.concatenate(a, 0), dst,
                                *(d for _, (_, *d) in rest))

    return dict(state=state, cot=cot, p_t=layer_leaves(wide_stack(tp, K), 1),
                jax={tier: run(tier) for tier in (True, False)},
                tiles={tier: run(tier, tiled=True) for tier in (True, False)})


def test_retrace_fwd_plain_bf16_matches_jax_aug_layer(retrace_setup):
    """The plain #16 in the tier (the jvp of ``layer_forward_wide(bf16=True)``)
    against JAX's augmented layer with ``mm_edge`` in bf16: the layer's primal
    and tangent outputs, computed with every intermediate in f32."""
    s = retrace_setup
    h, xp, vp, th, txp, tvp = (_t(a) if not isinstance(a, list) else [_t(b) for b in a]
                               for a in s["state"])
    out, t_out = torch.func.jvp(
        lambda a, b, c: layer_forward_wide(s["p_t"], a, b, c, 0.7, bf16=True),
        (h, xp, vp), (th, txp, tvp))
    flat = lambda o: [o[0], *o[1], *o[2]]
    got = flat(out) + flat(t_out)
    jb, jf = (s["jax"][tier][0] for tier in (True, False))
    want_b = [a for o in jb for a in (o if isinstance(o, list) else [o])]
    want_f = [a for o in jf for a in (o if isinstance(o, list) else [o])]
    moved = [_hold(g.numpy(), b, f, JVP_CAP, f"output {i}")
             for i, (g, b, f) in enumerate(zip(got, want_b, want_f))]
    assert max(moved) >= UNMOVED


def test_retrace_bwd_plain_bf16_matches_jax_vjp(retrace_setup):
    """The plain #17 in the tier (one layer, the whole batch one tile) against
    JAX's jitted ``jax.vjp`` of its augmented layer with ``mm_edge`` in bf16:
    the cotangents of h and th, and every leaf's gradient, the four edge
    weights' among them."""
    s = retrace_setup
    h, xp, vp, th, txp, tvp = (_t(a) if not isinstance(a, list) else [_t(b) for b in a]
                               for a in s["state"])
    stack = lambda a, planes=False: (torch.cat(a, -1).permute(2, 0, 1) if planes else a)[None]
    fwd = resid_ef.FwdOut(stack(h), stack(xp, True), stack(vp, True), None, None, None, None)
    tfwd = resid_ef.FwdOut(stack(th), stack(txp, True), stack(tvp, True), None, None, None, None)
    leaves = {n: a[None] for n, a in s["p_t"].items()}
    dh, dx, dth, grads = train2_ef.retrace_bwd_plain(
        leaves, fwd, tfwd, [0.7], _t(s["cot"][0]), _t(s["cot"][3]), bf16=True)
    (_, (gb, *cb)), (_, (gf, *cf)) = s["jax"][True], s["jax"][False]
    _hold(dh.numpy(), cb[0], cf[0], PULL_CAP, "dh")
    _hold(dth.numpy(), cb[3], cf[3], PULL_CAP, "dth")
    _hold(dx.numpy(), np.concatenate(cb[1], -1).transpose(2, 0, 1),
          np.concatenate(cf[1], -1).transpose(2, 0, 1), PULL_CAP, "dx")
    moved = [n for n in LEAF_NAMES
             if _hold(grads[n][0].numpy(), gb[n], gf[n], DW_CAP, n) >= UNMOVED]
    assert set(resid_ef.EDGE_MM_LEAVES) <= set(moved)



def test_retrace_bwd_plain_bf16_rounds_per_batch_tile(retrace_setup):
    """The plain #17 in the tier in two batch tiles of ``ABT`` molecules against
    JAX's jitted ``jax.vjp`` of its augmented layer run per tile, the leaves'
    cotangents summed over the tiles in f32 as the retrace ``bwd_kernel`` adds
    them. dh, dth, dx and the 25 other leaves are held as in the whole-batch test.
    The four edge weights, whose two terms each tile rounds to bf16, are held
    within ``QUARTER`` of the tier's distance in the rms norm: XLA and torch sum
    a term's products in other orders, so a term at a bf16 midpoint rounds the
    other way, one bf16 step of a few elements (8 of w_xmix's 4096 here; 0.15
    of the distance in the max norm, 0.02 in the rms norm). Rounding per whole
    batch or per molecule lies 0.4 to 0.8 of the distance away in that norm and
    is refused here."""
    s = retrace_setup
    h, xp, vp, th, txp, tvp = (_t(a) if not isinstance(a, list) else [_t(b) for b in a]
                               for a in s["state"])
    stack = lambda a, planes=False: (torch.cat(a, -1).permute(2, 0, 1) if planes else a)[None]
    fwd = resid_ef.FwdOut(stack(h), stack(xp, True), stack(vp, True), None, None, None, None)
    tfwd = resid_ef.FwdOut(stack(th), stack(txp, True), stack(tvp, True), None, None, None, None)
    leaves = {n: a[None] for n, a in s["p_t"].items()}
    run = lambda tile: train2_ef.retrace_bwd_plain(
        leaves, fwd, tfwd, [0.7], _t(s["cot"][0]), _t(s["cot"][3]), bf16=True, tile=tile)
    dh, dx, dth, grads = run(ABT)
    (gb, cb), (gf, cf) = s["tiles"][True], s["tiles"][False]
    _hold(dh.numpy(), cb[0], cf[0], PULL_CAP, "dh")
    _hold(dth.numpy(), cb[3], cf[3], PULL_CAP, "dth")
    _hold(dx.numpy(), np.concatenate(cb[1], -1).transpose(2, 0, 1),
          np.concatenate(cf[1], -1).transpose(2, 0, 1), PULL_CAP, "dx")
    edge = resid_ef.EDGE_MM_LEAVES
    for n in LEAF_NAMES:
        if n not in edge:
            _hold(grads[n][0].numpy(), gb[n], gf[n], DW_CAP, n)
    rms = lambda a, b: float(np.sqrt(((a - b) ** 2).sum() / (b ** 2).sum()))
    for n in edge:
        assert rms(grads[n][0].numpy(), gb[n]) <= QUARTER * rms(gf[n], gb[n]), n
    for tile in (1, B):  # the other tile models
        other = run(tile)[3]
        for n in edge:
            assert rms(other[n][0].numpy(), gb[n]) > QUARTER * rms(gf[n], gb[n]), (tile, n)


def test_make_ef_train2_passes_its_batch_tile_to_retrace_bwd(monkeypatch):
    """Retrace mode's backward rounds the edge weights per ``aug_batch_tile``
    molecules, else per ``batch_tile`` (JAX's ``ABT``), in both tiers."""
    tiles = []
    real = train2_ef.retrace_bwd
    monkeypatch.setattr(train2_ef, "retrace_bwd",
                        lambda *a, tile=None, **kw: tiles.append(tile) or real(*a, tile=tile, **kw))
    rng = np.random.RandomState(9)
    _, tp = _models(8, 1, seed=4)
    for kw, want in ((dict(aug_batch_tile=ABT), ABT), (dict(batch_tile=3), 3)):
        for tier in (BF16, {}):
            ef = train2_ef.make_ef_train2(n_heads=K, aug_mode="retrace", **kw, **tier)
            h = _t(rng.randn(4, 5, F_IN).astype(np.float32))
            x = _t(rng.randn(4, 5, 3).astype(np.float32)).requires_grad_(True)
            e, _ = ef(tp, h, x)
            e.sum().backward()
            assert tiles.pop() == want

def test_unported_tier_combinations_raise():
    """The other combinations of the tier's keywords raise in every mode,
    naming what they were given."""
    for mode in ("shared", "resid", "retrace", "fused"):
        with pytest.raises(NotImplementedError, match="matmul_dtype"):
            train2_ef.make_ef_train2(aug_mode=mode, matmul_dtype=torch.bfloat16, **BF16)
        with pytest.raises(NotImplementedError, match="go together"):
            train2_ef.make_ef_train2(aug_mode=mode, edge_matmul_dtype=torch.bfloat16)


def _stub(calls):
    """A library whose launch entries record their names and succeed; the smem
    and route entries answer as at aspirin's widths."""
    names = ("sake_resid_fwd", "sake_resid_fwd16", "sake_resid_bwd", "sake_resid_bwd16",
             "sake_resid_jvp", "sake_resid_jvp16", "sake_resid_tbwd", "sake_resid_tbwd16",
             "sake_resid_bwd_rows", "sake_resid_bwd_rows16", "sake_aug_fwd", "sake_aug_fwd16",
             "sake_param_grads_aug", "sake_param_grads_aug16", "sake_resid_fwd_tc",
             "sake_resid_bwd_tc", "sake_retrace_fwd", "sake_retrace_fwd16", "sake_retrace_bwd",
             "sake_retrace_bwd16", "sake_retrace_grads16")
    return SimpleNamespace(
        **{n: (lambda *a, n=n: calls.append(n) or 0) for n in names},
        **{f"sake_{k}_smem_bytes": (lambda *d: 0)
           for k in ("resid_fwd", "resid_fwd_tc", "resid_bwd", "resid_bwd_tc", "resid_jvp",
                     "resid_tbwd", "aug_fwd", "retrace_bwd", "retrace_bwd16")},
        sake_resid_fwd_tc_route=lambda *d: 1, sake_resid_bwd_tc_route=lambda *d: 1,
        sake_error_string=lambda err: b"refused")


def test_tier_wrappers_launch_the_tier_entries(monkeypatch):
    """On CUDA tensors (meta tensors here) the wrappers of #7, #8, #9, #10's
    three launches, #18, #19, #16 and #17 launch their tier entries on the
    tier's streams (the tangent's and #18's streams bf16 but r and t) and the
    f32 entries on f32 streams, each counted under its tier: #17 per layer,
    its tier the one pullback launch and its contraction (the 25 other leaves
    and the edge weights' rounded terms in one entry)."""
    calls = []
    monkeypatch.setattr(build, "load", lambda: _stub(calls))
    for mod in (resid_ef, train2_ef):
        monkeypatch.setattr(mod, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(resid_ef, "_stream", lambda dev: None)
    meta = lambda *s: torch.empty(*s, device="meta")
    depth, Bm, Nm = 2, 3, 21
    leaves = {n: meta(depth, *s) for n, s in resid_ef._leaf_shapes(64, 64, 50, 4, 256).items()}
    h0, xs, upd = meta(Bm, Nm, 64), meta(3, Bm, Nm), [1.0] * depth
    counted = (train2_ef.shared_fwd, train2_ef.shared_bwd, train2_ef.resid_jvp,
               train2_ef.resid_tbwd, train2_ef.resid_bwd_aug, train2_ef.param_grads_aug,
               train2_ef.aug_fwd, train2_ef.aug_bwd, train2_ef.retrace_fwd,
               train2_ef.retrace_bwd)
    before = [dict(c.tiers) for c in counted]
    for bf16 in (True, False):
        fwd = train2_ef.shared_fwd(leaves, h0, xs, upd, bf16=bf16)
        assert resid_ef.stream_tier(fwd) == bf16
        train2_ef.shared_bwd(leaves, fwd, upd, h0)
        tfwd = train2_ef.resid_jvp(leaves, fwd, upd, xs)
        assert resid_ef.stream_tier(tfwd) == bf16
        train2_ef.resid_aug_bwd(leaves, fwd, tfwd, upd, h0, h0)
        afwd, atfwd = train2_ef.aug_fwd(leaves, h0, xs, upd, xs, bf16=bf16)
        assert resid_ef.stream_tier(afwd) == resid_ef.stream_tier(atfwd) == bf16
        train2_ef.aug_bwd(leaves, afwd, atfwd, upd, h0, h0)
        rfwd, rtfwd = train2_ef.retrace_fwd(leaves, h0, xs, upd, xs, bf16=bf16)
        train2_ef.retrace_bwd(leaves, rfwd, rtfwd, upd, h0, h0, bf16=bf16, tile=2)
    tier = lambda names, t: [n + t for n in names]
    retrace16 = ["sake_retrace_fwd16",
                 *(["sake_retrace_bwd16", "sake_retrace_grads16"] * depth)]
    retrace32 = ["sake_retrace_fwd", *(["sake_retrace_bwd", "sake_param_grads_aug"] * depth)]
    shared = ["sake_resid_fwd", "sake_resid_bwd", "sake_resid_jvp"]
    aug = ["sake_resid_tbwd", "sake_resid_bwd_rows", "sake_param_grads_aug"]
    assert calls == (tier(shared[:2], "16") + tier(shared[2:], "16") + tier(aug, "16")
                     + ["sake_aug_fwd16"] + tier(aug, "16") + retrace16
                     + ["sake_resid_fwd_tc", "sake_resid_bwd_tc", "sake_resid_jvp"] + aug
                     + ["sake_aug_fwd"] + aug + retrace32)
    for c, b in zip(counted, before):
        runs = 2 if c in (train2_ef.resid_tbwd, train2_ef.resid_bwd_aug,
                          train2_ef.param_grads_aug) else depth if c is train2_ef.retrace_bwd else 1
        assert c.tiers == {"f32": b["f32"] + runs, "bf16": b["bf16"] + runs}, c.__name__
