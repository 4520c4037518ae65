"""The resid and retrace modes of the port's ``make_ef_train2`` against the
JAX package: the wide layer ``depthgrid_ef.layer_forward_wide``, the plain
versions of the augmented forwards (#18, #16) and of the retrace backward
(#17), and ``make_ef_train2(aug_mode="resid" | "retrace")`` against JAX
double autodiff (``ef_lax`` of ``tests/test_kernels.py:871-877``) and against
the JAX modes run in interpret mode (the Pallas sites #16-#19 run by the
interpreter). JAX layer functions run as plain jnp; the port's wrappers run
their plain versions on CPU tensors, and the CUDA kernels are checked on the
card by ``chip_smoke.py`` (and by the ``gpu``-marked test here).

Tolerances (f32 throughout):
- ``layer_forward_wide``: ``rtol=2e-4, atol=2e-5``, the functional model's;
- the tangent residuals of ``aug_fwd_plain``: ``rtol=atol=2e-5`` on values
  scaled by each tensor's largest magnitude, as ``layer_jvp_resid``'s;
- ``retrace_bwd_plain`` against ``resid_aug_bwd_plain`` (two routes to the
  same gradients) and the narrow-heads kernel check: ``rtol=1e-3,
  atol=1e-4``, the tier of the first-order pullback;
- ``make_ef_train2`` against JAX: ``rtol=2e-3, atol=1e-5``, the JAX test's
  own (``tests/test_kernels.py:901-904``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.kernels.depthgrid_ef import _LEAF_NAMES, layer_forward_wide as jax_layer_wide
from sake_tpu.kernels.depthgrid_ef import wide_stack as jax_wide_stack
from sake_tpu.kernels.functional import model_forward as jax_model_forward
from sake_tpu.kernels.resid_ef import layer_fwd_resid as jax_layer_fwd
from sake_tpu.kernels.split_ef import head_expansion_matrices
from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels import resid_ef, train2_ef
from sake_tpu_torch.kernels.adapter import model_params_from_linen, params_from_jax
from sake_tpu_torch.kernels.depthgrid_ef import layer_forward_wide
from sake_tpu_torch.kernels.functional import flat_params
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, layer_leaves, wide_stack

WIDE_TOL = dict(rtol=2e-4, atol=2e-5)
JVP_TOL = dict(rtol=2e-5, atol=2e-5)
PULL_TOL = dict(rtol=1e-3, atol=1e-4)
MODEL_TOL = dict(rtol=2e-3, atol=1e-5)
B, N, F_IN, HID, K, DEPTH = 4, 7, 5, 16, 4, 2
UPD = [1.0, 0.4]


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(11)
    h_raw = rng.randn(B, N, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(B, N, 3)).astype(np.float32)
    model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=DEPTH)
    params = jax.jit(model.init)(jax.random.PRNGKey(6), jnp.asarray(h_raw), jnp.asarray(x))
    f = lambda *s: rng.randn(*s).astype(np.float32)
    tp = model_params_from_linen(_np_tree(params))
    return dict(params=params, kp=jax_from_linen(params), tp=tp, leaves=wide_stack(tp, K),
                h_raw=h_raw, x=x, h=f(B, N, HID), tx=f(B, N, 3), v=f(B, N, 3),
                e_t=f(B), f_t=f(B, N, 3), dh=f(B, N, HID), dth=f(B, N, HID))


def _jax_kw():
    e_rep, e_tile = head_expansion_matrices(HID, K)
    return dict(e_rep=e_rep, e_tile=e_tile,
                mm=lambda a, w: jnp.dot(a, w, preferred_element_type=jnp.float32))


def _planes(a):
    return [a[..., k : k + 1] for k in range(3)]


def _layers_j(kp):
    """Each layer's wide leaves on the JAX side."""
    stacked = jax_wide_stack(kp, K)
    return [{n: a[l] for n, a in zip(_LEAF_NAMES, stacked)} for l in range(DEPTH)]


def _stack_inputs(s):
    """The augmented forward's inputs: ``h0 (B, N, F)``, ``xs`` and ``tx0``
    ``(3, B, N)``."""
    return (_t(s["h"]), _t(s["x"].transpose(2, 0, 1)).contiguous(),
            _t(s["tx"].transpose(2, 0, 1)).contiguous())


@pytest.mark.parametrize("layer", [0, 1])
def test_layer_forward_wide_matches_jax(setup, layer):
    """The port's ``layer_forward_wide`` against the JAX one on the same
    wide leaves, at a fractional update gate and a nonzero velocity."""
    s = setup
    p_j = _layers_j(s["kp"])[layer]
    want = jax.jit(lambda p, h, x, v: jax_layer_wide(p, h, _planes(x), _planes(v), 0.4,
                                                     **_jax_kw()))(
        p_j, jnp.asarray(s["h"]), jnp.asarray(s["x"]), jnp.asarray(s["v"]))
    got = layer_forward_wide(layer_leaves(s["leaves"], layer), _t(s["h"]), _planes(_t(s["x"])),
                             _planes(_t(s["v"])), 0.4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **WIDE_TOL)
    for a, b in zip([*got[1], *got[2]], [*want[1], *want[2]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **WIDE_TOL)


def test_aug_fwd_plain_matches_jax_jvp(setup):
    """#18's plain version against ``jax.jvp`` of the JAX ``layer_fwd_resid``
    over depth from ``(h0, x, 0)`` along ``(0, tx, 0)``: every tangent
    residual of every layer, the tangent boundaries and the final tangent
    state."""
    s = setup
    h0, xs, tx0 = _stack_inputs(s)
    _, tfwd = train2_ef.aug_fwd_plain(s["leaves"], h0, xs, UPD, tx0)
    kw = _jax_kw()

    @jax.jit
    def tangents(kp, h, x, tx):
        zeros = jnp.zeros((B, N, 1), jnp.float32)
        st = (h, _planes(x), [zeros] * 3)
        tst = (jnp.zeros((B, N, HID), jnp.float32), _planes(tx), [zeros] * 3)
        out = []
        for l, (u, p) in enumerate(zip(UPD, _layers_j(kp))):
            out.append([tst[0], jnp.concatenate(tst[1], -1), jnp.concatenate(tst[2], -1)])
            (h, xp, vp, _), (th, txp, tvp, tres) = jax.jvp(
                lambda h_, x_, v_: jax_layer_fwd(p, h_, x_, v_, u, **kw), st, tst)
            out[-1] += [tres[n] for n in resid_ef.RESIDS]
            st, tst = (h, xp, vp), (th, txp, tvp)
        return out, [tst[0], jnp.concatenate(tst[1], -1)]

    per_layer, fin = tangents(s["kp"], *(jnp.asarray(s[k]) for k in ("h", "x", "tx")))
    pairs = [*zip([tfwd.h_fin, tfwd.x_fin], fin)]
    for l, want in enumerate(per_layer):
        got = [tfwd.bh[l], tfwd.bx[l], tfwd.bv[l], *(tfwd.resid[n][l] for n in resid_ef.RESIDS)]
        pairs += zip(got, want)
    for a, b in pairs:
        b = np.asarray(b)
        if a.shape != b.shape:  # (3, B, N) planes against (B, N, 3), or flat edges
            b = b.transpose(2, 0, 1) if b.ndim == 3 and b.shape[-1] == 3 else b.reshape(a.shape)
        scale = float(np.abs(b).max()) + 1e-8
        np.testing.assert_allclose(a.numpy() / scale, b / scale, **JVP_TOL)


def test_retrace_fwd_plain_is_aug_fwd_without_residuals(setup):
    """#16's plain version (the jvp of the wide layer) gives #18's
    boundaries and final states (the jvp of the residual-saving layer)."""
    s = setup
    args = (s["leaves"], *_stack_inputs(s)[:2], UPD, _stack_inputs(s)[2])
    for got, want in zip(train2_ef.retrace_fwd_plain(*args), train2_ef.aug_fwd_plain(*args)):
        assert got.resid is None
        for a, b in zip(got[:6], want[:6]):
            torch.testing.assert_close(a, b, **WIDE_TOL)


def test_retrace_bwd_plain_matches_resid_aug_bwd(setup):
    """#17's plain version (``torch.func.vjp`` of the jvp of the wide layer)
    and #19's (the hand-written pullback bodies on #18's residuals) compute
    the same gradients by two routes: dh0, dx0, dth0 and every leaf of every
    layer."""
    s = setup
    fwd, tfwd = train2_ef.aug_fwd_plain(s["leaves"], *_stack_inputs(s)[:2], UPD,
                                        _stack_inputs(s)[2])
    dh, dth = _t(s["dh"]), _t(s["dth"])
    got = train2_ef.retrace_bwd_plain(s["leaves"], fwd, tfwd, UPD, dh, dth)
    want = train2_ef.resid_aug_bwd_plain(s["leaves"], fwd, tfwd, UPD, dh, dth)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, **PULL_TOL)
    assert set(got[3]) == set(LEAF_NAMES)
    for n in LEAF_NAMES:
        torch.testing.assert_close(got[3][n], want[3][n], **PULL_TOL, msg=n)


def _ef_lax(p, h_, x_):
    def e_fn(xx):
        out, _, _ = jax_model_forward(p, h_, xx, n_heads=K, update=True)
        return out.sum(axis=(-2, -1)).sum(), out.sum(axis=(-2, -1))

    g, e = jax.grad(e_fn, has_aux=True)(x_)
    return e, -g


def _jax_loss_grads(ef_j, kp, h_raw, x, e_t, f_t):
    """The JAX test's loss through ``ef_j`` and its gradients w.r.t. the
    parameters, h and x."""

    def loss_j(p, h_, x_):
        e, f = ef_j(p, h_, x_)
        return ((e - e_t) ** 2).sum() + 0.5 * ((f - f_t) ** 2).sum()

    return jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2)))(
        kp, jnp.asarray(h_raw), jnp.asarray(x))


@pytest.fixture(scope="module")
def lax_ref(setup):
    s = setup
    return _jax_loss_grads(_ef_lax, s["kp"], s["h_raw"], s["x"], s["e_t"], s["f_t"])


def _check_against_jax(ref, ef, tp, h_raw, x, e_t, f_t, depth):
    """Loss and gradients (every parameter, h and x) of the JAX test's loss
    through ``ef`` (the port) against JAX's ``ref = (loss, grads)``."""
    l_ref, g_ref = ref
    flat = [t.detach().clone().requires_grad_(True) for t in flat_params(tp)]
    p = resid_ef._unflat_params(flat, depth)
    h, xt = _t(h_raw).requires_grad_(True), _t(x).requires_grad_(True)
    e, f = ef(p, h, xt)
    assert type(e.grad_fn).__name__ == "EFBackward"  # the kernel backward, not autograd's
    loss = ((e - _t(e_t)) ** 2).sum() + 0.5 * ((f - _t(f_t)) ** 2).sum()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-5)
    got = torch.autograd.grad(loss, [h, xt, *flat])
    want = [np.asarray(g_ref[1]), np.asarray(g_ref[2]),
            *(w.numpy() for w in flat_params(params_from_jax(_np_tree(g_ref[0]))))]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"leaf {i}", **MODEL_TOL)
    return e, f, p, h, xt


@pytest.mark.parametrize("aug_chunk", [None, 3])
@pytest.mark.parametrize("aug_mode", ["resid", "retrace"])
def test_make_ef_train2_matches_jax_double_autodiff(setup, lax_ref, aug_mode, aug_chunk):
    """``make_ef_train2`` in its own default mode and in retrace mode
    against JAX double autodiff of the functional model; ``aug_chunk=3``
    cuts B = 4 into a chunk of 3 and a ragged chunk of 1. Outside autograd
    it is the primal alone."""
    s = setup
    ef = train2_ef.make_ef_train2(n_heads=K, update=True, aug_mode=aug_mode, aug_chunk=aug_chunk,
                                  batch_tile=2, aug_batch_tile=2, pad_atoms=True)
    e, f, p, h, xt = _check_against_jax(lax_ref, ef, s["tp"], s["h_raw"], s["x"], s["e_t"],
                                        s["f_t"], DEPTH)
    with torch.no_grad():
        e0, f0 = ef(p, h, xt)
    torch.testing.assert_close(e0, e.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(f0, f.detach(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("aug_mode", ["resid", "retrace"])
def test_make_ef_train2_matches_jax_mode_interpret(aug_mode):
    """A tiny case (hidden 8, depth 1, B = 2, N = 5, so JAX pads N to 8)
    against the JAX package's own ``make_ef_train2(aug_mode=m,
    interpret=True)``: the Pallas kernels #18 and #19, or #16 and #17, run by
    the interpreter."""
    from sake_tpu.kernels.train2_ef import make_ef_train2 as jax_make_ef_train2

    rng = np.random.RandomState(8)
    h_raw = rng.randn(2, 5, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(2, 5, 3)).astype(np.float32)
    e_t, f_t = rng.randn(2).astype(np.float32), rng.randn(2, 5, 3).astype(np.float32)
    model = JaxSAKEModel(hidden_features=8, out_features=1, depth=1)
    params = model.init(jax.random.PRNGKey(4), jnp.asarray(h_raw), jnp.asarray(x))
    ef_j = jax_make_ef_train2(n_heads=K, batch_tile=2, aug_batch_tile=2, aug_mode=aug_mode,
                              pad_atoms=True, chunk=None, aug_chunk=None, interpret=True)
    ef = train2_ef.make_ef_train2(n_heads=K, aug_mode=aug_mode, pad_atoms=True)
    ref = _jax_loss_grads(ef_j, jax_from_linen(params), h_raw, x, e_t, f_t)
    _check_against_jax(ref, ef, model_params_from_linen(_np_tree(params)), h_raw, x, e_t, f_t, 1)


def test_new_wrappers_count_only_card_launches(setup):
    """On CPU tensors #16-#19's wrappers take their plain versions and leave
    their launch counts alone."""
    s = setup
    h0, xs, tx0 = _stack_inputs(s)
    counted = (train2_ef.aug_fwd, train2_ef.retrace_fwd, train2_ef.aug_bwd,
               train2_ef.retrace_bwd, train2_ef.resid_tbwd, train2_ef.param_grads_aug)
    before = [c.launches for c in counted]
    dh, dth = _t(s["dh"]), _t(s["dth"])
    fwd, tfwd = train2_ef.aug_fwd(s["leaves"], h0, xs, UPD, tx0)
    train2_ef.aug_bwd(s["leaves"], fwd, tfwd, UPD, dh, dth)
    fwd, tfwd = train2_ef.retrace_fwd(s["leaves"], h0, xs, UPD, tx0)
    train2_ef.retrace_bwd(s["leaves"], fwd, tfwd, UPD, dh, dth)
    assert [c.launches for c in counted] == before


def test_md17_kernel_workload_builds_in_the_new_modes():
    """``get_workload("md17_kernel", aug_mode=m)`` builds the kernel branch
    in mode m, as the JAX registry does."""
    from sake_tpu.tasks.registry import get_workload as jax_get_workload
    from sake_tpu_torch.tasks import md17
    from sake_tpu_torch.tasks.registry import get_workload

    for mode in ("resid", "retrace"):
        run, cfg = get_workload("md17_kernel", aug_mode=mode, n_valid=200)
        _, cfg_j = jax_get_workload("md17_kernel", aug_mode=mode, n_valid=200)
        assert run is md17.run and cfg.use_kernel_ef and cfg.aug_mode == cfg_j.aug_mode == mode


@pytest.mark.gpu
def test_retrace_bwd_kernel_fits_narrow_heads(setup):
    """#17 (whose launch runs the tangent pullback's body after the two
    forward bodies) and #16 against their plain versions on the card with 50
    rbf channels at hidden 8 (R > H*K = 32) and hidden 16 (R < H*K = 64):
    the carve of the shared work region must hold every body's widest
    buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sake_tpu_torch.kernels.functional import params_to

    dev = torch.device("cuda")
    rng = np.random.RandomState(4)
    for hid in (8, HID):
        model = JaxSAKEModel(hidden_features=hid, out_features=1, depth=DEPTH)
        params = model.init(jax.random.PRNGKey(0), jnp.asarray(setup["h_raw"]),
                            jnp.asarray(setup["x"]))
        leaves = wide_stack(params_to(model_params_from_linen(_np_tree(params)), dev), K)
        h0 = torch.as_tensor(rng.randn(B, N, hid).astype(np.float32), device=dev)
        xs = _t(setup["x"].transpose(2, 0, 1)).contiguous().to(dev)
        tx0 = torch.as_tensor(rng.randn(3, B, N).astype(np.float32), device=dev)
        fwd, tfwd = train2_ef.retrace_fwd(leaves, h0, xs, UPD, tx0)
        pf, pt = train2_ef.retrace_fwd_plain(leaves, h0, xs, UPD, tx0)
        for a, b in zip([*fwd[:6], *tfwd[:6]], [*pf[:6], *pt[:6]]):
            torch.testing.assert_close(a, b, **PULL_TOL)
        dh = torch.as_tensor(rng.randn(B, N, hid).astype(np.float32), device=dev)
        dth = torch.as_tensor(rng.randn(B, N, hid).astype(np.float32), device=dev)
        got = train2_ef.retrace_bwd(leaves, pf, pt, UPD, dh, dth)
        want = train2_ef.retrace_bwd_plain(leaves, pf, pt, UPD, dh, dth)
        for a, b in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            torch.testing.assert_close(a, b, **PULL_TOL)
