"""The port's split edge pipeline (``kernels/split_ef``: the edge_att and
coeff_pool ops, #25 + #26, and the merged op, #27 + #28) against the JAX
package.

On CPU tensors the wrappers run their plain versions (the bodies and their
``torch.func.vjp``); the CUDA kernels are checked against those on the card
by ``chip_smoke.py`` (phases 21-23) and by the ``gpu``-marked test here.
References: the JAX bodies ``_edge_att_body``, ``_coeff_pool_body`` and
``_merged_body``; ``jax.vjp`` of the JAX ops run by the Pallas interpreter;
``jax.value_and_grad`` of the linen model and one tiny case of each JAX
entry point in interpret mode (``tests/test_kernels.py:103-137``' size).

Tolerances: the bodies and the entry points ``rtol=2e-4, atol=2e-5``, the
JAX test's own (``tests/test_kernels.py:17``; f32 sums in another order);
the VJPs ``rtol=1e-3, atol=1e-4`` (a pullback's sums cancel more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.kernels import split_ef as jse
from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels import build, split_ef
from sake_tpu_torch.kernels.adapter import model_params_from_linen

TOL = dict(rtol=2e-4, atol=2e-5)
VJP_TOL = dict(rtol=1e-3, atol=1e-4)
B, N, R, H, K, C = 4, 5, 10, 8, 4, 12  # the bodies' widths (R > H: the rbf products)
TILE = 2  # the JAX grid's batch tile; B is a multiple of it
EF_B, EF_N, EF_F, EF_HID = 4, 7, 5, 16  # the JAX entry-point test's size


def _t(a, grad=False):
    return torch.tensor(np.array(a), requires_grad=grad)


@pytest.fixture(scope="module")
def edge_inputs():
    """Seeded inputs of the ops: x planes, node halves, the edge_att weights
    and w_xmix, numpy f32 in the JAX shapes."""
    rng = np.random.RandomState(3)
    f = lambda *s, scale=1.0: (scale * rng.randn(*s)).astype(np.float32)
    xp = [f(B, N, 1, scale=1.5) for _ in range(3)]
    halves = [f(B, N, R), f(B, N, R), f(B, N, H), f(B, N, H)]
    w = dict(rbf_m=rng.uniform(0, 1, R).astype(np.float32),
             rbf_b=rng.uniform(0.5, 4, R).astype(np.float32),
             w_r=f(R, H, scale=0.3), w_rr=f(H, scale=0.3), b0=f(H, scale=0.1),
             w1=f(H, H, scale=0.3), b1=f(H, scale=0.1), w_sem=f(H, K, scale=0.5),
             b_sem=f(K, scale=0.1), w_xmix=f(H * K, C, scale=0.3))
    return dict(xp=xp, halves=halves, w=w, he=f(B, N, N, H), att=rng.uniform(
        0, 1, (B, N, N, K)).astype(np.float32))


def _args(s, kind):
    """The op's arguments (numpy, JAX order, no ``e_rep`` / ``e_tile``)."""
    w = [s["w"][n] for n in split_ef.WEIGHTS[kind]]
    if kind == "coeff_pool":
        return [*s["xp"], s["he"], s["att"], *w]
    return [*s["xp"], *s["halves"], *w]


def _jax_args(kind, args):
    """JAX's arguments: the coeff_pool body and the merged body also take the
    expansion matrices."""
    out = [jnp.asarray(a) for a in args]
    if kind != "edge_att":
        out += list(jse.head_expansion_matrices(H, K))
    return out


JAX_BODIES = {"edge_att": jse._edge_att_body, "coeff_pool": jse._coeff_pool_body,
              "merged": jse._merged_body}


@pytest.mark.parametrize("kind", ["edge_att", "coeff_pool", "merged"])
def test_plain_bodies_match_jax(edge_inputs, kind):
    args = _args(edge_inputs, kind)
    want = JAX_BODIES[kind](*_jax_args(kind, args))
    got = split_ef.BODIES[kind](*(_t(a) for a in args))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_head_expansion_matches_jax():
    """The re-exported expansion matrices are the JAX ones."""
    e_rep, e_tile = split_ef.head_expansion_matrices(H, K)
    j_rep, j_tile = jse.head_expansion_matrices(H, K)
    np.testing.assert_array_equal(e_rep.numpy(), np.asarray(j_rep))
    np.testing.assert_array_equal(e_tile.numpy(), np.asarray(j_tile))


def _jax_op(kind):
    if kind == "edge_att":
        return jse.make_edge_att_op(N, R, H, K, batch_tile=TILE, interpret=True)
    if kind == "coeff_pool":
        return jse.make_coeff_pool_op(N, H, K, C, batch_tile=TILE, interpret=True)
    return jse.make_edge_pool_op(N, R, H, K, C, io_tile=B, chunk=TILE, interpret=True)


def _torch_op(kind):
    if kind == "edge_att":
        return split_ef.make_edge_att_op(N, R, H, K, batch_tile=TILE)
    if kind == "coeff_pool":
        return split_ef.make_coeff_pool_op(N, H, K, C, batch_tile=TILE)
    return split_ef.make_edge_pool_op(N, R, H, K, C, io_tile=B, chunk=TILE)


@pytest.mark.parametrize("kind", ["edge_att", "coeff_pool", "merged"])
def test_op_vjp_matches_jax_interpret(edge_inputs, kind):
    """The op's VJP (every batched input and every weight) against
    ``jax.vjp`` of the JAX op in interpret mode, on seeded cotangents."""
    args = _args(edge_inputs, kind)
    jargs = _jax_args(kind, args)
    outs, vjp = jax.vjp(_jax_op(kind), *jargs)
    rng = np.random.RandomState(5)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    want = vjp(tuple(jnp.asarray(c) for c in cots))[: len(args)]
    targs = [_t(a, grad=True) for a in args]
    touts = _torch_op(kind)(*targs)
    for a, b in zip(touts, outs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    got = torch.autograd.grad(touts, targs, [_t(c) for c in cots])
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"argument {i}", **VJP_TOL)


@pytest.mark.parametrize("kind", ["edge_att", "coeff_pool", "merged"])
def test_second_derivative_raises(edge_inputs, kind):
    """First order, like the JAX ``custom_vjp``: a backward pass that
    records a graph raises."""
    targs = [_t(a, grad=True) for a in _args(edge_inputs, kind)]
    out = _torch_op(kind)(*targs)
    with pytest.raises(RuntimeError, match="first order"):
        torch.autograd.grad(out[0].sum(), targs[0], create_graph=True)


def test_op_skips_weight_cotangents_it_is_not_asked_for(edge_inputs, monkeypatch):
    """With only batched inputs requiring grad, the pullback is asked for no
    weight cotangents (the E + F path)."""
    asked = []
    real = split_ef.BWD["merged"]
    monkeypatch.setitem(split_ef.BWD, "merged",
                        lambda a, c, weights: asked.append(weights) or real(a, c, weights))
    args = _args(edge_inputs, "merged")
    targs = [_t(a, grad=i < 7) for i, a in enumerate(args)]
    out = _torch_op("merged")(*targs)
    torch.autograd.grad(out[0].sum(), targs[0])
    assert asked == [False]


def test_edge_pool_op_rejects_a_ragged_chunk():
    with pytest.raises(ValueError, match="multiple of chunk"):
        split_ef.make_edge_pool_op(N, R, H, K, C, io_tile=6, chunk=4)


def test_op_rejects_other_widths(edge_inputs):
    targs = [_t(a) for a in _args(edge_inputs, "edge_att")]
    with pytest.raises(ValueError, match="built for"):
        split_ef.make_edge_att_op(N, R + 1, H, K)(*targs)


# --------------------------------------------------------------------------
# The entry points
# --------------------------------------------------------------------------

ENTRY = {"split": split_ef.split_energy_forces, "merged": split_ef.merged_energy_forces}
_MODELS = {}


@pytest.fixture(scope="module")
def ef_inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(EF_B, EF_N, EF_F).astype(np.float32),
            rng.randn(EF_B, EF_N, 3).astype(np.float32))


def _model(update, h, x):
    key = str(update)
    if key not in _MODELS:
        model = JaxSAKEModel(hidden_features=EF_HID, out_features=1, depth=3, update=update)
        params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x))
        _MODELS[key] = model, params
    return _MODELS[key]


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("entry", ["split", "merged"])
@pytest.mark.parametrize("update", [True, [False, True, False]])
def test_energy_forces_match_linen(ef_inputs, entry, update):
    """E and F against ``jax.value_and_grad`` of the linen model, every layer
    updating and a mixed update schedule; the JAX tiling keywords are
    accepted."""
    h, x = ef_inputs
    model, params = _model(update, h, x)

    @jax.jit
    def ef(p, x_):
        def energy(xx):
            out, _, _ = model.apply(p, jnp.asarray(h), xx)
            return out.sum(), out.sum(axis=(-2, -1))

        (_, e), g = jax.value_and_grad(energy, has_aux=True)(x_)
        return e, -g

    e_ref, f_ref = ef(params, jnp.asarray(x))
    tp = model_params_from_linen(_np_tree(params))
    kw = (dict(batch_tile_edge=2, batch_tile_pool=2) if entry == "split"
          else dict(io_tile=4, chunk=2))
    e, f = ENTRY[entry](tp, _t(h), _t(x), update=update, interpret=True, **kw)
    assert e.shape == (EF_B,) and f.shape == (EF_B, EF_N, 3)
    assert not e.requires_grad and not f.requires_grad
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), **TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), **TOL)


@pytest.mark.parametrize("entry", ["split", "merged"])
def test_energy_forces_match_jax_interpret(ef_inputs, entry):
    """Against the JAX entry point run by the Pallas interpreter, at the JAX
    test's size and tiles (``tests/test_kernels.py:103-137``)."""
    h, x = ef_inputs
    _, params = _model(True, h, x)
    kw = (dict(batch_tile_edge=2, batch_tile_pool=2) if entry == "split"
          else dict(io_tile=4, chunk=2))
    jfn = jse.split_energy_forces if entry == "split" else jse.merged_energy_forces
    e_j, f_j = jfn(jax_from_linen(params), jnp.asarray(h), jnp.asarray(x), interpret=True, **kw)
    tp = model_params_from_linen(_np_tree(params))
    e, f = ENTRY[entry](tp, _t(h), _t(x), **kw)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), **TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), **TOL)


def test_wrappers_count_only_card_launches(ef_inputs):
    """On CPU tensors the six wrappers take their plain versions and leave
    their launch counts alone."""
    h, x = ef_inputs
    _, params = _model(True, h, x)
    tp = model_params_from_linen(_np_tree(params))
    counted = (*split_ef.FWD.values(), *split_ef.BWD.values())
    before = [c.launches for c in counted]
    for entry in ENTRY.values():
        entry(tp, _t(h), _t(x))
    assert [c.launches for c in counted] == before


def test_split_rows_match_the_kernel_table():
    """``SplitRow`` in ``csrc/split_edge.cuh`` indexes the rows by position."""
    src = (build.CSRC / "split_edge.cuh").read_text()
    body = src[src.index("enum SplitRow {"):src.index("};", src.index("enum SplitRow {"))]
    names = [t.strip() for t in body.split("{")[1].split(",") if t.strip()]
    assert [n.removeprefix("SR_") for n in names] == [n.upper() for n in split_ef.SPLIT_ROWS]
    assert f"kSplitRows = {len(split_ef.SPLIT_ROWS)};" in src
    assert set(split_ef.GRAD_TERMS) == set(split_ef.MERGED_WEIGHTS)


@pytest.mark.gpu
def test_split_kernels_match_plain_on_the_card(edge_inputs):
    """#25-#28 against their plain versions on the card (narrow widths, R >
    H*K is not needed here: chip_smoke.py covers full width), every batched
    and weight cotangent, each count moving by one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.RandomState(8)
    for kind in ("edge_att", "coeff_pool", "merged"):
        args = [torch.as_tensor(a, device=dev) for a in _args(edge_inputs, kind)]
        fwd, bwd = split_ef.FWD[kind], split_ef.BWD[kind]
        before = (fwd.launches, bwd.launches)
        outs = fwd(*args)
        want = split_ef.BODIES[kind](*args)
        cots = [torch.as_tensor(rng.randn(*o.shape).astype(np.float32), device=dev)
                for o in outs]
        gb, gw = bwd(args, cots, True)
        pb, pw = split_ef.vjp_plain(kind, args, cots, True)
        torch.cuda.synchronize()
        assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
        for a, b in zip([*outs, *gb, *gw], [*want, *pb, *pw]):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("merged", [False, True])
def test_model_energy_weight_gradients_match_autograd(ef_inputs, merged):
    """The gradient of the summed energy with respect to every edge weight
    (the CFConv tensors, w_sem, b_sem, w_xmix of each layer) and x through
    the ops' pullbacks with weights, against torch autograd of the
    functional model."""
    from sake_tpu_torch.kernels.functional import model_forward

    h, x = ef_inputs
    _, params = _model([False, True, False], h, x)
    tp = model_params_from_linen(_np_tree(params))
    leaves = [t for lp in tp.layers for t in (*lp.edge, lp.w_sem, lp.b_sem, lp.w_xmix)]
    for t in leaves:
        t.requires_grad_(True)
    xg = _t(x, grad=True)
    e = split_ef.model_energy(tp, _t(h), xg, update=[False, True, False], merged=merged)
    got = torch.autograd.grad(e.sum(), [*leaves, xg])
    out, _, _ = model_forward(tp, _t(h), xg, update=[False, True, False])
    want = torch.autograd.grad(out.sum(), [*leaves, xg])
    torch.testing.assert_close(e, out.sum(dim=(-2, -1)), **TOL)
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, msg=f"leaf {i}", **VJP_TOL)
