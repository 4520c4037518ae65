"""The port's sparse edge scope and kernel model (``kernels/sparse_ef.py``)
against the JAX package (``sake_tpu/kernels/sparse_ef.py``).

- The plain edge chain, its pullback (with the 11 leaf gradients) and the
  second-order body against the JAX ``_edge_chain``, ``_edge_pullback`` and
  ``jax.vjp`` of the two, on seeded inputs with an isolated row, a masked
  slot at the receiver and a live slot at distance 0: max error within
  1e-5 of each tensor's largest entry (the same f32 arithmetic in another
  order), 5e-5 for the second-order body (its b_sem term is a row sum whose
  terms cancel).
- The rows the kernels write, contracted under the kernels' term tables,
  against the leaf gradients and their second-order terms: the same
  1e-5 of each tensor's largest entry.
- ``sparse_kernel_model_forward`` and its E + F against the JAX Pallas op in
  interpret mode (``block_rows=8``, f32): ``rtol=2e-4, atol=2e-5``, forces
  ``rtol=5e-4, atol=5e-5``.
- The energy-loss and force-loss gradients per leaf against JAX lax
  autodiff through ``sake_tpu/sparse.py``: max error per leaf within 2e-4 of
  the leaf's largest entry (the JAX test's tolerance).
- An edge-leaf gradient through the kernel op is the true one (above) or
  raises (the JAX op returns zeros there).
On the CPU the wrappers run their plain versions; a ``gpu``-marked test
launches the kernels on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu import sparse as js
from sake_tpu.kernels import model_params_from_linen as jax_params_from_linen
from sake_tpu.kernels import sparse_ef as jse
from sake_tpu.kernels.depthgrid_ef import _make_mm_prec
from sake_tpu.kernels.resid_ef import _make_mmt_prec
from sake_tpu.kernels.split_ef import head_expansion_matrices
from sake_tpu.models import SAKEModel
from sake_tpu_torch.kernels import build
from sake_tpu_torch.kernels import sparse_ef as se
from sake_tpu_torch.kernels.adapter import model_params_from_linen
from sake_tpu_torch.kernels.functional import flat_params

EDGE_REL = 1e-5
SECOND_REL = 5e-5  # the b_sem cotangent is a row sum whose terms cancel
ROWS_REL = 1e-5
TOL = dict(rtol=2e-4, atol=2e-5)
F_TOL = dict(rtol=5e-4, atol=5e-5)
GRAD_REL = 2e-4
HI = jax.lax.Precision.HIGHEST


def t(a):
    return torch.as_tensor(np.array(a))


def assert_scaled(got, want, rel, what=""):
    """max |got - want| <= rel * max |want|: a cotangent's entries span
    orders of magnitude, so each is held to the tensor's scale."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, (what, err)


@pytest.fixture(scope="module")
def edge():
    """Edge-scope inputs at small widths: NR = 12 rows of K = 10 slots."""
    rng = np.random.RandomState(0)
    NR, K, F, R, H, Kh, C = 12, 10, 16, 10, 16, 4, 32
    f32 = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    d0 = f32(3, NR, K, sc=1.5)
    m = (rng.rand(NR, K) > 0.3).astype(np.float32)
    m[0] = 0.0  # a row with no live slot
    d0[:, 1, 0], m[1, 0] = 0.0, 0.0  # a masked slot at the receiver itself
    d0[:, 2, 1], m[2, 1] = 0.0, 1.0  # a live slot at distance 0
    shapes = dict(w_in_j=(F, R), w_o_j=(F, H), rbf_m=(1, R), rbf_b=(1, R), w_o_f=(R, H),
                  w_o_r=(1, H), w_o1=(H, H), b_o1=(1, H), w_sem=(H, Kh), b_sem=(1, Kh),
                  w_xmix=(H * Kh, C))
    ep = {n: f32(*s, sc=0.4) for n, s in shapes.items()}
    ep["rbf_m"] = rng.rand(1, R).astype(np.float32)
    ep["rbf_b"] = (rng.rand(1, R) * 3).astype(np.float32)
    return dict(hg=f32(NR, K, F), ai=f32(NR, R, sc=0.5), oi=f32(NR, H, sc=0.5), d0=d0, m=m,
                ep=ep, gp=f32(3, NR, C), gh=f32(NR, H * Kh),
                c=(f32(NR, K, F), f32(NR, R), f32(NR, H), f32(3, NR, K)), H=H, Kh=Kh)


def _jax_ep(e):
    ep = {n: jnp.asarray(a) for n, a in e["ep"].items()}
    ep["e_rep"], ep["e_tile"] = (jnp.asarray(a) for a in head_expansion_matrices(e["H"], e["Kh"]))
    return ep


def _j(e):
    """The JAX-shaped inputs: d0 as 3 (NR, K, 1) planes, m (NR, K, 1)."""
    return (jnp.asarray(e["hg"]), jnp.asarray(e["ai"]), jnp.asarray(e["oi"]),
            [jnp.asarray(e["d0"][k][..., None]) for k in range(3)],
            jnp.asarray(e["m"][..., None]))


def _t(e):
    return (t(e["hg"]), t(e["ai"]), t(e["oi"]), [t(e["d0"][k][..., None]) for k in range(3)],
            t(e["m"][..., None]), {n: t(a) for n, a in e["ep"].items()})


def test_edge_chain_matches_jax(edge):
    hg, ai, oi, d0, m = _j(edge)
    fj = jse._edge_chain(hg, ai, oi, d0, m, _jax_ep(edge), _make_mm_prec(None, HI))
    ft = se.edge_chain(*_t(edge))
    for k in range(3):
        assert_scaled(ft["pooled"][k].numpy(), np.asarray(fj["pooled"][k]), EDGE_REL)
    for name in ("hatt", "pre", "e0", "h_e", "att", "att2", "tanh_v", "r"):
        assert_scaled(ft[name].numpy().reshape(np.shape(fj[name])), np.asarray(fj[name]),
                      EDGE_REL, name)
    assert np.isfinite(ft["hatt"].numpy()).all() and float(ft["hatt"][0].abs().max()) == 0.0


@pytest.mark.parametrize("want_param_grads", [False, True])
def test_edge_pullback_matches_jax(edge, want_param_grads):
    hg, ai, oi, d0, m = _j(edge)
    ep = _jax_ep(edge)
    mm = _make_mm_prec(None, HI)
    fj = jse._edge_chain(hg, ai, oi, d0, m, ep, mm)
    gp = [jnp.asarray(edge["gp"][k]) for k in range(3)]
    outj = jse._edge_pullback(hg, d0, m, ep, mm, fj, gp, jnp.asarray(edge["gh"]),
                              mmt=_make_mmt_prec(None, HI) if want_param_grads else None)
    hg_t, ai_t, oi_t, d0_t, m_t, ep_t = _t(edge)
    ft = se.edge_chain(hg_t, ai_t, oi_t, d0_t, m_t, ep_t)
    outt = se.edge_pullback(hg_t, d0_t, m_t, ep_t, ft, [t(edge["gp"][k]) for k in range(3)],
                            t(edge["gh"]), want_param_grads)
    for a, b in zip(outt[:3], outj[:3]):
        assert_scaled(a.numpy(), np.asarray(b), EDGE_REL)
    for k in range(3):
        assert_scaled(outt[3][k].numpy(), np.asarray(outj[3][k]), EDGE_REL)
    if want_param_grads:
        for n in se.EDGE_LEAVES:
            assert_scaled(outt[4][n].numpy(), np.asarray(outj[4][n]), EDGE_REL, n)
    else:
        assert outt[4] is None


def test_second_order_body_matches_jax_vjp(edge):
    hg, ai, oi, d0, m = _j(edge)
    ep = _jax_ep(edge)
    mm = _make_mm_prec(None, HI)
    names = jse._EDGE_LEAVES

    def pb(hg_, ai_, oi_, da, db, dc, p0, p1, p2, ph, *wl):
        epk = dict(ep, **dict(zip(names, wl)))
        f = jse._edge_chain(hg_, ai_, oi_, [da, db, dc], m, epk, mm)
        d_h_g, d_a_i, d_o_i, d_d0, _ = jse._edge_pullback(hg_, [da, db, dc], m, epk, mm, f,
                                                          [p0, p1, p2], ph)
        return d_h_g, d_a_i, d_o_i, d_d0[0], d_d0[1], d_d0[2]

    gp = [jnp.asarray(edge["gp"][k]) for k in range(3)]
    c_hg, c_ai, c_oi, c_d0 = edge["c"]
    cot = (jnp.asarray(c_hg), jnp.asarray(c_ai), jnp.asarray(c_oi),
           *(jnp.asarray(c_d0[k][..., None]) for k in range(3)))
    cj = jax.jit(lambda *prim: jax.vjp(pb, *prim)[1](cot))(
        hg, ai, oi, *d0, *gp, jnp.asarray(edge["gh"]), *(ep[n] for n in names))
    hg_t, ai_t, oi_t, d0_t, m_t, ep_t = _t(edge)
    e_hg, e_ai, e_oi, e_d0, e_gp, e_gh, dW2 = se.edge_pullback2(
        hg_t, ai_t, oi_t, d0_t, m_t, ep_t, [t(edge["gp"][k]) for k in range(3)], t(edge["gh"]),
        (t(c_hg), t(c_ai), t(c_oi), [t(c_d0[k][..., None]) for k in range(3)]))
    got = [e_hg, e_ai, e_oi, *e_d0, *e_gp, e_gh, *(dW2[n] for n in names)]
    for i, (a, b) in enumerate(zip(got, cj)):
        assert_scaled(a.numpy(), np.asarray(b), SECOND_REL, str(i))


def test_rows_contract_to_the_leaf_gradients(edge):
    """The kernels' tables: the rows #14 writes, contracted under
    ``GRAD_TERMS``, are the leaf gradients; their tangents along the
    cotangents c (what #15 writes), contracted under ``aug_terms``, are
    #15's leaf cotangents."""
    hg, ai, oi, d0, m = (t(edge[k]) for k in ("hg", "ai", "oi", "d0", "m"))
    ep = {n: t(a) for n, a in edge["ep"].items()}
    gp, gh = t(edge["gp"]), t(edge["gh"])
    rows = se.edge_rows_plain(hg, ai, oi, d0, m, ep, gp, gh)
    assert list(rows) == list(se.EDGE_ROWS)
    rows["h_g"] = hg.reshape(-1, hg.shape[-1])
    dW = se.sparse_bwd_plain(hg, ai, oi, d0, m, ep, gp, gh, True)[4]
    got = se.contract_plain(rows, se.GRAD_TERMS)
    for n in se.EDGE_LEAVES:
        assert_scaled(got[n].numpy(), dW[n].numpy(), ROWS_REL, n)

    c = tuple(t(a) for a in edge["c"])
    t_rows = torch.func.jvp(lambda hg_, ai_, oi_, d0_: se.edge_rows_plain(
        hg_, ai_, oi_, d0_, m, ep, gp, gh), (hg, ai, oi, d0), c)[1]
    allrows = {**rows, **{"t_" + n: a for n, a in t_rows.items()},
               "t_h_g": c[0].reshape(rows["h_g"].shape)}
    dW2 = se.sparse_bwd2_plain(hg, ai, oi, d0, m, ep, gp, gh, *c)[6]
    got2 = se.contract_plain(allrows, se.aug_terms(se.GRAD_TERMS))
    for n in se.EDGE_LEAVES:
        assert_scaled(got2[n].numpy(), dW2[n].numpy(), ROWS_REL, n)


def test_edge_row_table_matches_the_kernel_enum():
    src = (build.CSRC / "sparse_edge.cuh").read_text()
    body = src[src.index("enum EdgeRow {"):src.index("};", src.index("enum EdgeRow {"))]
    names = [s.strip().removeprefix("ER_") for s in body.split("{")[1].split(",") if s.strip()]
    assert names == [n.upper() for n in se.EDGE_ROWS]
    assert f"kEdgeRows = {len(se.EDGE_ROWS)};" in src
    assert f"kEdgeWPtrs = {len(se.EDGE_LEAVES) + len(se._TRANSPOSED)};" in src


def test_wrappers_take_the_plain_versions_on_cpu(edge):
    hg, ai, oi, d0, m = (t(edge[k]) for k in ("hg", "ai", "oi", "d0", "m"))
    ep = {n: t(a) for n, a in edge["ep"].items()}
    gp, gh, c = t(edge["gp"]), t(edge["gh"]), tuple(t(a) for a in edge["c"])
    counters = (se.sparse_fwd, se.sparse_bwd, se.sparse_bwd_grads, se.sparse_bwd2)
    before = [f.launches for f in counters]
    pairs = [(se.sparse_fwd(hg, ai, oi, d0, m, ep), se.sparse_fwd_plain(hg, ai, oi, d0, m, ep)),
             (se.sparse_bwd(hg, ai, oi, d0, m, ep, gp, gh),
              se.sparse_bwd_plain(hg, ai, oi, d0, m, ep, gp, gh)),
             (se.sparse_bwd_grads(hg, ai, oi, d0, m, ep, gp, gh)[:4],
              se.sparse_bwd_plain(hg, ai, oi, d0, m, ep, gp, gh)),
             (se.sparse_bwd2(hg, ai, oi, d0, m, ep, gp, gh, *c)[:6],
              se.sparse_bwd2_plain(hg, ai, oi, d0, m, ep, gp, gh, *c)[:6])]
    for got, want in pairs:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError):  # a device that is neither the CPU nor CUDA
        se.sparse_fwd(hg.to("meta"), ai.to("meta"), oi.to("meta"), d0.to("meta"), m.to("meta"),
                      {n: a.to("meta") for n, a in ep.items()})


# --------------------------------------------------------------------------
# The kernel model against the JAX Pallas op and against lax autodiff
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    rng = np.random.RandomState(0)
    B, N, F = 2, 48, 5
    h = rng.randn(B, N, F).astype(np.float32)
    x = (rng.randn(B, N, 3) * 2.5).astype(np.float32)
    m = SAKEModel(hidden_features=16, out_features=1, depth=2)
    params = jax.device_get(m.init(jax.random.PRNGKey(0), jnp.asarray(h[0]), jnp.asarray(x[0])))
    idx, nm = js.neighbor_list(jnp.asarray(x), 2.5, 16)
    return dict(kp=jax_params_from_linen(params), params=params, h=h, x=x, idx=idx, m=nm)


def _tp(model, grad=False):
    tp = model_params_from_linen(model["params"])
    for a in flat_params(tp):
        a.requires_grad_(grad)
    return tp


@pytest.mark.parametrize("update", [True, False, (True, False)])
def test_kernel_model_forward_matches_jax_interpret(model, update):
    kp, h, x, idx, m = (model[k] for k in ("kp", "h", "x", "idx", "m"))
    v = np.random.RandomState(4).randn(*x.shape).astype(np.float32) * 0.1
    oj, xj, vj = jse.sparse_kernel_model_forward(kp, jnp.asarray(h), jnp.asarray(x), idx, m,
                                                 jnp.asarray(v), update=list(update) if
                                                 isinstance(update, tuple) else update,
                                                 block_rows=8, interpret=True)
    ot, xt, vt = se.sparse_kernel_model_forward(
        _tp(model), t(h), t(x), t(idx), t(m), t(v),
        update=list(update) if isinstance(update, tuple) else update, block_rows=8)
    for a, b in ((ot, oj), (xt, xj), (vt, vj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("case", ["open", "node_mask_pbc"])
def test_kernel_energy_forces_match_jax_interpret(model, case):
    kp, h, x = (model[k] for k in ("kp", "h", "x"))
    nm, box = None, None
    if case == "node_mask_pbc":
        nm = (np.random.RandomState(3).rand(*x.shape[:2]) > 0.25).astype(np.float32)
        box = (6.0, 6.0, 6.0)
        x = (x % 6.0).astype(np.float32)
    idx, m = js.neighbor_list(jnp.asarray(x), 2.5, 16, box=box,
                              node_mask=None if nm is None else jnp.asarray(nm))
    ej, fj = jse.make_sparse_kernel_energy_forces(
        jnp.asarray(h), node_mask=None if nm is None else jnp.asarray(nm), box=box,
        block_rows=8, edge_matmul_dtype=None, interpret=True)(kp, jnp.asarray(x), idx, m)
    et, ft = se.make_sparse_kernel_energy_forces(
        t(h), node_mask=None if nm is None else t(nm), box=box, block_rows=8)(
        _tp(model), t(x), t(idx), t(m))
    assert not et.requires_grad and not ft.requires_grad
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), **TOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **F_TOL)


def _leaf_errors(got, want_tree):
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    errs = []
    for a, b in zip(got, want):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        errs.append(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))
    return errs


@pytest.mark.parametrize("update", [False, True])
def test_energy_loss_gradients_match_jax_lax(model, update):
    kp, h, x, idx, m = (model[k] for k in ("kp", "h", "x", "idx", "m"))
    e_t = np.asarray([3.0, -1.0], np.float32)

    def lax_loss(p):
        out, _, _ = js.sparse_model_forward(p, jnp.asarray(h), jnp.asarray(x), idx, m,
                                            update=update)
        return jnp.abs(out.sum(axis=(-2, -1)) - e_t).mean()

    lj, gj = jax.jit(jax.value_and_grad(lax_loss))(kp)
    tp = _tp(model, grad=True)
    lt = se.make_sparse_kernel_energy_loss(t(h), update=update, block_rows=8)(
        tp, t(x), t(idx), t(m), t(e_t))
    gt = torch.autograd.grad(lt, flat_params(tp), allow_unused=True)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert max(_leaf_errors(gt, gj)) < GRAD_REL


def test_force_loss_gradients_match_jax_lax(model):
    kp, h, x, idx, m = (model[k] for k in ("kp", "h", "x", "idx", "m"))
    rng = np.random.RandomState(5)
    f_t = rng.randn(*x.shape).astype(np.float32)
    e_t = np.asarray([3.0, -1.0], np.float32)

    def lax_loss(p):
        def e_sum(x_):
            out, _, _ = js.sparse_model_forward(p, jnp.asarray(h), x_, idx, m, update=False)
            e_b = out.sum(axis=(-2, -1))
            return e_b.sum(), e_b

        (_, e_b), neg_f = jax.value_and_grad(e_sum, has_aux=True)(jnp.asarray(x))
        return jnp.abs(-neg_f - f_t).mean() + 1e-3 * jnp.abs(e_b - e_t).mean()

    lj, gj = jax.jit(jax.value_and_grad(lax_loss))(kp)
    tp = _tp(model, grad=True)
    before = (se.sparse_bwd.launches, se.sparse_bwd2.launches)
    lt = se.make_sparse_kernel_force_loss(t(h), block_rows=8, bn2=4)(
        tp, t(x), t(idx), t(m), t(f_t), t(e_t))
    gt = torch.autograd.grad(lt, flat_params(tp), allow_unused=True)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert max(_leaf_errors(gt, gj)) < GRAD_REL
    assert (se.sparse_bwd.launches, se.sparse_bwd2.launches) == before  # CPU: plain


def test_edge_leaf_gradient_is_true_or_raises(model):
    """Where the JAX op returns zero leaf cotangents, the port raises. The
    guard asks the autograd engine through the private
    ``torch._C._will_engine_execute_node``; this test fails if a torch
    upgrade takes it away."""
    h, x, idx, m = (t(model[k]) for k in ("h", "x", "idx", "m"))
    tp = _tp(model, grad=True)
    leaves = flat_params(tp)
    # the evaluation op (param_grads=False): x gets its gradient, the leaves raise
    xg = x.clone().requires_grad_(True)
    out, _, _ = se.sparse_kernel_model_forward(tp, h, xg, idx, m)
    (gx,) = torch.autograd.grad(out.sum(), xg, retain_graph=True)
    assert torch.isfinite(gx).all() and float(gx.abs().max()) > 0
    with pytest.raises(RuntimeError, match="param_grads"):
        torch.autograd.grad(out.sum(), leaves, allow_unused=True)
    # the force-loss op: its create_graph (force) pass does not give the leaves
    # their gradient; asking for it raises
    xg = x.clone().requires_grad_(True)
    out, _, _ = se.sparse_kernel_model_forward(tp, h, xg, idx, m, update=False, order2=True)
    with pytest.raises(RuntimeError, match="create_graph"):
        torch.autograd.grad(out.sum(), [xg, *leaves], create_graph=True, allow_unused=True)
    # the first-order training op cannot be differentiated twice
    out, _, _ = se.sparse_kernel_model_forward(tp, h, xg, idx, m, update=False,
                                               param_grads=True)
    with pytest.raises(RuntimeError, match="order2"):
        torch.autograd.grad(out.sum(), xg, create_graph=True)
    with pytest.raises(NotImplementedError, match="f32"):
        se.sparse_kernel_model_forward(tp, h, x, idx, m, edge_matmul_dtype=torch.bfloat16)


@pytest.mark.gpu
def test_kernels_match_plain_on_card(edge):
    """On a card each wrapper launches its kernel (its count moves) and
    agrees with its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cpu = [t(edge[k]) for k in ("hg", "ai", "oi", "d0", "m")]
    ep_c = {n: t(a) for n, a in edge["ep"].items()}
    g_c = [t(edge["gp"]), t(edge["gh"])]
    c_c = [t(a) for a in edge["c"]]
    gpu = [a.to(dev) for a in cpu]
    ep_g = {n: a.to(dev) for n, a in ep_c.items()}
    g_g, c_g = [a.to(dev) for a in g_c], [a.to(dev) for a in c_c]
    before = se.sparse_bwd2.launches
    got = se.sparse_bwd2(*gpu, ep_g, *g_g, *c_g)
    want = se.sparse_bwd2(*cpu, ep_c, *g_c, *c_c)
    assert se.sparse_bwd2.launches == before + 1
    for a, b in zip(got[:6], want[:6]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    for n in se.EDGE_LEAVES:
        np.testing.assert_allclose(got[6][n].cpu().numpy(), want[6][n].numpy(), rtol=1e-4,
                                   atol=1e-5)
