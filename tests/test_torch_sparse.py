"""The port's cutoff-sparse geometry and plain sparse model against the JAX
package (``sake_tpu/sparse.py``).

Neighbour lists agree as sets of live ``(batch, receiver, sender)`` pairs
(``lax.top_k`` and ``torch.topk`` order ties differently and masked slots
hold arbitrary indices), and overflow counts exactly. The model tests feed
the JAX ``idx``/``nbr_mask`` to the port. Tolerances: the model and energies
``rtol=2e-4, atol=2e-5``, forces ``rtol=5e-4, atol=5e-5``; the port's sparse
model against its own masked dense model ``rtol=5e-5, atol=5e-6`` (the JAX
``test_sparse.py`` tolerance for the same contract).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu import sparse as js
from sake_tpu.kernels import model_params_from_linen as jax_params_from_linen
from sake_tpu.models import SAKEModel
from sake_tpu_torch import sparse as ts
from sake_tpu_torch.kernels.adapter import model_params_from_linen
from sake_tpu_torch.kernels.functional import model_forward

TOL = dict(rtol=2e-4, atol=2e-5)
F_TOL = dict(rtol=5e-4, atol=5e-5)
DENSE_TOL = dict(rtol=5e-5, atol=5e-6)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    B, N, F = 2, 48, 5
    h = rng.randn(B, N, F).astype(np.float32)
    x = (rng.randn(B, N, 3) * 2.5).astype(np.float32)
    model = SAKEModel(hidden_features=16, out_features=1, depth=2)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(h[0]),
                                       jnp.asarray(x[0])))
    return jax_params_from_linen(params), model_params_from_linen(params), h, x


def pair_set(idx, m):
    idx, m = np.asarray(idx), np.asarray(m)
    b, i, k = np.nonzero(m > 0)
    return set(zip(b.tolist(), i.tolist(), idx[b, i, k].tolist()))


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("case", ["plain", "node_mask_ragged_chunk", "pbc", "overflow"])
def test_neighbor_list_matches_jax_as_sets(setup, case):
    _, _, _, x = setup
    rng = np.random.RandomState(1)
    kw, cutoff, K = {}, 2.0, 16
    if case == "node_mask_ragged_chunk":
        kw = dict(node_mask=(rng.rand(*x.shape[:2]) > 0.3).astype(np.float32), row_chunk=7)
    elif case == "pbc":
        box = (6.0, 7.0, 6.5)
        x = (x % np.asarray(box, np.float32)).astype(np.float32)
        kw, cutoff = dict(box=box), 2.5
    elif case == "overflow":
        cutoff, K = 3.0, 4
        kw = dict(row_chunk=16)
    ij, mj, oj = js.neighbor_list(jnp.asarray(x), cutoff, K, with_overflow=True,
                                  **{k: (jnp.asarray(v) if k == "node_mask" else v)
                                     for k, v in kw.items()})
    it, mt, ot = ts.neighbor_list(t(x), cutoff, K, with_overflow=True,
                                  **{k: (t(v) if k == "node_mask" else v) for k, v in kw.items()})
    assert it.shape == ij.shape and mt.shape == mj.shape
    assert pair_set(it, mt) == pair_set(ij, mj)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    if case == "overflow":
        assert int(ot.max()) > 0
    assert int(it.min()) >= 0 and int(it.max()) < x.shape[1]


@pytest.mark.parametrize("case", ["periodic", "periodic_node_mask", "open_grid", "small_box",
                                  "capacity_overflow", "k_truncation"])
def test_cell_neighbor_list_matches_jax_as_sets(case):
    rng = np.random.RandomState(3)
    B, N, K, cutoff, cap = 2, 129, 32, 3.0, 64
    box = (12.0, 15.0, 13.0)
    x = (rng.rand(B, N, 3) * np.asarray(box) * 3.0 - 7.0).astype(np.float32)  # wraps
    kw = dict(box=box)
    if case == "periodic_node_mask":
        kw["node_mask"] = (rng.rand(B, N) > 0.2).astype(np.float32)
    elif case == "open_grid":
        x = (rng.rand(B, N, 3) * np.asarray(box)).astype(np.float32)
        x[rng.rand(B, N) < 0.15] += np.asarray([4.0, -3.0, 5.0], np.float32)  # off the grid
        kw["periodic"] = False
    elif case == "small_box":
        cutoff = 6.0  # 2 cells a side: the all-pairs fallback
    elif case == "capacity_overflow":
        cap = 1
    elif case == "k_truncation":
        K = 2
    kj = {k: (jnp.asarray(v) if k == "node_mask" else v) for k, v in kw.items()}
    kt = {k: (t(v) if k == "node_mask" else v) for k, v in kw.items()}
    ij, mj, oj = js.cell_neighbor_list(jnp.asarray(x), cutoff, K, cell_capacity=cap,
                                       with_overflow=True, **kj)
    it, mt, ot = ts.cell_neighbor_list(t(x), cutoff, K, cell_capacity=cap, with_overflow=True,
                                       **kt)
    assert pair_set(it, mt) == pair_set(ij, mj)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    if case in ("capacity_overflow", "k_truncation"):
        assert int(ot.max()) > 0
    elif case != "small_box":  # the fallback's cutoff 6 holds more than K senders
        assert int(ot.max()) == 0


def test_densify_gather_and_min_image_match_jax(setup):
    _, _, _, x = setup
    idx, m = js.neighbor_list(jnp.asarray(x), 2.5, 16)
    np.testing.assert_array_equal(ts.densify_neighbors(t(idx), t(m), x.shape[1]).numpy(),
                                  np.asarray(js.densify_neighbors(idx, m, x.shape[1])))
    np.testing.assert_array_equal(ts._gather(t(x), t(idx)).numpy(),
                                  np.asarray(js._gather(jnp.asarray(x), idx)))
    d = np.asarray([[2.5, -3.5, 0.1], [7.0, -7.0, 3.25]], np.float32)  # halves round to even
    box = (5.0, 7.0, 6.5)
    np.testing.assert_array_equal(ts._min_image(t(d), box).numpy(),
                                  np.asarray(js._min_image(jnp.asarray(d), jnp.asarray(box))))


@pytest.mark.parametrize("case", ["update", "mixed_schedule_remat", "pbc"])
def test_sparse_model_forward_matches_jax(setup, case):
    kp, tp, h, x = setup
    kw, box = {}, None
    if case == "mixed_schedule_remat":
        kw = dict(update=[True, False], remat=True)
    elif case == "pbc":
        box = (6.0, 6.0, 6.0)
        x = (x % 6.0).astype(np.float32)
        kw = dict(box=box)
    idx, m = js.neighbor_list(jnp.asarray(x), 2.5, 16, box=box)
    v = np.random.RandomState(2).randn(*x.shape).astype(np.float32) * 0.1
    oj, xj, vj = js.sparse_model_forward(kp, jnp.asarray(h), jnp.asarray(x), idx, m,
                                         jnp.asarray(v), **kw)
    ot, xt, vt = ts.sparse_model_forward(tp, t(h), t(x), t(idx), t(m), t(v), **kw)
    for a, b in ((ot, oj), (xt, xj), (vt, vj)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("case", ["open", "node_mask_pbc"])
def test_sparse_energy_forces_match_jax(setup, case):
    kp, tp, h, x = setup
    nm, box = None, None
    if case == "node_mask_pbc":
        nm = (np.random.RandomState(3).rand(*x.shape[:2]) > 0.25).astype(np.float32)
        box = (6.0, 6.0, 6.0)
        x = (x % 6.0).astype(np.float32)
    idx, m = js.neighbor_list(jnp.asarray(x), 2.5, 16, box=box,
                              node_mask=None if nm is None else jnp.asarray(nm))
    ej, fj = js.make_sparse_energy_forces(
        jnp.asarray(h), box=box, node_mask=None if nm is None else jnp.asarray(nm))(
        kp, jnp.asarray(x), idx, m)
    et, ft = ts.make_sparse_energy_forces(t(h), box=box,
                                          node_mask=None if nm is None else t(nm))(
        tp, t(x), t(idx), t(m))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), **TOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **F_TOL)


def test_sparse_matches_port_masked_dense(setup):
    _, tp, h, x = setup
    idx, m = ts.neighbor_list(t(x), 2.5, 32)
    mask = ts.densify_neighbors(idx, m, x.shape[1])
    od, xd, vd = model_forward(tp, t(h), t(x), mask=mask)
    os_, xs, vs = ts.sparse_model_forward(tp, t(h), t(x), idx, m)
    for a, b in ((os_, od), (xs, xd), (vs, vd)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **DENSE_TOL)


def test_isolated_atoms_finite_and_f32_only(setup):
    _, tp, h, x = setup
    idx, m = ts.neighbor_list(t(x), 1e-4, 8)
    assert float(m.sum()) == 0.0
    out, xo, _ = ts.sparse_model_forward(tp, t(h), t(x), idx, m)
    assert torch.isfinite(out).all() and torch.isfinite(xo).all()
    with pytest.raises(NotImplementedError, match="f32"):
        ts.sparse_model_forward(tp, t(h), t(x), idx, m, matmul_dtype=torch.bfloat16)
