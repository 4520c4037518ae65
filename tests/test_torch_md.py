"""The port's MD rollouts (``sake_tpu_torch/md.py``) and the sparse tasks
(``tasks/sparse_md.py``, ``tasks/sparse_train.py``) against the JAX package.

Rollouts run the same seeded weights and inputs through both packages for a
few steps, with the plain sparse force field on each side; neighbour lists
may order their slots differently, which reorders sums only. Tolerances:
positions and velocities ``rtol=1e-4, atol=1e-5``, energies ``rtol=1e-4,
atol=1e-4``; overflow counts exactly. ``_synthesize_box`` is compared bit
for bit. The tasks run tiny configurations on the CPU (their weights come
from the port's seeded init, so only their keys and behaviour are compared
with JAX).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu import md as jmd
from sake_tpu import sparse as js
from sake_tpu.kernels import model_params_from_linen as jax_params_from_linen
from sake_tpu.kernels.functional import model_forward as jax_model_forward
from sake_tpu.models import SAKEModel
from sake_tpu_torch import md as tmd
from sake_tpu_torch import sparse as ts
from sake_tpu_torch.kernels.adapter import model_params_from_linen
from sake_tpu_torch.kernels.functional import model_forward

X_TOL = dict(rtol=1e-4, atol=1e-5)
E_TOL = dict(rtol=1e-4, atol=1e-4)
SPARSE_MD_KEYS = {"steps_per_s", "atom_steps_per_s", "compile_s", "energy_first",
                  "energy_last", "energy_drift_abs", "finite", "max_nbr_overflow", "n_atoms"}
SPARSE_TRAIN_KEYS = {"first_loss", "final_loss", "loss_decreased", "finite", "steps_per_s",
                     "atom_updates_per_s", "wall_s"}


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def system():
    rng = np.random.RandomState(5)
    B, N, F = 1, 96, 4
    h = rng.randn(B, N, F).astype(np.float32)
    x0 = (rng.rand(B, N, 3) * 9.0).astype(np.float32)
    v0 = (rng.randn(B, N, 3) * 0.05).astype(np.float32)
    model = SAKEModel(hidden_features=8, out_features=1, depth=2)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(h[0]),
                                       jnp.asarray(x0[0])))
    return dict(kp=jax_params_from_linen(params), tp=model_params_from_linen(params), h=h,
                x0=x0, v0=v0, masses=np.full((N,), 2.0, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_velocity_verlet_matches_jax(system):
    s = system
    x0 = s["x0"][:, :16]
    idx, m = js.neighbor_list(jnp.asarray(x0), 1e3, 16)  # the complete graph
    efj = js.make_sparse_energy_forces(jnp.asarray(s["h"][:, :16]), update=False)
    eft = ts.make_sparse_energy_forces(t(s["h"][:, :16]), update=False)
    args = (1e-2, 6)
    xj, vj, ej = jax.jit(lambda p, x, v, ms: jmd.velocity_verlet_rollout(
        lambda p_, x_: efj(p_, x_, idx, m), p, x, v, ms, *args, sample_every=2))(
        s["kp"], jnp.asarray(x0), jnp.asarray(s["v0"][:, :16]), jnp.asarray(s["masses"][:16]))
    xt, vt, et = tmd.velocity_verlet_rollout(lambda p, x: eft(p, x, t(idx), t(m)), s["tp"],
                                             t(x0), t(s["v0"][:, :16]), t(s["masses"][:16]),
                                             *args, sample_every=2)
    assert xt.shape == xj.shape and et.shape == ej.shape
    _close(xt, xj, X_TOL)
    _close(vt, vj, X_TOL)
    _close(et, ej, E_TOL)


@pytest.mark.parametrize("case", ["allpairs_open", "pbc_cell_list", "open_cell_extent",
                                  "node_mask_overflow"])
def test_neighborlist_rollout_matches_jax(system, case):
    s = system
    box, nm = None, None
    kw = dict(cutoff=2.5, max_neighbors=32, rebuild_every=2, skin=0.3, with_overflow=True)
    if case == "pbc_cell_list":
        box = (9.0, 9.0, 9.0)
        kw.update(box=box, cell_capacity=32)
    elif case == "open_cell_extent":
        kw.update(cell_capacity=64, cell_extent=(9.0, 9.0, 9.0))
    elif case == "node_mask_overflow":
        nm = (np.random.RandomState(1).rand(1, s["x0"].shape[1]) > 0.2).astype(np.float32)
        kw.update(max_neighbors=3, node_mask=nm)
    hj, ht = jnp.asarray(s["h"]), t(s["h"])
    efj = js.make_sparse_energy_forces(hj, update=False, box=box,
                                       node_mask=None if nm is None else jnp.asarray(nm))
    eft = ts.make_sparse_energy_forces(ht, update=False, box=box,
                                       node_mask=None if nm is None else t(nm))
    kwj = dict(kw, node_mask=jnp.asarray(nm)) if nm is not None else kw
    kwt = dict(kw, node_mask=t(nm)) if nm is not None else kw
    outj = jax.jit(lambda p, x, v, ms: jmd.neighborlist_verlet_rollout(
        efj, p, x, v, ms, 5e-2, 6, **kwj))(s["kp"], jnp.asarray(s["x0"]),
                                           jnp.asarray(s["v0"]), jnp.asarray(s["masses"]))
    outt = tmd.neighborlist_verlet_rollout(eft, s["tp"], t(s["x0"]), t(s["v0"]),
                                           t(s["masses"]), 5e-2, 6, **kwt)
    assert len(outt) == 4
    _close(outt[0], outj[0], X_TOL)
    _close(outt[1], outj[1], X_TOL)
    _close(outt[2], outj[2], E_TOL)
    np.testing.assert_array_equal(outt[3].numpy(), np.asarray(outj[3]))
    if case == "node_mask_overflow":
        assert int(outt[3].max()) > 0
    else:
        assert int(outt[3].max()) == 0
    assert float((outt[0][-1] - t(s["x0"])).abs().max()) > 0  # the atoms moved


def test_neighborlist_rollout_guards(system):
    s = system
    ef = ts.make_sparse_energy_forces(t(s["h"]), update=False)
    args = (ef, s["tp"], t(s["x0"]), t(s["v0"]), t(s["masses"]), 1e-3, 2)
    with pytest.raises(ValueError, match="cell_capacity"):
        tmd.neighborlist_verlet_rollout(*args, cutoff=2.5, max_neighbors=8, cell_capacity=16)
    with pytest.raises(ValueError, match="not both"):
        tmd.neighborlist_verlet_rollout(*args, cutoff=2.5, max_neighbors=8, box=(9.0,) * 3,
                                        cell_capacity=16, cell_extent=(9.0,) * 3)
    out = tmd.neighborlist_verlet_rollout(*args, cutoff=2.5, max_neighbors=8, rebuild_every=2)
    assert len(out) == 3


def test_learned_integrator_matches_jax(system):
    s = system
    h, x0 = s["h"][:, :12], s["x0"][:, :12]
    rng = np.random.RandomState(2)
    model = SAKEModel(hidden_features=8, out_features=1, depth=2, update=True)
    params = jax.device_get(model.init(jax.random.PRNGKey(1), jnp.asarray(h[0]),
                                       jnp.asarray(x0[0])))
    v0 = (rng.randn(*x0.shape) * 0.1).astype(np.float32)
    xj, vj = jmd.learned_integrator_rollout(
        lambda p, h_, x, v: jax_model_forward(p, h_, x, v), jax_params_from_linen(params),
        jnp.asarray(h), jnp.asarray(x0), jnp.asarray(v0), 3)
    xt, vt = tmd.learned_integrator_rollout(
        lambda p, h_, x, v: model_forward(p, h_, x, v), model_params_from_linen(params), t(h),
        t(x0), t(v0), 3)
    _close(xt, xj, X_TOL)
    _close(vt, vj, X_TOL)
    xt0, _ = tmd.learned_integrator_rollout(
        lambda p, h_, x, v: model_forward(p, h_, x, v), model_params_from_linen(params), t(h),
        t(x0), None, 1)
    assert xt0.shape == (1, *x0.shape)


@pytest.mark.parametrize("periodic", [False, True])
def test_synthesize_box_matches_jax_bit_for_bit(periodic):
    from sake_tpu.tasks.sparse_md import SparseMDConfig as JaxCfg
    from sake_tpu.tasks.sparse_md import _synthesize_box as jax_box
    from sake_tpu_torch.tasks.sparse_md import SparseMDConfig, _synthesize_box

    kw = dict(n_atoms=300, periodic=periodic, seed=3)
    hj, xj, vj, bj = jax_box(JaxCfg(**kw))
    ht, xt, vt, bt = _synthesize_box(SparseMDConfig(**kw), "cpu")
    for a, b in ((ht, hj), (xt, xj), (vt, vj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if periodic:
        np.testing.assert_array_equal(np.asarray(bt, np.float32), np.asarray(bj))
    else:
        assert bt is None and bj is None


@pytest.mark.parametrize("name", ["sparse_md", "sparse_md_kernel", "sparse_train",
                                  "sparse_train_kernel"])
def test_registry_builds_the_sparse_entries_as_jax(name):
    from sake_tpu.tasks.registry import get_workload as jax_get_workload
    from sake_tpu_torch.tasks import sparse_md, sparse_train
    from sake_tpu_torch.tasks.registry import get_workload

    run, cfg = get_workload(name)
    _, cfg_j = jax_get_workload(name)
    assert run is (sparse_md.run if name.startswith("sparse_md") else sparse_train.run)
    assert type(cfg).__name__ == type(cfg_j).__name__
    assert cfg.use_kernel == name.endswith("_kernel")
    fields = {f.name for f in dataclasses.fields(cfg)}
    assert fields == {f.name for f in dataclasses.fields(cfg_j)}
    for f in sorted(fields):
        assert getattr(cfg, f) == getattr(cfg_j, f), f


TINY_MD = dict(n_atoms=64, hidden_features=8, depth=1, n_steps=4, rebuild_every=2,
               max_neighbors=16, cutoff=2.0, skin=0.5)


class _Log:
    def __init__(self):
        self.records = []

    def log(self, step, **kw):
        self.records.append((step, kw))


@pytest.mark.parametrize("kw", [dict(use_kernel=False), dict(use_kernel=True),
                                dict(use_kernel=True, periodic=True, cell_capacity=16)])
def test_sparse_md_run_tiny_on_cpu(kw):
    from sake_tpu_torch.tasks.sparse_md import SparseMDConfig, run

    log = _Log()
    (xs, vs, es), res = run(SparseMDConfig(**TINY_MD, **kw), log, device="cpu")
    assert set(res) == SPARSE_MD_KEYS
    assert res["finite"] and np.isfinite(es).all() and xs.shape == (2, 1, 64, 3)
    assert res["max_nbr_overflow"] == 0 and res["n_atoms"] == 64
    assert log.records and log.records[-1][0] == 4


def test_sparse_md_kernel_matches_plain_and_rejects_checkpoints():
    from sake_tpu_torch.tasks.sparse_md import SparseMDConfig, run

    (xk, _, ek), _ = run(SparseMDConfig(**TINY_MD, use_kernel=True), _Log(), device="cpu")
    (xp, _, ep), _ = run(SparseMDConfig(**TINY_MD), _Log(), device="cpu")
    np.testing.assert_allclose(xk.numpy(), xp.numpy(), **X_TOL)
    np.testing.assert_allclose(ek, ep, **E_TOL)
    with pytest.raises(NotImplementedError, match='Queue 1, "Checkpoints"'):
        run(SparseMDConfig(**TINY_MD, checkpoint_dir="/nonexistent"), _Log(), device="cpu")


def test_sparse_train_run_tiny_on_cpu():
    from sake_tpu_torch.tasks.sparse_train import SparseTrainConfig, run

    kw = dict(n_atoms=48, hidden_features=8, depth=1, max_neighbors=16, n_steps=6,
              steps_per_block=3, learning_rate=1e-2)
    results = {}
    for use_kernel in (False, True):
        log = _Log()
        _, res = run(SparseTrainConfig(use_kernel=use_kernel, **kw), log, device="cpu")
        assert set(res) == SPARSE_TRAIN_KEYS
        assert res["finite"] and res["loss_decreased"]
        assert [s for s, _ in log.records] == [3, 6]
        results[use_kernel] = res
    np.testing.assert_allclose(results[True]["first_loss"], results[False]["first_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(results[True]["final_loss"], results[False]["final_loss"],
                               rtol=1e-3)
