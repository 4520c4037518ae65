"""The port's MD17 task against the JAX package: the serving slice (aspirin
E + F, colored, through ``tasks/md17.make_energy_force_fn`` -> ``SAKEModel``
-> ``kernels/dispatch``, plain K1/K2 stacks on the CPU, vs the JAX linen
path), force-loss training (one step of each branch, the kernel branch in
both modes, against the JAX ``make_step_fn`` on its plain branch, and ``run``
end to end) and the task registry against the JAX one.

Tolerances: serving ``rtol=2e-4, atol=2e-5``; a training step's loss
``rtol=1e-4`` and its updated parameters ``rtol=1e-5, atol=1e-6`` (one adam
step at lr 1e-3 moves each weight by about lr, whose sign is the
gradient's, so the gradients' f32 differences appear at 1e-3 of lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.data.md17 import load_md17 as jax_load_md17
from sake_tpu.data.md17 import synthesize_md17 as jax_synthesize
from sake_tpu.tasks.md17 import MD17Config as JaxMD17Config
from sake_tpu.tasks.md17 import make_energy_force_fn as jax_make_ef
from sake_tpu.tasks.md17 import make_model as jax_make_model
from sake_tpu.tasks.md17 import make_step_fn as jax_make_step_fn
from sake_tpu.train import TrainState as JaxTrainState
from sake_tpu.train import make_optimizer as jax_make_optimizer
from sake_tpu_torch.data.md17 import ASPIRIN_Z, MD17_Z, load_md17, synthesize_md17
from sake_tpu_torch.kernels.adapter import (
    linen_tree,
    load_linen_params,
    model_params_from_linen,
)
from sake_tpu_torch.kernels.functional import flat_params
from sake_tpu_torch.tasks import md17 as task
from sake_tpu_torch.tasks.md17 import (
    MD17Config,
    make_energy_force_fn,
    make_model,
    species_onehot,
)
from sake_tpu_torch.train import TrainState, make_optimizer, tree_leaves

TOL = dict(rtol=2e-4, atol=2e-5)
STEP_LOSS_RTOL = 1e-4
STEP_PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("molecule", ["aspirin", "uracil"])
def test_data_matches_jax(molecule):
    a = load_md17(molecule, n_samples=6)
    b = jax_load_md17(molecule, n_samples=6)
    for name in ("x", "e", "f", "z"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(MD17_Z["aspirin"], ASPIRIN_Z)


def test_species_onehot_reproduces_jax_quirk():
    z = ASPIRIN_Z
    got = species_onehot(z, int(z.max())).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.one_hot(z, z.max())))
    assert not got[z == 8].any()  # oxygens: out of range -> all-zero rows
    assert got[z == 6, 6].all() and got[z == 1, 1].all()


def test_slice_matches_jax_linen_path():
    """B = 5 aspirin conformations (not a multiple of 8), hidden 16, depth 2,
    colored with the data's e_mean/e_std."""
    data = jax_synthesize(n_samples=9, seed=3)
    x = data.x[:5]
    e_mean, e_std = float(data.e.mean()), float(data.e.std())
    species_j = jax.nn.one_hot(data.z, data.z.max())
    cfg_j = JaxMD17Config(hidden_features=16, depth=2)
    model_j = jax_make_model(cfg_j)
    params = model_j.init(jax.random.PRNGKey(7),
                          jnp.broadcast_to(species_j, (x.shape[1], species_j.shape[-1])),
                          jnp.asarray(x[0]))
    e_ref, f_ref = jax_make_ef(model_j, species_j, e_mean, e_std)(params, jnp.asarray(x))

    species = species_onehot(data.z, int(data.z.max()))
    model = make_model(MD17Config(hidden_features=16, depth=2), in_features=species.shape[-1],
                       device="cpu")
    load_linen_params(model, jax.tree.map(np.asarray, params))
    e, f = make_energy_force_fn(model, species, e_mean, e_std)(torch.as_tensor(x))
    assert e.shape == (5, 1) and f.shape == (5, 21, 3)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), **TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), **TOL)


def test_seeded_init_is_reproducible():
    data = synthesize_md17(n_samples=2, seed=0)
    species = species_onehot(data.z, int(data.z.max()))
    cfg = MD17Config(hidden_features=8, depth=2)
    outs = []
    for _ in range(2):
        model = make_model(cfg, species.shape[-1], device="cpu",
                           generator=torch.Generator().manual_seed(11))
        outs.append(make_energy_force_fn(model, species, 0.0, 1.0)(torch.as_tensor(data.x)))
    for a, b in zip(*outs):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means CUDA: without a card the entry points raise
    instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_model(MD17Config(hidden_features=8, depth=1), 4)


@pytest.mark.parametrize("use_kernel_ef,aug_mode", [(False, "fused"), (True, "shared"),
                                                    (True, "fused")])
def test_train_step_matches_jax_plain_branch(use_kernel_ef, aug_mode):
    """One training step from the same linen init and batch: the port's
    plain branch (double autograd through the functional model) or its
    kernel branch (``make_ef_train2`` in shared or in the default fused
    mode, plain stacks on the CPU) against the JAX plain branch's
    ``make_step_fn``: the loss, and every parameter after the adam update."""
    data = jax_synthesize(n_samples=12, seed=4)
    # an odd batch: the readout bias's gradient is a sum of E-MAE signs, which
    # cancels exactly at an even count and leaves f32 noise for adam to scale
    x, e, f = data.x[:5], data.e[:5], data.f[:5]
    e_mean, e_std = float(data.e.mean()), float(data.e.std())
    species_j = jax.nn.one_hot(data.z, data.z.max())
    model_j = jax_make_model(JaxMD17Config(hidden_features=16, depth=2))
    params = model_j.init(jax.random.PRNGKey(3),
                          jnp.broadcast_to(species_j, (x.shape[1], species_j.shape[-1])),
                          jnp.asarray(x[0]))
    step_j = jax_make_step_fn(jax_make_ef(model_j, species_j, e_mean, e_std), 1e-3)
    state_j = JaxTrainState.create(apply_fn=model_j.apply, params=params,
                                   tx=jax_make_optimizer(1e-3))
    batch_j = {"x": jnp.asarray(x), "e": jnp.asarray(e), "f": jnp.asarray(f)}
    state_j, loss_j = step_j(state_j, batch_j)
    want = jax.tree.map(np.asarray, state_j.params)

    cfg = MD17Config(hidden_features=16, depth=2, use_kernel_ef=use_kernel_ef,
                     aug_mode=aug_mode)
    species = species_onehot(data.z, int(data.z.max()))
    model = make_model(cfg, species.shape[-1], device="cpu")
    load_linen_params(model, jax.tree.map(np.asarray, params))
    prm, ef_fn, _ = task.make_branch(cfg, model, species, e_mean, e_std)
    state = TrainState.create(params=prm, tx=make_optimizer(1e-3))
    state, loss = task.make_step_fn(ef_fn, 1e-3)(state, {k: torch.as_tensor(v) for k, v in
                                                         dict(x=x, e=e, f=f).items()})
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=STEP_LOSS_RTOL)
    if use_kernel_ef:
        got, ref = flat_params(state.params), flat_params(model_params_from_linen(want))
    else:
        tree = linen_tree(model)
        got = tree_leaves(tree)
        ref = tree_leaves(jax.tree.map(torch.as_tensor, _pick(want["params"], tree)))
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), err_msg=f"leaf {i}",
                                   **STEP_PARAM_TOL)


def _pick(tree, like):
    """The entries of ``tree`` at the keys of ``like``, nested."""
    return {k: _pick(tree[k], v) if isinstance(v, dict) else tree[k] for k, v in like.items()}


@pytest.mark.parametrize("use_kernel_ef,aug_mode", [(False, "fused"), (True, "shared"),
                                                    (True, "fused")])
def test_run_trains_and_reports_kcal_mae(use_kernel_ef, aug_mode):
    """``run`` end to end at a tiny size: the loss stays finite and the E and
    F bootstrap MAE come back in kcal/mol."""
    cfg = MD17Config(hidden_features=8, depth=1, n_heads=2, n_train=8, n_valid=4, n_epochs=2,
                     epochs_per_block=1, use_kernel_ef=use_kernel_ef, aug_mode=aug_mode)
    logs = []

    class Log:
        def log(self, step, **m):
            logs.append((step, m))

    state, res = task.run(cfg, Log(), device="cpu")
    assert state.step == 4 and [s for s, _ in logs] == [2, 4, 4]
    assert all(np.isfinite(m["train_loss"]) for _, m in logs[:2])
    for k in ("e_mae_kcalmol", "f_mae_kcalmol"):
        assert np.isfinite(res[k]) and res[k] > 0
        assert res[k.replace("kcalmol", "ci")][0] <= res[k.replace("kcalmol", "ci")][1]


@pytest.mark.parametrize("kw", [dict(use_kernel_ef=True, aug_mode="resid"),
                                dict(checkpoint_dir="ckpt")])
def test_run_rejects_unported_options(kw):
    with pytest.raises(NotImplementedError):
        task.run(MD17Config(hidden_features=8, depth=1, **kw), device="cpu")


def test_registry_md17_kernel_is_the_fused_kernel_branch():
    """``get_workload("md17_kernel")`` gives the port's ``run`` and the JAX
    preset: the kernel branch in the config's default fused mode."""
    from sake_tpu.tasks.registry import get_workload as jax_get_workload
    from sake_tpu_torch.tasks.registry import get_workload

    run, cfg = get_workload("md17_kernel")
    assert run is task.run and isinstance(cfg, MD17Config)
    assert cfg.use_kernel_ef and cfg.aug_mode == "fused"
    _, cfg_j = jax_get_workload("md17_kernel")
    assert (cfg_j.use_kernel_ef, cfg_j.aug_mode) == (cfg.use_kernel_ef, cfg.aug_mode)
    _, cfg2 = get_workload("md17_kernel", n_epochs=2, molecule="uracil")
    assert (cfg2.n_epochs, cfg2.molecule, cfg2.aug_mode) == (2, "uracil", "fused")


@pytest.mark.parametrize("name", ["md17", "md17_traj", "md17_kernel", "qm9", "qm9_tpu",
                                  "qm9_kernel", "qm9_kernel_bucketed"])
def test_registry_builds_every_ported_entry_as_jax(name):
    """Every entry of a ported task builds the JAX preset's values on the
    port's config (the fields both have)."""
    import dataclasses

    from sake_tpu.tasks.registry import get_workload as jax_get_workload
    from sake_tpu_torch.tasks.registry import get_workload

    _, cfg = get_workload(name)
    _, cfg_j = jax_get_workload(name)
    assert type(cfg).__name__ == type(cfg_j).__name__
    shared = {f.name for f in dataclasses.fields(cfg)} & {f.name for f in dataclasses.fields(cfg_j)}
    assert {"seed", "depth"} <= shared
    for f in sorted(shared):
        assert getattr(cfg, f) == getattr(cfg_j, f), f


def test_registry_lists_jax_and_rejects_the_rest():
    from sake_tpu.tasks.registry import list_workloads as jax_list
    from sake_tpu_torch.tasks import registry

    assert registry.list_workloads() == jax_list()
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        registry.get_workload("oc20_sparse_kernel")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        registry.get_workload("dw4")
    with pytest.raises(KeyError):
        registry.get_workload("md18")
    assert registry.parse_overrides(["molecule=ethanol", "n_epochs=3"]) == dict(
        molecule="ethanol", n_epochs=3)
