"""The port's QM9 training slice against the JAX package: the data module
(bit for bit), the graph property head, the bootstrap MAE, the optimizer
(against optax) and one training step of both of the port's branches
against the JAX plain ``QM9Model`` branch from the same linen init and the
same batch; then the task end to end on the CPU. On CPU tensors the kernel
branch runs the kernels' plain versions.

Tolerances: data bit for bit; optimizer parameters ``atol=1e-6`` (f32
arithmetic in a different order); the head and the loss ``rtol=1e-5``;
gradients through the stack ``rtol=2e-3, atol=2e-4`` and parameters after
one adamw step ``rtol=1e-5, atol=1e-6`` (the step moves each weight by at
most about the learning rate, 1e-4 here).
"""

from functools import reduce

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.data import qm9 as jax_qm9
from sake_tpu.models import GraphPropertyHead as JaxHead
from sake_tpu.tasks.qm9 import QM9Config as JaxQM9Config
from sake_tpu.tasks.qm9 import QM9Model as JaxQM9Model
from sake_tpu.train import TrainState as JaxTrainState
from sake_tpu.train import make_optimizer as jax_make_optimizer
from sake_tpu.train import warmup_cosine_schedule as jax_schedule
from sake_tpu.utils import bootstrap_mae as jax_bootstrap_mae
from sake_tpu_torch.data import qm9
from sake_tpu_torch.kernels.adapter import load_linen_params, model_params_from_linen
from sake_tpu_torch.kernels.resid_ef import flat_params
from sake_tpu_torch.models import GraphPropertyHead
from sake_tpu_torch.tasks import qm9 as task
from sake_tpu_torch.train import (
    TrainState,
    make_optimizer,
    notfinite_count,
    tree_leaves,
    warmup_cosine_schedule,
)
from sake_tpu_torch.train.metrics import MetricLogger
from sake_tpu_torch.utils import bootstrap_mae

STACK_TOL = dict(rtol=2e-3, atol=2e-4)
N_ATOMS = 9


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def test_data_matches_jax(tmp_path):
    a, b = qm9.synthesize_qm9(40, seed=5), jax_qm9.synthesize_qm9(40, seed=5)
    for name in ("charges", "x", "y"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(qm9.atomization_offsets(a.charges),
                                  jax_qm9.atomization_offsets(b.charges))
    for n in (40, 200_000):
        for s1, s2 in zip(qm9.dimenet_split(n), jax_qm9.dimenet_split(n)):
            np.testing.assert_array_equal(s1, s2)
    np.savez(tmp_path / "train.npz", charges=a.charges, positions=a.x, U0=a.y[:, 0])
    for kw in (dict(), dict(data_dir=str(tmp_path), target="U0")):
        got, want = qm9.load_qm9(n_samples=12, **kw), jax_qm9.load_qm9(n_samples=12, **kw)
        for name in ("charges", "x", "y"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_graph_property_head_matches_linen():
    rng = np.random.RandomState(0)
    h = rng.randn(3, 5, 8).astype(np.float32)
    mask = (rng.rand(3, 5) > 0.4).astype(np.float32)
    head_j = JaxHead(out_features=2, hidden_features=6)
    params = head_j.init(jax.random.PRNGKey(0), jnp.asarray(h))
    want = head_j.apply(params, jnp.asarray(h), mask=jnp.asarray(mask))
    head = GraphPropertyHead(8, 2, 6, device="cpu")
    load_linen_params(head, _np_tree(params))
    got = head(torch.as_tensor(h), mask=torch.as_tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    bare = GraphPropertyHead(8, use_mlp=False, device="cpu")
    np.testing.assert_allclose(bare(torch.as_tensor(h)).numpy(), h.sum(axis=1), rtol=1e-6)


def test_bootstrap_mae_matches_jax_mae():
    rng = np.random.RandomState(1)
    x, y = rng.randn(50).astype(np.float32), rng.randn(50).astype(np.float32)
    got = bootstrap_mae(torch.as_tensor(x), torch.as_tensor(y))
    want = jax_bootstrap_mae(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)  # resamples differ by design
    assert got[1] <= got[2]


@pytest.mark.parametrize("kind", ["adam", "adamw_schedule", "clip_zero_nans"])
def test_optimizer_matches_optax(kind):
    """A few steps, one of them with a non-finite gradient (skipped, and
    counted), against the JAX package's optax chain."""
    rng = np.random.RandomState(2)
    shapes = {"a": (3, 4), "b": (4,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    lr_j, lr_t = 1e-2, 1e-2
    kw = {}
    if kind == "adamw_schedule":
        lr_j, lr_t = jax_schedule(1e-2, 6), warmup_cosine_schedule(1e-2, 6)
        kw = dict(weight_decay=1e-2)
    elif kind == "clip_zero_nans":
        kw = dict(clip_norm=0.5, zero_nans=True)
    tx_j = jax_make_optimizer(lr_j, **kw, if_finite_patience=1)
    st_j = JaxTrainState.create(apply_fn=None, params=jax.tree.map(jnp.asarray, params),
                                tx=tx_j)
    st_t = TrainState.create(params={k: torch.as_tensor(v.copy()) for k, v in params.items()},
                             tx=make_optimizer(lr_t, **kw, if_finite_patience=1))
    for i in range(6):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        if i == 2:
            grads["a"][0, 0] = np.inf  # skipped (zero_nans does not touch inf)
        if i == 4:
            grads["b"][1] = np.nan  # zeroed by zero_nans, else skipped
        st_j = st_j.apply_gradients(jax.tree.map(jnp.asarray, grads))
        st_t = st_t.apply_gradients({k: torch.as_tensor(v) for k, v in grads.items()})
        for k in shapes:
            np.testing.assert_allclose(st_t.params[k].numpy(), np.asarray(st_j.params[k]),
                                       rtol=0, atol=1e-6, err_msg=f"step {i} {k}")
        assert notfinite_count(st_t.opt_state) == int(st_j.opt_state.notfinite_count)
        assert st_t.step == int(st_j.step)


def _small_batch():
    data = qm9.synthesize_qm9(8, seed=4)
    data = qm9.QM9Data(charges=data.charges[:, :N_ATOMS], x=data.x[:, :N_ATOMS], y=data.y)
    data.charges[1, 5:] = 0  # a molecule with padding
    data.x[1, 5:] = 0.0
    return data


@pytest.mark.parametrize("kernel", [False, True])
def test_qm9_step_matches_jax_plain_branch(kernel):
    data = _small_batch()
    n_classes = int(data.charges.max()) + 1
    idx = np.arange(4)
    y_mean, y_std = float(data.y.mean()), float(data.y.std())
    batch = task.prepare_split(data, idx, n_classes, y_mean, y_std, "cpu")
    cfg_j = JaxQM9Config(hidden_features=16, depth=2)
    model_j = JaxQM9Model(cfg_j)
    bj = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    params_j = model_j.init(jax.random.PRNGKey(3), bj["species"], bj["x"], bj["edge_mask"],
                            bj["node_mask"])

    def loss_j(p):
        pred = model_j.apply(p, bj["species"], bj["x"], bj["edge_mask"], bj["node_mask"])
        return ((pred - bj["y"]) ** 2).mean()

    l_ref, g_ref = jax.value_and_grad(loss_j)(params_j)
    g_ref = _np_tree(g_ref)["params"]

    cfg = task.QM9Config(hidden_features=16, depth=2, use_kernel_backbone=kernel)
    model = task.QM9Model(cfg, n_classes, device="cpu")
    load_linen_params(model, _np_tree(params_j))
    params, forward = task.make_forward(cfg, model)
    if kernel:
        head = lambda tree: [tree[d][w] for d in ("dense_0", "dense_1") for w in ("bias", "kernel")]
        ours = flat_params(params["kp"]) + head(params["head"])
        want_g = (flat_params(model_params_from_linen(g_ref["backbone"]))
                  + [torch.tensor(a) for a in head(g_ref["head"]["head"])])
    else:
        names, ours = zip(*model.named_parameters())
        want_g = [torch.tensor(reduce(lambda node, k: node[k], n.split("."), g_ref))
                  for n in names]
    pred = forward(params, batch["species"], batch["x"], batch["edge_mask"], batch["node_mask"])
    loss = ((pred - batch["y"]) ** 2).mean()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-5)
    grads = torch.autograd.grad(loss, ours, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ours, grads)]
    for i, (g, w) in enumerate(zip(grads, want_g)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"grad {i}", **STACK_TOL)

    # the step: optax adamw's first update, p - lr * (g / (|g| + eps) + wd * p)
    before = [p.detach().clone() for p in ours]
    state = TrainState.create(params=params, tx=make_optimizer(1e-4, weight_decay=1e-5))
    state, step_loss = task.make_train_step(forward)(state, batch)
    np.testing.assert_allclose(float(step_loss), float(l_ref), rtol=1e-5)
    for i, (p, p0, g) in enumerate(zip(ours, before, grads)):
        want = p0 - 1e-4 * (g / (g.abs() + 1e-8) + 1e-5 * p0)
        np.testing.assert_allclose(p.detach().numpy(), want.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=f"param {i}")


@pytest.mark.parametrize("kernel,bucket", [(False, None), (True, None), (True, 8)])
def test_run_end_to_end_on_cpu(kernel, bucket):
    cfg = task.QM9Config(hidden_features=16, depth=2, batch_size=8, n_epochs=2, n_samples=48,
                         use_kernel_backbone=kernel, bucket_pad_multiple=bucket)
    logger = MetricLogger(stream=open("/dev/null", "w"))
    state, results = task.run(cfg, logger, device="cpu")
    epochs = [r for r in logger.records if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in epochs)
    assert state.step > 0 and notfinite_count(state.opt_state) == 0
    for name in ("valid", "test"):
        assert np.isfinite(results[f"{name}_mae"])
        low, high = results[f"{name}_mae_ci"]
        assert low <= high


def test_run_needs_a_device_or_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        task.run(task.QM9Config(n_epochs=1, n_samples=16))
    with pytest.raises(RuntimeError, match="CUDA"):
        task.QM9Model(task.QM9Config(depth=1), 4)


def test_kernel_branch_params_live_on_the_model_device():
    """Every training tensor of the kernel branch, the adapter's zero
    placeholders included, sits on the model's device."""
    model = task.QM9Model(task.QM9Config(hidden_features=8, depth=2), 4, device="meta")
    params, _ = task.make_forward(task.QM9Config(hidden_features=8, depth=2,
                                                 use_kernel_backbone=True), model)
    assert {t.device.type for t in tree_leaves(params)} == {"meta"}
    assert all(t.requires_grad for t in tree_leaves(params))
