"""The cluster route of #4 and #5's rows kernel (one molecule per cluster of two
CTAs, its receiver rows split between them): the row split, the route the
``cluster`` keyword picks, the wrappers' refusal to fall back on a failed
launch, ``make_hidden_fn`` on CPU tensors (the plain versions, against
``jax.grad`` of the linen model) and, on a card, both cluster kernels against
their plain versions.

Tolerances: ``make_hidden_fn``'s gradients ``rtol=2e-3, atol=2e-4`` and its loss
``rtol=1e-4`` (``test_torch_hidden.py``'s); on the card 1e-4 relative per tensor
(max |kernel - plain| / max |plain|) and two launches bit for bit equal.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels import build, resid_ef
from sake_tpu_torch.kernels.adapter import model_params_from_linen
from sake_tpu_torch.kernels.functional import readout

STACK_TOL = dict(rtol=2e-3, atol=2e-4)
CARD_TOL = 1e-4
B, N, F_IN, HID, K, DEPTH = 3, 9, 5, 16, 4, 2
SIZES = (9, 4, 1)  # atoms per molecule: whole, rank 1's rows all padding, a lone atom


def _probe_resid():
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_resid.py"
    spec = importlib.util.spec_from_file_location("probe_resid", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_atoms", range(1, 41))
def test_cluster_rows_cover_every_receiver_once(n_atoms):
    spans = [resid_ef.cluster_rows(n_atoms, r) for r in range(resid_ef.CLUSTER_SIZE)]
    rows = [i for i0, i1 in spans for i in range(i0, i1)]
    assert rows == list(range(n_atoms))  # each once, in order, rank 0 first
    assert all(i1 - i0 <= -(-n_atoms // 2) for i0, i1 in spans)
    assert spans[0][1] - spans[0][0] == -(-n_atoms // 2)


def test_cluster_rows_mirror_the_kernel_source():
    """``cluster_rows`` restates ``cl_rows`` of ``csrc/cluster.cuh``."""
    src = (build.CSRC / "cluster.cuh").read_text()
    assert "constexpr int kClSize = 2;" in src and resid_ef.CLUSTER_SIZE == 2
    assert "return (N + kClSize - 1) / kClSize;" in src
    assert "i0 = rank * s < N ? rank * s : N;" in src and "i1 = i0 + s < N ? i0 + s : N;" in src


@pytest.mark.parametrize("B_", [64, 96, 192, 512])
@pytest.mark.parametrize("cluster", [False, True])
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_route_follows_the_cluster_keyword(monkeypatch, B_, cluster, kind):
    """On a CUDA tensor (a stub device) ``cluster=True`` launches the cluster
    kernel at every batch and counts it apart; ``cluster=False`` the one-block
    kernel. No device property or occupancy query decides it."""
    routes = []
    monkeypatch.setattr(resid_ef, "_launch_fwd", lambda *a: routes.append(a[-1]))
    monkeypatch.setattr(resid_ef, "_bwd_launch",
                        lambda *a, route: routes.append(route) or (None,) * 4)
    monkeypatch.setattr(torch.cuda, "get_device_properties", None)
    cuda = SimpleNamespace(device=SimpleNamespace(type="cuda"), shape=(B_, 29, 64))
    fn = resid_ef.resid_fwd if kind == "fwd" else resid_ef.resid_bwd_rows
    before = (fn.launches, fn.cluster_launches)
    if kind == "fwd":
        fn({}, cuda, None, None, [1.0] * 6, None, cluster=cluster)
    else:
        fn({}, None, [1.0] * 6, cuda, None, None, None, cluster=cluster)
    assert routes == ["cluster" if cluster else "block"]
    assert (fn.launches - before[0], fn.cluster_launches - before[1]) == \
        ((0, 1) if cluster else (1, 0))


def _stub_cuda(monkeypatch, lib):
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(resid_ef, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(resid_ef, "_stream", lambda dev: None)


def _tiny_inputs():
    g = torch.Generator().manual_seed(0)
    leaves = {n: torch.randn(DEPTH, *s, generator=g)
              for n, s in resid_ef._leaf_shapes(HID, HID, 6, K, 12).items()}
    h0, xs = torch.randn(B, N, HID, generator=g), torch.randn(3, B, N, generator=g)
    return leaves, h0, xs


def _refusing_lib(route_entry):
    """A library whose cluster entry fails with CUDA error 1 and whose one-block
    entries must not be reached."""
    def never(*a):
        raise AssertionError("a one-block entry was called after the cluster launch failed")

    return SimpleNamespace(**{
        route_entry: lambda *a: 1, "sake_resid_fwd": never, "sake_resid_bwd_rows": never,
        "sake_resid_fwd_cluster_smem_bytes": lambda *d: 0,
        "sake_resid_bwd_cluster_smem_bytes": lambda *d: 0,
        "sake_error_string": lambda err: b"refused"})


def test_refused_cluster_forward_raises_without_fallback(monkeypatch):
    _stub_cuda(monkeypatch, _refusing_lib("sake_resid_fwd_cluster"))
    leaves, h0, xs = _tiny_inputs()
    with pytest.raises(RuntimeError, match=r"resid_fwd \(cluster\): CUDA error 1: refused"):
        resid_ef._launch_fwd(leaves, h0, xs, torch.zeros_like(xs), [1.0] * DEPTH, None,
                             "cluster")


def test_refused_cluster_pullback_raises_without_fallback(monkeypatch):
    _stub_cuda(monkeypatch, _refusing_lib("sake_resid_bwd_rows_cluster"))
    leaves, h0, xs = _tiny_inputs()
    fwd = resid_ef.resid_fwd_plain(leaves, h0, xs, torch.zeros_like(xs), [1.0] * DEPTH)
    with pytest.raises(RuntimeError, match=r"resid_bwd_rows \(cluster\): CUDA error 1"):
        resid_ef._bwd_launch("resid_bwd_rows", leaves, fwd, [1.0] * DEPTH, h0, xs, xs, None,
                             None, True, route="cluster")
    with pytest.raises(ValueError, match="no addend"):
        resid_ef._bwd_launch("resid_bwd_rows", leaves, fwd, [1.0] * DEPTH, h0, xs, xs, None,
                             None, True, (h0, xs, xs), route="cluster")


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("masked", [False, True])
def test_make_hidden_fn_on_cpu_takes_plain_and_matches_linen(masked):
    """The QM9 entry on CPU tensors: the plain versions (no launch counted on
    either route) and the gradients of a weighted readout loss equal
    ``jax.grad`` of the linen model's."""
    rng = np.random.RandomState(13)
    h_raw = rng.randn(B, N, F_IN).astype(np.float32)
    x = (1.5 * rng.randn(B, N, 3)).astype(np.float32)
    w = rng.randn(B).astype(np.float32)
    node_m = (np.arange(N)[None, :] < np.array(SIZES)[:, None]).astype(np.float32)
    mask = node_m[:, :, None] * node_m[:, None, :] if masked else None
    model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=DEPTH)
    params = model.init(jax.random.PRNGKey(2), jnp.asarray(h_raw), jnp.asarray(x))

    def loss_linen(p_):
        out, _, _ = model.apply(p_, jnp.asarray(h_raw), jnp.asarray(x),
                                mask=None if mask is None else jnp.asarray(mask))
        if masked:
            out = out * jnp.asarray(node_m)[..., None]
        return (out.sum(axis=(-2, -1)) * w).sum()

    l_ref, g_ref = jax.value_and_grad(loss_linen)(params)
    want = resid_ef.flat_params(model_params_from_linen(_np_tree(g_ref)))
    tp = model_params_from_linen(_np_tree(params))
    flat = [t.requires_grad_(True) for t in resid_ef.flat_params(tp)]
    counters = (resid_ef.resid_fwd, resid_ef.resid_bwd_rows)
    before = [(c.launches, c.cluster_launches) for c in counters]
    hidden = resid_ef.make_hidden_fn(n_heads=K)
    h_fin = hidden(tp, torch.as_tensor(h_raw), torch.as_tensor(x),
                   None if mask is None else torch.as_tensor(mask))
    out = readout(tp, h_fin)
    if masked:
        out = out * torch.as_tensor(node_m)[..., None]
    loss = (out.sum(dim=(-2, -1)) * torch.as_tensor(w)).sum()
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    assert [(c.launches, c.cluster_launches) for c in counters] == before
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-4)
    for i, (g, wt) in enumerate(zip(got, want)):
        g = torch.zeros_like(wt) if g is None else g
        np.testing.assert_allclose(g.numpy(), wt.numpy(), err_msg=f"leaf {i}", **STACK_TOL)


@pytest.mark.gpu
def test_cluster_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = _probe_resid().check_on_card(torch.device("cuda", 0))
    for check in ("resid_fwd_cluster", "resid_bwd_rows_cluster"):
        worst = max(res[check], key=res[check].get)
        assert res[check][worst] <= CARD_TOL, (check, worst, res[check][worst])
        assert res["bitwise"][check], check
