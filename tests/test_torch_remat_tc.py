"""#22 and #24, the remat pullbacks of ``fori_energy_forces`` and
``depthgrid_energy_forces`` (``csrc/remat_ef.cu``'s ``remat_bwd_kernel``), on the
tensor cores: their re-forward and pullback run the bodies' ``kTc``
instantiations (``csrc/remat_step.cuh``), whose x-mixing product, its transpose
and the edge products o_f and o1 run in 3xTF32 on ``mma.sync``
(``csrc/mma_tf32x3.cuh``) where the shape allows (``tc_dims``: aspirin's widths),
on the CUDA cores elsewhere.

On the CPU:
- each of those products at #22's shapes (a receiver row of aspirin's 21
  senders) through the plain models of ``kernels/tf32.py``, as the helpers sum
  them (``mm_tc``: chunks of 32 k summed from zero, then added in f32;
  ``mm_tc_small``: the three passes summed apart over k), against float64
  within 1e-6 of max |ref| on 4 seeds, where one TF32 pass misses by 1e-4;
- ``fori_energy_forces`` and ``depthgrid_energy_forces`` at aspirin's widths
  (hidden 64, 4 heads, 50 rbf, C 256, N = 21, B = 2, depth 2), the width at
  which the card takes the tensor cores, against JAX ``fori_energy_forces`` run
  by the Pallas interpreter with ``pad_atoms`` (21 atoms padded to 24),
  ``rtol=2e-4, atol=2e-5`` (``test_torch_fori_ef.py``'s);
- the route by shape from a mirror of ``tc_dims`` read from the header, and the
  wrappers on stub CUDA (meta) tensors: each launch counted under its route, a
  refused launch raising with no other launch tried, a misaligned w_xmix refused
  on the tensor-core route.

On the card (``gpu``-marked): #22 and #24 against their plain versions
(``tools/probe_fused.check_remat``), aspirin on the tensor cores, hidden 8 and 16
on the CUDA cores, and the re-forward's residual scratch against the plain
forward's within ``REMAT_RESID_TOL``.
"""

import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels import build, depthgrid_ef, fori_ef
from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
from sake_tpu_torch.kernels.leaves import transposed, wide_stack
from sake_tpu_torch.kernels.tf32 import (
    mm_tf32_plain,
    mm_tf32x3_chunked_plain,
    mm_tf32x3_plain,
)
from sake_tpu_torch.models import SAKEModel

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "sake_tpu_torch" / "csrc" / "mma_tf32x3.cuh"
TOL = dict(rtol=2e-4, atol=2e-5)
PRODUCT_TOL = 1e-6  # max |diff| / max |float64 ref|
N_ASP, HID, HEADS, RBF, C = 21, 64, 4, 50, 256
# (n, k, m, weight transposed, mm_tc's chunked sum) of each product of a row
PRODUCTS = {
    "x-mixing he_att @ w_xmix": (N_ASP, HID * HEADS, C, False, True),
    "x-mixing pullback d_xm @ w_xmix^T": (N_ASP, C, HID * HEADS, True, True),
    "o_f filtered @ w_o_f": (N_ASP, RBF, HID, False, False),
    "o1 silu(e0) @ w_o1": (N_ASP, HID, HID, False, False),
    "o_f pullback d_e0 @ w_o_f^T": (N_ASP, HID, RBF, True, False),
    "o1 pullback d_h_e @ w_o1^T": (N_ASP, HID, HID, True, False),
}


def _operands(n, k, m, trans, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((m, k) if trans else (k, m))
                          / np.sqrt(k)).astype(np.float32))
    return a, w.T if trans else w


def _rel(got, a, w):
    ref = a.double() @ w.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("product", list(PRODUCTS))
def test_route_products_against_float64(product, seed):
    n, k, m, trans, chunked = PRODUCTS[product]
    a, w = _operands(n, k, m, trans, seed)
    got = mm_tf32x3_chunked_plain(a, w) if chunked else mm_tf32x3_plain(a, w)
    assert _rel(got, a, w) <= PRODUCT_TOL


def test_one_tf32_pass_misses_the_f32_tier():
    a, w = _operands(N_ASP, HID * HEADS, C, False, 0)
    assert _rel(mm_tf32_plain(a, w), a, w) >= 1e-4


def _header_constants():
    text = HEADER.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
            for name in ("kTcK", "kTcMaxN", "kTcSmallK")}


def tc_dims(dims) -> bool:
    """Mirror of ``mma_tf32x3.cuh``'s ``tc_dims`` at ``(B, N, F, H, R, K, C,
    depth)``."""
    _, N, _, H, R, K, C_, _ = dims
    c = _header_constants()
    return (H * K == c["kTcK"] and C_ == c["kTcK"] and N <= c["kTcMaxN"]
            and H <= c["kTcSmallK"] and R <= c["kTcSmallK"])


def test_mirror_is_the_header_rule():
    body = re.search(r"inline bool tc_dims\(const Dims& d\) \{\s*return (.*?);\s*\}",
                     HEADER.read_text(), re.S).group(1)
    assert " ".join(body.split()) == ("d.H * d.K == kTcK && d.C == kTcK && d.N <= kTcMaxN && "
                                      "d.H <= kTcSmallK && d.R <= kTcSmallK")
    assert _header_constants() == {"kTcK": 256, "kTcMaxN": 22, "kTcSmallK": 64}


def _leaves(hid, depth=2, seed=0):
    model = SAKEModel(hid, 1, depth, in_features=5, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    return wide_stack(model_params_from_linen(linen_tree(model), device="cpu"), HEADS)


def _dims(leaves, B, N):
    depth, F, R = leaves["w_in_j"].shape
    return (B, N, F, leaves["w_o_j"].shape[-1], R, leaves["w_sem"].shape[-1],
            leaves["w_xmix"].shape[-1], depth)


@pytest.mark.parametrize("hid,N,tc", [(64, 21, True), (64, 22, True), (64, 23, False),
                                      (8, 21, False), (16, 21, False), (16, 7, False)])
def test_route_by_shape(hid, N, tc):
    """Aspirin's widths take the tensor cores up to 22 atoms (the carve's
    limit); the narrow models of chip_smoke.py phase 17 keep the CUDA cores."""
    assert tc_dims(_dims(_leaves(hid), 512, N)) is tc


def _stub_lib(calls, refuse=False):
    def launch(*a):
        calls.append(a[:2])  # l_hi, l_lo
        return 1 if refuse else 0

    return SimpleNamespace(sake_remat_bwd=launch, sake_remat_bwd_smem_bytes=lambda *d: 0,
                           sake_remat_bwd_tc=lambda *d: int(tc_dims(d)),
                           sake_error_string=lambda err: b"refused")


def _stub_cuda(monkeypatch, lib):
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(fori_ef, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(fori_ef, "_stream", lambda dev: None)


def _meta_inputs(hid, B=3, N=N_ASP):
    """The pullback's inputs as meta tensors: a stand-in for CUDA ones (not on
    the CPU, so the wrappers take their launch path)."""
    leaves = {n: t.to("meta") for n, t in _leaves(hid).items()}
    depth = leaves["w_in_j"].shape[0]
    bnd = fori_ef.Bounds(torch.empty(depth, B, N, hid, device="meta"),
                         torch.empty(depth, 3, B, N, device="meta"),
                         torch.empty(depth, 3, B, N, device="meta"),
                         torch.empty(B, N, hid, device="meta"))
    return leaves, bnd, [1.0] * depth, torch.empty(B, N, hid, device="meta")


@pytest.mark.parametrize("hid,route", [(64, "tensor cores"), (8, "CUDA cores")])
def test_wrappers_count_the_route_of_each_launch(monkeypatch, hid, route):
    calls = []
    _stub_cuda(monkeypatch, _stub_lib(calls))
    leaves, bnd, upd, dh = _meta_inputs(hid)
    depth = len(upd)
    for fn, launches in ((fori_ef.fori_bwd, [(depth - 1, 0)]),
                         (depthgrid_ef.depthgrid_bwd, [(l, l) for l in reversed(range(depth))])):
        before, routes = fn.launches, dict(fn.routes)
        calls.clear()
        fn(leaves, bnd, upd, dh)
        assert calls == launches
        assert fn.launches - before == len(launches)
        assert {r: fn.routes[r] - routes[r] for r in fn.routes} == {
            r: len(launches) if r == route else 0 for r in fori_ef.ROUTES}


def test_refused_pullback_raises_without_fallback(monkeypatch):
    calls = []
    _stub_cuda(monkeypatch, _stub_lib(calls, refuse=True))
    leaves, bnd, upd, dh = _meta_inputs(HID)
    for fn, name in ((fori_ef.fori_bwd, "fori_bwd"), (depthgrid_ef.depthgrid_bwd, "depthgrid_bwd")):
        before, routes = fn.launches, dict(fn.routes)
        calls.clear()
        with pytest.raises(RuntimeError, match=rf"{name}: CUDA error 1: refused"):
            fn(leaves, bnd, upd, dh)
        assert len(calls) == 1 and fn.launches == before and fn.routes == routes


@pytest.mark.parametrize("leaf", ["w_xmix", "w_xmix.T"])
def test_tensor_core_route_refuses_a_misaligned_w_xmix(monkeypatch, leaf):
    """mm_tc copies w_xmix (and its transpose) 16 bytes at a time: the
    tensor-core route refuses one that does not start 16-byte aligned; the
    CUDA-core route does not ask."""
    _stub_cuda(monkeypatch, _stub_lib([]))

    def misaligned(t):
        flat = torch.empty(t.numel() + 1)[1:]
        return flat.view(t.shape).copy_(t)

    for hid, raises in ((HID, True), (8, False)):
        leaves = _leaves(hid)
        leaves_t = transposed(leaves)
        if leaf == "w_xmix":
            leaves["w_xmix"] = misaligned(leaves["w_xmix"])
        else:
            leaves_t["w_xmix"] = misaligned(leaves_t["w_xmix"])
        B, N = 2, 7
        depth, F = leaves["w_in_j"].shape[:2]
        bnd = fori_ef.Bounds(torch.zeros(depth, B, N, F), torch.zeros(depth, 3, B, N),
                             torch.zeros(depth, 3, B, N), torch.zeros(B, N, F))
        args = ("fori_bwd", leaves, bnd, [1.0] * depth, torch.zeros(B, N, F), leaves_t)
        if raises:
            with pytest.raises(ValueError, match=rf"{re.escape(leaf)} must start at a 16-byte"):
                fori_ef._bwd_setup(*args)
        else:
            assert fori_ef._bwd_setup(*args)[-1] == "CUDA cores"


@pytest.fixture(scope="module")
def aspirin_width():
    """Aspirin's widths at B = 2, depth 2: the linen model's weights, the
    inputs and the JAX ``fori_energy_forces`` run by the Pallas interpreter
    with ``pad_atoms`` (21 atoms padded to 24)."""
    from sake_tpu.kernels.fori_ef import fori_energy_forces as jax_fori

    rng = np.random.RandomState(16)
    h = rng.randn(2, N_ASP, 5).astype(np.float32)
    x = (1.5 * rng.randn(2, N_ASP, 3)).astype(np.float32)
    model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=2, n_heads=HEADS)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(h), jnp.asarray(x))
    e, f = jax_fori(jax_from_linen(params), jnp.asarray(h), jnp.asarray(x), n_heads=HEADS,
                    batch_tile=2, pad_atoms=True, interpret=True)
    tree = jax.tree.map(np.asarray, jax.device_get(params))
    return dict(h=h, x=x, params=tree, e=np.asarray(e), f=np.asarray(f))


@pytest.mark.parametrize("entry", ["fori", "depthgrid"])
def test_entry_points_match_jax_interpret_at_aspirin_width(aspirin_width, entry):
    s = aspirin_width
    tp = model_params_from_linen(s["params"])
    leaves = wide_stack(tp, HEADS)
    assert tc_dims(_dims(leaves, 2, N_ASP))  # the card's tensor-core route
    fn = {"fori": fori_ef.fori_energy_forces,
          "depthgrid": depthgrid_ef.depthgrid_energy_forces}[entry]
    e, f = fn(tp, torch.as_tensor(s["h"]), torch.as_tensor(s["x"]), n_heads=HEADS,
              pad_atoms=True) if entry == "fori" else \
        fn(tp, torch.as_tensor(s["h"]), torch.as_tensor(s["x"]), n_heads=HEADS)
    assert e.shape == (2,) and f.shape == (2, N_ASP, 3)
    np.testing.assert_allclose(e.numpy(), s["e"], **TOL)
    np.testing.assert_allclose(f.numpy(), s["f"], **TOL)


@pytest.mark.gpu
def test_remat_pullbacks_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = importlib.util.spec_from_file_location("probe_fused", ROOT / "tools" / "probe_fused.py")
    pf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pf)
    errs = pf.check_remat(torch.device("cuda", 0))
    assert len(errs) == 7
    for case, (err, route) in errs.items():
        limit = pf.REMAT_RESID_TOL if case.startswith("re-forward") else pf.REMAT_TOL
        assert err <= limit, (case, err)
        assert route == ("tensor cores" if "aspirin" in case else "CUDA cores"), case
