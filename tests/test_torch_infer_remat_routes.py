"""The forwards that keep no residuals, on their Hopper routes: #6, the
evaluation forward of ``make_hidden_fn`` (``resid_ef.resid_infer``), on the
two-CTA cluster kernel at every batch (``csrc/resid_fwd.cu``'s
``resid_fwd_cl_kernel<false>``); #21 and #23, the forwards of
``fori_energy_forces`` and ``depthgrid_energy_forces`` (``fori_ef.fori_fwd``,
``depthgrid_ef.depthgrid_fwd``), on K1's tensor-core body where K1's rule takes
the shape (``csrc/remat_ef.cu``'s ``remat_fwd_kernel<true>``: aspirin's widths,
N <= 21), on its CUDA-core body (``<false>``) elsewhere.

On the CPU:
- the route each wrapper takes, on meta tensors (a stand-in for CUDA ones: not on
  the CPU, so the wrappers take their launch path) with a stub library: #6 on the
  cluster entry at every batch, masked or not, counted in ``resid_infer.launches``;
  #21 and #23 on the entry that routes by shape, counted under the route this
  file's mirror of the header's ``fwd_tc_route`` gives;
- that mirror against the header itself, compiled on the host (``g++`` against
  ``tools/cuda_emu/cuda_runtime.h``), and against the remat source's own route and
  carve entries (``sake_remat_fwd_tc``, ``sake_remat_fwd_smem_bytes``), compiled
  the same way;
- a refused launch raising with no other kernel tried, a carve beyond one block's
  shared memory raising, and a misaligned w_xmix refused on the tensor-core route;
- ``make_hidden_fn``'s no-grad output (the plain version on CPU tensors) against
  the JAX ``make_hidden_fn`` run by the Pallas interpreter (its ``infer_kernel``),
  ``rtol=2e-4, atol=2e-5`` (``test_torch_hidden.py``'s forward tier), unmasked
  and masked;
- ``fori_energy_forces`` and ``depthgrid_energy_forces`` at aspirin's widths
  (hidden 64, 4 heads, 50 rbf, C 256, N = 21, B = 2, depth 2: the card's
  tensor-core route) against ``jax.value_and_grad`` of the linen model,
  ``rtol=2e-4, atol=2e-5`` (``test_torch_remat_tc.py``'s).

On the card (``gpu``-marked): #6 on the cluster route against
``resid_infer_plain`` at QM9's shapes and two launches bit for bit
(``tools/probe_resid.check_on_card``), and #21 and #23 against their plain
versions on the route their shape takes, the tensor cores at aspirin,
the CUDA cores at N = 22 and at hidden 8 and 16
(``tools/probe_fused.check_remat_fwd``), 1e-4 relative per tensor.
"""

import ctypes
import functools
import importlib.util
import subprocess
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels import build, depthgrid_ef, fori_ef, resid_ef
from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
from sake_tpu_torch.kernels.leaves import wide_stack
from sake_tpu_torch.models import SAKEModel

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "sake_tpu_torch" / "csrc"
TOL = dict(rtol=2e-4, atol=2e-5)
CARD_TOL = 1e-4
N_ASP, HID, HEADS, RBF, C = 21, 64, 4, 50, 256
# (hidden, N) of the route cases: aspirin's widths up to 21 atoms on the tensor
# cores; 22 (tc_dims still holds, two blocks no longer fit) and 29 (QM9's N) not;
# the narrow models never
SHAPES = [(64, 1), (64, 7), (64, 21), (64, 22), (64, 29), (8, 21), (16, 21), (16, 7)]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the mirror of K1's rule (fwd_tc_route, fwd_tc_smem_floats, tc_dims), read from
# the headers' constants, which test_torch_resid_serving.py holds for K1
rules = _load("resid_serving_rules", ROOT / "tests" / "test_torch_resid_serving.py")


def _dims(hid, N, B=512, depth=6):
    return (B, N, hid, hid, RBF, HEADS, C if hid * HEADS == C else hid * HEADS, depth)


@pytest.fixture(scope="module")
def header_route(tmp_path_factory):
    """``fwd_tc_route``, ``fwd_tc_smem_floats * 4`` and ``fwd_smem_floats * 4``
    (the CUDA-core carve) of the header at ``SHAPES``, compiled on the host
    against the CPU emulator's ``cuda_runtime.h``."""
    tmp = tmp_path_factory.mktemp("route")
    cases = ", ".join(f"{{{h}, {n}}}" for h, n in SHAPES)
    (tmp / "route.cpp").write_text(
        '#include "cuda_runtime.h"\n#include "resid_fwd.cuh"\n#include <cstdio>\n'
        f"int main() {{\n  const int cases[][2] = {{{cases}}};\n"
        "  for (const auto& c : cases) {\n    const int hid = c[0], N = c[1];\n"
        "    const sake::Dims d{512, N, hid, hid, 50, 4, hid == 64 ? 256 : 4 * hid, 6};\n"
        '    std::printf("%d %d %d %lld %lld\\n", hid, N, (int)sake::fwd_tc_route(d),\n'
        "                sake::fwd_tc_smem_floats(d) * 4, sake::fwd_smem_floats(d) * 4);\n"
        "  }\n}\n")
    subprocess.run(["g++", "-std=c++20", "-O0", "-I", str(ROOT / "tools" / "cuda_emu"), "-I",
                    str(CSRC), "-x", "c++", str(tmp / "route.cpp"), "-o", str(tmp / "route"),
                    "-lpthread"], check=True)
    out = subprocess.run([str(tmp / "route")], capture_output=True, text=True, check=True).stdout
    return {(h, n): (bool(r), s, c)
            for h, n, r, s, c in (map(int, l.split()) for l in out.splitlines())}


@pytest.fixture(scope="module")
def remat_entries(tmp_path_factory):
    """``csrc/remat_ef.cu`` compiled on the host against the CPU emulator's
    ``cuda_runtime.h`` (its launches rewritten, ``tools/cuda_emu/emulate.py``),
    with its route and carve entries declared."""
    emu = _load("emulate", ROOT / "tools" / "cuda_emu" / "emulate.py")
    lib = emu.compile_source("remat_ef.cu", tmp_path_factory.mktemp("remat"), False,
                             opt=("-O0",))
    return build.declare(ctypes.CDLL(str(lib)), ["sake_remat_fwd_tc", "sake_remat_fwd_smem_bytes"])


@pytest.mark.parametrize("hid,N", SHAPES)
def test_route_mirror_is_the_header_rule(header_route, hid, N):
    dims = _dims(hid, N)
    assert header_route[(hid, N)][:2] == (rules.fwd_tc_route(dims), rules.fwd_tc_smem_bytes(dims))
    assert rules.fwd_tc_route(dims) is (hid == HID and N <= N_ASP)


@pytest.mark.parametrize("hid,N", SHAPES)
def test_remat_source_routes_and_carves_by_k1s_rule(header_route, remat_entries, hid, N):
    """The remat source reports K1's route for #21 and #23 and sizes the
    forward's shared memory by the kernel that route launches: the tensor-core
    carve (the 8-warp W ring and the kTc carve) on it, the CUDA-core one off it."""
    dims = _dims(hid, N)
    route, tc_bytes, cc_bytes = header_route[(hid, N)]
    assert bool(remat_entries.sake_remat_fwd_tc(*dims)) is route
    assert remat_entries.sake_remat_fwd_smem_bytes(*dims) == (tc_bytes if route else cc_bytes)


# --------------------------------------------------------------------------
# #6: resid_infer on the cluster route
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model_leaves(hid, depth, seed):
    model = SAKEModel(hid, 1, depth, in_features=5, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    return wide_stack(model_params_from_linen(linen_tree(model), device="cpu"), HEADS)


def _leaves(hid, depth=2, seed=0):
    """A seeded model's wide leaves (a new dict of the same tensors each call)."""
    return dict(_model_leaves(hid, depth, seed))


def _infer_lib(calls, refuse=False, smem=0):
    """A library whose forward-without-residuals entry records its calls and
    fails with CUDA error 1 when ``refuse``."""
    def launch(*a):
        calls.append("sake_resid_infer_cluster")
        return 1 if refuse else 0

    return SimpleNamespace(sake_resid_infer_cluster=launch,
                           sake_resid_fwd_cluster_smem_bytes=lambda *d: smem,
                           sake_error_string=lambda err: b"refused")


def _stub_resid(monkeypatch, lib):
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(resid_ef, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(resid_ef, "_stream", lambda dev: None)


def _meta_infer_inputs(B, N=29, hid=16, masked=False):
    leaves = {n: t.to("meta") for n, t in _leaves(hid).items()}
    h0 = torch.empty(B, N, hid, device="meta")
    xs = torch.empty(3, B, N, device="meta")
    mask = torch.empty(B, N, N, 1, device="meta") if masked else None
    return leaves, h0, xs, [1.0] * leaves["w_in_j"].shape[0], mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B", [1, 29, 64, 96, 512])
def test_infer_takes_the_cluster_route_at_every_batch(monkeypatch, B, masked):
    calls = []
    _stub_resid(monkeypatch, _infer_lib(calls))
    leaves, h0, xs, upd, mask = _meta_infer_inputs(B, masked=masked)
    before = resid_ef.resid_infer.launches
    h_fin, x_fin = resid_ef.resid_infer(leaves, h0, xs, xs, upd, mask)
    assert calls == ["sake_resid_infer_cluster"]
    assert h_fin.shape == h0.shape and x_fin.shape == xs.shape
    assert resid_ef.resid_infer.launches - before == 1


def test_refused_cluster_infer_raises_without_fallback(monkeypatch):
    calls = []
    _stub_resid(monkeypatch, _infer_lib(calls, refuse=True))
    leaves, h0, xs, upd, mask = _meta_infer_inputs(64, masked=True)
    before = resid_ef.resid_infer.launches
    with pytest.raises(RuntimeError, match=r"resid_infer: CUDA error 1: refused"):
        resid_ef.resid_infer(leaves, h0, xs, xs, upd, mask)
    assert calls == ["sake_resid_infer_cluster"]
    assert resid_ef.resid_infer.launches == before


def test_infer_carve_beyond_one_block_raises(monkeypatch):
    calls = []
    _stub_resid(monkeypatch, _infer_lib(calls, smem=resid_ef._SMEM_LIMIT + 4))
    leaves, h0, xs, upd, mask = _meta_infer_inputs(4)
    with pytest.raises(ValueError, match="exceeds one block's shared memory"):
        resid_ef.resid_infer(leaves, h0, xs, xs, upd, mask)
    assert calls == []


# --------------------------------------------------------------------------
# #21 and #23 on K1's tensor-core body
# --------------------------------------------------------------------------


def _remat_lib(calls, refuse=False):
    """A library whose forward entry records ``(entry, route, l0, l1)`` and
    whose route entry is the mirror."""
    def by_shape(*a):
        dims = a[-9:-1]
        calls.append(("sake_remat_fwd", fori_ef.ROUTES[rules.fwd_tc_route(dims)], *a[:2]))
        return 1 if refuse else 0

    return SimpleNamespace(sake_remat_fwd=by_shape,
                           sake_remat_fwd_smem_bytes=lambda *d: 0,
                           sake_remat_fwd_tc=lambda *d: int(rules.fwd_tc_route(d)),
                           sake_error_string=lambda err: b"refused")


def _stub_remat(monkeypatch, lib):
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(fori_ef, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(fori_ef, "_stream", lambda dev: None)


def _meta_remat_inputs(hid, N, B=3, depth=2):
    leaves = {n: t.to("meta") for n, t in _leaves(hid, depth).items()}
    return leaves, torch.empty(B, N, hid, device="meta"), torch.empty(3, B, N, device="meta"), \
        [1.0] * depth


FORWARDS = {"fori_fwd": (fori_ef.fori_fwd, lambda depth: [(0, depth)]),
            "depthgrid_fwd": (depthgrid_ef.depthgrid_fwd,
                              lambda depth: [(l, l + 1) for l in range(depth)])}


@pytest.mark.parametrize("hid,N", SHAPES)
def test_remat_forwards_count_the_route_of_each_launch(monkeypatch, hid, N):
    calls = []
    _stub_remat(monkeypatch, _remat_lib(calls))
    leaves, h0, xs, upd = _meta_remat_inputs(hid, N)
    route = "tensor cores" if hid == HID and N <= N_ASP else "CUDA cores"
    for name, (fn, layers) in FORWARDS.items():
        calls.clear()
        before, routes = fn.launches, dict(fn.routes)
        bnd = fn(leaves, h0, xs, upd)
        launches = layers(len(upd))
        assert calls == [("sake_remat_fwd", route, *ls) for ls in launches], name
        assert bnd.bh.shape == (len(upd), *h0.shape) and bnd.h_fin.shape == h0.shape
        assert fn.launches - before == len(launches)
        assert {r: fn.routes[r] - routes[r] for r in fori_ef.ROUTES} == {
            r: len(launches) if r == route else 0 for r in fori_ef.ROUTES}


@pytest.mark.parametrize("name", list(FORWARDS))
def test_refused_remat_forward_raises_without_fallback(monkeypatch, name):
    calls = []
    _stub_remat(monkeypatch, _remat_lib(calls, refuse=True))
    fn, _ = FORWARDS[name]
    leaves, h0, xs, upd = _meta_remat_inputs(HID, N_ASP)
    before, routes = fn.launches, dict(fn.routes)
    with pytest.raises(RuntimeError, match=rf"{name}: CUDA error 1: refused"):
        fn(leaves, h0, xs, upd)
    assert calls == [("sake_remat_fwd", "tensor cores", 0, 2 if name == "fori_fwd" else 1)]
    assert fn.launches == before and fn.routes == routes


@pytest.mark.parametrize("name", list(FORWARDS))
def test_tensor_core_route_refuses_a_misaligned_w_xmix(monkeypatch, name):
    """mm_tc copies w_xmix 16 bytes at a time: the forwards' tensor-core route
    refuses one that does not start 16-byte aligned; the CUDA-core route does
    not ask."""
    _stub_remat(monkeypatch, _remat_lib([]))

    def misaligned(t):
        flat = torch.empty(t.numel() + 1)[1:]
        return flat.view(t.shape).copy_(t)

    for hid, N, raises in ((HID, N_ASP, True), (HID, N_ASP + 1, False), (8, N_ASP, False)):
        leaves = _leaves(hid)
        leaves["w_xmix"] = misaligned(leaves["w_xmix"])
        h0, xs = torch.zeros(2, N, hid), torch.zeros(3, 2, N)
        if raises:
            with pytest.raises(ValueError, match="w_xmix must start at a 16-byte aligned"):
                fori_ef._fwd_setup(name, leaves, h0, xs, [1.0, 1.0])
        else:
            assert fori_ef._fwd_setup(name, leaves, h0, xs, [1.0, 1.0])[-1] == "CUDA cores"


# --------------------------------------------------------------------------
# the entry points on CPU tensors against the JAX package
# --------------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def hidden_setup():
    """A small linen model (hidden 8, depth 2) and its inputs, B = 2, N = 5."""
    B, N, F_in, hid = 2, 5, 5, 8
    rng = np.random.RandomState(18)
    h = rng.randn(B, N, F_in).astype(np.float32)
    x = (1.5 * rng.randn(B, N, 3)).astype(np.float32)
    model = JaxSAKEModel(hidden_features=hid, out_features=1, depth=2)
    params = jax.jit(model.init)(jax.random.PRNGKey(4), jnp.asarray(h), jnp.asarray(x))
    return dict(h=h, x=x, hid=hid, params=params)


@pytest.mark.parametrize("masked", [False, True])
def test_hidden_no_grad_matches_jax_infer_kernel(hidden_setup, masked):
    """``make_hidden_fn`` outside autograd (the evaluation forward, #6's path)
    against the JAX ``make_hidden_fn`` outside autodiff, whose ``infer_kernel``
    the Pallas interpreter runs."""
    from sake_tpu.kernels.resid_ef import make_hidden_fn as jax_make_hidden_fn

    s = hidden_setup
    h, x = s["h"], s["x"]
    B, N = h.shape[:2]
    mask = None
    if masked:  # the second molecule three atoms, then padding
        nm = (np.arange(N)[None, :] < np.array([N, 3])[:, None]).astype(np.float32)
        mask = nm[:, :, None] * nm[:, None, :]
    want = jax_make_hidden_fn(batch_tile=2, interpret=True)(
        jax_from_linen(s["params"]), jnp.asarray(h), jnp.asarray(x),
        None if mask is None else jnp.asarray(mask))
    tp = model_params_from_linen(_np_tree(s["params"]))
    before = resid_ef.resid_infer.launches
    with torch.no_grad():
        got = resid_ef.make_hidden_fn(n_heads=4)(
            tp, torch.as_tensor(h), torch.as_tensor(x),
            None if mask is None else torch.as_tensor(mask))
    assert resid_ef.resid_infer.launches == before  # CPU tensors: the plain version
    assert got.shape == (B, N, s["hid"]) and got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def aspirin_width():
    """Aspirin's widths at B = 2, depth 2: a seeded model's weights as the linen
    tree (the names the linen model's init gives), the inputs and
    ``jax.value_and_grad`` of the linen model's summed energy (E per molecule,
    F = -dE/dx)."""
    rng = np.random.RandomState(21)
    h = rng.randn(2, N_ASP, 5).astype(np.float32)
    x = (1.5 * rng.randn(2, N_ASP, 3)).astype(np.float32)
    model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=2, n_heads=HEADS)
    seeded = SAKEModel(HID, 1, 2, n_heads=HEADS, in_features=5, device="cpu",
                       generator=torch.Generator().manual_seed(6))
    params = {"params": jax.tree.map(lambda t: t.detach().numpy(), linen_tree(seeded))}

    @jax.jit
    def energy_forces(x_):
        def energy(xx):
            out, _, _ = model.apply(params, jnp.asarray(h), xx)
            return out.sum(), out.sum(axis=(-2, -1))

        (_, e), g = jax.value_and_grad(energy, has_aux=True)(x_)
        return e, -g

    e, f = energy_forces(jnp.asarray(x))
    return dict(h=h, x=x, params=_np_tree(params), e=np.asarray(e), f=np.asarray(f))


@pytest.mark.parametrize("entry", ["fori", "depthgrid"])
def test_remat_energy_forces_match_jax_at_aspirin_width(aspirin_width, entry):
    s = aspirin_width
    tp = model_params_from_linen(s["params"])
    assert rules.fwd_tc_route(resid_ef._dims(wide_stack(tp, HEADS),
                                             torch.empty(2, N_ASP, HID)))  # the card's route
    fn = {"fori": fori_ef.fori_energy_forces,
          "depthgrid": depthgrid_ef.depthgrid_energy_forces}[entry]
    counted = (fori_ef.fori_fwd, depthgrid_ef.depthgrid_fwd)
    before = [(c.launches, dict(c.routes)) for c in counted]
    e, f = fn(tp, torch.as_tensor(s["h"]), torch.as_tensor(s["x"]), n_heads=HEADS)
    assert [(c.launches, dict(c.routes)) for c in counted] == before  # the plain versions
    assert e.shape == (2,) and f.shape == (2, N_ASP, 3)
    np.testing.assert_allclose(e.numpy(), s["e"], **TOL)
    np.testing.assert_allclose(f.numpy(), s["f"], **TOL)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.mark.gpu
def test_cluster_infer_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = _load("probe_resid", ROOT / "tools" / "probe_resid.py").check_on_card(
        torch.device("cuda", 0))
    worst = max(res["resid_infer_cluster"], key=res["resid_infer_cluster"].get)
    assert res["resid_infer_cluster"][worst] <= CARD_TOL, worst
    assert res["bitwise"]["resid_infer_cluster"]


@pytest.mark.gpu
def test_remat_forwards_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    errs = _load("probe_fused", ROOT / "tools" / "probe_fused.py").check_remat_fwd(
        torch.device("cuda", 0))
    for case, (err, route) in errs.items():
        assert err <= CARD_TOL, (case, err)
        assert route == ("tensor cores" if "aspirin" in case else "CUDA cores"), case
