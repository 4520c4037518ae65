"""K1 and K2 on MD17 serving's route: their tensor-core kernels
(``csrc/resid_fwd.cu``'s ``resid_fwd_tc_kernel``, ``csrc/resid_bwd.cu``'s
``resid_bwd_tc_kernel``), which run the bodies' ``kTc`` instantiations, the
x-mixing product, its transpose and the edge products o_f and o1 in 3xTF32 on
``mma.sync`` (``csrc/mma_tf32x3.cuh``), where the shape allows; the CUDA-core
kernels elsewhere.

On the CPU:
- the route each wrapper takes by shape, on meta tensors (a stand-in for CUDA
  ones: not on the CPU, so the wrappers take their launch path) with a stub
  library whose route entries are this file's mirror of the sources' rules: K1
  at aspirin's widths while two 256-thread blocks fit an SM (N <= 21), K2 while
  ``tc_dims`` holds (N <= 22), the hidden-8 and hidden-16 models on the CUDA
  cores; each launch counted under its route;
- the mirror of K1's two-blocks rule against the header itself, compiled on the
  host (``g++`` against ``tools/cuda_emu/cuda_runtime.h``), N = 1..40;
- a refused launch raising with no other kernel tried, and a misaligned w_xmix
  (or its transpose) refused on the tensor-core route;
- ``resid_energy_forces`` on CPU tensors (the plain versions) at aspirin's widths
  (hidden 64, 4 heads, 50 rbf, C 256, N = 21, B = 2, depth 2), unmasked and
  masked, against JAX ``resid_energy_forces`` run by the Pallas interpreter,
  ``rtol=2e-4, atol=2e-5`` (``test_torch_resid_ef.py``'s);
- a plain model of K1's 8-warp column split of the x-mixing product (each warp
  two 16-column strips in turn, chunks of 32 k summed from zero and then added
  in f32) and of K2's transposed product within 1e-6 of float64, where one
  TF32 pass misses by 1e-4; ``tc_product`` on CPU tensors is that model.

On the card (``gpu``-marked): ``tools/probe_resid.check_serving_on_card``, both
kernels on both routes against their plain versions (1e-4 relative per
tensor, two launches bit for bit) and the routes' products against float64.
"""

import importlib.util
import re
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
from sake_tpu_torch.kernels import build, resid_ef
from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
from sake_tpu_torch.kernels.leaves import transposed, wide_stack
from sake_tpu_torch.kernels.tf32 import (
    WG_CHUNK,
    mm_tf32_plain,
    mm_tf32x3_chunked_plain,
    tf32_split,
)
from sake_tpu_torch.models import SAKEModel

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "sake_tpu_torch" / "csrc"
TOL = dict(rtol=2e-4, atol=2e-5)
PRODUCT_TOL = 1e-6  # max |diff| / max |float64 ref|
CARD_TOL = 1e-4
N_ASP, HID, HEADS, RBF, C = 21, 64, 4, 50, 256


def _constants():
    """The header constants the rules read."""
    mma = (CSRC / "mma_tf32x3.cuh").read_text()
    fwd = (CSRC / "resid_fwd.cuh").read_text()
    c = {n: int(re.search(rf"constexpr int {n} = (\d+);", mma).group(1))
         for n in ("kTcK", "kTcPad", "kTcStrip", "kTcWarps", "kTcFwdWarps", "kTcStages",
                   "kTcMaxN", "kTcSmallK")}
    m = re.search(r"constexpr long long kSmemPerSm = (\d+), kSmemReservedPerBlock = (\d+);", fwd)
    c["kSmemPerSm"], c["kSmemReservedPerBlock"] = int(m.group(1)), int(m.group(2))
    return c


def tc_dims(dims) -> bool:
    """Mirror of ``mma_tf32x3.cuh``'s ``tc_dims`` at ``(B, N, F, H, R, K, C,
    depth)``."""
    _, N, _, H, R, K, C_, _ = dims
    c = _constants()
    return (H * K == c["kTcK"] and C_ == c["kTcK"] and N <= c["kTcMaxN"]
            and H <= c["kTcSmallK"] and R <= c["kTcSmallK"])


def fwd_tc_smem_bytes(dims) -> int:
    """Mirror of ``resid_fwd.cuh``'s ``fwd_tc_smem_floats`` in bytes: the 8-warp W
    ring, then ``carve_fwd<true>``'s buffers, each rounded up to 4 floats."""
    _, N, F, H, R, K, C_, _ = dims
    c = _constants()
    tc = tc_dims(dims)
    takes = [N * F, 3 * N, 3 * N, N * R, N * R, N * H, N * H, N * H * K, 3 * N, N,  # node
             3 * N, N, 2 * N, N, N * R, N * H, N * H, N * K, N * K,  # row
             N * (H * K + c["kTcPad"] if tc else H * K), max(C_, 2 * H + F + 1) * N]
    ring = c["kTcFwdWarps"] * c["kTcStages"] * 8 * c["kTcStrip"] if tc else 0
    return 4 * (ring + sum((t + 3) & ~3 for t in takes))


def fwd_tc_route(dims) -> bool:
    """Mirror of ``resid_fwd.cuh``'s ``fwd_tc_route``: ``tc_dims`` and two blocks
    an SM."""
    c = _constants()
    return tc_dims(dims) and \
        2 * (fwd_tc_smem_bytes(dims) + c["kSmemReservedPerBlock"]) <= c["kSmemPerSm"]


def _dims(hid, N, B=512, depth=6):
    return (B, N, hid, hid, RBF, HEADS, C if hid * HEADS == C else hid * HEADS, depth)


def test_mirrors_read_the_header_rules():
    src = (CSRC / "resid_fwd.cuh").read_text()
    body = re.search(r"inline bool fwd_tc_route\(const Dims& d\) \{\s*return (.*?);\s*\}",
                     src, re.S).group(1)
    assert " ".join(body.split()) == (
        "tc_dims(d) && 2 * (fwd_tc_smem_floats(d) * (long long)sizeof(float) + "
        "kSmemReservedPerBlock) <= kSmemPerSm")
    assert "return tc_ring_floats<kTcFwdWarps>(d) + fwd_smem_floats<true>(d);" in src
    bwd = (CSRC / "resid_bwd.cu").read_text()
    assert re.search(r"sake_resid_bwd_tc_route\(.*?\{\s*return sake::tc_dims\(", bwd, re.S)
    c = _constants()
    assert (c["kTcFwdWarps"], c["kTcWarps"], c["kTcMaxN"]) == (8, 16, 22)
    assert (c["kSmemPerSm"], c["kSmemReservedPerBlock"]) == (233472, 1024)


@pytest.fixture(scope="module")
def header_rules(tmp_path_factory):
    """``(fwd_tc_smem_floats * 4, fwd_tc_route, tc_dims)`` of the header at
    hidden 64, 8 and 16 and N = 1..40, compiled on the host against the CPU
    emulator's ``cuda_runtime.h``."""
    tmp = tmp_path_factory.mktemp("carve")
    (tmp / "carve.cpp").write_text(
        '#include "cuda_runtime.h"\n#include "resid_fwd.cuh"\n#include <cstdio>\n'
        "int main() {\n  for (int hid : {64, 8, 16})\n    for (int N = 1; N <= 40; ++N) {\n"
        "      const sake::Dims d{512, N, hid, hid, 50, 4, hid == 64 ? 256 : 4 * hid, 6};\n"
        '      std::printf("%d %d %lld %d %d\\n", hid, N, sake::fwd_tc_smem_floats(d) * 4,\n'
        "                  (int)sake::fwd_tc_route(d), (int)sake::tc_dims(d));\n    }\n}\n")
    subprocess.run(["g++", "-std=c++20", "-O0", "-I", str(ROOT / "tools" / "cuda_emu"), "-I",
                    str(CSRC), "-x", "c++", str(tmp / "carve.cpp"), "-o", str(tmp / "carve"),
                    "-lpthread"], check=True)
    out = subprocess.run([str(tmp / "carve")], capture_output=True, text=True, check=True).stdout
    rules = {}
    for line in out.splitlines():
        hid, N, smem, route, tc = map(int, line.split())
        rules[(hid, N)] = (smem, bool(route), bool(tc))
    return rules


@pytest.mark.parametrize("N", range(1, 41))
def test_two_blocks_rule_mirrors_the_header(header_rules, N):
    """K1's tensor-core route: aspirin's widths while two blocks of its carve
    (115,040 bytes at N = 21) fit an SM's 233,472 bytes, N <= 21."""
    for hid in (64, 8, 16):
        dims = _dims(hid, N)
        assert header_rules[(hid, N)] == (fwd_tc_smem_bytes(dims), fwd_tc_route(dims),
                                          tc_dims(dims))
    assert fwd_tc_route(_dims(HID, N)) is (N <= 21)
    assert tc_dims(_dims(HID, N)) is (N <= 22)
    if N == N_ASP:
        assert fwd_tc_smem_bytes(_dims(HID, N)) == 115040


def _leaves(hid, depth=2, seed=0):
    model = SAKEModel(hid, 1, depth, in_features=5, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    return wide_stack(model_params_from_linen(linen_tree(model), device="cpu"), HEADS)


def _stub_lib(calls, refuse=()):
    """A library whose launch entries record their calls and fail with CUDA
    error 1 when named in ``refuse``; its route entries are the mirrors."""
    def entry(name):
        def launch(*a):
            calls.append(name)
            return 1 if name in refuse else 0
        return launch

    names = ("sake_resid_fwd", "sake_resid_fwd_tc", "sake_resid_bwd", "sake_resid_bwd_tc")
    return SimpleNamespace(**{n: entry(n) for n in names},
                           **{f"{n}_smem_bytes": (lambda *d: 0) for n in names},
                           sake_resid_fwd_tc_route=lambda *d: int(fwd_tc_route(d)),
                           sake_resid_bwd_tc_route=lambda *d: int(tc_dims(d)),
                           sake_error_string=lambda err: b"refused")


def _stub_cuda(monkeypatch, lib):
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(resid_ef, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(resid_ef, "_stream", lambda dev: None)


def _meta_inputs(hid, N, B=3):
    """K1's and K2's inputs as meta tensors."""
    leaves = {n: t.to("meta") for n, t in _leaves(hid).items()}
    leaves_t = {n: t.to("meta") for n, t in transposed(_leaves(hid)).items()}
    depth = leaves["w_in_j"].shape[0]
    h0 = torch.empty(B, N, hid, device="meta")
    xs = torch.empty(3, B, N, device="meta")
    dims = resid_ef._dims(leaves, h0)
    e = lambda *s: torch.empty(s, device="meta")
    fwd = resid_ef.FwdOut(e(depth, B, N, hid), e(depth, 3, B, N), e(depth, 3, B, N),
                          e(B, N, hid), e(3, B, N), e(3, B, N),
                          {n: e(*s) for n, s in resid_ef._resid_shapes(dims, leaves).items()})
    return leaves, leaves_t, h0, xs, fwd, [1.0] * depth


def _run_both(leaves, leaves_t, h0, xs, fwd, upd, mask=None):
    resid_ef.resid_fwd(leaves, h0, xs, xs, upd, mask)
    resid_ef.resid_bwd(leaves, fwd, upd, h0, xs, xs, mask, leaves_t=leaves_t)


@pytest.mark.parametrize("hid,N", [(HID, n) for n in range(1, 41)] + [(8, 21), (16, 21),
                                                                      (16, 7)])
def test_route_by_shape_counted(monkeypatch, hid, N):
    """Each wrapper launches the kernel of the route its shape takes and counts
    the launch under it: aspirin's widths on the tensor cores (K1 up to 21 atoms,
    K2 up to 22), the narrow models on the CUDA cores."""
    calls = []
    _stub_cuda(monkeypatch, _stub_lib(calls))
    ins = _meta_inputs(hid, N)
    before = {k: (f.launches, dict(f.routes)) for k, f in (("K1", resid_ef.resid_fwd),
                                                          ("K2", resid_ef.resid_bwd))}
    _run_both(*ins)
    k1_tc, k2_tc = hid == HID and N <= 21, hid == HID and N <= 22
    assert calls == ["sake_resid_fwd_tc" if k1_tc else "sake_resid_fwd",
                     "sake_resid_bwd_tc" if k2_tc else "sake_resid_bwd"]
    for kind, fn, tc in (("K1", resid_ef.resid_fwd, k1_tc), ("K2", resid_ef.resid_bwd, k2_tc)):
        launches, routes = before[kind]
        assert fn.launches - launches == 1
        assert {r: fn.routes[r] - routes[r] for r in resid_ef.ROUTES} == {
            "tensor cores": int(tc), "CUDA cores": int(not tc)}


@pytest.mark.parametrize("masked", [False, True])
def test_masked_requests_take_the_same_route(monkeypatch, masked):
    calls = []
    _stub_cuda(monkeypatch, _stub_lib(calls))
    leaves, leaves_t, h0, xs, fwd, upd = _meta_inputs(HID, N_ASP)
    mask = torch.empty(3, N_ASP, N_ASP, 1, device="meta") if masked else None
    _run_both(leaves, leaves_t, h0, xs, fwd, upd, mask)
    assert calls == ["sake_resid_fwd_tc", "sake_resid_bwd_tc"]


@pytest.mark.parametrize("kind", ["K1", "K2"])
def test_refused_launch_raises_without_fallback(monkeypatch, kind):
    calls = []
    entry = "sake_resid_fwd_tc" if kind == "K1" else "sake_resid_bwd_tc"
    _stub_cuda(monkeypatch, _stub_lib(calls, refuse=(entry,)))
    leaves, leaves_t, h0, xs, fwd, upd = _meta_inputs(HID, N_ASP)
    fn = resid_ef.resid_fwd if kind == "K1" else resid_ef.resid_bwd
    before, routes = fn.launches, dict(fn.routes)
    name = "resid_fwd" if kind == "K1" else "resid_bwd"
    with pytest.raises(RuntimeError, match=rf"{name} \(tensor cores\): CUDA error 1: refused"):
        if kind == "K1":
            resid_ef.resid_fwd(leaves, h0, xs, xs, upd)
        else:
            resid_ef.resid_bwd(leaves, fwd, upd, h0, xs, xs, leaves_t=leaves_t)
    assert calls == [entry] and fn.launches == before and fn.routes == routes


def test_forced_route_is_refused_off_its_shape(monkeypatch):
    """``_launch_fwd``/``_bwd_launch`` with an explicit route pass it to its
    entry as asked (the kernel source refuses a shape off it); the rows kernel
    has no tensor-core route."""
    calls = []
    _stub_cuda(monkeypatch, _stub_lib(calls))
    leaves, leaves_t, h0, xs, fwd, upd = _meta_inputs(HID, 22)
    resid_ef._launch_fwd(leaves, h0, xs, xs, upd, None, "CUDA cores")
    resid_ef._bwd_launch("resid_bwd", leaves, fwd, upd, h0, xs, xs, None, leaves_t, False,
                         route="CUDA cores")
    assert calls == ["sake_resid_fwd", "sake_resid_bwd"]
    with pytest.raises(ValueError, match="rows kernel takes the block or the cluster route"):
        resid_ef._bwd_launch("resid_bwd_rows", leaves, fwd, upd, h0, xs, xs, None, leaves_t,
                             True, route="tensor cores")


def _misaligned(t):
    flat = torch.empty(t.numel() + 1)[1:]
    return flat.view(t.shape).copy_(t)


@pytest.mark.parametrize("kind,leaf", [("K1", "w_xmix"), ("K2", "w_xmix"), ("K2", "w_xmix.T")])
def test_tensor_core_route_refuses_a_misaligned_w_xmix(monkeypatch, kind, leaf):
    """mm_tc copies w_xmix (K1) and its transpose (K2) 16 bytes at a time: the
    tensor-core route refuses one that does not start 16-byte aligned; the
    CUDA-core route does not ask."""
    calls = []
    _stub_cuda(monkeypatch, _stub_lib(calls))
    B, N = 2, 7
    for hid, raises in ((HID, True), (8, False)):
        leaves = _leaves(hid)
        leaves_t = transposed(leaves)
        if leaf == "w_xmix":
            leaves["w_xmix"] = _misaligned(leaves["w_xmix"])
        else:
            leaves_t["w_xmix"] = _misaligned(leaves_t["w_xmix"])
        h0, xs = torch.zeros(B, N, hid), torch.zeros(3, B, N)
        upd = [1.0] * leaves["w_in_j"].shape[0]
        fwd = resid_ef.resid_fwd_plain(leaves, h0, xs, xs, upd)
        run = ((lambda: resid_ef._launch_fwd(leaves, h0, xs, xs, upd, None))
               if kind == "K1" else
               (lambda: resid_ef._bwd_launch("resid_bwd", leaves, fwd, upd, h0, xs, xs, None,
                                             leaves_t, False)))
        calls.clear()
        if raises:
            with pytest.raises(ValueError, match=rf"{re.escape(leaf)} must start at a 16-byte"):
                run()
            assert calls == []
        else:
            run()
            assert calls == ["sake_resid_fwd" if kind == "K1" else "sake_resid_bwd"]


@pytest.fixture(scope="module")
def aspirin_width():
    """Aspirin's widths at B = 2, depth 2: the linen model's weights, the
    inputs, an edge mask (the second molecule's last 5 atoms padding) and the
    JAX ``resid_energy_forces`` run by the Pallas interpreter, unmasked and
    masked."""
    from sake_tpu.kernels.resid_ef import resid_energy_forces as jax_ref

    rng = np.random.RandomState(17)
    h = rng.randn(2, N_ASP, 5).astype(np.float32)
    x = (1.5 * rng.randn(2, N_ASP, 3)).astype(np.float32)
    nm = np.ones((2, N_ASP), np.float32)
    nm[1, -5:] = 0.0
    mask = nm[:, :, None] * nm[:, None, :]
    model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=2, n_heads=HEADS)
    params = jax.jit(model.init)(jax.random.PRNGKey(4), jnp.asarray(h), jnp.asarray(x))
    kp = jax_from_linen(params)
    ref = {}
    for label, m in (("unmasked", None), ("masked", mask)):
        e, f = jax_ref(kp, jnp.asarray(h), jnp.asarray(x),
                       None if m is None else jnp.asarray(m), n_heads=HEADS, batch_tile=2,
                       interpret=True)
        ref[label] = (np.asarray(e), np.asarray(f))
    tree = jax.tree.map(np.asarray, jax.device_get(params))
    return dict(h=h, x=x, mask=mask, params=tree, ref=ref)


@pytest.mark.parametrize("label", ["unmasked", "masked"])
def test_resid_energy_forces_matches_jax_interpret_at_aspirin_width(aspirin_width, label):
    s = aspirin_width
    tp = model_params_from_linen(s["params"])
    assert tc_dims(_dims(HID, N_ASP, B=2, depth=2))  # the card's tensor-core route
    assert fwd_tc_route(_dims(HID, N_ASP, B=2, depth=2))
    mask = torch.as_tensor(s["mask"]) if label == "masked" else None
    e, f = resid_ef.resid_energy_forces(tp, torch.as_tensor(s["h"]), torch.as_tensor(s["x"]),
                                        mask, n_heads=HEADS)
    e_ref, f_ref = s["ref"][label]
    assert e.shape == (2,) and f.shape == (2, N_ASP, 3)
    np.testing.assert_allclose(e.numpy(), e_ref, **TOL)
    np.testing.assert_allclose(f.numpy(), f_ref, **TOL)


def column_split_plain(a, w, warps: int, strip: int = 16, chunk: int = WG_CHUNK):
    """``a @ w`` as ``mm_tc`` computes it in a block of ``warps`` warps: warp
    ``q`` takes the 16-column strips ``q``, ``q + warps``, ... in turn, each strip
    in chunks of ``chunk`` k of ``lo(a) hi(w) + hi(a) lo(w) + hi(a) hi(w)``
    summed from zero, then added to the strip's running f32 sum."""
    ah, al = tf32_split(a)
    wh, wl = tf32_split(w)
    out = torch.full((a.shape[0], w.shape[1]), float("nan"))
    for q in range(warps):
        for s0 in range(q * strip, w.shape[1], warps * strip):
            cols = slice(s0, s0 + strip)
            acc = torch.zeros(a.shape[0], strip)
            for k0 in range(0, a.shape[1], chunk):
                k = slice(k0, k0 + chunk)
                acc = acc + ((al[:, k] @ wh[k, cols] + ah[:, k] @ wl[k, cols])
                             + ah[:, k] @ wh[k, cols])
            out[:, cols] = acc
    return out


def _operands(n, k, m, trans, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((m, k) if trans else (k, m))
                          / np.sqrt(k)).astype(np.float32))
    return a, w.T.contiguous() if trans else w


def _rel(got, a, w):
    ref = a.double() @ w.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("product,warps,trans", [("K1 x-mixing he_att @ w_xmix", 8, False),
                                                 ("K2 x-mixing pullback d_xm @ w_xmix^T", 16,
                                                  True)])
def test_column_split_product_against_float64(product, warps, trans, seed):
    a, w = _operands(N_ASP, HID * HEADS, C, trans, seed)
    got = column_split_plain(a, w, warps)
    assert bool(torch.isfinite(got).all())  # every column once
    assert _rel(got, a, w) <= PRODUCT_TOL
    # the split sums each column as the unsplit chunked model does
    assert torch.equal(got, mm_tf32x3_chunked_plain(a, w))
    assert torch.equal(resid_ef.tc_product(a, w, warps), got)


def test_one_tf32_pass_misses_the_f32_tier():
    a, w = _operands(N_ASP, HID * HEADS, C, False, 0)
    assert _rel(mm_tf32_plain(a, w), a, w) >= 1e-4


@pytest.mark.gpu
def test_serving_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = importlib.util.spec_from_file_location("probe_resid", ROOT / "tools" / "probe_resid.py")
    pr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pr)
    res = pr.check_serving_on_card(torch.device("cuda", 0))
    assert max(res.pop("products").values()) <= pr.TC_PRODUCT_TOL
    bitwise = res.pop("bitwise")
    assert len(res) == 8 and all(bitwise.values())
    for case, errs in res.items():
        assert max(errs.values()) <= CARD_TOL, (case, errs)
