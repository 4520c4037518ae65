"""The split forwards #25 (the edge_att and coeff_pool ops) and #27 (the merged
op) and their pullbacks #26 and #28 on their Hopper route: ``64 // N`` receiver
rows of a molecule as one 64-row tile, the x-mixing product (and in a pullback
its transpose) on ``wgmma``, the edge products on ``mma.sync``, all in 3xTF32
(``csrc/split_edge.cuh``'s ``split_tc_fwd_kernel`` and ``split_tc_kernel``),
where the shape allows it; the CUDA-core kernel (``split_kernel``) elsewhere.

On the CPU:
- the grouped tile through the plain model of the product
  (``kernels/tf32.mm_tf32x3_chunked_plain``): g rows of N edges stacked into 64
  rows, forward and transposed, within 1e-6 of max |ref| of a float64 product,
  the padding rows adding nothing (the stacked rows give the unpadded product
  bit for bit, the padding rows zeros);
- a plain mirror of the grouped coeff_pool forward (the groups in the kernel's
  order, the x-mixing through the same model, hatt_sum and the pooled planes
  summed over the senders in order) within 1e-6 of max |ref| of the float64 body;
- the groups of receiver rows cover each row once, at most 64 edges a tile;
- the route rule of each direction (H * K = 256, C = 256 where the op mixes x, R
  and H at most 64, at most 16 heads, g = 64 // N, the direction's carve under
  232,448 bytes with the deepest ring that fits) mirrored here and held against
  the header compiled on the host (``g++`` against
  ``tools/cuda_emu/cuda_runtime.h``) and against the sources' own entries
  (``sake_split_fwd_tc``, ``sake_split_bwd_tc``, ``sake_split_smem_bytes``),
  compiled the same way (``tools/cuda_emu/emulate.compile_source``);
- the wrappers on meta tensors (a stand-in for CUDA ones) with a stub library:
  each launch, forward and pullback, counted under the route the mirror gives,
  the packed x-mixing planes passed only where the direction's tensor-core route
  mixes x; a refused launch raising with nothing else tried; misaligned planes
  refused;
- on CPU tensors the wrappers take the plain versions bit for bit and leave every
  launch and route count at 0.

On the card (``gpu``-marked): ``tools/probe_split.check_on_card``, the three
forwards against their plain bodies and the three pullbacks against
``vjp_plain`` at aspirin's widths (N = 21, 22, 17: the tensor cores) and at
hidden 8 and 16 (N = 7: the CUDA cores), 1e-4 relative per tensor, two launches
bit for bit.
"""

import ctypes
import functools
import importlib.util
import subprocess
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from sake_tpu_torch.kernels import build, split_ef
from sake_tpu_torch.kernels.functional import EPSILON
from sake_tpu_torch.kernels.tf32 import mm_tf32x3_chunked_plain

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "sake_tpu_torch" / "csrc"
OPS = ("edge_att", "coeff_pool", "merged")
R, HEADS = 50, 4
SMEM_LIMIT = 232448  # kSplitSmemLimit
SMEM_SM, SMEM_RESERVED = 233472, 1024  # an SM's shared memory, reserved a block
WG_ROWS, WG_COLS, WG_XPAD, WG_STAGE = 64, 256, 4, 2 * 256 * 8  # wgmma_tf32.cuh
MIN_STAGES, MAX_STAGES = 2, 4  # kWgMinStages, kWgMaxStages
TC_SMALL_K = 64  # kTcSmallK
MAX_HEADS = 16  # kSplitMaxHeads
# (hidden, N) of the route cases: aspirin's widths on the tensor cores up to 64
# atoms (the merged pullback's carve is over the limit at 64), 65 not; the narrow
# models (H * K = 32, 64, 128) never
SHAPES = [(64, 1), (64, 7), (64, 10), (64, 17), (64, 21), (64, 22), (64, 29), (64, 33),
          (64, 64), (64, 65), (8, 7), (16, 7), (16, 21), (32, 21)]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dims(kind, hid, N, B=512):
    """``(B, N, R, H, K, C)`` as ``split_ef._dims`` gives them (the edge_att op
    has no C)."""
    C = 0 if kind == "edge_att" else (256 if hid * HEADS == 256 else hid * HEADS)
    return (B, N, 0 if kind == "coeff_pool" else R, hid, HEADS, C)


# --------------------------------------------------------------------------
# the mirror of the header's rule
# --------------------------------------------------------------------------


def tc_rows(N):
    """``split_tc_rows``: receiver rows a tile."""
    return min(WG_ROWS // N, N)


def split_ld(k):
    """``split_ld``: an operand's row stride for ``mm_tc_small``, k rounded up to
    8 and then to an odd multiple of 8."""
    return ((k + 7) & ~7) | 8


def tc_groups(N):
    """The groups of receiver rows ``(first, count)`` that ``split_tc_kernel``
    runs: ``tc_rows(N)`` at a time, the last group what is left."""
    g = tc_rows(N)
    return [(i0, min(g, N - i0)) for i0 in range(0, N, g)]


def tc_floats(kind, dims, stages, pull=True):
    """``carve_split_tc``'s floats (each buffer rounded up to 4) for a pullback:
    the group's buffers (no rbf), the sender sums, the molecule's a_j and o_j and
    the weights' vectors (kEA), then X and the ring (kCP) beside se and df, which
    share one buffer (kEA). For a forward (``pull`` false), ``carve_split_fwd``'s:
    (kEA) r, t, the group's a_i and o_i, filtered (the edge_att op's h_e over it),
    silu(e0) (those two with rows ``split_ld`` apart), sem_pre, att and the
    weights' vectors; (kCP) u, the ring's barriers, X and the ring, nothing laid
    over another."""
    B, N, R_, H, K, C = dims
    ea, cp = kind != "coeff_pool", kind != "edge_att"
    g = tc_rows(N)
    M, HK = g * N, H * K
    r4 = lambda n: (n + 3) & ~3
    vectors = [R_, R_, H, H, H, K, H * K]
    if not pull:
        main = []
        if ea:
            ldf = split_ld(R_)
            main += [M, M, g * R_, g * H, M * (ldf if cp else max(ldf, H)), M * split_ld(H),
                     M * K, M * K, *vectors]
        if cp:
            main += [3 * M, 4 * stages, WG_ROWS * (WG_COLS + WG_XPAD), stages * WG_STAGE]
        return sum(r4(n) for n in main)
    main = [3 * M, M, M, M, M, M * H, M * K, M * H, M * K, 3 * M, M, 3 * N]
    if ea:
        main += [g * R_, g * H, M * R_, M * H, M * K, N * R_, N * H, N * R_, N * H, *vectors]
    if cp:
        main += [g * 3 * C, g * HK, 4 * stages]
    wide = r4(WG_ROWS * (WG_COLS + WG_XPAD)) + r4(stages * WG_STAGE) if cp else 0
    rest = r4(M * max(H, R_)) if ea else 0
    return sum(r4(n) for n in main) + max(wide, rest)


def tc_stages(kind, dims, pull=True):
    """``split_tc_stages`` (``split_fwd_stages``): the deepest ring that fits one
    block (0 without one), or None."""
    if kind == "edge_att":
        return 0 if 4 * tc_floats(kind, dims, 0, pull) <= SMEM_LIMIT else None
    for s in range(MAX_STAGES, MIN_STAGES - 1, -1):
        if 4 * tc_floats(kind, dims, s, pull) <= SMEM_LIMIT:
            return s
    return None


def tc_route(kind, dims, pull=True):
    """``split_bwd_tc`` (``split_fwd_tc``): the widths and a carve that fits."""
    B, N, R_, H, K, C = dims
    widths = (1 <= N <= WG_ROWS and H * K == 256 and (kind == "edge_att" or C == 256)
              and R_ <= TC_SMALL_K and H <= TC_SMALL_K and K <= MAX_HEADS)
    return widths and tc_stages(kind, dims, pull) is not None


@pytest.fixture(scope="module")
def split_host(tmp_path_factory):
    """``csrc/split_bwd.cu`` and ``csrc/split_fwd.cu`` compiled on the host
    against the CPU emulator's ``cuda_runtime.h`` (launches rewritten,
    ``tools/cuda_emu/emulate.compile_source``), their route and carve entries
    declared; and ``(split_tc_rows, the route, its stages or -1, split_smem(op,
    pull))`` of the header in each direction at every op and ``SHAPES``, from a
    program compiled against the same rewritten sources."""
    emu = _load("emulate", ROOT / "tools" / "cuda_emu" / "emulate.py")
    tmp = tmp_path_factory.mktemp("split_host")
    libs = [build.declare(ctypes.CDLL(str(emu.compile_source(src, tmp / src, False,
                                                             opt=("-O0",)))), names)
            for src, names in (("split_bwd.cu", ["sake_split_bwd_tc"]),
                               ("split_fwd.cu", ["sake_split_fwd_tc", "sake_split_smem_bytes"]))]
    cases = ", ".join(f"{{{split_ef._OPS[k]}, {h}, {n}}}" for k in OPS for h, n in SHAPES)
    (tmp / "route.cpp").write_text(
        '#include "cuda_runtime.h"\n#include "split_edge.cuh"\n#include <cstdio>\n'
        f"int main() {{\n  const int cases[][3] = {{{cases}}};\n"
        "  for (const auto& c : cases) {\n    const int op = c[0], hid = c[1], N = c[2];\n"
        "    const int C = op == 0 ? 0 : (hid == 64 ? 256 : 4 * hid);\n"
        "    const sake::SDims d{512, N, op == 1 ? 0 : 50, hid, 4, C};\n"
        "    const int st = op == 0 ? sake::split_tc_stages<true, false>(d)\n"
        "                 : op == 1 ? sake::split_tc_stages<false, true>(d)\n"
        "                           : sake::split_tc_stages<true, true>(d);\n"
        "    const int fst = op == 0 ? sake::split_fwd_stages<true, false>(d)\n"
        "                  : op == 1 ? sake::split_fwd_stages<false, true>(d)\n"
        "                            : sake::split_fwd_stages<true, true>(d);\n"
        '    std::printf("%d %d %d 1 %d %d %d %lld\\n", op, hid, N, sake::split_tc_rows(N),\n'
        "                (int)sake::split_bwd_tc(op, d), st, sake::split_smem(op, true, d));\n"
        '    std::printf("%d %d %d 0 %d %d %d %lld\\n", op, hid, N, sake::split_tc_rows(N),\n'
        "                (int)sake::split_fwd_tc(op, d), fst, sake::split_smem(op, false, d));\n"
        "  }\n}\n")
    subprocess.run(["g++", "-std=c++20", "-O0", "-I", str(ROOT / "tools" / "cuda_emu"), "-I",
                    str(tmp / "split_bwd.cu" / "src"), "-x", "c++", str(tmp / "route.cpp"),
                    "-o", str(tmp / "route"), "-lpthread"], check=True)
    out = subprocess.run([str(tmp / "route")], capture_output=True, text=True, check=True).stdout
    rows = (list(map(int, line.split())) for line in out.splitlines())
    rule = {(OPS[op], h, n, bool(pull)): (g, bool(tc), st, smem)
            for op, h, n, pull, g, tc, st, smem in rows}
    return SimpleNamespace(rule=rule, sake_split_bwd_tc=libs[0].sake_split_bwd_tc,
                           sake_split_fwd_tc=libs[1].sake_split_fwd_tc,
                           sake_split_smem_bytes=libs[1].sake_split_smem_bytes)


DIRECTIONS = pytest.mark.parametrize("pull", [True, False], ids=["bwd", "fwd"])


@DIRECTIONS
@pytest.mark.parametrize("kind", OPS)
@pytest.mark.parametrize("hid,N", SHAPES)
def test_route_mirror_is_the_header_rule(split_host, kind, hid, N, pull):
    dims = _dims(kind, hid, N)
    g, tc, stages, smem = split_host.rule[(kind, hid, N, pull)]
    assert g == tc_rows(N)
    assert tc is tc_route(kind, dims, pull)
    assert (None if stages < 0 else stages) == tc_stages(kind, dims, pull)
    if tc:
        assert smem == 4 * tc_floats(kind, dims, stages, pull) <= SMEM_LIMIT
    # aspirin's widths up to 33 atoms (and to 64 but for the merged pullback, whose
    # carve is over the limit there; the forwards keep no sender sums and fit),
    # every op; no narrow model
    assert tc is (hid == 64 and (N <= 33 or (N <= 64 and (kind != "merged" or not pull))))


@DIRECTIONS
@pytest.mark.parametrize("kind", OPS)
@pytest.mark.parametrize("hid,N", SHAPES)
def test_sources_route_and_carve_by_the_rule(split_host, kind, hid, N, pull):
    """Each direction's source reports the header's route, and the forward
    source's carve entry sizes the direction by the kernel that route launches."""
    dims = _dims(kind, hid, N)
    _, tc, _, smem = split_host.rule[(kind, hid, N, pull)]
    op = split_ef._OPS[kind]
    entry = split_host.sake_split_bwd_tc if pull else split_host.sake_split_fwd_tc
    assert bool(entry(op, *dims)) is tc
    assert split_host.sake_split_smem_bytes(op, int(pull), *dims) == smem


@DIRECTIONS
def test_aspirin_carves_and_rings(pull):
    """At aspirin's 21 atoms: three rows a tile. The pullbacks: coeff_pool keeps
    the deepest ring, merged three stages (se and df lie under X and the ring).
    The forwards: both ops that mix x the deepest ring in one block an SM, the
    edge_att op four blocks an SM (228 KB, 1 KB reserved a block)."""
    stages = {k: tc_stages(k, _dims(k, 64, 21), pull) for k in OPS}
    assert tc_rows(21) == 3
    if pull:
        assert stages == {"edge_att": 0, "coeff_pool": 4, "merged": 3}
        assert 4 * tc_floats("merged", _dims("merged", 64, 21), 3) <= SMEM_LIMIT
        return
    assert stages == {"edge_att": 0, "coeff_pool": 4, "merged": 4}
    size = lambda k, st: 4 * tc_floats(k, _dims(k, 64, 21), st, False)
    assert 4 * (size("edge_att", 0) + SMEM_RESERVED) <= SMEM_SM
    assert size("coeff_pool", 4) <= SMEM_LIMIT and size("merged", 4) <= SMEM_LIMIT


# --------------------------------------------------------------------------
# the grouped tile
# --------------------------------------------------------------------------


@pytest.mark.parametrize("N", [1, 7, 10, 17, 21, 22, 33, 64])
def test_groups_cover_each_row_once(N):
    groups = tc_groups(N)
    rows = [i0 + k for i0, n in groups for k in range(n)]
    assert rows == list(range(N))
    assert all(n * N <= WG_ROWS for _, n in groups)
    assert all(n == tc_rows(N) for _, n in groups[:-1])


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("N", [21, 22, 17, 7])
def test_grouped_tile_product_matches_float64(N, transposed):
    """Each group's g rows of N edges, stacked as the rows of one 64-row tile
    (zeros below), through the chunked 3xTF32 model of ``wg_xmix``: within 1e-6
    of max |ref| of the float64 product, the group's rows bit for bit the
    unpadded product, the padding rows zeros."""
    gen = torch.Generator().manual_seed(N + 100 * transposed)
    w = 0.3 * torch.randn(256, 256, generator=gen) / 16
    rows = torch.randn(N * N, 256, generator=gen)  # a molecule's edges, (b, i, j) order
    if transposed:
        w = w.T.contiguous()
    for i0, n in tc_groups(N):
        x = rows[i0 * N:(i0 + n) * N]
        tile = torch.zeros(WG_ROWS, 256)
        tile[: n * N] = x
        out = mm_tf32x3_chunked_plain(tile, w)
        ref = x.double() @ w.double()
        err = float((out[: n * N].double() - ref).abs().max() / ref.abs().max())
        assert err <= 1e-6, (i0, err)
        assert torch.equal(out[: n * N], mm_tf32x3_chunked_plain(x, w))
        assert not out[n * N:].any()


def grouped_coeff_pool(x0, x1, x2, h_e, att, w_xmix):
    """The coeff_pool forward as ``split_group_fwd`` orders it: each molecule's
    groups of ``tc_rows(N)`` receiver rows, their edges the rows of one 64-row
    tile (zeros below); u_k = d_k / (r + 1e-5); hatt_sum the tile's rows summed
    over the senders in order; coeff = tanh of the tile through
    ``mm_tf32x3_chunked_plain``; the pooled planes summed over the senders in
    order. Returns the body's four outputs and coeff's padding rows, a tile each."""
    B, N, _, H = h_e.shape
    K, C = att.shape[-1], w_xmix.shape[-1]
    HK = H * K
    xs = torch.cat([x0, x1, x2], dim=-1)
    pooled, hs, pads = torch.zeros(3, B, N, C), torch.zeros(B, N, HK), []
    for b in range(B):
        for i0, gn in tc_groups(N):
            M, rows = gn * N, slice(i0, i0 + gn)
            tile = torch.zeros(WG_ROWS, HK)
            tile[:M] = (h_e[b, rows, :, :, None] * att[b, rows, :, None, :]).reshape(M, HK)
            d = (xs[b][None] - xs[b, rows][:, None]).reshape(M, 3)  # x_j - x_i
            s = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            u = d * (1.0 / (torch.sqrt(torch.relu(s) + EPSILON) + 1e-5))[:, None]
            coeff = torch.tanh(mm_tf32x3_chunked_plain(tile, w_xmix))
            pads.append(coeff[M:])
            for ii in range(gn):
                a, p = torch.zeros(HK), torch.zeros(3, C)
                for j in range(N):
                    a = a + tile[ii * N + j]
                    p = p + coeff[ii * N + j][None] * u[ii * N + j][:, None]
                hs[b, i0 + ii], pooled[:, b, i0 + ii] = a, p
    return (*pooled, hs), pads


@pytest.mark.parametrize("N", [21, 22, 17, 7])
def test_grouped_forward_matches_float64(N):
    """The grouped coeff_pool forward's plain mirror (on the edge_att body's h_e
    and att at aspirin's widths) within 1e-6 of max |ref| of the float64 body in
    every output, the padding rows zeros."""
    args, _ = _cpu_args(64, N)
    outs, pads = grouped_coeff_pool(*args["coeff_pool"])
    ref = split_ef.coeff_pool_body(*(t.double() for t in args["coeff_pool"]))
    for name, o, r in zip(("pooled0", "pooled1", "pooled2", "hatt_sum"), outs, ref):
        err = float((o.double() - r).abs().max() / r.abs().max())
        assert err <= 1e-6, (name, err)
    assert not any(p.any() for p in pads)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------


def _split_lib(calls, refuse=False):
    """A library whose pullback entry records ``(op, route, weight pointers)``,
    whose forward entry records ``(op, "fwd", route, weight pointers)`` and whose
    route entries are the mirror."""
    def bwd(op, ins, w, g, out, rows, *a):
        kind = OPS[op]
        calls.append((kind, split_ef.ROUTES[tc_route(kind, a[:6])], len(w)))
        return 1 if refuse else 0

    def fwd(op, ins, w, out, *a):
        kind = OPS[op]
        calls.append((kind, "fwd", split_ef.ROUTES[tc_route(kind, a[:6], False)], len(w)))
        return 1 if refuse else 0

    return SimpleNamespace(sake_split_bwd=bwd, sake_split_fwd=fwd,
                           sake_split_bwd_tc=lambda op, *d: int(tc_route(OPS[op], d)),
                           sake_split_fwd_tc=lambda op, *d: int(tc_route(OPS[op], d, False)),
                           sake_split_smem_bytes=lambda *a: 0,
                           sake_error_string=lambda err: b"refused")


def _stub(monkeypatch, lib, calls):
    """The stub library in place of the build, each packing of the x-mixing
    planes recorded in ``calls``, the launch counts restored after the test."""
    real = split_ef.xmix_planes

    def planes(w, pullback=True):
        calls.append("xmix_planes")
        return real(w, pullback)

    monkeypatch.setattr(split_ef, "xmix_planes", planes)
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(split_ef, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(split_ef, "_stream", lambda dev: None)
    for fn in (*split_ef.FWD.values(), *split_ef.BWD.values()):
        monkeypatch.setattr(fn, "launches", fn.launches)
        monkeypatch.setattr(fn, "routes", dict(fn.routes))


@functools.lru_cache(maxsize=None)
def _cpu_args(hid, N, B=2):
    ps = _load("probe_split", ROOT / "tools" / "probe_split.py")
    args = ps.model_args(torch.device("cpu"), hid, B, N, seed=hid + N)
    return args, ps.cotangents(args, seed=N)


def _meta(kind, hid, N):
    args, cots = _cpu_args(hid, N)
    return ([a.to("meta") for a in args[kind]], [c.to("meta") for c in cots[kind]])


@pytest.mark.parametrize("kind", OPS)
@pytest.mark.parametrize("hid,N", [(64, 21), (64, 22), (64, 7), (8, 7), (16, 7)])
def test_pullbacks_count_the_route_of_each_launch(monkeypatch, kind, hid, N):
    calls = []
    _stub(monkeypatch, _split_lib(calls), calls)
    args, cots = _meta(kind, hid, N)
    fn = split_ef.BWD[kind]
    before, routes = fn.launches, dict(fn.routes)
    outs, dw = fn(args, cots, False)
    route = "tensor cores" if hid == 64 else "CUDA cores"
    planes = ["xmix_planes"] if route == "tensor cores" and kind != "edge_att" else []
    assert calls == [*planes, (kind, route, 16)]
    assert [o.shape for o in outs] == [a.shape for a in args[:split_ef.N_BATCHED[kind]]]
    assert dw is None and fn.launches - before == 1
    assert {r: fn.routes[r] - routes[r] for r in split_ef.ROUTES} == {
        r: int(r == route) for r in split_ef.ROUTES}


@pytest.mark.parametrize("kind", OPS)
def test_refused_pullback_raises_without_fallback(monkeypatch, kind):
    calls = []
    _stub(monkeypatch, _split_lib(calls, refuse=True), calls)
    args, cots = _meta(kind, 64, 21)
    fn = split_ef.BWD[kind]
    before, routes = fn.launches, dict(fn.routes)
    with pytest.raises(RuntimeError, match=rf"{kind}_bwd: CUDA error 1: refused"):
        fn(args, cots, False)
    assert calls == [*(["xmix_planes"] if kind != "edge_att" else []), (kind, "tensor cores", 16)]
    assert fn.launches == before and fn.routes == routes


def _misaligned_planes(monkeypatch, launch):
    """``launch()`` with x-mixing planes that start 4 bytes off: refused before
    any launch."""
    calls = []
    _stub(monkeypatch, _split_lib(calls), calls)
    real = split_ef.xmix_planes

    def misaligned(w, pullback=True):
        out = []
        for p in real(w, pullback):
            flat = None if p is None else torch.empty(p.numel() + 1)[1:]
            out.append(None if p is None else flat.view(p.shape).copy_(p))
        return out

    monkeypatch.setattr(split_ef, "xmix_planes", misaligned)
    with pytest.raises(ValueError, match="x-mixing planes must start 16-byte aligned"):
        launch()
    assert calls == ["xmix_planes"]


@pytest.mark.parametrize("kind", ["coeff_pool", "merged"])
def test_tensor_core_route_refuses_misaligned_planes(monkeypatch, kind):
    """The ring's bulk copies need 16-byte addresses: planes that do not start
    so are refused before any launch."""
    args, cots = _cpu_args(64, 21)
    _misaligned_planes(monkeypatch, lambda: split_ef._launch_bwd(
        f"{kind}_bwd", kind, args[kind], cots[kind], False))


@pytest.mark.parametrize("kind", ["coeff_pool", "merged"])
def test_forward_tensor_core_route_refuses_misaligned_planes(monkeypatch, kind):
    args, _ = _cpu_args(64, 21)
    _misaligned_planes(monkeypatch, lambda: split_ef._launch_fwd(f"{kind}_fwd", kind, args[kind]))


@pytest.mark.parametrize("kind", OPS)
@pytest.mark.parametrize("hid,N", [(64, 21), (64, 22), (64, 7), (8, 7), (16, 7)])
def test_forwards_count_the_route_of_each_launch(monkeypatch, kind, hid, N):
    """Each forward launch counts under the route the mirror gives, the forward
    plane of w_xmix packed and passed only where the tensor-core route mixes x."""
    calls = []
    _stub(monkeypatch, _split_lib(calls), calls)
    args, _ = _meta(kind, hid, N)
    fn = split_ef.FWD[kind]
    before, routes = fn.launches, dict(fn.routes)
    outs = fn(*args)
    route = "tensor cores" if hid == 64 else "CUDA cores"
    mixes = route == "tensor cores" and kind != "edge_att"
    assert calls == [*(["xmix_planes"] if mixes else []), (kind, "fwd", route, 16)]
    want = split_ef.BODIES[kind](*_cpu_args(hid, N)[0][kind])
    assert [o.shape for o in outs] == [w.shape for w in want]
    assert fn.launches - before == 1
    assert {r: fn.routes[r] - routes[r] for r in split_ef.ROUTES} == {
        r: int(r == route) for r in split_ef.ROUTES}


@pytest.mark.parametrize("pull", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("kind", ["coeff_pool", "merged"])
def test_each_direction_packs_only_the_planes_it_reads(monkeypatch, kind, pull):
    """On the tensor-core route a forward packs only the forward plane of
    w_xmix (the pullback's slot stays null); a pullback packs both."""
    calls = []
    _stub(monkeypatch, _split_lib(calls), calls)
    args, _ = _meta(kind, 64, 21)
    fwd_plane, bwd_plane = split_ef._setup(kind, kind, args, pull)[-1][1][-2:]
    assert calls == ["xmix_planes"]
    assert tuple(fwd_plane.shape) == (32, 2, 32, 2, 8, 4)
    assert (bwd_plane is not None) is pull


@pytest.mark.parametrize("kind", OPS)
def test_refused_forward_raises_without_fallback(monkeypatch, kind):
    calls = []
    _stub(monkeypatch, _split_lib(calls, refuse=True), calls)
    args, _ = _meta(kind, 64, 21)
    fn = split_ef.FWD[kind]
    before, routes = fn.launches, dict(fn.routes)
    with pytest.raises(RuntimeError, match=rf"{kind}_fwd: CUDA error 1: refused"):
        fn(*args)
    mixes = kind != "edge_att"
    assert calls == [*(["xmix_planes"] if mixes else []), (kind, "fwd", "tensor cores", 16)]
    assert fn.launches == before and fn.routes == routes


@pytest.mark.parametrize("kind", OPS)
def test_cpu_tensors_take_the_plain_forwards(kind):
    args, _ = _cpu_args(64, 21)
    fn = split_ef.FWD[kind]
    out = fn(*args[kind])
    assert all(torch.equal(a, b) for a, b in zip(out, split_ef.BODIES[kind](*args[kind])))
    assert fn.launches == 0 and set(fn.routes.values()) == {0}


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("kind", OPS)
def test_cpu_tensors_take_the_plain_pullbacks(kind, weights):
    args, cots = _cpu_args(64, 21)
    fn = split_ef.BWD[kind]
    gb, gw = fn(args[kind], cots[kind], weights)
    pb, pw = split_ef.vjp_plain(kind, args[kind], cots[kind], weights)
    assert all(torch.equal(a, b) for a, b in zip(gb, pb))
    assert (gw is None) is (pw is None) is (not weights)
    if weights:
        assert all(torch.equal(a, b) for a, b in zip(gw, pw))
    assert fn.launches == 0 and set(fn.routes.values()) == {0}


def test_probe_split_reads_its_slots():
    """``tools/probe_split.py`` reads the split kernels' slots of
    ``csrc/probe.cuh`` (``tools/probe_fused.py``'s ``SLOTS`` is the enum's
    order, held by ``tests/test_torch_contract.py``)."""
    ps = _load("probe_split", ROOT / "tools" / "probe_split.py")
    fused = _load("probe_fused", ROOT / "tools" / "probe_fused.py").SLOTS
    assert ps.N_SLOTS == len(fused)
    assert tuple(fused[ps.SLOT0:ps.SLOT0 + len(ps.SLOTS)]) == ps.SLOTS


@pytest.mark.gpu
def test_split_pullbacks_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ps = _load("probe_split", ROOT / "tools" / "probe_split.py")
    assert ps.check_on_card(torch.device("cuda", 0))
