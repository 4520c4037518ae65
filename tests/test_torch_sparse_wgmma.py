"""The tensor-core route of the sparse edge kernels #13-#15
(``csrc/wgmma_tf32.cuh``: the x-mixing product and its transpose on ``wgmma`` in
3xTF32 with chunked sums), through its plain model and its host side, on the CPU.

- The plain model of the product (``kernels/tf32.mm_tf32x3_chunked_plain``: hi/lo
  split, each chunk of 32 k summed from zero, then added in f32) at the sparse
  shapes, a row's 64 slots (and 48, padded with zero rows to the 64-row tile)
  against w_xmix (the forward) and its transpose (the pullback): within 1e-6 of
  max |ref| of a float64 product, as close as the plain f32 product (the kernels'
  gates are 1e-4 relative per tensor), and the padded rows add nothing.
- The host-side split and packing of w_xmix and t_xmix (``sparse_ef.xmix_planes``)
  bit for bit against a numpy reference of ``cvt.rna.tf32.f32`` and of the packed
  layout ``wgmma_tf32.cuh`` reads.
- At the sparse tasks' widths the wrappers still take their plain versions on
  CPU tensors, bit for bit, with every launch count left at 0 (the model too),
  and the wrappers' checks of the route's widths and of the planes' alignment.
- A K over the route's limit of slots raises, naming the limit.
- #15's dual tile (``csrc/sparse_edge.cuh``'s ``edge_wide_dl``): 32 slots' value
  rows stacked over their tangent rows in one 64-row tile give, through the plain
  model, the value and the tangent products (within 1e-6 of max |ref| of float64,
  K = 48 and 37, w_xmix and its transpose), the padded rows add nothing, and the
  dual tanh that pairs tile row r with row r + 32 is the dual-number rule; on CPU
  tensors ``sparse_bwd2`` is its plain version bit for bit and launches nothing;
  on the route it raises at other widths and above its limit of slots, before
  any launch.
- ``gpu``-marked: ``tools/probe_sparse.py``'s ``check_on_card`` (#13, #14 and #14
  with the leaf gradients against their plain versions on the card at K = 64, 48,
  80, 96, 128 (two and three tiles) and 37 (not a multiple of 8), 1e-4 relative
  per tensor, and two launches bitwise equal) and ``check_slot_limit`` (the same
  at the most slots the route takes, and one more raising); #15 alike
  (``check_bwd2_on_card`` at K = 48, 37, 16, ``check_bwd2_slot_limit``). They skip here;
  ``tools/sparse_ab.py`` and ``chip_smoke.py`` run them on the card without
  pytest, whose conftest needs JAX.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sake_tpu_torch.kernels import sparse_ef as se
from sake_tpu_torch.kernels.tf32 import (
    WG_CHUNK,
    mm_tf32x3_chunked_plain,
    tf32_split,
    wgmma_planes,
)
from sake_tpu_torch.sparse import neighbor_list
from sake_tpu_torch.tasks.sparse_md import make_params

TC = se.XMIX_TC_WIDTH  # H * heads = C of the route
_spec = importlib.util.spec_from_file_location(  # the seeded inputs and the check on the card
    "probe_sparse", Path(__file__).resolve().parents[1] / "tools" / "probe_sparse.py")
PS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PS)
sparse_inputs, _rel = PS.sparse_inputs, PS._rel


def _operands(rows, transposed, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((rows, TC)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((TC, TC)) / np.sqrt(TC)).astype(np.float32))
    return a, (w.T.contiguous() if transposed else w)


@pytest.mark.parametrize("rows", [64, 48])
@pytest.mark.parametrize("transposed", [False, True], ids=["forward", "pullback"])
def test_chunked_split_product_is_f32_accurate(rows, transposed):
    a, w = _operands(rows, transposed)
    tile = torch.zeros(64, TC)
    tile[:rows] = a  # the 64-row tile, zero rows below a short row's slots
    got = mm_tf32x3_chunked_plain(tile, w)
    ref = a.double() @ w.double()
    assert _rel(got[:rows], ref) <= 1e-6
    assert _rel(a @ w, ref) <= 1e-6
    assert not got[rows:].any()


def _tf32_np(x):
    """cvt.rna.tf32.f32 on the uint32 view: add half an ulp of the 10-bit
    significand, then drop the low 13 bits; inf and NaN unchanged."""
    u = x.view(np.uint32).astype(np.uint64)
    finite = (u & 0x7F800000) != 0x7F800000
    r = np.where(finite, (u + 0x1000) & 0xFFFFE000, u)
    return r.astype(np.uint32).view(np.float32)


def _planes_np(m):
    """The packed planes of a K-major operand m (N, K), index by index:
    out[ks, plane, n // 8, kh, n % 8, j] = plane(m)[n, 8 ks + 4 kh + j]."""
    N, K = m.shape
    hi = _tf32_np(m)
    lo = _tf32_np((m - hi).astype(np.float32))
    out = np.empty((K // 8, 2, N // 8, 2, 8, 4), np.float32)
    ks, pl, ng, kh, r, j = np.indices(out.shape)
    n, k = ng * 8 + r, ks * 8 + kh * 4 + j
    out[...] = np.where(pl == 0, hi[n, k], lo[n, k])
    return out


def test_xmix_planes_match_numpy_bit_for_bit():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((TC, TC)) / 16).astype(np.float32)
    w[0, :4] = [0.0, -0.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)]  # zeros and rounding ties
    fwd, bwd = se.xmix_planes(torch.from_numpy(w))
    for got, want in ((fwd, _planes_np(np.ascontiguousarray(w.T))), (bwd, _planes_np(w))):
        assert got.is_contiguous() and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    # each stage (both planes of a k-step) is 16 KB of consecutive floats
    assert fwd[0].numel() * 4 == 16384
    # hi + lo reconstruct the weight to within TF32's two roundings
    np.testing.assert_allclose((fwd[:, 0] + fwd[:, 1]).permute(1, 3, 0, 2, 4).reshape(TC, TC)
                               .numpy(), w.T, rtol=2 ** -21, atol=0)


def test_packed_planes_reproduce_the_product():
    """Unpacking the planes and multiplying is the plain chunked product: the
    layout holds each element where the kernel's descriptors read it."""
    a, w = _operands(64, False, seed=5)
    p = wgmma_planes(w.T.contiguous())  # B K-major: row c holds w[:, c]
    wh, wl = (p[:, i].permute(1, 3, 0, 2, 4).reshape(TC, TC).T for i in (0, 1))
    ah, al = tf32_split(a)
    out = torch.zeros(64, TC)
    for k0 in range(0, TC, WG_CHUNK):
        s = slice(k0, k0 + WG_CHUNK)
        out = out + ((al[:, s] @ wh[s] + ah[:, s] @ wl[s]) + ah[:, s] @ wh[s])
    np.testing.assert_array_equal(out.numpy(), mm_tf32x3_chunked_plain(a, w).numpy())


def test_wrappers_take_the_plain_versions_on_cpu_at_the_route_widths():
    hg, ai, oi, d0, m, ep, gp, gh = sparse_inputs(5, 12)
    counters = (se.sparse_fwd, se.sparse_bwd, se.sparse_bwd_grads, se.sparse_bwd2)
    before = [f.launches for f in counters]
    for got, want in ((se.sparse_fwd(hg, ai, oi, d0, m, ep), se.sparse_fwd_plain(hg, ai, oi, d0,
                                                                                  m, ep)),
                      (se.sparse_bwd(hg, ai, oi, d0, m, ep, gp, gh),
                       se.sparse_bwd_plain(hg, ai, oi, d0, m, ep, gp, gh)),
                      (se.sparse_bwd_grads(hg, ai, oi, d0, m, ep, gp, gh)[:4],
                       se.sparse_bwd_plain(hg, ai, oi, d0, m, ep, gp, gh))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the model (its autograd op makes no transposes or planes on the CPU)
    p = make_params(SimpleNamespace(hidden_features=64, depth=1, n_heads=4), 3, 0, "cpu")
    g = torch.Generator().manual_seed(0)
    h = torch.nn.functional.one_hot(torch.randint(0, 3, (1, 20), generator=g), 3).float()
    x = 3.0 * torch.rand(1, 20, 3, generator=g)
    idx, nm = neighbor_list(x, 2.5, 8)
    ef = se.make_sparse_kernel_energy_forces(h, update=False)
    e, f = ef(p, x, idx, nm)
    assert torch.isfinite(f).all() and e.shape == (1,)
    assert [f_.launches for f_ in counters] == before


def test_route_checks_widths_and_plane_alignment(monkeypatch):
    """The route's own checks (reached on the card past the device check):
    other widths raise rather than fall back; planes off 16-byte alignment
    raise (the ring's bulk copies need it)."""
    monkeypatch.setattr(se, "_require_cuda", lambda name, t: None)
    hg, ai, oi, d0, m, ep, *_ = sparse_inputs(2, 8, H=16)  # H * heads = 64
    with pytest.raises(ValueError, match="tensor-core x-mixing takes"):
        se._check_edge("sparse_fwd", hg, ai, oi, d0, m, ep)
    se._check_edge("sparse_bwd2", hg, ai, oi, d0, m, ep, se.edge_transposes(ep), tc=False)
    hg, ai, oi, d0, m, ep, *_ = sparse_inputs(2, 8)
    wt = se.edge_transposes(ep)
    se._check_edge("sparse_bwd", hg, ai, oi, d0, m, ep, wt)
    shifted = torch.empty(wt[-1].numel() + 1)[1:].view_as(wt[-1])
    shifted.copy_(wt[-1])
    with pytest.raises(ValueError, match="16-byte aligned"):
        se._check_edge("sparse_bwd", hg, ai, oi, d0, m, ep, wt[:-1] + [shifted])


def test_slot_limit_raises_naming_the_largest_k():
    """#13 and #14 hold a row's edge values in shared memory: a K over the
    route's limit (the source's ``..._max_slots``) raises, naming it."""
    dims = (2, 146, 64, 50, 64, 4, 256)
    se._check_slots("sparse_bwd", dims[:1] + (145,) + dims[2:], lambda *w: 145)
    with pytest.raises(ValueError, match="at most 145 neighbour slots"):
        se._check_slots("sparse_bwd", dims, lambda *w: 145)


HALF = 32  # the dual tile's slots: values in rows 0 ... 31, tangents in rows 32 ... 63


def _dual_tiles(a_v, a_t):
    """#15's tiles of a row: per 32 slots, their value rows stacked over their
    tangent rows in a 64-row tile, the unused rows zero; with each tile's count
    of slots."""
    for t0 in range(0, a_v.shape[0], HALF):
        n = min(HALF, a_v.shape[0] - t0)
        tile = torch.zeros(2 * HALF, a_v.shape[1])
        tile[:n], tile[HALF:HALF + n] = a_v[t0:t0 + n], a_t[t0:t0 + n]
        yield tile, n


@pytest.mark.parametrize("K", [48, 37])
@pytest.mark.parametrize("transposed", [False, True], ids=["forward", "pullback"])
def test_dual_tile_gives_the_value_and_tangent_products(K, transposed):
    a_v, w = _operands(K, transposed, seed=K)
    a_t = _operands(K, transposed, seed=K + 1)[0]
    got_v, got_t = [], []
    for tile, n in _dual_tiles(a_v, a_t):
        out = mm_tf32x3_chunked_plain(tile, w)
        assert not out[n:HALF].any() and not out[HALF + n:].any()  # the padded rows
        got_v.append(out[:n])
        got_t.append(out[HALF:HALF + n])
    assert _rel(torch.cat(got_v), a_v.double() @ w.double()) <= 1e-6
    assert _rel(torch.cat(got_t), a_t.double() @ w.double()) <= 1e-6


def test_dual_tanh_pairs_each_value_row_with_its_tangent_row():
    """The forward epilogue of #15's dual tile, in float32 as the kernel runs
    it: slot e's value is tanh(P[e]) and its tangent (1 - value^2) P[e + 32],
    the dual-number rule tanh(x + dx eps) = tanh x + (1 - tanh^2 x) dx eps."""
    rng = np.random.default_rng(7)
    n = 21  # slots in use; the rows between n and 32 (and 32 + n and 64) unused
    P = rng.standard_normal((2 * HALF, TC)).astype(np.float32)
    P[n:HALF] = P[HALF + n:] = np.nan
    val = np.tanh(P[:n])
    tan = (np.float32(1) - val * val) * P[HALF:HALF + n]
    x, dx = P[:n].astype(np.float64), P[HALF:HALF + n].astype(np.float64)
    ref = np.tanh(x)
    for got, want in ((val, ref), (tan, (1 - ref ** 2) * dx)):
        assert got.dtype == np.float32 and np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_second_order_wrapper_takes_the_plain_version_on_cpu():
    hg, ai, oi, d0, m, ep, gp, gh = sparse_inputs(4, 12, seed=2)
    cg = PS.cotangents(hg, ai, oi, d0)
    before = se.sparse_bwd2.launches
    got = se.sparse_bwd2(hg, ai, oi, d0, m, ep, gp, gh, *cg)
    want = se.sparse_bwd2_plain(hg, ai, oi, d0, m, ep, gp, gh, *cg)
    for a, b in zip([*got[:6], *got[6].values()], [*want[:6], *want[6].values()]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert list(got[6]) == list(want[6]) == list(se.EDGE_LEAVES)
    assert se.sparse_bwd2.launches == before == 0


class _NoLaunch:
    """A stand-in library: #15's limit of slots, and no launch."""

    def __init__(self, most):
        self.most = most

    def sake_sparse_bwd2_max_slots(self, *widths):
        return self.most

    def sake_sparse_bwd2(self, *args):
        raise AssertionError("launched")


def test_second_order_route_checks_widths(monkeypatch):
    """#15 takes only the tensor-core widths (H * heads = C = 256): other
    widths raise rather than fall back; the CUDA-core check (``tc=False``)
    still takes them."""
    monkeypatch.setattr(se, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(se.build, "load", lambda: _NoLaunch(67))
    hg, ai, oi, d0, m, ep, gp, gh = sparse_inputs(2, 8, H=16)  # H * heads = 64
    with pytest.raises(ValueError, match="sparse_bwd2: the tensor-core x-mixing takes"):
        se._check_edge("sparse_bwd2", hg, ai, oi, d0, m, ep, se.edge_transposes(ep))
    se._check_edge("sparse_bwd2", hg, ai, oi, d0, m, ep, se.edge_transposes(ep), tc=False)
    with pytest.raises(ValueError, match="sparse_bwd2: the tensor-core x-mixing takes"):
        se._launch_bwd2(hg, ai, oi, d0, m, ep, gp, gh, *PS.cotangents(hg, ai, oi, d0))


def test_second_order_slot_limit_raises_naming_it(monkeypatch):
    """A dual slot takes twice a float slot's shared memory: a K over #15's
    limit (``sake_sparse_bwd2_max_slots``) raises naming it, before launching."""
    dims = (2, 68, 64, 50, 64, 4, 256)
    se._check_slots("sparse_bwd2", dims[:1] + (67,) + dims[2:], lambda *w: 67)
    with pytest.raises(ValueError, match="sparse_bwd2: .* at most 67 neighbour slots"):
        se._check_slots("sparse_bwd2", dims, lambda *w: 67)
    monkeypatch.setattr(se, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(se.build, "load", lambda: _NoLaunch(67))
    hg, ai, oi, d0, m, ep, gp, gh = sparse_inputs(2, 68)
    with pytest.raises(ValueError, match="at most 67 neighbour slots a row at F=64, R=50, H=64, "
                                         "heads=4, C=256, not 68"):
        se._launch_bwd2(hg, ai, oi, d0, m, ep, gp, gh, *PS.cotangents(hg, ai, oi, d0))


@pytest.mark.gpu
@pytest.mark.parametrize("K,NR", PS.CARD_CASES)
def test_tensor_core_kernels_match_plain_on_card(K, NR):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    PS.check_on_card(K, NR, torch.device("cuda"))


@pytest.mark.gpu
def test_slot_limit_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    PS.check_slot_limit(torch.device("cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("K,NR", PS.BWD2_CASES)
def test_second_order_kernel_matches_plain_on_card(K, NR):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    PS.check_bwd2_on_card(K, NR, torch.device("cuda"))


@pytest.mark.gpu
def test_second_order_slot_limit_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    PS.check_bwd2_slot_limit(torch.device("cuda"))
