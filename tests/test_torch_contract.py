"""The host side of the two gradient contractions on the f64 tensor cores
(``csrc/sparse_contract.cu``, ``csrc/param_grads.cu``, through
``csrc/dmma_f64.cuh``), on the CPU.

- The row-chunk planner of ``param_grads.cu`` (``resid_ef.grad_chunks`` and
  ``grad_chunk_rows``, the rule of the source's ``chunk_span``): every row of a
  layer lies in exactly one chunk, at batches from 1 to 512 and for each row
  kind (edges, atoms, w_vmix's pooled rows); chunks start on whole f64 stages;
  the partial buffer is ``(chunks, every leaf's gradient)`` f64; and at
  ``MD17Config``'s B = 4 (aspirin, N = 21) and QM9's B = 64 (N = 29), depth 6
  and 4 heads, one launch has at least two of w_xmix's blocks for each of the
  H100's 132 SMs (one head's 64 rows a block).
- The sparse contraction's chunk count (``sparse_ef.contract_chunks``) and its
  stage rounding (every edge in one chunk), and ``_aligned``: a row array that
  does not start 16-byte aligned is copied before the launch (the ring streams
  16-byte pieces), an aligned one is passed as it is.
- The CPU paths: ``param_grads`` and ``param_grads_aug`` on CPU tensors are
  their plain versions, with every launch count left at 0.
- The probe slots that the tools read (``tools/probe_fused.py``'s ``SLOTS``,
  ``tools/probe_sparse.py``'s and ``tools/probe_contract.py``'s offsets) are
  ``csrc/probe.cuh``'s ``ProbeSlot`` enum, in order.
- ``gpu``-marked: ``tools/probe_contract.py``'s ``check_contractions`` (both
  kernels against their plain versions on the card, each sparse leaf within
  1e-6 of the f64 ``contract_plain``, each dense leaf within 1e-4 of the f32
  plain version, and two launches bitwise equal). It skips here;
  ``chip_smoke.py`` and ``tools/contract_ab.py`` run it on the card without
  pytest, whose conftest needs JAX.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from sake_tpu_torch.kernels import resid_ef
from sake_tpu_torch.kernels import sparse_ef as se
from sake_tpu_torch.kernels import train2_ef as t2
from sake_tpu_torch.kernels.leaves import LEAF_NAMES

ROOT = Path(__file__).resolve().parents[1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PC = _tool("probe_contract")


@pytest.mark.parametrize("B,N", [(1, 5), (1, 21), (4, 21), (7, 29), (64, 29), (512, 21)])
@pytest.mark.parametrize("depth", [1, 6])
def test_every_row_lies_in_exactly_one_chunk(B, N, depth):
    n = resid_ef.grad_chunks(B, N, 4, depth)
    assert 1 <= n <= resid_ef._GRAD_MAX_CHUNKS
    for rows in (B * N * N, B * N, 3 * B * N):  # edges, atoms, w_vmix's pooled rows
        spans = resid_ef.grad_chunk_rows(rows, n)
        assert len(spans) == n
        seen = torch.zeros(rows, dtype=torch.int64)
        for b, e in spans:
            assert 0 <= b <= e <= rows
            seen[b:e] += 1
        assert bool((seen == 1).all())
        # every chunk but empty ones starts on a whole f64 stage
        assert all(b % resid_ef._GRAD_STAGE == 0 for b, e in spans if e > b)


def _dims(B, N, hidden=64, depth=6):
    return (B, N, hidden, hidden, 50, 4, 4 * hidden, depth)


@pytest.mark.parametrize("B,N", [(4, 21), (64, 29), (512, 21)])
def test_partial_buffer_holds_every_leaf_per_chunk(B, N):
    dims = _dims(B, N)
    n, partial, out, sizes = resid_ef._grad_scratch(dims, "cpu")
    shapes = resid_ef._leaf_shapes(*dims[2:7])
    assert n == resid_ef.grad_chunks(B, N, 4, 6)
    assert sizes == [6 * shapes[k][0] * shapes[k][1] for k in LEAF_NAMES]
    assert tuple(partial.shape) == (n, sum(sizes)) and partial.dtype == torch.float64
    assert tuple(out.shape) == (sum(sizes),) and out.dtype == torch.float32


@pytest.mark.parametrize("B,N", [(4, 21), (64, 29)])  # MD17Config's batch, QM9's
def test_one_launch_fills_the_card(B, N):
    depth, heads, hidden = 6, 4, 64
    n = resid_ef.grad_chunks(B, N, heads, depth)
    xmix_blocks = depth * n * heads * -(-hidden // 64)
    assert xmix_blocks >= 2 * resid_ef._GRAD_SMS == 264
    # and every chunk keeps rows to contract
    assert all(e > b for b, e in resid_ef.grad_chunk_rows(B * N * N, n))


@pytest.mark.parametrize("E", [1, 15, 16, 1023, 1025, 49152, 64 * 1024 + 1, 200000])
def test_sparse_chunks_cover_every_edge_once(E):
    n = se.contract_chunks(E)
    assert 1 <= n <= se._CONTRACT_MAX_CHUNKS
    # the source's rule: ceil(E / n) rounded up to whole 16-edge stages
    chunk = -(-(-(-E // n)) // 16) * 16
    seen = torch.zeros(E, dtype=torch.int64)
    for c in range(n):
        seen[min(E, c * chunk):min(E, c * chunk + chunk)] += 1
    assert bool((seen == 1).all())


def test_misaligned_rows_are_copied_before_the_launch():
    base = torch.randn(1 + 64 * 8)
    view = base[1:].view(64, 8)  # 4 bytes past an aligned start
    assert view.data_ptr() % 16 == 4
    got = se._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    aligned = torch.randn(64, 8)
    assert se._aligned(aligned) is aligned


def test_cpu_tensors_take_the_plain_versions():
    before = (resid_ef.param_grads.launches, t2.param_grads_aug.launches)
    ins = PC.dense_inputs(2, 5, False, torch.device("cpu"), hidden=8, depth=2)
    got, want = resid_ef.param_grads(*ins), resid_ef.param_grads_plain(*ins)
    assert all(torch.equal(got[n], want[n]) for n in LEAF_NAMES)
    ins = PC.dense_inputs(2, 5, True, torch.device("cpu"), hidden=8, depth=2)
    got, want = t2.param_grads_aug(*ins), t2.param_grads_aug_plain(*ins)
    assert all(torch.equal(got[n], want[n]) for n in LEAF_NAMES)
    assert (resid_ef.param_grads.launches, t2.param_grads_aug.launches) == before


def test_probe_slots_match_the_enum():
    text = (ROOT / "sake_tpu_torch" / "csrc" / "probe.cuh").read_text()
    body = text[text.index("enum ProbeSlot {"):text.index("kProbeSlots")]
    body = re.sub(r"//[^\n]*", "", body.split("{", 1)[1])
    enum = [s.strip() for s in body.split(",") if s.strip()]
    fused = _tool("probe_fused").SLOTS
    assert [s.lower() for s in enum] == ["pr_" + s for s in fused]
    ps = _tool("probe_sparse")
    assert ps.N_SLOTS == PC.N_SLOTS == len(enum)
    assert list(fused[ps.SLOT0:ps.SLOT0 + len(ps.SLOTS)]) == list(ps.SLOTS)
    assert list(fused[PC.SLOT0:PC.SLOT0 + len(PC.SLOTS)]) == list(PC.SLOTS)


@pytest.mark.gpu
def test_contractions_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    PC.check_contractions(torch.device("cuda"))
