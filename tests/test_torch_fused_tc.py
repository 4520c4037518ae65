"""#20's products on the tensor cores in its bf16 tier (``csrc/mma_tf32x3.cuh``'s
``tc_passes``), through the plain models of ``sake_tpu_torch/kernels/tf32.py``, and
the device-memory scratch of its molecule slots (``kernels/fused_ef.slot_shapes``),
on the CPU.

A bf16 value is exact in TF32, so the split of a bf16-valued float leaves ``lo``
zero. The forward's o_f and o1 round both operands to bf16: one pass is then exact,
and its f32 sum lies within 1e-6 of max |ref| of a float64 product. A pullback
product (an f32 cotangent against a bf16 weight) takes two passes, within 1e-6 of
float64; one pass misses by more than 1e-4. The shape is the x-mixing's over a
molecule: aspirin's 441 edges, 256 against 256.

``tools/probe_fused.check_tc_products`` holds ``fused_ef.tc_product`` (each of
these products alone at the shapes #20's bodies give them) to float64 within the
same 1e-6: here through the plain models, on the card (gpu-marked) through the
kernel's own ``mm_tc`` and ``mm_tc_small``.

Every layer's residuals stay in the block's slot: at aspirin's widths (hidden 64,
R 50, 4 heads, C 256, N 21, depth 6) on 132 slots that is 697,413,024 bytes.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from sake_tpu_torch.kernels import fused_ef
from sake_tpu_torch.kernels.functional import bf16_round
from sake_tpu_torch.kernels.leaves import wide_stack
from sake_tpu_torch.kernels.tf32 import mm_tf32_plain, mm_tf32x2_plain, tf32_split

EDGES, K, M = 21 * 21, 256, 256  # the x-mixing over aspirin's edges


def _probe_fused():
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_fused.py"
    spec = importlib.util.spec_from_file_location("probe_fused", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((EDGES, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, M)) / np.sqrt(K)).astype(np.float32))
    return a, bf16_round(w)


def _rel(got, a, w):
    ref = a.double() @ w.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


def test_split_of_bf16_values_leaves_lo_zero():
    a, w = _operands()
    for t in (bf16_round(a), w):
        hi, lo = tf32_split(t)
        assert torch.equal(hi, t) and not lo.any()


def test_one_pass_over_bf16_operands_is_f32_accurate():
    a, w = _operands()
    ab = bf16_round(a)
    assert _rel(mm_tf32_plain(ab, w), ab, w) <= 1e-6


def test_two_passes_of_an_f32_cotangent_against_a_bf16_weight():
    g, w = _operands(1)
    assert _rel(mm_tf32x2_plain(g, w), g, w) <= 1e-6
    assert _rel(mm_tf32_plain(g, w), g, w) >= 1e-4


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_bf16_tensor_core_products_against_float64(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pf = _probe_fused()
    errs = pf.check_tc_products(torch.device(device))
    assert len(errs) == len(pf.TC_PRODUCTS)
    assert max(errs.values()) <= pf.TC_PRODUCT_TOL, errs


def test_tc_product_on_cpu_is_the_plain_model():
    g, w = _operands(2)
    assert torch.equal(fused_ef.tc_product(g[:21], w, 2), mm_tf32x2_plain(g[:21], w))
    ab = bf16_round(g[:21, :64])
    assert torch.equal(fused_ef.tc_product(g[:21, :64], w[:64, :50], 1),
                       mm_tf32_plain(ab, w[:64, :50]))


def test_slot_scratch_holds_every_layer_at_aspirin_widths():
    from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
    from sake_tpu_torch.models import SAKEModel

    N, F, H, R, Kh, C, depth, slots = 21, 64, 64, 50, 4, 256, 6, 132
    model = SAKEModel(F, 1, depth, n_heads=Kh, in_features=9, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    leaves = wide_stack(model_params_from_linen(linen_tree(model), device="cpu"), Kh)
    shapes = fused_ef.slot_shapes(slots, (2048, N, F, H, R, Kh, C, depth), leaves)
    edge = {"r": 1, "t": 1, "rbf": R, "e0": H, "h_e": H, "sem_pre": Kh, "att": Kh, "coeff": C}
    node = {"pool0": C, "pool1": C, "pool2": C, "ps0": H, "ps1": H, "node_pre": H, "uv": F,
            "g0": H, "g1": 1}
    want = {"bh": (depth, slots, N, F), "bx": (depth, 3, slots, N), "bv": (depth, 3, slots, N),
            **{n: (depth, slots, N * N, w) for n, w in edge.items()},
            **{n: (depth, slots, N, w) for n, w in node.items()}}
    assert shapes == want
    per_layer = N * N * sum(edge.values()) + N * sum(node.values())  # floats a slot and layer
    assert per_layer == 218_673
    nbytes = 4 * sum(int(np.prod(s)) for s in shapes.values())
    assert nbytes == 4 * depth * slots * (per_layer + N * (F + 6)) == 697_413_024
