"""The 3xTF32 product of the tensor-core kernels (#11, #12: ``csrc/mma_tf32x3.cuh``)
through its plain version (``sake_tpu_torch/kernels/tf32.py``), on the CPU.

At the shapes of the four x-mixing sites (21 receivers' rows against w_xmix,
the pullback's against its transpose, the tangent pullback's 42 rows), the split
product lies within 1e-6 of max |ref| of a float64 product (the f32 tier; the
kernels' gates are 1e-4 relative per tensor), while one TF32 pass lies beyond
1e-4. ``tf32_round`` is held bit for bit to the rounding of ``cvt.rna.tf32.f32``.
On the card, #11, #12 and #20 (in its bf16 tier, whose weights ``kernel_weights``
rounds) refuse a w_xmix leaf that does not start 16-byte aligned (their products
copy it in 16-byte pieces).
"""

import numpy as np
import pytest
import torch

from sake_tpu_torch.kernels.tf32 import mm_tf32_plain, mm_tf32x3_plain, tf32_round

# (rows, k, columns, transposed W): fwd / tangent forward, pullback, tangent pullback
SITES = {"xmix_fwd": (21, 256, 256, False), "xmix_bwd": (21, 256, 256, True),
         "xmix_tbwd": (42, 256, 256, True)}


def _operands(site, seed=0):
    n, k, m, transposed = SITES[site]
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, k)).astype(np.float32)
    w = (rng.standard_normal((m, k) if transposed else (k, m)) / np.sqrt(k)).astype(np.float32)
    if transposed:
        w = np.ascontiguousarray(w.T)
    return torch.from_numpy(a), torch.from_numpy(w)


def _rel(got, a, w):
    ref = a.double() @ w.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("site", sorted(SITES))
def test_split_product_is_f32_accurate(site):
    a, w = _operands(site)
    assert _rel(mm_tf32x3_plain(a, w), a, w) <= 1e-6


@pytest.mark.parametrize("site", sorted(SITES))
def test_one_tf32_pass_misses_the_f32_tier(site):
    a, w = _operands(site)
    assert _rel(mm_tf32_plain(a, w), a, w) > 1e-4


def _bits(u):
    return torch.tensor([u], dtype=torch.int64).to(torch.int32).view(torch.float32)


# (input bits, rounded bits)
ROUNDING = {
    "below_half": (0x3F800FFF, 0x3F800000),
    "tie_away": (0x3F801000, 0x3F802000),  # 1 + 2^-11: halfway, away from zero
    "above_half": (0x3F801001, 0x3F802000),
    "negative_tie": (0xBF801000, 0xBF802000),
    "carry_into_exponent": (0x3FFFF000, 0x40000000),
    "subnormal_tie": (0x00001000, 0x00002000),
    "subnormal_below": (0x00000FFF, 0x00000000),
    "inf": (0x7F800000, 0x7F800000),
    "negative_inf": (0xFF800000, 0xFF800000),
}


@pytest.mark.parametrize("case", sorted(ROUNDING))
def test_tf32_round_bit_exact(case):
    src, want = ROUNDING[case]
    got = tf32_round(_bits(src)).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert int(got) == want


def test_tf32_round_keeps_nan():
    assert torch.isnan(tf32_round(torch.tensor([float("nan"), 1.0])))[0]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fused_primal", "fused_bwd_block", "fused_energy_forces"])
@pytest.mark.parametrize("leaf", ["w_xmix", "w_xmix.T"])
def test_tensor_core_kernels_refuse_misaligned_w_xmix(kernel, leaf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sake_tpu_torch.kernels import fused_ef, resid_ef
    from sake_tpu_torch.kernels import train2_ef as t2
    from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack
    from sake_tpu_torch.models import SAKEModel

    dev = torch.device("cuda")
    B, N, hid, depth = 2, 21, 64, 2  # aspirin's widths: the tensor-core route
    model = SAKEModel(hid, 1, depth, in_features=hid, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    p = model_params_from_linen(linen_tree(model), device=dev)
    if kernel == "fused_energy_forces":
        w16 = fused_ef.kernel_weights(p, 4, True)
        leaves, leaves_t = w16.leaves, w16.leaves_t
    else:
        leaves = wide_stack(p, 4)
        leaves_t = transposed(leaves)
    target = leaves if leaf == "w_xmix" else leaves_t
    w = target["w_xmix"]
    shifted = torch.empty(w.numel() + 1, device=dev)[1:].view_as(w)  # 4 bytes past alignment
    shifted.copy_(w)
    target["w_xmix"] = shifted
    g = torch.Generator().manual_seed(1)
    h0 = torch.randn(B, N, hid, generator=g).to(dev)
    xs = torch.randn(3, B, N, generator=g).to(dev)
    upd = [1.0] * depth
    with pytest.raises(ValueError, match="16-byte aligned"):
        if kernel == "fused_primal":
            t2.fused_primal(p, leaves, h0, xs, upd, leaves_t=leaves_t)
        elif kernel == "fused_energy_forces":
            fused_ef.launch(w16, h0, xs.permute(1, 2, 0).contiguous(), upd)
        else:
            fwd = resid_ef.resid_fwd_plain(leaves, h0, xs, torch.zeros_like(xs), upd)
            t2.fused_bwd_block(p, leaves, fwd, upd, torch.randn(3, B, N, generator=g).to(dev),
                               torch.randn(B, generator=g).to(dev), leaves_t=leaves_t)
