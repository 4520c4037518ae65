"""Plain versions of the 3xTF32 products that ``csrc/mma_tf32x3.cuh`` (#11's,
#12's and #20's x-mixing and edge products, ``mma.sync``) and
``csrc/wgmma_tf32.cuh`` (#13's and #14's x-mixing, ``wgmma``) run on the tensor
cores, for the tests: what the split computes and why one TF32 pass is not
enough for the f32 tier, and the fewer passes of #20's bf16 tier, whose weights
are bf16 values and so exact in TF32 (:func:`mm_tf32x2_plain`);
and :func:`wgmma_planes`, the host-side split and packing of a weight that the
``wgmma`` route reads (``kernels/sparse_ef.xmix_planes`` calls it once per
layer), and ``fused_ef.tc_product``, a check of #20's bf16 passes, takes the
two on CPU tensors. Nothing else on a training or serving path calls them.
"""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: each float32 rounded to 10 significand bits, to
    nearest with ties away from zero, on the int32 view (subnormals alike);
    inf and NaN pass unchanged."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    finite = (u & 0x7F800000) != 0x7F800000
    r = torch.where(finite, (u + 0x1000) & 0xFFFFE000, u)
    return r.to(torch.int32).view(torch.float32).view(x.shape)


def tf32_split(x: torch.Tensor):
    """``(hi, lo)`` with ``hi = tf32(x)``, ``lo = tf32(x - hi)``."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def mm_tf32x3_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in 3xTF32: ``lo(a) hi(w) + hi(a) lo(w) + hi(a) hi(w)``, each
    product of TF32 values (exact in f32), summed in f32. ``lo(a) lo(w)`` is
    left out, as in the kernels."""
    ah, al = tf32_split(a)
    wh, wl = tf32_split(w)
    return (al @ wh + ah @ wl) + ah @ wh


def mm_tf32x2_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the two passes that a weight exact in TF32 (a bf16 value)
    needs: ``lo(a) hi(w) + hi(a) hi(w)``, each product exact in f32, summed in
    f32 (``mma_tf32x3.cuh``'s ``tc_passes`` of a bf16 pullback product)."""
    ah, al = tf32_split(a)
    wh = tf32_round(w)
    return al @ wh + ah @ wh


def mm_tf32_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in one TF32 pass, the operands rounded once: what the tensor
    cores give without the split."""
    return tf32_round(a) @ tf32_round(w)


# k of a chunk that wgmma_tf32.cuh (like mma_tf32x3.cuh) sums from zero before
# adding it to the running f32 sum: kTcSumSteps k-steps of 8
WG_CHUNK = 32


def mm_tf32x3_chunked_plain(a: torch.Tensor, w: torch.Tensor, chunk: int = WG_CHUNK):
    """``a @ w`` as ``wgmma_tf32.cuh`` sums it: for each chunk of ``chunk`` k,
    ``lo(a) hi(w) + hi(a) lo(w) + hi(a) hi(w)`` summed from zero, then added to
    the running f32 sum."""
    ah, al = tf32_split(a)
    wh, wl = tf32_split(w)
    out = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[1], chunk):
        s = slice(k0, k0 + chunk)
        out = out + ((al[:, s] @ wh[s] + ah[:, s] @ wl[s]) + ah[:, s] @ wh[s])
    return out


def wgmma_planes(m: torch.Tensor, split=None) -> torch.Tensor:
    """The hi and lo TF32 planes of a K-major ``wgmma`` operand ``m (N, K)``
    (row ``n`` holds the ``K`` values of output column ``n``), packed as
    ``wgmma_tf32.cuh`` reads them: ``(K / 8, 2, N / 8, 2, 8, 4)`` = [k-step]
    [hi, lo][8-column group][k half][column in the group][k in the half], so
    that each k-step's two planes are one contiguous 16-byte-aligned stage of
    8 x 16-byte core matrices. ``split``: ``tf32_split(m)`` when the caller
    has it (the split is elementwise, so a transpose's is the split's)."""
    N, K = m.shape
    hi, lo = tf32_split(m) if split is None else split

    def pack(p):
        return p.reshape(N // 8, 8, K // 8, 2, 4).permute(2, 0, 3, 1, 4)

    return torch.stack([pack(hi), pack(lo)], dim=1).contiguous()
