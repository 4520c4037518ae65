"""Plain versions of the 3xTF32 product that ``csrc/mma_tf32x3.cuh`` runs on
the tensor cores (#11's and #12's x-mixing and edge products), for the tests: what the split computes and why one TF32 pass is
not enough for the f32 tier. Nothing on a training or serving path calls them.
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


def mm_tf32_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in one TF32 pass, the operands rounded once: what the tensor
    cores give without the split."""
    return tf32_round(a) @ tf32_round(w)
