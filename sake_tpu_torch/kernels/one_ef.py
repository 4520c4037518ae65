"""Single-launch E + F: forward, readout and pullback of a whole batch in one
kernel (#3).

Port of ``sake_tpu/kernels/one_ef.py``, ``one_energy_forces`` (``:88-303``).
On CUDA tensors :func:`one_energy_forces` launches ``csrc/fused_ef.cu`` in
its one_ef instantiation (the JAX ``kernel`` ``:177``, pallas_call
``:261``): the source of the fused training primal (#11), with the residuals
and boundary states in a scratch of one molecule per resident block instead
of outputs. A persistent grid (as many blocks as the card holds, each
walking the batch) takes the whole batch in one launch with no chunking;
the scratch is the grid's, not the batch's. On CPU tensors it runs the
resid path's plain stacks (:func:`one_ef_plain`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sake_tpu_torch.kernels import build, resid_ef
from sake_tpu_torch.kernels.functional import ModelParams, embed, per_layer
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, transposed, wide_stack
from sake_tpu_torch.kernels.resid_ef import (
    RESIDS,
    _check_cuda,
    _dims,
    _edge_mask,
    _ptr,
    _ptrs,
    _resid_shapes,
    _strides,
)
from sake_tpu_torch.kernels.train2_ef import _fused_args, fused_primal_plain


def one_ef_plain(params: ModelParams, leaves: dict, h0, xs, upd: Sequence[float], mask=None):
    """Plain version of the kernel (:func:`train2_ef.fused_primal_plain`
    without the streams): ``(e (B,), dx (3, B, N))`` from ``(h0 (B, N, F), xs
    (3, B, N), v = 0)``, the energy summed over the diagonal atoms of ``mask
    (B, N, N)`` when given; ``F = -dx``."""
    return fused_primal_plain(params, leaves, h0, xs, upd, mask)[1:]


def _launch_one_ef(params, leaves, h0, xs, upd, mask, leaves_t):
    lib, dims, dev, upd_t, ro, F0, O, leaves_t = _fused_args(
        "one_energy_forces", params, leaves, h0, upd, leaves_t, "sake_fused_ef_smem_bytes")
    B, N, F, H, R, K, C, depth = dims
    _check_cuda("h0", h0, (B, N, F), dev)
    _check_cuda("xs", xs, (3, B, N), dev)
    m = _edge_mask(mask, dims, dev)
    grid = lib.sake_one_ef_grid(*dims, F0)
    if grid <= 0:
        raise RuntimeError("one_energy_forces: no resident block fits the card")
    slots = (grid, *dims[1:])  # the scratch holds one molecule per block
    empty = lambda *s: torch.empty(s, device=dev, dtype=torch.float32)
    bh, bx, bv = empty(depth, grid, N, F), empty(depth, 3, grid, N), empty(depth, 3, grid, N)
    resid = {n: empty(*s) for n, s in _resid_shapes(slots, leaves).items()}
    e, dx = empty(B), empty(3, B, N)
    err = lib.sake_one_ef(
        h0.data_ptr(), xs.data_ptr(), upd_t.data_ptr(), _ptr(m),
        _ptrs([leaves[n] for n in LEAF_NAMES]), _ptrs([leaves_t[n] for n in LEAF_NAMES]),
        _strides(leaves), *(t.data_ptr() for t in ro), bh.data_ptr(), bx.data_ptr(),
        bv.data_ptr(), _ptrs([resid[n] for n in RESIDS]), e.data_ptr(), dx.data_ptr(), grid,
        *dims, F0, O, resid_ef._stream(dev),
    )
    build.check(lib, err, "one_energy_forces")
    return e, dx


@torch.no_grad()
def one_energy_forces(
    params: ModelParams,
    h: torch.Tensor,  # (B, N, F_in)
    x: torch.Tensor,  # (B, N, 3)
    mask: Optional[torch.Tensor] = None,  # (B, N, N) edge mask
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    batch_tile: int = 8,
    matmul_dtype=None,
    precision=None,
    edge_matmul_dtype=None,
    edge_precision=None,
    resid_dtype=torch.float32,
    resid_lowp=None,
    pad_atoms: bool = False,
    vmem_limit: Optional[int] = None,
    batch_parallel: bool = False,
    interpret: bool = False,
):
    """Raw ``E (B,)`` and ``F = -dE/dx (B, N, 3)`` in one kernel launch (#3),
    the contract of :func:`resid_ef.resid_energy_forces`: with an edge mask
    the layers take the masked semantics and the energy sums the readout over
    the mask's diagonal atoms. CPU tensors take the plain version.

    The bf16 tier (``matmul_dtype``, ``edge_matmul_dtype``, ``resid_dtype``
    other than f32, ``resid_lowp``) raises. Accepted with no counterpart:
    ``batch_tile``, ``pad_atoms``, ``vmem_limit`` and ``batch_parallel`` (one
    block per molecule, N as it comes), ``precision`` and ``edge_precision``
    (f32 products) and ``interpret`` (CPU tensors take the plain version)."""
    if (matmul_dtype is not None or edge_matmul_dtype is not None or resid_lowp is not None
            or resid_dtype not in (None, torch.float32)):
        raise NotImplementedError("one_energy_forces: the port's kernels are f32 only")
    upd = [1.0 if u else 0.0 for u in per_layer(update, len(params.layers))]
    leaves = wide_stack(params, n_heads)
    h0 = embed(params, h.float()).contiguous()
    xs = x.permute(2, 0, 1).float().contiguous()
    m = mask.float().contiguous() if mask is not None else None
    if x.device.type == "cpu":
        e, dx = one_ef_plain(params, leaves, h0, xs, upd, m)
    else:
        e, dx = _launch_one_ef(params, leaves, h0, xs, upd, m, transposed(leaves))
        one_energy_forces.launches += 1
    return e, -dx.permute(1, 2, 0)


one_energy_forces.launches = 0
