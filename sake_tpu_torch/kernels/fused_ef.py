"""Whole-model E + F in one kernel launch, f32 or with bf16 products (#20).

Port of ``sake_tpu/kernels/fused_ef.py``, ``fused_energy_forces``
(``:59-209``). On CUDA tensors :func:`fused_energy_forces` launches
``csrc/fused_remat_ef.cu`` (the JAX ``kernel`` ``:94``, pallas_call ``:183``)
through :func:`fused_ef`: a persistent grid of one molecule per block that
embeds, runs the forward over depth keeping each layer's input state and
residuals in the block's slot of device memory (:func:`slot_shapes`), the
readout and its seed, and pulls the cotangents back over depth in reverse on
those residuals; ``F = -dx``. Every layer runs the update branch and is
selected by its 0/1 gate, and v starts at zero, as in JAX. On CPU tensors it
runs the plain version :func:`fused_ef_plain`.

``matmul_dtype=torch.bfloat16`` (the default, as JAX's) is the rounding rule
of ``functional._make_mm`` for every product of the embedding, the layers and
the readout: the kernel rounds each product's activation operand to bf16 and
takes the weights already rounded (made here once per call), with f32 sums.

At aspirin's widths (:func:`tensor_core_route`) the x-mixing and the edge
products run on the tensor cores in both tiers, elsewhere on the CUDA cores;
:func:`fused_ef` counts its launches by route in ``fused_ef.routes``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from sake_tpu_torch.kernels import build
from sake_tpu_torch.kernels.functional import (
    ModelParams,
    bf16_round,
    embed,
    is_bf16,
    layer_forward_planes,
    per_layer,
    readout,
)
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, transposed, wide_stack
from sake_tpu_torch.kernels.tf32 import mm_tf32_plain, mm_tf32x2_plain
from sake_tpu_torch.kernels.resid_ef import (
    _SMEM_LIMIT,
    RESIDS,
    ROUTES,
    _check_cuda,
    _check_leaves,
    _check_tc_leaves,
    _ptrs,
    _require_cuda,
    _resid_shapes,
    _stream,
    _strides,
)

# The leaves that are a product's weight: the bf16 kernel takes them rounded.
# The biases, the RBF parameters and w_o_r (r * w_o_r is no product) stay f32.
PRODUCT_LEAVES = (
    "w_in_j", "w_in_i", "w_o_j", "w_o_i", "w_o_f", "w_o1", "w_sem", "w_xmix",
    "w_post0", "w_post1", "w_node_h", "w_node_agg", "w_node_comb", "w_node1",
    "w_vmix", "w_vel0", "w_vel1",
)


def fused_ef_plain(params: ModelParams, h, x, upd: Sequence[float], *, n_heads: int,
                   matmul_dtype):
    """Plain version of #20: the embedding, the gated update layer of
    :func:`functional.layer_forward_planes` over depth from ``v = 0``, the
    readout summed over atoms and outputs, and ``F = -dE/dx`` by one autograd
    over the stack (the same numbers as JAX's per-layer re-trace: the bf16
    products' pullbacks round in the backward of their casts). ``h (B, N,
    F_in)``, ``x (B, N, 3)``; returns ``(E (B,), F (B, N, 3))``."""
    with torch.enable_grad():
        xg = x.detach().float().requires_grad_(True)
        hc = embed(params, h.float(), matmul_dtype)
        xp = [xg[..., k : k + 1] for k in range(3)]
        vp = [torch.zeros_like(xp[0])] * 3
        for lp, u in zip(params.layers, upd):
            hc, xp2, vp2 = layer_forward_planes(lp, hc, xp, vp, n_heads=n_heads, update=True,
                                                matmul_dtype=matmul_dtype)
            xp = [a + u * (b - a) for a, b in zip(xp, xp2)]
            vp = [a + u * (b - a) for a, b in zip(vp, vp2)]
        e = readout(params, hc, matmul_dtype).sum(dim=(-2, -1))
        (g,) = torch.autograd.grad(e.sum(), xg)
    return e.detach(), -g


class KernelWeights(NamedTuple):
    """The weights as the kernel reads them: f32, every product's weight
    rounded to bf16 when ``bf16``."""

    bf16: bool
    leaves: dict  # {name: (depth, rows, cols)}
    leaves_t: dict  # their transposes
    head: tuple  # w_emb (F_in, F), b_emb, w0 (F, F0), b0, w1 (F0, O), b1, w0^T


def kernel_weights(params: ModelParams, n_heads: int, bf16: bool) -> KernelWeights:
    leaves = wide_stack(params, n_heads)
    rnd = bf16_round if bf16 else (lambda t: t)
    leaves = {n: rnd(a) if n in PRODUCT_LEAVES else a for n, a in leaves.items()}
    w_emb, w0, w1 = (rnd(t.detach().float()).contiguous()
                     for t in (params.w_embed, params.w_out0, params.w_out1))
    b_emb, b0, b1 = (t.detach().float().contiguous()
                     for t in (params.b_embed, params.b_out0, params.b_out1))
    return KernelWeights(bf16, leaves, transposed(leaves),
                         (w_emb, b_emb, w0, b0, w1, b1, w0.T.contiguous()))


def slot_shapes(grid: int, dims, leaves: dict) -> dict:
    """The device-memory scratch of #20's ``grid`` molecule slots (one per
    resident block) at ``dims = (B, N, F, H, R, K, C, depth)``: the state
    entering each layer (``bh``, ``bx``, ``bv``) and the 17 residual streams of
    every layer, K1's layouts with ``grid`` molecules."""
    _, N, F, H, R, K, C, depth = dims
    return {"bh": (depth, grid, N, F), "bx": (depth, 3, grid, N), "bv": (depth, 3, grid, N),
            **_resid_shapes((grid, N, F, H, R, K, C, depth), leaves)}


def _dims(w: KernelWeights, h):
    B, N, _ = h.shape
    depth, F, R = w.leaves["w_in_j"].shape
    H, K = w.leaves["w_o_j"].shape[-1], w.leaves["w_sem"].shape[-1]
    return B, N, F, H, R, K, w.leaves["w_xmix"].shape[-1], depth


def tensor_core_route(w: KernelWeights, h) -> bool:
    """Whether #20 takes the tensor cores for ``h (B, N, F_in)`` at these
    weights' widths (the kernel's ``tc_dims``: H * K = C = 256, H and R at most
    64, N at most 22), else the CUDA cores."""
    return bool(build.load().sake_fused_remat_ef_tc(*_dims(w, h)))


def tc_product(a, w, passes: int):
    """One of #20's bf16 tensor-core products alone, for a check of its pass
    arithmetic (``csrc/mma_tf32x3.cuh``'s ``tc_passes``): ``a (n, k) @ w (k, m)``
    with ``w`` of bf16 values, in ``passes`` TF32 passes. k = m = 256 (the
    x-mixing and its pullback, n at most 24): 2 passes on ``mm_tc``. k and m at
    most 64 (the edge products): 1 pass (the forward's, ``a`` rounded to bf16 as
    read) or 2 (the pullback's) on ``mm_tc_small``. CPU tensors take the plain
    models of ``kernels/tf32.py``; a CUDA tensor launches the kernel or raises."""
    if a.device.type == "cpu":
        return mm_tf32_plain(bf16_round(a), w) if passes == 1 else mm_tf32x2_plain(a, w)
    name = "tc_product"
    _require_cuda(name, a)
    (n, k), m = a.shape, w.shape[-1]
    _check_cuda("a", a, (n, k), a.device)
    _check_cuda("w", w, (k, m), a.device)
    if w.data_ptr() % 16:  # mm_tc copies w 16 bytes at a time
        raise ValueError(f"{name}: w must start at a 16-byte aligned address")
    out = torch.empty(n, m, device=a.device, dtype=torch.float32)
    lib = build.load()
    build.check(lib, lib.sake_fused_remat_ef_tc_product(passes, a.data_ptr(), w.data_ptr(),
                                                        out.data_ptr(), n, k, m,
                                                        _stream(a.device)), name)
    return out


def launch(w: KernelWeights, h, x, upd: Sequence[float]):
    """One launch of #20 on contiguous f32 CUDA tensors ``h (B, N, F_in)``,
    ``x (B, N, 3)``: ``(E (B,), F (B, N, 3))``. Uncounted: :func:`fused_ef`
    counts its launches. w_xmix and its transpose must start 16-byte aligned
    (the tensor-core route copies them 16 bytes at a time), as
    :func:`kernel_weights` makes them."""
    name = "fused_energy_forces"
    _require_cuda(name, x)
    dev = x.device
    leaves, head = w.leaves, w.head
    F_in = h.shape[-1]
    F0, O = head[2].shape[1], head[4].shape[1]
    dims = _dims(w, h)
    B, N, F, H, R, K, C, depth = dims
    _check_cuda("h", h, (B, N, F_in), dev)
    _check_cuda("x", x, (B, N, 3), dev)
    _check_leaves(leaves, dims, dev)
    _check_tc_leaves(name, leaves, w.leaves_t)
    for n, t in zip(("w_embed", "b_embed", "w_out0", "b_out0", "w_out1", "b_out1", "w_out0.T"),
                    head):
        _check_cuda(n, t, t.shape, dev)
    if F != H or len(upd) != depth or head[0].shape != (F_in, F):
        raise ValueError(f"{name}: needs hidden width == feature width, one gate per layer "
                         "and an embedding of the features' width")
    lib = build.load()
    if lib.sake_fused_remat_ef_smem_bytes(*dims, F_in, F0) > _SMEM_LIMIT:
        raise ValueError(f"{name}: N={N} at these widths exceeds one block's shared memory")
    grid = lib.sake_fused_remat_ef_grid(int(w.bf16), *dims, F_in, F0)
    if grid <= 0:
        raise RuntimeError(f"{name}: no resident block fits the card")
    empty = lambda *s: torch.empty(s, device=dev, dtype=torch.float32)
    scratch = {n: empty(*s) for n, s in slot_shapes(grid, dims, leaves).items()}
    bh, bx, bv = scratch.pop("bh"), scratch.pop("bx"), scratch.pop("bv")
    resid = scratch
    upd_t = torch.tensor(list(upd), dtype=torch.float32, device=dev)
    e, f = empty(B), empty(B, N, 3)
    err = lib.sake_fused_remat_ef(
        int(w.bf16), h.data_ptr(), x.data_ptr(), upd_t.data_ptr(),
        _ptrs([leaves[n] for n in LEAF_NAMES]), _ptrs([w.leaves_t[n] for n in LEAF_NAMES]),
        _strides(leaves), *(t.data_ptr() for t in head), bh.data_ptr(), bx.data_ptr(),
        bv.data_ptr(), _ptrs([resid[n] for n in RESIDS]), e.data_ptr(), f.data_ptr(), grid,
        *dims, F_in, F0, O, _stream(dev),
    )
    build.check(lib, err, name)
    return e, f


def fused_ef(params: ModelParams, h, x, upd: Sequence[float], *, n_heads: int = 4,
             matmul_dtype=torch.bfloat16):
    """#20: ``(E (B,), F (B, N, 3))`` of raw features ``h (B, N, F_in)`` and
    positions ``x (B, N, 3)`` in one launch, the gates ``upd`` one per layer.
    CPU tensors take the plain version; a CUDA tensor launches the kernel or
    raises. Each launch counts in ``fused_ef.launches`` and in
    ``fused_ef.routes`` under its route."""
    bf16 = is_bf16("fused_energy_forces", matmul_dtype)
    if x.device.type == "cpu":
        return fused_ef_plain(params, h, x, upd, n_heads=n_heads, matmul_dtype=matmul_dtype)
    w, hc = kernel_weights(params, n_heads, bf16), h.float().contiguous()
    out = launch(w, hc, x.float().contiguous(), upd)
    fused_ef.launches += 1
    fused_ef.routes[ROUTES[tensor_core_route(w, hc)]] += 1
    return out


fused_ef.launches = 0
fused_ef.routes = dict.fromkeys(ROUTES, 0)


@torch.no_grad()
def fused_energy_forces(
    params: ModelParams,
    h: torch.Tensor,  # (B, N, F_in)
    x: torch.Tensor,  # (B, N, 3)
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    batch_tile: int = 8,
    matmul_dtype=torch.bfloat16,
    interpret: bool = False,
):
    """Fused (E, F) evaluation: ``E (B,)``, ``F = -dE/dx (B, N, 3)``, one
    launch per call (#20).

    ``matmul_dtype=torch.bfloat16`` rounds every product's operands to bf16
    and sums in f32; None (or f32) is strict f32; any other raises. ``B %
    batch_tile`` must be 0, as in JAX, though the kernel takes one molecule per
    block whatever the tile; ``interpret`` has no counterpart (CPU tensors take
    the plain version). Not differentiable, as the JAX function."""
    B = h.shape[0]
    if B % batch_tile:
        raise ValueError(f"batch {B} not divisible by batch_tile {batch_tile}")
    upd = [1.0 if u else 0.0 for u in per_layer(update, len(params.layers))]
    return fused_ef(params, h, x, upd, n_heads=n_heads, matmul_dtype=matmul_dtype)
