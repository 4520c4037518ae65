"""Fori-over-depth E + F that keeps only the boundary states: #21 and #22.

Port of ``sake_tpu/kernels/fori_ef.py``. :func:`fori_energy_forces` embeds
(torch), runs #21 (:func:`fori_fwd`, ``csrc/remat_ef.cu``; JAX ``fwd_kernel``
``:133``, pallas_call ``:161``), which writes only the state entering each
layer and the final ``h``, then the readout and its seed (torch, as the JAX
package left them to XLA), then #22 (:func:`fori_bwd`, the same source; JAX
``bwd_kernel`` ``:200``, pallas_call ``:237``), which walks the layers in
reverse, re-runs each from its boundary into a one-layer residual scratch and
pulls the cotangents back through it; ``F = -dx``. Per aspirin molecule at
depth 6 that keeps about 35 KB of boundaries where K1 + K2 keep 5.3 MB of
residuals, for one forward more of work.

At aspirin's widths (:func:`tensor_core_route`) the pullback's x-mixing product,
its transpose and the edge products o_f and o1 run on the tensor cores in
3xTF32 (``csrc/remat_step.cuh``), and so do the forward's x-mixing, o_f and o1
(:func:`fwd_tensor_core_route`, K1's rule: up to 21 atoms, where two 256-thread
blocks fit an SM); the narrow models keep the CUDA-core products. The four
wrappers (these and ``depthgrid_ef``'s) count their launches by route in
``.routes``.

The plain versions :func:`fori_fwd_plain` and :func:`fori_bwd_plain` run
``resid_ef.layer_fwd_resid`` and ``layer_bwd_resid``. The launch helpers here
also serve the depth-grid pair (#23, #24) in ``depthgrid_ef``. Each wrapper
takes its plain version only for CPU tensors; on a CUDA tensor it launches
its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from sake_tpu_torch.kernels import build
from sake_tpu_torch.kernels.functional import ModelParams, _f32_only, embed, per_layer
from sake_tpu_torch.kernels.fused_ef import ROUTES
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, layer_leaves, transposed, wide_stack
from sake_tpu_torch.kernels.resid_ef import (
    _SMEM_LIMIT,
    RESIDS,
    _check_cuda,
    _check_leaves,
    _check_tc_leaves,
    _dims,
    _leaf_shapes,
    _planes,
    _ptrs,
    _readout_seed,
    _require_cuda,
    _resid_shapes,
    _stream,
    _strides,
    _unplanes,
    layer_bwd_resid,
    layer_fwd_resid,
)


class Bounds(NamedTuple):
    bh: torch.Tensor  # (depth, B, N, F) h entering each layer
    bx: torch.Tensor  # (depth, 3, B, N)
    bv: torch.Tensor  # (depth, 3, B, N)
    h_fin: torch.Tensor  # (B, N, F)


def stack_plain(layer, leaves: dict, h0, xs, upd: Sequence[float]) -> Bounds:
    """``layer(p, h, xp, vp, u)`` over depth from ``(h0 (B, N, F), xs (3, B,
    N), v = 0)``, keeping the state entering each layer and the final ``h``."""
    h, xp, vp = h0, _planes(xs), _planes(torch.zeros_like(xs))
    bh, bx, bv = [], [], []
    for l, u in enumerate(upd):
        bh.append(h)
        bx.append(_unplanes(xp))
        bv.append(_unplanes(vp))
        h, xp, vp = layer(layer_leaves(leaves, l), h, xp, vp, u)[:3]
    return Bounds(torch.stack(bh), torch.stack(bx), torch.stack(bv), h)


def fori_fwd_plain(leaves: dict, h0, xs, upd: Sequence[float]) -> Bounds:
    """Plain version of :func:`fori_fwd`: :func:`resid_ef.layer_fwd_resid`
    over depth (:func:`stack_plain`)."""
    return stack_plain(layer_fwd_resid, leaves, h0, xs, upd)


def fori_bwd_plain(leaves: dict, bnd: Bounds, upd: Sequence[float], dh_fin):
    """Plain version of :func:`fori_bwd`: per layer in reverse, re-run
    :func:`resid_ef.layer_fwd_resid` from the layer's boundary and pull the
    cotangents back with :func:`resid_ef.layer_bwd_resid`, from ``(dh_fin, 0,
    0)``. Returns the cotangents ``(dh0 (B, N, F), dx (3, B, N), dv (3, B,
    N))`` of the initial state."""
    zeros = _planes(torch.zeros_like(bnd.bx[0]))
    dh, dxp, dvp = dh_fin, zeros, zeros
    for l in reversed(range(len(upd))):
        p = layer_leaves(leaves, l)
        xp, vp = _planes(bnd.bx[l]), _planes(bnd.bv[l])
        resid = layer_fwd_resid(p, bnd.bh[l], xp, vp, upd[l])[3]
        dh, dxp, dvp = layer_bwd_resid(p, resid, bnd.bh[l], xp, vp, upd[l], dh, dxp, dvp)
    return dh, _unplanes(dxp), _unplanes(dvp)


# --------------------------------------------------------------------------
# Launches of csrc/remat_ef.cu: the forward over a range of layers, the
# pullback over a range of layers in reverse.
# --------------------------------------------------------------------------


def _gates(name, dims, upd, dev):
    F, H, depth = dims[2], dims[3], dims[7]
    if F != H or len(upd) != depth:
        raise ValueError(f"{name}: needs hidden width == feature width and one gate per layer")
    return torch.tensor(list(upd), dtype=torch.float32, device=dev)


def fwd_tensor_core_route(dims) -> bool:
    """Whether #21 and #23 take their tensor-core kernel at ``dims`` (``(B, N,
    F, H, R, K, C, depth)``; the kernel source's ``fwd_tc_route``, K1's rule:
    ``tc_dims``'s widths and two 256-thread blocks an SM, which at aspirin's
    widths is N at most 21), else their CUDA-core kernel: an index into
    ``ROUTES``."""
    return bool(build.load().sake_remat_fwd_tc(*dims))


def _fwd_setup(name, leaves, h0, xs, upd):
    """Checks and outputs of the forward kernels: ``(lib, dims, upd, out,
    pool, route)``, ``out`` the empty :class:`Bounds`, ``pool`` the scratch of
    one layer's pooled vectors and ``route`` the ``ROUTES`` entry the launches
    take (:func:`fwd_tensor_core_route`)."""
    _require_cuda(name, h0)
    dims = _dims(leaves, h0)
    B, N, F, H, R, K, C, depth = dims
    dev = h0.device
    _check_cuda("h0", h0, (B, N, F), dev)
    _check_cuda("xs", xs, (3, B, N), dev)
    _check_leaves(leaves, dims, dev)
    upd_t = _gates(name, dims, upd, dev)
    lib = build.load()
    if lib.sake_remat_fwd_smem_bytes(*dims) > _SMEM_LIMIT:
        raise ValueError(f"{name}: N={N} at these widths exceeds one block's shared memory")
    route = ROUTES[fwd_tensor_core_route(dims)]
    if route == "tensor cores":
        _check_tc_leaves(name, leaves)
    empty = lambda *s: torch.empty(s, device=dev, dtype=torch.float32)
    out = Bounds(empty(depth, B, N, F), empty(depth, 3, B, N), empty(depth, 3, B, N),
                 empty(B, N, F))
    return lib, dims, upd_t, out, empty(3, B, N, C), route


def _launch_fwd(lib, dims, l0, l1, h_in, x_in, v_in, upd_t, leaves, out: Bounds, pool, h_out,
                x_out, v_out, name):
    """One launch of the forward over layers ``[l0, l1)``, on the kernel the
    shape takes. A refused launch raises."""
    err = lib.sake_remat_fwd(
        l0, l1, h_in.data_ptr(), x_in.data_ptr(), None if v_in is None else v_in.data_ptr(),
        upd_t.data_ptr(), _ptrs([leaves[n] for n in LEAF_NAMES]), _strides(leaves),
        out.bh.data_ptr(), out.bx.data_ptr(), out.bv.data_ptr(), pool.data_ptr(),
        h_out.data_ptr(), None if x_out is None else x_out.data_ptr(),
        None if v_out is None else v_out.data_ptr(), *dims, _stream(h_in.device),
    )
    build.check(lib, err, name)


def tensor_core_route(dims) -> bool:
    """Whether #22 and #24 take the tensor cores at ``dims`` (``(B, N, F, H, R,
    K, C, depth)``; the kernel's ``tc_dims``: H * K = C = 256, H and R at most
    64, N at most 22), else the CUDA cores: an index into ``ROUTES``."""
    return bool(build.load().sake_remat_bwd_tc(*dims))


def _bwd_setup(name, leaves, bnd: Bounds, upd, dh_fin, leaves_t):
    """Checks and scratch of the pullback kernels: ``(lib, dims, upd,
    leaves_t, res, route)``, ``res`` one layer's residual scratch ``{name: (B,
    N*N | N, ch)}``, ``route`` the ``ROUTES`` entry the launches take."""
    _require_cuda(name, dh_fin)
    dims = _dims(leaves, bnd.bh[0])
    B, N, F, H, R, K, C, depth = dims
    dev = dh_fin.device
    _check_leaves(leaves, dims, dev)
    _check_cuda("bh", bnd.bh, (depth, B, N, F), dev)
    _check_cuda("bx", bnd.bx, (depth, 3, B, N), dev)
    _check_cuda("bv", bnd.bv, (depth, 3, B, N), dev)
    _check_cuda("dh_fin", dh_fin, (B, N, F), dev)
    upd_t = _gates(name, dims, upd, dev)
    lib = build.load()
    if lib.sake_remat_bwd_smem_bytes(*dims) > _SMEM_LIMIT:
        raise ValueError(f"{name}: N={N} at these widths exceeds one block's shared memory")
    if leaves_t is None:
        leaves_t = transposed(leaves)
    for leaf, shape in _leaf_shapes(F, H, R, K, C).items():
        _check_cuda(f"{leaf}.T", leaves_t[leaf], (depth, *shape[::-1]), dev)
    tc = tensor_core_route(dims)
    if tc:
        _check_tc_leaves(name, leaves, leaves_t)
    res = {n: torch.empty(s[1:], device=dev) for n, s in _resid_shapes(dims, leaves).items()}
    return lib, dims, upd_t, leaves_t, res, ROUTES[tc]


def _launch_bwd(lib, dims, l_hi, l_lo, bnd: Bounds, upd_t, leaves, leaves_t, res, dh_in, dx_in,
                dv_in, dh_out, dx_out, dv_out, name):
    err = lib.sake_remat_bwd(
        l_hi, l_lo, bnd.bh.data_ptr(), bnd.bx.data_ptr(), bnd.bv.data_ptr(), upd_t.data_ptr(),
        _ptrs([leaves[n] for n in LEAF_NAMES]), _ptrs([leaves_t[n] for n in LEAF_NAMES]),
        _strides(leaves), _ptrs([res[n] for n in RESIDS]), dh_in.data_ptr(),
        None if dx_in is None else dx_in.data_ptr(), None if dv_in is None else dv_in.data_ptr(),
        dh_out.data_ptr(), dx_out.data_ptr(), dv_out.data_ptr(), *dims, _stream(dh_in.device),
    )
    build.check(lib, err, name)


def fori_fwd(leaves: dict, h0, xs, upd: Sequence[float]) -> Bounds:
    """#21: the layer stack's forward from ``(h0 (B, N, F), xs (3, B, N), v =
    0)`` in one launch, writing the state entering each layer and the final
    ``h`` (:class:`Bounds`), no residuals. CPU tensors take the plain
    version. On the card it takes the kernel its shape selects
    (:func:`fwd_tensor_core_route`: K1's tensor-core body at aspirin's widths),
    each launch counted in ``fori_fwd.launches`` and under its route in
    ``fori_fwd.routes``."""
    if h0.device.type == "cpu":
        return fori_fwd_plain(leaves, h0, xs, upd)
    lib, dims, upd_t, out, pool, route = _fwd_setup("fori_fwd", leaves, h0, xs, upd)
    _launch_fwd(lib, dims, 0, dims[7], h0, xs, None, upd_t, leaves, out, pool, out.h_fin, None,
                None, "fori_fwd")
    fori_fwd.launches += 1
    fori_fwd.routes[route] += 1
    return out


fori_fwd.launches = 0
fori_fwd.routes = dict.fromkeys(ROUTES, 0)


def fori_bwd(leaves: dict, bnd: Bounds, upd: Sequence[float], dh_fin, *,
             leaves_t: Optional[dict] = None):
    """#22: the pullback of ``(dh_fin (B, N, F), 0, 0)`` through the layers
    in reverse in one launch, each layer re-run from its boundary in ``bnd``
    (#21's output). Returns ``(dh0, dx (3, B, N), dv (3, B, N))``. CPU
    tensors take the plain version. ``leaves_t``: ``leaves.transposed(
    leaves)``, built here when not given. Each launch counts in
    ``fori_bwd.launches`` and in ``fori_bwd.routes`` under its route."""
    if dh_fin.device.type == "cpu":
        return fori_bwd_plain(leaves, bnd, upd, dh_fin)
    lib, dims, upd_t, leaves_t, res, route = _bwd_setup("fori_bwd", leaves, bnd, upd, dh_fin,
                                                        leaves_t)
    dx = bnd.bx.new_empty(bnd.bx.shape[1:])
    dh0, dv = torch.empty_like(dh_fin), torch.empty_like(dx)
    _launch_bwd(lib, dims, dims[7] - 1, 0, bnd, upd_t, leaves, leaves_t, res, dh_fin, None, None,
                dh0, dx, dv, "fori_bwd")
    fori_bwd.launches += 1
    fori_bwd.routes[route] += 1
    return dh0, dx, dv


fori_bwd.launches = 0
fori_bwd.routes = dict.fromkeys(ROUTES, 0)


def remat_energy_forces(fwd_fn, bwd_fn, params: ModelParams, h, x, n_heads: int, update,
                        chunk: Optional[int]):
    """Raw ``E (B,)`` and ``F (B, N, 3)`` through a boundary-keeping forward
    and its remat pullback (#21 and #22, or #23 and #24), per chunk of
    ``chunk`` molecules: embed, ``fwd_fn``, the readout seed, ``bwd_fn``."""
    B = h.shape[0]
    upd = [1.0 if u else 0.0 for u in per_layer(update, len(params.layers))]
    leaves = wide_stack(params, n_heads)
    leaves_t = transposed(leaves) if x.is_cuda else None  # the pullback's layout, once per call
    h0 = embed(params, h.float())
    step = chunk or B
    es, fs = [], []
    for s in range(0, B, step):
        sl = slice(s, s + step)
        xs = x[sl].permute(2, 0, 1).float().contiguous()
        bnd = fwd_fn(leaves, h0[sl].contiguous(), xs, upd)
        e, dh_fin = _readout_seed(params, bnd.h_fin, None)
        dx = bwd_fn(leaves, bnd, upd, dh_fin, leaves_t=leaves_t)[1]
        es.append(e)
        fs.append(-dx.permute(1, 2, 0))
    return torch.cat(es), torch.cat(fs)


@torch.no_grad()
def fori_energy_forces(
    params: ModelParams,
    h: torch.Tensor,  # (B, N, F_in)
    x: torch.Tensor,  # (B, N, 3)
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    batch_tile: int = 4,
    matmul_dtype=None,
    precision=None,
    edge_matmul_dtype=None,
    edge_precision=None,
    pad_atoms: bool = False,
    interpret: bool = False,
    chunk: Optional[int] = 512,
):
    """Raw (uncolored) ``E (B,)`` and ``F = -dE/dx (B, N, 3)`` through #21,
    the readout seed and #22. ``chunk`` bounds the molecules whose one-layer
    residual scratch is alive at once (f32: about 0.87 MB per aspirin
    molecule).

    The JAX keywords, under the policy of ``resid_energy_forces``: the bf16
    tier (``matmul_dtype``, ``edge_matmul_dtype``) raises; accepted with no
    counterpart are ``batch_tile`` (one molecule per block), ``pad_atoms``
    (N as it comes: the JAX padded call masks its pad atoms out, so E and F
    are the unpadded ones), the precisions (every product is f32) and
    ``interpret`` (CPU tensors take the plain versions)."""
    _f32_only("fori_energy_forces", matmul_dtype, edge_matmul_dtype)
    return remat_energy_forces(fori_fwd, fori_bwd, params, h, x, n_heads, update, chunk)
