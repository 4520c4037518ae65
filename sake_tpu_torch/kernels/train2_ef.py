"""Second-order (force-loss) training: the gradient of a loss of ``(E, F)``
with ``F = -dE/dx``, on kernels.

Port of ``sake_tpu/kernels/train2_ef.py`` in its ``aug_mode="shared"``
(``:936-2055``). The training gradient of ``(E, F)`` under cotangents
``(g_e, g_f)`` is the gradient of ``S = sum_b g_e[b] E[b] - E_dot``, with
``E_dot`` the tangent of the energy along ``x_dot = g_f`` (the minus of
``F = -dE/dx`` lives in ``- E_dot``, so the tangent seed is ``+g_f``). So
the backward is a tangent-only forward plus one pullback of the
tangent-augmented layer map, all on kernels:

- the primal (``#7``, ``#8``): :func:`shared_fwd` is K1 (``resid_fwd``)
  keeping its boundary states and residuals across the autograd boundary,
  the readout and its seed run in torch, and :func:`shared_bwd` is K2
  (``resid_bwd``) for ``F = -dx``;
- the tangent forward (``#9``, ``csrc/resid_jvp.cu``): :func:`resid_jvp`
  runs ``layer_jvp_resid`` over depth on the saved residuals from the seed
  ``(0, g_f, 0)`` and writes the tangent boundaries and residuals;
- the head (torch): the gradient of ``S`` through the readout gives the
  seeds ``dh_fin``, ``dth_fin`` and the readout's gradients;
- the augmented pullback (``#10``): :func:`resid_aug_bwd` runs, per layer
  in reverse, ``layer_bwd_resid`` on the primal cotangent ``c_p`` and the
  jvp of ``layer_bwd_resid`` on the tangent cotangent ``c_t``, whose
  tangent (the Hessian term) adds into ``c_p``, and sums every leaf's
  gradient. ``c_t`` does not depend on ``c_p``, so the kernels take the
  chains in turn: :func:`resid_tbwd` (``csrc/resid_tbwd.cu``) runs the
  ``c_t`` chain with tangents over all layers and writes the Hessian
  terms, the ``c_t`` rows and their tangents; :func:`resid_bwd_aug` (the
  K2 source, rows instantiation) runs the ``c_p`` chain adding the Hessian
  term after each layer; :func:`param_grads_aug` (``csrc/param_grads.cu``)
  contracts both sets of rows into the 29 leaves' gradients per layer;
- the embedding pullback runs in torch, as the JAX package left it to XLA.

:func:`make_ef_train2` wraps it as a ``torch.autograd.Function``. Each
kernel wrapper takes its plain version only for CPU tensors; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from sake_tpu_torch.kernels import build, resid_ef
from sake_tpu_torch.kernels.functional import (
    ModelParams,
    _silu,
    embed,
    flat_params,
    per_layer,
)
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, layer_leaves, transposed, wide_stack
from sake_tpu_torch.kernels.resid_ef import (
    _GRAD_CHUNKS,
    _SMEM_LIMIT,
    RESIDS,
    ROWS,
    FwdOut,
    _check_all,
    _check_cuda,
    _check_leaves,
    _dims,
    _dsilu,
    _layer,
    _leaf_shapes,
    _planes,
    _ptrs,
    _readout_seed,
    _require_cuda,
    _resid_shapes,
    _row_shapes,
    _strides,
    _unflat_params,
    _unplanes,
    layer_bwd_resid,
    layer_bwd_resid_jvp,
    layer_jvp_resid,
    layer_param_grads,
    layer_param_grads_tangent,
    unsplit_layer_grads,
)

# --------------------------------------------------------------------------
# Plain versions: the layer functions of resid_ef over depth.
# --------------------------------------------------------------------------


def resid_jvp_plain(leaves: dict, fwd: FwdOut, upd: Sequence[float], tx0) -> FwdOut:
    """Plain version of :func:`resid_jvp`: :func:`layer_jvp_resid` over
    depth from the tangent seed ``(0, tx0 (3, B, N), 0)``, in the layout of
    ``FwdOut`` (tangent boundaries, final tangent state, tangent
    residuals)."""
    th = torch.zeros_like(fwd.bh[0])
    txp, tvp = _planes(tx0), _planes(torch.zeros_like(tx0))
    tbh, tbx, tbv, tres = [], [], [], {n: [] for n in RESIDS}
    for l, u in enumerate(upd):
        tbh.append(th)
        tbx.append(_unplanes(txp))
        tbv.append(_unplanes(tvp))
        th, txp, tvp, tr = layer_jvp_resid(
            layer_leaves(leaves, l), _layer(fwd.resid, l), fwd.bh[l], _planes(fwd.bx[l]),
            _planes(fwd.bv[l]), th, txp, tvp, u,
        )
        for n in RESIDS:
            tres[n].append(tr[n])
    return FwdOut(torch.stack(tbh), torch.stack(tbx), torch.stack(tbv), th, _unplanes(txp),
                  _unplanes(tvp), {n: torch.stack(v) for n, v in tres.items()})


def resid_tbwd_plain(leaves: dict, fwd: FwdOut, tfwd: FwdOut, upd: Sequence[float], dh, dx,
                     dv):
    """Plain version of :func:`resid_tbwd`: :func:`layer_bwd_resid_jvp` in
    reverse depth. The cotangent ``(dh (B, N, F), dx, dv (3, B, N))`` of the
    final state runs back through the layers with tangents along ``tfwd``.
    Returns ``(dh0, dx0, dv0, add, rows, t_rows)``: the cotangents of the
    initial state, ``add = (add_h (depth, B, N, F), add_x, add_v (depth, 3,
    B, N))`` the tangents of each layer's pullback (the Hessian terms), and
    the depth-stacked cotangent rows and their tangents."""
    dxp, dvp = _planes(dx), _planes(dv)
    depth = len(upd)
    per = [None] * depth
    for l in reversed(range(depth)):
        (dh, dxp, dvp, rows), (hc, xc, vc, t_rows) = layer_bwd_resid_jvp(
            layer_leaves(leaves, l), _layer(fwd.resid, l), fwd.bh[l], _planes(fwd.bx[l]),
            _planes(fwd.bv[l]), upd[l], dh, dxp, dvp, _layer(tfwd.resid, l), tfwd.bh[l],
            _planes(tfwd.bx[l]), _planes(tfwd.bv[l]),
        )
        per[l] = (hc, _unplanes(xc), _unplanes(vc), rows, t_rows)
    add = tuple(torch.stack([p[k] for p in per]) for k in range(3))
    stack = lambda k: {n: torch.stack([p[k][n] for p in per]) for n in ROWS}
    return dh, _unplanes(dxp), _unplanes(dvp), add, stack(3), stack(4)


def resid_bwd_aug_plain(leaves: dict, fwd: FwdOut, upd: Sequence[float], dh, dx, dv,
                        add: tuple):
    """Plain version of :func:`resid_bwd_aug`: :func:`layer_bwd_resid` with
    its rows in reverse depth, ``add[k][l]`` added to the cotangents leaving
    layer ``l``. Returns ``(dh0, dx0, dv0, rows)``."""
    dxp, dvp = _planes(dx), _planes(dv)
    add_h, add_x, add_v = add
    depth = len(upd)
    rows = [None] * depth
    for l in reversed(range(depth)):
        dh, dxp, dvp, rows[l] = layer_bwd_resid(
            layer_leaves(leaves, l), _layer(fwd.resid, l), fwd.bh[l], _planes(fwd.bx[l]),
            _planes(fwd.bv[l]), upd[l], dh, dxp, dvp, want_param_grads="rows",
        )
        dh = dh + add_h[l]
        dxp = [a + b for a, b in zip(dxp, _planes(add_x[l]))]
        dvp = [a + b for a, b in zip(dvp, _planes(add_v[l]))]
    return dh, _unplanes(dxp), _unplanes(dvp), {n: torch.stack([r[n] for r in rows])
                                                for n in ROWS}


def param_grads_aug_plain(leaves: dict, fwd: FwdOut, tfwd: FwdOut, rows: dict,
                          rows_t: dict, t_rows: dict) -> dict:
    """Plain version of :func:`param_grads_aug`: per layer, the contraction
    of the primal chain's rows (:func:`layer_param_grads`) plus the tangent
    of the contraction of the tangent chain's rows
    (:func:`layer_param_grads_tangent`). ``{name: (depth, r, c)}``."""
    out = {n: [] for n in LEAF_NAMES}
    for l in range(fwd.bh.shape[0]):
        p, res = layer_leaves(leaves, l), _layer(fwd.resid, l)
        g = layer_param_grads(p, res, fwd.bh[l], _layer(rows, l))
        tg = layer_param_grads_tangent(p, res, fwd.bh[l], _layer(rows_t, l),
                                       _layer(tfwd.resid, l), tfwd.bh[l], _layer(t_rows, l))
        for n in LEAF_NAMES:
            out[n].append(g[n] + tg[n])
    return {n: torch.stack(v) for n, v in out.items()}


def resid_aug_bwd_plain(leaves: dict, fwd: FwdOut, tfwd: FwdOut, upd: Sequence[float],
                        dh_fin, dth_fin):
    """Plain version of :func:`resid_aug_bwd`. Returns ``(dh0, dx0, dth0,
    grads)``: the primal chain's cotangents of the initial ``h`` and ``x``,
    the tangent chain's of ``h``, and every leaf's gradient per layer."""
    zeros = torch.zeros_like(fwd.bx[0])
    dth0, _, _, add, rows_t, t_rows = resid_tbwd_plain(leaves, fwd, tfwd, upd, dth_fin,
                                                       zeros, zeros)
    dh0, dx0, _, rows = resid_bwd_aug_plain(leaves, fwd, upd, dh_fin, zeros, zeros, add)
    return dh0, dx0, dth0, param_grads_aug_plain(leaves, fwd, tfwd, rows, rows_t, t_rows)


# --------------------------------------------------------------------------
# Kernel wrappers. Each ``_launch_*`` checks, allocates and launches; the
# public function picks the plain version for CPU tensors and counts its
# launches.
# --------------------------------------------------------------------------


def _check_fwd(name, fwd: FwdOut, dims, leaves, dev):
    B, N, F, H, R, K, C, depth = dims
    _check_cuda(f"{name}.bh", fwd.bh, (depth, B, N, F), dev)
    _check_cuda(f"{name}.bx", fwd.bx, (depth, 3, B, N), dev)
    _check_cuda(f"{name}.bv", fwd.bv, (depth, 3, B, N), dev)
    _check_all(f"{name}.resid", fwd.resid, _resid_shapes(dims, leaves), dev)


def _common(name, leaves, fwd, upd=None, smem_fn=None):
    """Checks every kernel here makes; returns ``(lib, dims, dev, upd)``, the
    update gates as the kernels read them (when given)."""
    dims = _dims(leaves, fwd.bh[0])
    B, N, F, H, R, K, C, depth = dims
    dev = fwd.bh.device
    _check_leaves(leaves, dims, dev)
    _check_fwd("fwd", fwd, dims, leaves, dev)
    if F != H or (upd is not None and len(upd) != depth):
        raise ValueError(f"{name}: needs hidden width == feature width and one gate per layer")
    lib = build.load()
    if smem_fn is not None and getattr(lib, smem_fn)(*dims) > _SMEM_LIMIT:
        raise ValueError(f"{name}: N={N} at these widths exceeds one block's shared memory")
    upd_t = None if upd is None else torch.tensor(list(upd), dtype=torch.float32, device=dev)
    return lib, dims, dev, upd_t


def _launch_resid_jvp(leaves, fwd, upd, tx0) -> FwdOut:
    lib, dims, dev, upd_t = _common("resid_jvp", leaves, fwd, upd, "sake_resid_jvp_smem_bytes")
    B, N, F, H, R, K, C, depth = dims
    _check_cuda("tx0", tx0, (3, B, N), dev)
    empty = lambda *s: torch.empty(s, device=dev, dtype=torch.float32)
    out = FwdOut(
        empty(depth, B, N, F), empty(depth, 3, B, N), empty(depth, 3, B, N),
        empty(B, N, F), empty(3, B, N), empty(3, B, N),
        {n: empty(*s) for n, s in _resid_shapes(dims, leaves).items()},
    )
    err = lib.sake_resid_jvp(
        fwd.bh.data_ptr(), fwd.bx.data_ptr(), fwd.bv.data_ptr(), upd_t.data_ptr(),
        _ptrs([leaves[n] for n in LEAF_NAMES]), _strides(leaves),
        _ptrs([fwd.resid[n] for n in RESIDS]), tx0.data_ptr(),
        out.bh.data_ptr(), out.bx.data_ptr(), out.bv.data_ptr(),
        out.h_fin.data_ptr(), out.x_fin.data_ptr(), out.v_fin.data_ptr(),
        _ptrs([out.resid[n] for n in RESIDS]), *dims, resid_ef._stream(dev),
    )
    build.check(lib, err, "resid_jvp")
    return out


def resid_jvp(leaves: dict, fwd: FwdOut, upd: Sequence[float], tx0) -> FwdOut:
    """#9, the tangent-only forward (``csrc/resid_jvp.cu``; JAX
    ``tfwd_kernel`` ``train2_ef.py:1397``): ``layer_jvp_resid`` over depth
    on K1's boundaries and residuals ``fwd``, from the tangent seed ``(0,
    tx0 (3, B, N), 0)``. Returns the tangent in the layout of ``FwdOut``.
    CPU tensors take the plain version."""
    if tx0.device.type == "cpu":
        return resid_jvp_plain(leaves, fwd, upd, tx0)
    _require_cuda("resid_jvp", tx0)
    out = _launch_resid_jvp(leaves, fwd, upd, tx0)
    resid_jvp.launches += 1
    return out


resid_jvp.launches = 0


def _launch_resid_tbwd(leaves, fwd, tfwd, upd, dh, dx, dv, leaves_t):
    lib, dims, dev, upd_t = _common("resid_tbwd", leaves, fwd, upd,
                                    "sake_resid_tbwd_smem_bytes")
    B, N, F, H, R, K, C, depth = dims
    _check_fwd("tfwd", tfwd, dims, leaves, dev)
    _check_cuda("dh", dh, (B, N, F), dev)
    _check_cuda("dx", dx, (3, B, N), dev)
    _check_cuda("dv", dv, (3, B, N), dev)
    if leaves_t is None:
        leaves_t = transposed(leaves)
    for leaf, shape in _leaf_shapes(F, H, R, K, C).items():
        _check_cuda(f"{leaf}.T", leaves_t[leaf], (depth, *shape[::-1]), dev)
    empty = lambda *s: torch.empty(s, device=dev, dtype=torch.float32)
    dh_out, dx_out, dv_out = empty(B, N, F), empty(3, B, N), empty(3, B, N)
    add = (empty(depth, B, N, F), empty(depth, 3, B, N), empty(depth, 3, B, N))
    rows = {n: empty(*s) for n, s in _row_shapes(dims, leaves).items()}
    t_rows = {n: empty(*s) for n, s in _row_shapes(dims, leaves).items()}
    # per molecule: d_hatt and d_pool_sq with their tangents, read row by row
    scratch = empty(B, 2 * N * (H * K + C))
    err = lib.sake_resid_tbwd(
        fwd.bh.data_ptr(), fwd.bx.data_ptr(), fwd.bv.data_ptr(),
        tfwd.bh.data_ptr(), tfwd.bx.data_ptr(), tfwd.bv.data_ptr(), upd_t.data_ptr(),
        _ptrs([leaves[n] for n in LEAF_NAMES]), _ptrs([leaves_t[n] for n in LEAF_NAMES]),
        _strides(leaves), _ptrs([fwd.resid[n] for n in RESIDS]),
        _ptrs([tfwd.resid[n] for n in RESIDS]), dh.data_ptr(), dx.data_ptr(), dv.data_ptr(),
        dh_out.data_ptr(), dx_out.data_ptr(), dv_out.data_ptr(),
        *(a.data_ptr() for a in add), _ptrs([rows[n] for n in ROWS]),
        _ptrs([t_rows[n] for n in ROWS]), scratch.data_ptr(), *dims, resid_ef._stream(dev),
    )
    build.check(lib, err, "resid_tbwd")
    return dh_out, dx_out, dv_out, add, rows, t_rows


def resid_tbwd(leaves: dict, fwd: FwdOut, tfwd: FwdOut, upd: Sequence[float], dh, dx, dv,
               *, leaves_t: Optional[dict] = None):
    """The tangent cotangent chain of #10 (``csrc/resid_tbwd.cu``; the
    ``jax.jvp`` of ``layer_bwd_resid`` in JAX ``bwd_kernel``
    ``train2_ef.py:1585-1598``): the pullback of ``(dh, dx, dv)`` through
    the layers in reverse, each with its tangent along the tangent forward
    ``tfwd``. Returns ``(dh0, dx0, dv0, add, rows, t_rows)`` as
    :func:`resid_tbwd_plain`. CPU tensors take the plain version."""
    if dh.device.type == "cpu":
        return resid_tbwd_plain(leaves, fwd, tfwd, upd, dh, dx, dv)
    _require_cuda("resid_tbwd", dh)
    out = _launch_resid_tbwd(leaves, fwd, tfwd, upd, dh, dx, dv, leaves_t)
    resid_tbwd.launches += 1
    return out


resid_tbwd.launches = 0


def resid_bwd_aug(leaves: dict, fwd: FwdOut, upd: Sequence[float], dh, dx, dv, add: tuple,
                  *, leaves_t: Optional[dict] = None):
    """The primal cotangent chain of #10: K2 with its rows (``csrc/
    resid_bwd.cu``, ``kRows``), adding ``add[k][l]`` (the Hessian terms of
    :func:`resid_tbwd`) to the cotangents leaving layer ``l``. Returns
    ``(dh0, dx0, dv0, rows)``. CPU tensors take the plain version."""
    if dh.device.type == "cpu":
        return resid_bwd_aug_plain(leaves, fwd, upd, dh, dx, dv, add)
    out = resid_ef._bwd_launch("resid_bwd_aug", leaves, fwd, upd, dh, dx, dv, None,
                               leaves_t, True, add)
    resid_bwd_aug.launches += 1
    return out


resid_bwd_aug.launches = 0


def _launch_param_grads_aug(leaves, fwd, tfwd, rows, rows_t, t_rows) -> dict:
    lib, dims, dev, _ = _common("param_grads_aug", leaves, fwd)
    B, N, F, H, R, K, C, depth = dims
    _check_fwd("tfwd", tfwd, dims, leaves, dev)
    for name, rw in (("rows", rows), ("rows_t", rows_t), ("t_rows", t_rows)):
        _check_all(name, rw, _row_shapes(dims, leaves), dev)
    shapes = _leaf_shapes(F, H, R, K, C)
    sizes = [depth * shapes[n][0] * shapes[n][1] for n in LEAF_NAMES]
    per_chunk = -(-B // min(B, _GRAD_CHUNKS))
    n_chunks = -(-B // per_chunk)
    partial = torch.empty(n_chunks, sum(sizes), device=dev, dtype=torch.float64)
    out = torch.empty(sum(sizes), device=dev)
    err = lib.sake_param_grads_aug(
        fwd.bh.data_ptr(), tfwd.bh.data_ptr(), _ptrs([leaves[n] for n in LEAF_NAMES]),
        _strides(leaves), _ptrs([fwd.resid[n] for n in RESIDS]),
        _ptrs([tfwd.resid[n] for n in RESIDS]), _ptrs([rows[n] for n in ROWS]),
        _ptrs([rows_t[n] for n in ROWS]), _ptrs([t_rows[n] for n in ROWS]),
        partial.data_ptr(), out.data_ptr(), per_chunk, *dims, resid_ef._stream(dev),
    )
    build.check(lib, err, "param_grads_aug")
    return {n: a.view(depth, *shapes[n]) for n, a in zip(LEAF_NAMES, out.split(sizes))}


def param_grads_aug(leaves: dict, fwd: FwdOut, tfwd: FwdOut, rows: dict, rows_t: dict,
                    t_rows: dict) -> dict:
    """The parameter gradients of #10 (``csrc/param_grads.cu``, its
    augmented instantiation; the ``dW_a + dW_t`` sums of JAX ``bwd_kernel``
    ``train2_ef.py:1568-1607``): every leaf's gradient per layer, summed
    over the batch, ``{name: (depth, r, c)}``. CPU tensors take the plain
    version."""
    if fwd.bh.device.type == "cpu":
        return param_grads_aug_plain(leaves, fwd, tfwd, rows, rows_t, t_rows)
    _require_cuda("param_grads_aug", fwd.bh)
    out = _launch_param_grads_aug(leaves, fwd, tfwd, rows, rows_t, t_rows)
    param_grads_aug.launches += 1
    return out


param_grads_aug.launches = 0


def resid_aug_bwd(leaves: dict, fwd: FwdOut, tfwd: FwdOut, upd: Sequence[float], dh_fin,
                  dth_fin, *, leaves_t: Optional[dict] = None):
    """#10, the augmented pullback with every leaf's gradient (JAX
    ``bwd_kernel`` ``train2_ef.py:1507``, pallas_call ``:1632``):
    :func:`resid_tbwd` for the tangent chain, :func:`resid_bwd_aug` for the
    primal chain and :func:`param_grads_aug` for the gradients. Returns
    ``(dh0, dx0, dth0, grads)`` as :func:`resid_aug_bwd_plain`."""
    zeros = torch.zeros_like(fwd.bx[0])
    dth0, _, _, add, rows_t, t_rows = resid_tbwd(leaves, fwd, tfwd, upd, dth_fin, zeros,
                                                 zeros, leaves_t=leaves_t)
    dh0, dx0, _, rows = resid_bwd_aug(leaves, fwd, upd, dh_fin, zeros, zeros, add,
                                      leaves_t=leaves_t)
    return dh0, dx0, dth0, param_grads_aug(leaves, fwd, tfwd, rows, rows_t, t_rows)


def shared_fwd(leaves: dict, h0, xs, upd: Sequence[float]) -> FwdOut:
    """#7, the shared-mode primal forward (JAX ``fwd_kernel``
    ``train2_ef.py:1030``, pallas_call ``:1069``): K1 (``resid_fwd``) from
    ``(h0, xs, v = 0)``, whose boundaries and residuals the backward keeps.
    Counted apart from K1's other callers."""
    out = resid_ef.resid_fwd(leaves, h0, xs, torch.zeros_like(xs), upd)
    if h0.is_cuda:
        shared_fwd.launches += 1
    return out


shared_fwd.launches = 0


def shared_bwd(leaves: dict, fwd: FwdOut, upd: Sequence[float], dh_fin, *,
               leaves_t: Optional[dict] = None):
    """#8, the force backward of the shared primal (JAX ``fbwd_kernel``
    ``train2_ef.py:1110``, pallas_call ``:1155``): K2 (``resid_bwd``), input
    cotangents only. Returns ``dx (3, B, N)``, so ``F = -dx``. Counted apart
    from K2's other callers."""
    zeros = torch.zeros_like(fwd.bx[0])
    _, dx, _ = resid_ef.resid_bwd(leaves, fwd, upd, dh_fin, zeros, zeros, leaves_t=leaves_t)
    if dh_fin.is_cuda:
        shared_bwd.launches += 1
    return dx


shared_bwd.launches = 0


# --------------------------------------------------------------------------
# The training entry.
# --------------------------------------------------------------------------


def head_grads(params: ModelParams, h_fin, th_fin, g_e):
    """The seeds and readout gradients of the training backward (JAX
    ``head`` ``train2_ef.py:1487-1504``): the gradient of ``S = sum_b
    g_e[b] e[b] - sum_b e_dot[b]`` with ``e`` the readout summed over atoms
    and outputs and ``e_dot`` its tangent along ``th_fin``. Returns
    ``((d_w_out0, d_b_out0, d_w_out1, d_b_out1), dh_fin, dth_fin)``."""
    with torch.enable_grad():
        w0, b0, w1, b1 = (t.detach().requires_grad_(True)
                          for t in (params.w_out0, params.b_out0, params.w_out1,
                                    params.b_out1))
        hf, thf = h_fin.detach().requires_grad_(True), th_fin.detach().requires_grad_(True)
        z = hf @ w0 + b0
        e = (_silu(z) @ w1 + b1).sum(dim=(-2, -1))
        e_dot = ((_dsilu(z) * (thf @ w0)) @ w1).sum(dim=(-2, -1))
        s = (g_e * e).sum() - e_dot.sum()
        *readout, dh, dth = torch.autograd.grad(s, (w0, b0, w1, b1, hf, thf))
    return tuple(readout), dh.contiguous(), dth.contiguous()


def make_ef_train2(
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    batch_tile: int = 8,
    aug_batch_tile: Optional[int] = None,
    matmul_dtype=None,
    precision=None,
    edge_matmul_dtype=None,
    edge_precision=None,
    resid_dtype=torch.float32,
    resid_lowp=None,
    spatial_mode: Optional[str] = None,
    pad_atoms: bool = False,
    chunk: Optional[int] = 512,
    aug_mode: str = "resid",
    aug_chunk: Optional[int] = 128,
    shared_chunk: Optional[int] = 512,
    fused_primal: Optional[bool] = None,
    interpret: bool = False,
):
    """Build ``ef(params: ModelParams, h (B, N, F_in), x (B, N, 3)) -> (e
    (B,), f (B, N, 3))``, raw energies and forces whose first- and
    second-order gradients w.r.t. ``params``, ``h`` and ``x`` run on the
    kernels (JAX ``make_ef_train2``, ``train2_ef.py:118-2074``, in its
    ``aug_mode="shared"``).

    ``shared_chunk`` bounds the molecules whose tangent streams and rows are
    alive at once: the primal and the backward run per chunk of that many
    molecules (a ragged last chunk is fine: the kernels take any batch).

    Not ported yet, and raising when asked for: ``aug_mode`` ``"retrace"``
    and ``"resid"`` (sites #16-#19), ``"fused"`` and ``fused_primal=True``
    (sites #11-#12), the bf16 tier (``matmul_dtype``, ``edge_matmul_dtype``,
    ``resid_dtype`` other than f32, ``resid_lowp``) and the TPU-only MXU
    pooling ``spatial_mode``. Accepted with no counterpart: ``batch_tile``
    and ``aug_batch_tile`` (the kernels take one molecule per block),
    ``pad_atoms`` (the kernels take N as it comes, unpadded), ``chunk`` and
    ``aug_chunk`` (the other modes' chunks), ``precision`` and
    ``edge_precision`` (every product is f32 on the CUDA cores) and
    ``interpret`` (CPU tensors take the plain versions).
    """
    if aug_mode not in ("retrace", "resid", "shared", "fused"):
        raise ValueError(f"unknown aug_mode {aug_mode!r}")
    if aug_mode in ("retrace", "resid"):
        raise NotImplementedError(
            f"make_ef_train2: aug_mode={aug_mode!r} (sites #16-#19, train2_ef.py:330, :464, "
            ":668, :837) is not ported; use aug_mode='shared'")
    if aug_mode == "fused" or fused_primal:
        raise NotImplementedError(
            "make_ef_train2: the fused mode (sites #11-#12, train2_ef.py:1320, :1908) is not "
            "ported yet; use aug_mode='shared'")
    if (matmul_dtype is not None or edge_matmul_dtype is not None or resid_lowp is not None
            or resid_dtype not in (None, torch.float32)):
        raise NotImplementedError("make_ef_train2: the port's kernels are f32 only")
    if spatial_mode is not None:
        raise NotImplementedError("make_ef_train2: spatial_mode is a TPU-only probe")

    def prep(params, h):
        upd = [1.0 if u else 0.0 for u in per_layer(update, len(params.layers))]
        leaves = wide_stack(params, n_heads)
        leaves_t = transposed(leaves) if h.is_cuda else None
        return upd, leaves, leaves_t, embed(params, h.float()).contiguous()

    def chunks(B):
        step = shared_chunk or B
        return [slice(s, s + step) for s in range(0, B, step)]

    def primal(params, h, x, keep: bool):
        """``(e, f)`` and, with ``keep``, each chunk's ``FwdOut``."""
        upd, leaves, leaves_t, h0 = prep(params, h)
        es, fs, fwds = [], [], []
        for sl in chunks(h.shape[0]):
            xs = x[sl].permute(2, 0, 1).float().contiguous()
            fwd = shared_fwd(leaves, h0[sl].contiguous(), xs, upd)
            e, dh_fin = _readout_seed(params, fwd.h_fin, None)
            dx = shared_bwd(leaves, fwd, upd, dh_fin, leaves_t=leaves_t)
            es.append(e)
            fs.append(-dx.permute(1, 2, 0))
            if keep:
                fwds.append(fwd)
        return torch.cat(es), torch.cat(fs), fwds

    class EF(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, x, *flat):
            params = _unflat_params(flat, (len(flat) - 6) // resid_ef._LAYER_TENSORS)
            e, f, ctx.fwds = primal(params, h, x, keep=True)
            ctx.save_for_backward(h, *flat)
            return e, f

        @staticmethod
        @once_differentiable
        def backward(ctx, g_e, g_f):
            h, *flat = ctx.saved_tensors
            params = _unflat_params(flat, (len(flat) - 6) // resid_ef._LAYER_TENSORS)
            upd, leaves, leaves_t, _ = prep(params, h)
            B, N, _ = h.shape
            g_e = torch.zeros(B, device=h.device) if g_e is None else g_e
            g_f = torch.zeros(B, N, 3, device=h.device) if g_f is None else g_f
            dh0s, dxs, readout, layer = [], [], None, None
            for sl, fwd in zip(chunks(B), ctx.fwds):
                # F = -dE/dx: the minus lives in the head's -e_dot, so the seed is +g_f
                tx0 = g_f[sl].permute(2, 0, 1).float().contiguous()
                tfwd = resid_jvp(leaves, fwd, upd, tx0)
                ro, dh_fin, dth_fin = head_grads(params, fwd.h_fin, tfwd.h_fin, g_e[sl])
                dh0, dx0, _, g = resid_aug_bwd(leaves, fwd, tfwd, upd, dh_fin, dth_fin,
                                               leaves_t=leaves_t)
                dh0s.append(dh0)
                dxs.append(dx0.permute(1, 2, 0))
                readout = ro if readout is None else [a + b for a, b in zip(readout, ro)]
                layer = g if layer is None else {n: layer[n] + g[n] for n in LEAF_NAMES}
            ctx.fwds = None
            # embedding pullback, h0 = h @ w_embed + b_embed (plain torch, as in JAX)
            dh0 = torch.cat(dh0s)
            F = dh0.shape[-1]
            h2, dh2 = h.reshape(B * N, -1).float(), dh0.reshape(B * N, F)
            d_params = [h2.T @ dh2, dh2.sum(dim=0)]
            for l in range(len(upd)):
                lp = unsplit_layer_grads({n: layer[n][l] for n in LEAF_NAMES})
                d_params += [*lp.edge, *lp[1:]]
            d_params += list(readout)
            return ((dh2 @ params.w_embed.T).reshape(h.shape), torch.cat(dxs), *d_params)

    def ef(params: ModelParams, h, x):
        flat = flat_params(params)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (h, x, *flat)):
            return EF.apply(h, x, *flat)
        with torch.no_grad():
            return primal(params, h, x, keep=False)[:2]

    return ef
