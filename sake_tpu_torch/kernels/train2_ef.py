"""Second-order (force-loss) training: the gradient of a loss of ``(E, F)``
with ``F = -dE/dx``, on kernels.

Port of ``sake_tpu/kernels/train2_ef.py`` in its four modes. The training
gradient of ``(E, F)`` under cotangents
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

The resid mode (``make_ef_train2``'s default) and the retrace mode keep no
streams from the primal (K1 + K2 through ``resid_ef.resid_energy_forces``)
and recompute per chunk of the backward: resid mode runs #18
(:func:`aug_fwd`, ``csrc/aug_fwd.cu``: K1's and #9's bodies per layer in one
launch, writing both residual sets) and then #19 (:func:`aug_bwd`, the
three launches of #10 above); retrace mode runs #16 (:func:`retrace_fwd`, the
same source writing only the augmented boundary states) and then #17
(:func:`retrace_bwd`, ``csrc/retrace_bwd.cu``: per layer in reverse, one
launch re-forwards the layer for primal and tangent and runs #10's two
pullback bodies, then the augmented contraction sums that layer's leaf
gradients), so only one layer's residuals are ever alive.

Fused mode runs the same math in fewer launches: the primal is #11
(:func:`fused_primal`, ``csrc/fused_ef.cu``: K1's forward, the readout and
its seed, K2's pullback in one kernel that still writes the streams), and
the backward per chunk is #12 (:func:`fused_bwd`: ``csrc/fused_bwd.cu``
runs the tangent forward, the seed head and both cotangent chains in one
kernel, then the augmented contraction sums the leaves' and the readout's
gradients).

Fused mode also runs in resid_ef's bf16 tier (JAX's production setting,
``edge_matmul_dtype`` and ``resid_dtype`` bf16): #11 (``csrc/fused_ef16.cu``),
#12's block (``csrc/fused_bwd16.cu``) and the augmented contraction
(``sake_param_grads_aug16``) are the bodies' bf16 instantiations, the plain
versions take the tier from the streams (:func:`resid_ef.stream_tier`); the
other modes compute in f32 only.

:func:`make_ef_train2` wraps it as a ``torch.autograd.Function``. Each
kernel wrapper takes its plain version only for CPU tensors; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from sake_tpu_torch.kernels import build, resid_ef
from sake_tpu_torch.kernels.depthgrid_ef import layer_forward_wide
from sake_tpu_torch.kernels.functional import (
    ModelParams,
    _bf16_edge_tier,
    _silu,
    embed,
    flat_params,
    per_layer,
    readout,
)
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, layer_leaves, transposed, wide_stack
from sake_tpu_torch.kernels.resid_ef import (
    _SMEM_LIMIT,
    RESIDS,
    ROWS,
    FwdOut,
    _check_all,
    _check_cuda,
    _check_leaves,
    _check_tc_leaves,
    _dims,
    _dsilu,
    _layer,
    _layer_f32,
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
    stream_dtype,
    stream_tier,
    unsplit_layer_grads,
)

# --------------------------------------------------------------------------
# Plain versions: the layer functions of resid_ef over depth.
# --------------------------------------------------------------------------


def resid_jvp_plain(leaves: dict, fwd: FwdOut, upd: Sequence[float], tx0) -> FwdOut:
    """Plain version of :func:`resid_jvp`: :func:`layer_jvp_resid` over
    depth from the tangent seed ``(0, tx0 (3, B, N), 0)``, in the layout of
    ``FwdOut`` (tangent boundaries, final tangent state, tangent
    residuals). In the tier of ``fwd``'s streams (:func:`resid_ef.stream_tier`):
    in the bf16 tier the tangent streams are bf16 tensors but r and t, as the
    primal's (``stream_dtype``)."""
    bf16 = stream_tier(fwd)
    th = torch.zeros_like(fwd.bh[0])
    txp, tvp = _planes(tx0), _planes(torch.zeros_like(tx0))
    tbh, tbx, tbv, tres = [], [], [], {n: [] for n in RESIDS}
    for l, u in enumerate(upd):
        tbh.append(th)
        tbx.append(_unplanes(txp))
        tbv.append(_unplanes(tvp))
        th, txp, tvp, tr = layer_jvp_resid(
            layer_leaves(leaves, l), _layer_f32(fwd.resid, l), fwd.bh[l], _planes(fwd.bx[l]),
            _planes(fwd.bv[l]), th, txp, tvp, u, bf16=bf16,
        )
        for n in RESIDS:
            tres[n].append(tr[n])
    return FwdOut(torch.stack(tbh), torch.stack(tbx), torch.stack(tbv), th, _unplanes(txp),
                  _unplanes(tvp),
                  {n: torch.stack(v).to(stream_dtype(n, bf16)) for n, v in tres.items()})


def resid_tbwd_plain(leaves: dict, fwd: FwdOut, tfwd: FwdOut, upd: Sequence[float], dh, dx,
                     dv):
    """Plain version of :func:`resid_tbwd`: :func:`layer_bwd_resid_jvp` in
    reverse depth. The cotangent ``(dh (B, N, F), dx, dv (3, B, N))`` of the
    final state runs back through the layers with tangents along ``tfwd``.
    Returns ``(dh0, dx0, dv0, add, rows, t_rows)``: the cotangents of the
    initial state, ``add = (add_h (depth, B, N, F), add_x, add_v (depth, 3,
    B, N))`` the tangents of each layer's pullback (the Hessian terms), and
    the depth-stacked cotangent rows and their tangents. In the tier of
    ``fwd``'s streams."""
    dxp, dvp = _planes(dx), _planes(dv)
    depth = len(upd)
    per = [None] * depth
    bf16 = stream_tier(fwd)
    for l in reversed(range(depth)):
        (dh, dxp, dvp, rows), (hc, xc, vc, t_rows) = layer_bwd_resid_jvp(
            layer_leaves(leaves, l), _layer_f32(fwd.resid, l), fwd.bh[l], _planes(fwd.bx[l]),
            _planes(fwd.bv[l]), upd[l], dh, dxp, dvp, _layer_f32(tfwd.resid, l), tfwd.bh[l],
            _planes(tfwd.bx[l]), _planes(tfwd.bv[l]), bf16=bf16,
        )
        per[l] = (hc, _unplanes(xc), _unplanes(vc), rows, t_rows)
    add = tuple(torch.stack([p[k] for p in per]) for k in range(3))
    stack = lambda k: {n: torch.stack([p[k][n] for p in per]) for n in ROWS}
    return dh, _unplanes(dxp), _unplanes(dvp), add, stack(3), stack(4)


def resid_bwd_aug_plain(leaves: dict, fwd: FwdOut, upd: Sequence[float], dh, dx, dv,
                        add: tuple):
    """Plain version of :func:`resid_bwd_aug`: :func:`layer_bwd_resid` with
    its rows in reverse depth, ``add[k][l]`` added to the cotangents leaving
    layer ``l``. Returns ``(dh0, dx0, dv0, rows)``. In the tier of ``fwd``'s
    streams."""
    dxp, dvp = _planes(dx), _planes(dv)
    add_h, add_x, add_v = add
    depth = len(upd)
    rows = [None] * depth
    bf16 = stream_tier(fwd)
    for l in reversed(range(depth)):
        dh, dxp, dvp, rows[l] = layer_bwd_resid(
            layer_leaves(leaves, l), _layer_f32(fwd.resid, l), fwd.bh[l], _planes(fwd.bx[l]),
            _planes(fwd.bv[l]), upd[l], dh, dxp, dvp, want_param_grads="rows", bf16=bf16,
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
    (:func:`layer_param_grads_tangent`). ``{name: (depth, r, c)}``. In the
    tier of ``fwd``'s streams."""
    out = {n: [] for n in LEAF_NAMES}
    bf16 = stream_tier(fwd)
    for l in range(fwd.bh.shape[0]):
        p, res = layer_leaves(leaves, l), _layer_f32(fwd.resid, l)
        g = layer_param_grads(p, res, fwd.bh[l], _layer(rows, l), bf16=bf16)
        tg = layer_param_grads_tangent(p, res, fwd.bh[l], _layer(rows_t, l),
                                       _layer_f32(tfwd.resid, l), tfwd.bh[l], _layer(t_rows, l),
                                       bf16=bf16)
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


def _jvp_stack(layer_fn, leaves: dict, h0, xs, upd: Sequence[float], tx0):
    """``torch.func.jvp`` of ``layer_fn(p, h, xp, vp, u)`` over depth from
    the primal ``(h0, xs, v = 0)`` and the tangent seed ``(0, tx0, 0)``.
    Returns the primal and tangent ``FwdOut``s; with a ``layer_fn`` that
    also returns residuals (:func:`resid_ef.layer_fwd_resid`) they carry the
    residuals and their tangents, else ``resid`` is None."""
    zeros = torch.zeros_like(xs)
    state = (h0, _planes(xs), _planes(zeros))
    tstate = (torch.zeros_like(h0), _planes(tx0), _planes(zeros))
    bnd, tbnd = ([], [], []), ([], [], [])
    res, tres = [], []
    for l, u in enumerate(upd):
        p = layer_leaves(leaves, l)
        for out, st in ((bnd, state), (tbnd, tstate)):
            out[0].append(st[0])
            out[1].append(_unplanes(st[1]))
            out[2].append(_unplanes(st[2]))
        o, to = torch.func.jvp(lambda h, xp, vp: layer_fn(p, h, xp, vp, u), state, tstate)
        state, tstate = o[:3], to[:3]
        if len(o) > 3:
            res.append(o[3])
            tres.append(to[3])

    def out(b, st, rs):
        resid = {n: torch.stack([r[n] for r in rs]) for n in RESIDS} if rs else None
        return FwdOut(*(torch.stack(s) for s in b), st[0], _unplanes(st[1]), _unplanes(st[2]),
                      resid)

    return out(bnd, state, res), out(tbnd, tstate, tres)


def aug_fwd_plain(leaves: dict, h0, xs, upd: Sequence[float], tx0):
    """Plain version of :func:`aug_fwd`: ``torch.func.jvp`` of
    :func:`resid_ef.layer_fwd_resid` over depth. Returns ``(fwd, tfwd)``, the
    primal and tangent boundaries, final states and residuals."""
    return _jvp_stack(lambda p, h, xp, vp, u: resid_ef.layer_fwd_resid(p, h, xp, vp, u),
                      leaves, h0, xs, upd, tx0)


def retrace_fwd_plain(leaves: dict, h0, xs, upd: Sequence[float], tx0):
    """Plain version of :func:`retrace_fwd`: ``torch.func.jvp`` of
    :func:`depthgrid_ef.layer_forward_wide` over depth. Returns ``(fwd,
    tfwd)`` as :func:`aug_fwd_plain`, without residuals."""
    return _jvp_stack(layer_forward_wide, leaves, h0, xs, upd, tx0)


def retrace_bwd_plain(leaves: dict, fwd: FwdOut, tfwd: FwdOut, upd: Sequence[float], dh_fin,
                      dth_fin):
    """Plain version of :func:`retrace_bwd` (JAX ``bwd_kernel``
    ``train2_ef.py:379-456``): per layer in reverse, ``torch.func.vjp`` of
    ``torch.func.jvp`` of :func:`depthgrid_ef.layer_forward_wide` from the
    layer's primal and tangent boundaries, the leaves among its inputs, pulls
    the cotangents of the augmented state ``(h, x, v, th, tx, tv)`` back and
    gives the layer's leaf gradients. Returns ``(dh0, dx0, dth0, grads)`` as
    :func:`resid_aug_bwd_plain`."""
    zeros = _planes(torch.zeros_like(fwd.bx[0]))
    cot = (dh_fin, zeros, zeros, dth_fin, zeros, zeros)
    grads = [None] * len(upd)
    for l in reversed(range(len(upd))):
        u = upd[l]

        def aug(p, h, xp, vp, th, txp, tvp):
            o, to = torch.func.jvp(lambda a, b, c: layer_forward_wide(p, a, b, c, u),
                                   (h, xp, vp), (th, txp, tvp))
            return (*o, *to)

        _, vjp = torch.func.vjp(aug, layer_leaves(leaves, l), fwd.bh[l], _planes(fwd.bx[l]),
                                _planes(fwd.bv[l]), tfwd.bh[l], _planes(tfwd.bx[l]),
                                _planes(tfwd.bv[l]))
        grads[l], *cot = vjp(cot)
        cot = tuple(cot)
    return (cot[0], _unplanes(cot[1]), cot[3],
            {n: torch.stack([g[n] for g in grads]) for n in LEAF_NAMES})


# --------------------------------------------------------------------------
# Kernel wrappers. Each ``_launch_*`` checks, allocates and launches; the
# public function picks the plain version for CPU tensors and counts its
# launches.
# --------------------------------------------------------------------------


def _check_bnd(name, fwd: FwdOut, dims, dev):
    B, N, F, H, R, K, C, depth = dims
    _check_cuda(f"{name}.bh", fwd.bh, (depth, B, N, F), dev)
    _check_cuda(f"{name}.bx", fwd.bx, (depth, 3, B, N), dev)
    _check_cuda(f"{name}.bv", fwd.bv, (depth, 3, B, N), dev)


def _check_fwd(name, fwd: FwdOut, dims, leaves, dev, tier: bool = False):
    """``fwd``'s boundaries and streams; ``tier``: the kernel also takes the
    bf16 tier's streams (``stream_dtype``), else they raise."""
    _check_bnd(name, fwd, dims, dev)
    if stream_tier(fwd) and not tier:
        raise NotImplementedError(
            f"{name}: this kernel has no bf16 tier; make_ef_train2 runs the tier in "
            "aug_mode='fused' only (#11, #12's block and its contraction)")
    resid_ef._check_resid(fwd.resid, dims, leaves, dev, stream_tier(fwd))


def _common(name, leaves, fwd, upd=None, smem_fn=None, tier: bool = False):
    """Checks every kernel here makes; returns ``(lib, dims, dev, upd)``, the
    update gates as the kernels read them (when given). ``tier``: as
    :func:`_check_fwd`'s."""
    dims = _dims(leaves, fwd.bh[0])
    B, N, F, H, R, K, C, depth = dims
    dev = fwd.bh.device
    _check_leaves(leaves, dims, dev)
    _check_fwd("fwd", fwd, dims, leaves, dev, tier)
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


def _launch_param_grads_aug(leaves, fwd, tfwd, rows, rows_t, t_rows, ro_part=None,
                            ro_shapes=None):
    """Every leaf's gradient per layer; with ``ro_part (B, len)``, per-molecule
    partials of tensors of ``ro_shapes``, also their sums over the batch
    (else None). In the tier of ``fwd``'s streams: the bf16 tier's
    contraction (``sake_param_grads_aug16``) on the bf16 primal and tangent
    streams, the four edge leaves' terms with both operands rounded."""
    lib, dims, dev, _ = _common("param_grads_aug", leaves, fwd, tier=True)
    B, N, F, H, R, K, C, depth = dims
    bf16 = stream_tier(fwd)
    _check_fwd("tfwd", tfwd, dims, leaves, dev, tier=True)
    if stream_tier(tfwd) != bf16:
        raise ValueError("param_grads_aug: the primal and tangent streams of one tier")
    for name, rw in (("rows", rows), ("rows_t", rows_t), ("t_rows", t_rows)):
        _check_all(name, rw, _row_shapes(dims, leaves), dev)
    shapes = _leaf_shapes(F, H, R, K, C)
    n_chunks, partial, out, sizes = resid_ef._grad_scratch(dims, dev)
    ro_sizes = [math.prod(s) for s in ro_shapes or ()]
    ro_out = None
    if ro_part is not None:
        _check_cuda("ro_part", ro_part, (B, sum(ro_sizes)), dev)
        ro_out = torch.empty(sum(ro_sizes), device=dev)
    err = (lib.sake_param_grads_aug16 if bf16 else lib.sake_param_grads_aug)(
        fwd.bh.data_ptr(), tfwd.bh.data_ptr(), _ptrs([leaves[n] for n in LEAF_NAMES]),
        _strides(leaves), _ptrs([fwd.resid[n] for n in RESIDS]),
        _ptrs([tfwd.resid[n] for n in RESIDS]), _ptrs([rows[n] for n in ROWS]),
        _ptrs([rows_t[n] for n in ROWS]), _ptrs([t_rows[n] for n in ROWS]),
        partial.data_ptr(), out.data_ptr(), resid_ef._ptr(ro_part), resid_ef._ptr(ro_out),
        sum(ro_sizes), n_chunks, *dims, resid_ef._stream(dev),
    )
    build.check(lib, err, "param_grads_aug (bf16)" if bf16 else "param_grads_aug")
    grads = {n: a.view(depth, *shapes[n]) for n, a in zip(LEAF_NAMES, out.split(sizes))}
    if ro_out is None:
        return grads, None
    return grads, tuple(a.view(s) for a, s in zip(ro_out.split(ro_sizes), ro_shapes))


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
    out = _launch_param_grads_aug(leaves, fwd, tfwd, rows, rows_t, t_rows)[0]
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


# --------------------------------------------------------------------------
# Resid and retrace modes: #18 and #16 (csrc/aug_fwd.cu), #19 (#10's
# launches) and #17 (csrc/retrace_bwd.cu).
# --------------------------------------------------------------------------


def _layer_resids(dims, leaves) -> dict:
    """One layer's residual shapes ``{name: (B, N*N | N, ch)}``: the per-molecule
    scratch of the kernels that keep only the running layer's residuals."""
    return {n: s[1:] for n, s in _resid_shapes(dims, leaves).items()}


def _launch_aug_fwd(leaves, h0, xs, upd, tx0, stream: bool):
    name = "aug_fwd" if stream else "retrace_fwd"
    _require_cuda(name, h0)
    dims = _dims(leaves, h0)
    B, N, F, H, R, K, C, depth = dims
    dev = h0.device
    _check_leaves(leaves, dims, dev)
    _check_cuda("h0", h0, (B, N, F), dev)
    _check_cuda("xs", xs, (3, B, N), dev)
    _check_cuda("tx0", tx0, (3, B, N), dev)
    if F != H or len(upd) != depth:
        raise ValueError(f"{name}: needs hidden width == feature width and one gate per layer")
    lib = build.load()
    if lib.sake_aug_fwd_smem_bytes(*dims) > _SMEM_LIMIT:
        raise ValueError(f"{name}: N={N} at these widths exceeds one block's shared memory")
    upd_t = torch.tensor(list(upd), dtype=torch.float32, device=dev)
    empty = lambda *s: torch.empty(s, device=dev, dtype=torch.float32)
    shapes = _resid_shapes(dims, leaves) if stream else _layer_resids(dims, leaves)
    res, tres = ({n: empty(*s) for n, s in shapes.items()} for _ in range(2))
    fwd, tfwd = (FwdOut(empty(depth, B, N, F), empty(depth, 3, B, N), empty(depth, 3, B, N),
                        empty(B, N, F), empty(3, B, N), empty(3, B, N), r)
                 for r in (res, tres))
    err = (lib.sake_aug_fwd if stream else lib.sake_retrace_fwd)(
        h0.data_ptr(), xs.data_ptr(), tx0.data_ptr(), upd_t.data_ptr(),
        _ptrs([leaves[n] for n in LEAF_NAMES]), _strides(leaves),
        *(t.data_ptr() for f in (fwd, tfwd) for t in f[:6]),
        _ptrs([res[n] for n in RESIDS]), _ptrs([tres[n] for n in RESIDS]), *dims,
        resid_ef._stream(dev),
    )
    build.check(lib, err, name)
    if not stream:  # the residuals of the last layer were scratch
        fwd, tfwd = fwd._replace(resid=None), tfwd._replace(resid=None)
    return fwd, tfwd


def aug_fwd(leaves: dict, h0, xs, upd: Sequence[float], tx0):
    """#18, the resid-mode augmented forward (``csrc/aug_fwd.cu``; JAX
    ``_aug_grad_resid._pipe``'s ``fwd_kernel`` ``train2_ef.py:584``,
    pallas_call ``:668``): ``jax.jvp`` of ``layer_fwd_resid`` over depth
    from ``(h0 (B, N, F), xs (3, B, N), v = 0)`` along ``(0, tx0, 0)``, in one
    launch. Returns ``(fwd, tfwd)``: the primal and tangent boundaries, final
    states and all 17 residuals of each, as :func:`aug_fwd_plain`, which CPU
    tensors take."""
    if h0.device.type == "cpu":
        return aug_fwd_plain(leaves, h0, xs, upd, tx0)
    out = _launch_aug_fwd(leaves, h0, xs, upd, tx0, True)
    aug_fwd.launches += 1
    return out


aug_fwd.launches = 0


def retrace_fwd(leaves: dict, h0, xs, upd: Sequence[float], tx0):
    """#16, the retrace-mode augmented forward (``csrc/aug_fwd.cu`` without
    residual streams; JAX ``_aug_grad``'s ``fwd_kernel`` ``train2_ef.py:270``,
    pallas_call ``:330``): #18's layers, each layer's residuals kept only in a
    per-molecule scratch for its tangent. Returns ``(fwd, tfwd)``: the 14
    boundary planes per layer and the final states (``resid`` None), as
    :func:`retrace_fwd_plain`, which CPU tensors take."""
    if h0.device.type == "cpu":
        return retrace_fwd_plain(leaves, h0, xs, upd, tx0)
    out = _launch_aug_fwd(leaves, h0, xs, upd, tx0, False)
    retrace_fwd.launches += 1
    return out


retrace_fwd.launches = 0


def aug_bwd(leaves: dict, fwd: FwdOut, tfwd: FwdOut, upd: Sequence[float], dh_fin, dth_fin, *,
            leaves_t: Optional[dict] = None):
    """#19, the resid-mode augmented backward (JAX ``_pipe``'s ``bwd_kernel``
    ``train2_ef.py:723``, pallas_call ``:837``): #10's mathematics (JAX
    ``:1506`` says so), so #10's launches (:func:`resid_aug_bwd`) on #18's
    streams. Counted apart from #10's other callers. Returns ``(dh0, dx0,
    dth0, grads)`` as :func:`resid_aug_bwd_plain`, which CPU tensors take."""
    out = resid_aug_bwd(leaves, fwd, tfwd, upd, dh_fin, dth_fin, leaves_t=leaves_t)
    if dh_fin.is_cuda:
        aug_bwd.launches += 1
    return out


aug_bwd.launches = 0


def _launch_retrace_bwd(leaves, fwd, tfwd, upd, dh_fin, dth_fin, leaves_t):
    _require_cuda("retrace_bwd", dh_fin)
    dims = _dims(leaves, fwd.bh[0])
    B, N, F, H, R, K, C, depth = dims
    dev = dh_fin.device
    _check_leaves(leaves, dims, dev)
    _check_bnd("fwd", fwd, dims, dev)
    _check_bnd("tfwd", tfwd, dims, dev)
    _check_cuda("dh_fin", dh_fin, (B, N, F), dev)
    _check_cuda("dth_fin", dth_fin, (B, N, F), dev)
    if F != H or len(upd) != depth:
        raise ValueError("retrace_bwd: needs hidden width == feature width and one gate per layer")
    lib = build.load()
    if lib.sake_retrace_bwd_smem_bytes(*dims) > _SMEM_LIMIT:
        raise ValueError(f"retrace_bwd: N={N} at these widths exceeds one block's shared memory")
    if leaves_t is None:
        leaves_t = transposed(leaves)
    for leaf, shape in _leaf_shapes(F, H, R, K, C).items():
        _check_cuda(f"{leaf}.T", leaves_t[leaf], (depth, *shape[::-1]), dev)
    upd_t = torch.tensor(list(upd), dtype=torch.float32, device=dev)
    empty = lambda *s: torch.empty(s, device=dev, dtype=torch.float32)
    # one layer's residuals and rows: only the running layer's are alive
    res, tres = ({n: empty(*s) for n, s in _layer_resids(dims, leaves).items()}
                 for _ in range(2))
    rows, rows_t, t_rows = ({n: empty(*s[1:]) for n, s in _row_shapes(dims, leaves).items()}
                            for _ in range(3))
    scratch = empty(B, 2 * N * (H * K + C))  # per block: d_hatt, d_pool_sq with tangents
    # the chains' cotangents, carried from layer to layer in place
    zeros = lambda: torch.zeros(3, B, N, device=dev)
    cp = (dh_fin.clone(), zeros(), zeros())
    ct = (dth_fin.clone(), zeros(), zeros())
    one = lambda d: {n: a[None] for n, a in d.items()}
    per = [None] * depth
    for l in reversed(range(depth)):
        err = lib.sake_retrace_bwd(
            l, *(t.data_ptr() for t in (fwd.bh, fwd.bx, fwd.bv, tfwd.bh, tfwd.bx, tfwd.bv)),
            upd_t.data_ptr(), _ptrs([leaves[n] for n in LEAF_NAMES]),
            _ptrs([leaves_t[n] for n in LEAF_NAMES]), _strides(leaves),
            _ptrs([res[n] for n in RESIDS]), _ptrs([tres[n] for n in RESIDS]),
            *(_ptrs([r[n] for n in ROWS]) for r in (rows, rows_t, t_rows)), scratch.data_ptr(),
            *(t.data_ptr() for t in (*cp, *ct)), *dims, resid_ef._stream(dev),
        )
        build.check(lib, err, "retrace_bwd")
        retrace_bwd.launches += 1
        # layer l's leaf gradients, while its residuals and rows are alive
        sl = slice(l, l + 1)
        f1, t1 = (FwdOut(f.bh[sl], f.bx[sl], f.bv[sl], None, None, None, one(r))
                  for f, r in ((fwd, res), (tfwd, tres)))
        per[l] = _launch_param_grads_aug({n: a[sl] for n, a in leaves.items()}, f1, t1,
                                         one(rows), one(rows_t), one(t_rows))[0]
    return cp[0], cp[1], ct[0], {n: torch.cat([g[n] for g in per]) for n in LEAF_NAMES}


def retrace_bwd(leaves: dict, fwd: FwdOut, tfwd: FwdOut, upd: Sequence[float], dh_fin, dth_fin,
                *, leaves_t: Optional[dict] = None):
    """#17, the retrace-mode augmented backward (``csrc/retrace_bwd.cu``; JAX
    ``_aug_grad``'s ``bwd_kernel`` ``train2_ef.py:379``, pallas_call
    ``:464``): per layer in reverse, one launch re-forwards the layer for the
    primal and the tangent from #16's boundaries ``fwd``, ``tfwd`` into a
    one-layer scratch and runs #10's two pullback bodies on it; then the
    augmented contraction (``csrc/param_grads.cu``) of that layer's rows.
    Returns ``(dh0, dx0, dth0, grads)`` as :func:`retrace_bwd_plain`, which
    CPU tensors take."""
    if dh_fin.device.type == "cpu":
        return retrace_bwd_plain(leaves, fwd, tfwd, upd, dh_fin, dth_fin)
    return _launch_retrace_bwd(leaves, fwd, tfwd, upd, dh_fin, dth_fin, leaves_t)


retrace_bwd.launches = 0


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


# --------------------------------------------------------------------------
# Fused mode: #11 (csrc/fused_ef.cu) and #12 (csrc/fused_bwd.cu, then the
# augmented contraction of csrc/param_grads.cu).
# --------------------------------------------------------------------------


def _readout_leaves(params: ModelParams, dev):
    """The readout as the fused kernels read it: ``(w0 (F, F0), b0, w1 (F0,
    O), b1, w0^T)``, with ``F0`` and ``O``."""
    w0, b0, w1, b1 = (t.detach().float().contiguous()
                      for t in (params.w_out0, params.b_out0, params.w_out1, params.b_out1))
    for name, t in (("w_out0", w0), ("b_out0", b0), ("w_out1", w1), ("b_out1", b1)):
        _check_cuda(name, t, t.shape, dev)
    return (w0, b0, w1, b1, w0.T.contiguous()), w0.shape[1], w1.shape[1]


def _readout_shapes(F, F0, O):
    return (F, F0), (F0,), (F0, O), (O,)


def _fused_args(name, params, leaves, h0, upd, leaves_t, smem_fn):
    """Checks the fused kernels make; returns ``(lib, dims, dev, upd, ro, F0,
    O, leaves_t)``, ``ro`` the readout of :func:`_readout_leaves`."""
    _require_cuda(name, h0)
    dims = _dims(leaves, h0)
    B, N, F, H, R, K, C, depth = dims
    dev = h0.device
    _check_leaves(leaves, dims, dev)
    if F != H or len(upd) != depth:
        raise ValueError(f"{name}: needs hidden width == feature width and one gate per layer")
    ro, F0, O = _readout_leaves(params, dev)
    lib = build.load()
    if getattr(lib, smem_fn)(*dims, F0) > _SMEM_LIMIT:
        raise ValueError(f"{name}: N={N} at these widths exceeds one block's shared memory")
    if leaves_t is None:
        leaves_t = transposed(leaves)
    for leaf, shape in _leaf_shapes(F, H, R, K, C).items():
        _check_cuda(f"{leaf}.T", leaves_t[leaf], (depth, *shape[::-1]), dev)
    upd_t = torch.tensor(list(upd), dtype=torch.float32, device=dev)
    return lib, dims, dev, upd_t, ro, F0, O, leaves_t


def fused_primal_plain(params: ModelParams, leaves: dict, h0, xs, upd: Sequence[float],
                       mask=None, bf16=False):
    """Plain version of :func:`fused_primal` (and of one_ef's kernel): K1's
    plain stack from ``(h0, xs, v = 0)``, the readout (summed over the
    diagonal atoms of ``mask (B, N, N)`` when given) and its seed, K2's plain
    stack. Returns ``(fwd, e (B,), dx (3, B, N))``. ``bf16``: resid_ef's bf16
    tier (K1's and K2's plain bf16 stacks, the streams bf16 but r and t; the
    readout stays f32)."""
    zeros = torch.zeros_like(xs)
    m4 = mask[..., None] if mask is not None else None
    fwd = resid_ef.resid_fwd_plain(leaves, h0, xs, zeros, upd, mask=m4, bf16=bf16)
    node_mask = torch.diagonal(mask, dim1=-2, dim2=-1) if mask is not None else None
    e, dh_fin = _readout_seed(params, fwd.h_fin, node_mask)
    return fwd, e, resid_ef.resid_bwd_plain(leaves, fwd, upd, dh_fin, zeros, zeros, mask=m4)[1]


def _launch_fused_primal(params, leaves, h0, xs, upd, leaves_t, bf16=False):
    lib, dims, dev, upd_t, ro, F0, O, leaves_t = _fused_args(
        "fused_primal", params, leaves, h0, upd, leaves_t,
        "sake_fused_primal16_smem_bytes" if bf16 else "sake_fused_ef_smem_bytes")
    if bf16:  # the tier's kernel reads the four edge weights rounded
        leaves, leaves_t = resid_ef.edge_bf16_leaves(leaves), resid_ef.edge_bf16_leaves(leaves_t)
    _check_tc_leaves("fused_primal", leaves, leaves_t)
    B, N, F, H, R, K, C, depth = dims
    _check_cuda("h0", h0, (B, N, F), dev)
    _check_cuda("xs", xs, (3, B, N), dev)
    empty = lambda *s, dtype=torch.float32: torch.empty(s, device=dev, dtype=dtype)
    fwd = FwdOut(
        empty(depth, B, N, F), empty(depth, 3, B, N), empty(depth, 3, B, N),
        empty(B, N, F), empty(3, B, N), empty(3, B, N),
        {n: empty(*s, dtype=stream_dtype(n, bf16))
         for n, s in _resid_shapes(dims, leaves).items()},
    )
    e, dx = empty(B), empty(3, B, N)
    args = (
        h0.data_ptr(), xs.data_ptr(), upd_t.data_ptr(), _ptrs([leaves[n] for n in LEAF_NAMES]),
        _ptrs([leaves_t[n] for n in LEAF_NAMES]), _strides(leaves), *(t.data_ptr() for t in ro),
        fwd.bh.data_ptr(), fwd.bx.data_ptr(), fwd.bv.data_ptr(),
        _ptrs([fwd.resid[n] for n in RESIDS]), fwd.h_fin.data_ptr(), fwd.x_fin.data_ptr(),
        fwd.v_fin.data_ptr(), e.data_ptr(), dx.data_ptr(),
    )
    if bf16:  # the forward body's f32 pooled vectors, one layer at a time
        pool16 = empty(3, B, N, C)
        err = lib.sake_fused_primal16(*args, pool16.data_ptr(), *dims, F0, O,
                                      resid_ef._stream(dev))
    else:
        err = lib.sake_fused_primal(*args, *dims, F0, O, resid_ef._stream(dev))
    build.check(lib, err, "fused_primal (bf16)" if bf16 else "fused_primal")
    return fwd, e, dx


def fused_primal(params: ModelParams, leaves: dict, h0, xs, upd: Sequence[float], *,
                 leaves_t: Optional[dict] = None, bf16: bool = False):
    """#11, the fused primal (``csrc/fused_ef.cu``; JAX ``_fused_primal``'s
    kernel ``train2_ef.py:1239``, pallas_call ``:1320``): in one launch, K1's
    forward from ``(h0 (B, N, F), xs (3, B, N), v = 0)`` writing the boundary
    states and residuals (``FwdOut``, as :func:`shared_fwd`), the readout's
    energy and seed in f32, and K2's pullback. Returns ``(fwd, e (B,), dx (3,
    B, N))``, ``F = -dx``. ``bf16``: resid_ef's bf16 tier (``csrc/
    fused_ef16.cu``: K1's and K2's bodies in their tier, the streams bf16 but r
    and t; the readout f32). CPU tensors take the plain version."""
    if h0.device.type == "cpu":
        return fused_primal_plain(params, leaves, h0, xs, upd, bf16=bf16)
    out = _launch_fused_primal(params, leaves, h0, xs, upd, leaves_t, bf16)
    fused_primal.launches += 1
    fused_primal.tiers[TIERS[bf16]] += 1
    return out


# #11's and #12's launches by tier, beside their totals
TIERS = ("f32", "bf16")
fused_primal.launches = 0
fused_primal.tiers = dict.fromkeys(TIERS, 0)
_fused_primal = fused_primal  # make_ef_train2's argument of that name shadows it


def _head_partials_plain(params: ModelParams, h_fin, th_fin, g_e):
    """Per molecule, the readout gradients of :func:`head_grads` (``(B, F*F0
    + F0 + F0*O + O)``, in the order of :func:`_readout_shapes`): with ``z =
    h w0 + b0``, ``tz = th w0``, ``gz = w1s (g_e silu'(z) - silu''(z) tz)`` and
    ``gtz = -w1s silu'(z)`` (``w1s`` the row sums of ``w1``), ``d_w0 = h^T gz +
    th^T gtz``, ``d_b0 = sum gz``, ``d_w1 = sum (g_e silu(z) - silu'(z) tz)``
    for every output and ``d_b1 = g_e N``."""
    w0, b0, w1 = params.w_out0, params.b_out0, params.w_out1
    B, N, _ = h_fin.shape
    z, tz = h_fin @ w0 + b0, th_fin @ w0
    s = torch.sigmoid(z)
    d1 = s * (1.0 + z * (1.0 - s))
    d2 = s * (1.0 - s) * (2.0 + z * (1.0 - 2.0 * s))
    ge = g_e[:, None, None]
    w1s = w1.sum(dim=-1)
    gz, gtz = w1s * (ge * d1 - d2 * tz), -w1s * d1
    d_w0 = h_fin.transpose(1, 2) @ gz + th_fin.transpose(1, 2) @ gtz
    d_w1 = (ge * z * s - d1 * tz).sum(dim=1)[..., None].expand(B, *w1.shape)
    d_b1 = (g_e * N)[:, None].expand(B, w1.shape[1])
    return torch.cat([d_w0.reshape(B, -1), gz.sum(dim=1), d_w1.reshape(B, -1), d_b1], dim=1)


def fused_bwd_block_plain(params: ModelParams, leaves: dict, fwd: FwdOut,
                          upd: Sequence[float], tx0, g_e):
    """Plain version of :func:`fused_bwd_block`: :func:`resid_jvp_plain`, the
    seed head (:func:`head_grads`, and its per-molecule readout gradients),
    :func:`resid_tbwd_plain` and :func:`resid_bwd_aug_plain`."""
    tfwd = resid_jvp_plain(leaves, fwd, upd, tx0)
    _, dh_fin, dth_fin = head_grads(params, fwd.h_fin, tfwd.h_fin, g_e)
    zeros = torch.zeros_like(tx0)
    _, _, _, add, rows_t, t_rows = resid_tbwd_plain(leaves, fwd, tfwd, upd, dth_fin, zeros,
                                                    zeros)
    dh0, dx0, _, rows = resid_bwd_aug_plain(leaves, fwd, upd, dh_fin, zeros, zeros, add)
    return (dh0, dx0, tfwd, rows, rows_t, t_rows,
            _head_partials_plain(params, fwd.h_fin, tfwd.h_fin, g_e))


def _launch_fused_bwd_block(params, leaves, fwd, upd, tx0, g_e, leaves_t):
    bf16 = stream_tier(fwd)
    lib, dims, dev, upd_t, ro, F0, O, leaves_t = _fused_args(
        "fused_bwd_block", params, leaves, fwd.bh[0], upd, leaves_t,
        "sake_fused_bwd16_smem_bytes" if bf16 else "sake_fused_bwd_smem_bytes")
    if bf16:  # the tier's kernel reads the four edge weights rounded
        leaves, leaves_t = resid_ef.edge_bf16_leaves(leaves), resid_ef.edge_bf16_leaves(leaves_t)
    _check_tc_leaves("fused_bwd_block", leaves, leaves_t)
    B, N, F, H, R, K, C, depth = dims
    _check_fwd("fwd", fwd, dims, leaves, dev, tier=True)
    _check_cuda("h_fin", fwd.h_fin, (B, N, F), dev)
    _check_cuda("tx0", tx0, (3, B, N), dev)
    _check_cuda("g_e", g_e, (B,), dev)
    empty = lambda *s, dtype=torch.float32: torch.empty(s, device=dev, dtype=dtype)
    # the tangent forward's streams (in the tier of the primal's); its final
    # state stays in the kernel
    tfwd = FwdOut(empty(depth, B, N, F), empty(depth, 3, B, N), empty(depth, 3, B, N),
                  None, None, None,
                  {n: empty(*s, dtype=stream_dtype(n, bf16))
                   for n, s in _resid_shapes(dims, leaves).items()})
    rows, rows_t, t_rows = ({n: empty(*s) for n, s in _row_shapes(dims, leaves).items()}
                            for _ in range(3))
    scratch = empty(B, 2 * N * (H * K + C))  # per block: d_hatt, d_pool_sq with tangents
    dh0, dx0 = empty(B, N, F), empty(3, B, N)
    ro_part = empty(B, sum(math.prod(s) for s in _readout_shapes(F, F0, O)))
    args = (
        fwd.bh.data_ptr(), fwd.bx.data_ptr(), fwd.bv.data_ptr(), upd_t.data_ptr(),
        _ptrs([leaves[n] for n in LEAF_NAMES]), _ptrs([leaves_t[n] for n in LEAF_NAMES]),
        _strides(leaves), _ptrs([fwd.resid[n] for n in RESIDS]), fwd.h_fin.data_ptr(),
        tx0.data_ptr(), g_e.data_ptr(), *(t.data_ptr() for t in ro),
        tfwd.bh.data_ptr(), tfwd.bx.data_ptr(), tfwd.bv.data_ptr(),
        _ptrs([tfwd.resid[n] for n in RESIDS]), _ptrs([rows[n] for n in ROWS]),
        _ptrs([rows_t[n] for n in ROWS]), _ptrs([t_rows[n] for n in ROWS]), scratch.data_ptr(),
        dh0.data_ptr(), dx0.data_ptr(), ro_part.data_ptr(),
    )
    if bf16:  # the tangent forward's f32 pooled vectors, one layer of a molecule a block
        tpool16 = empty(3, B, N, C)
        err = lib.sake_fused_bwd16(*args, tpool16.data_ptr(), *dims, F0, O,
                                   resid_ef._stream(dev))
    else:
        err = lib.sake_fused_bwd(*args, *dims, F0, O, resid_ef._stream(dev))
    build.check(lib, err, "fused_bwd_block (bf16)" if bf16 else "fused_bwd_block")
    return dh0, dx0, tfwd, rows, rows_t, t_rows, ro_part


def fused_bwd_block(params: ModelParams, leaves: dict, fwd: FwdOut, upd: Sequence[float], tx0,
                    g_e, *, leaves_t: Optional[dict] = None):
    """The block kernel of #12 (``csrc/fused_bwd.cu``; JAX
    ``_fused_bwd_chunk``'s kernel ``train2_ef.py:1750``, pallas_call
    ``:1908``): per molecule the tangent forward from ``(0, tx0 (3, B, N),
    0)``, the seed head of ``S = g_e e - e_dot`` and, per layer in reverse,
    the tangent pullback then the primal chain with the Hessian terms.
    Returns ``(dh0, dx0, tfwd, rows, rows_t, t_rows, ro_part)``: the primal
    chain's cotangents, the tangent forward's streams (its final state is
    None on the card), both chains' rows and the tangent chain's row
    tangents, and the per-molecule readout gradients ``(B, F*F0 + F0 + F0*O
    + O)``. In the tier of ``fwd``'s streams: on the bf16 tier's streams
    (#11's with ``bf16``) the tier's kernel (``csrc/fused_bwd16.cu``), whose
    tangent streams are bf16 but r and t. CPU tensors take the plain
    version."""
    if tx0.device.type == "cpu":
        return fused_bwd_block_plain(params, leaves, fwd, upd, tx0, g_e)
    out = _launch_fused_bwd_block(params, leaves, fwd, upd, tx0, g_e, leaves_t)
    fused_bwd_block.launches += 1
    fused_bwd_block.tiers[TIERS[stream_tier(fwd)]] += 1
    return out


fused_bwd_block.launches = 0
fused_bwd_block.tiers = dict.fromkeys(TIERS, 0)


def fused_bwd_grads(params: ModelParams, leaves: dict, fwd: FwdOut, tfwd: FwdOut, rows: dict,
                    rows_t: dict, t_rows: dict, ro_part):
    """The contraction of #12 (``csrc/param_grads.cu``, augmented): every
    leaf's gradient per layer (``{name: (depth, r, c)}``, as
    :func:`param_grads_aug`) and the readout gradients ``(d_w_out0, d_b_out0,
    d_w_out1, d_b_out1)``, the sums of ``ro_part`` over the molecules in
    order. In the tier of ``fwd``'s streams (``sake_param_grads_aug16`` on the
    bf16 tier's). CPU tensors take the plain version."""
    shapes = _readout_shapes(params.w_out0.shape[0], *params.w_out1.shape)
    if fwd.bh.device.type == "cpu":
        ro = ro_part.double().sum(dim=0).float().split([math.prod(s) for s in shapes])
        return (param_grads_aug_plain(leaves, fwd, tfwd, rows, rows_t, t_rows),
                tuple(a.view(s) for a, s in zip(ro, shapes)))
    _require_cuda("fused_bwd_grads", fwd.bh)
    out = _launch_param_grads_aug(leaves, fwd, tfwd, rows, rows_t, t_rows, ro_part, shapes)
    fused_bwd_grads.launches += 1
    fused_bwd_grads.tiers[TIERS[stream_tier(fwd)]] += 1
    return out


fused_bwd_grads.launches = 0
fused_bwd_grads.tiers = dict.fromkeys(TIERS, 0)


def fused_bwd_plain(params: ModelParams, leaves: dict, fwd: FwdOut, upd: Sequence[float], tx0,
                    g_e):
    """Plain version of :func:`fused_bwd`: :func:`resid_jvp_plain`,
    :func:`head_grads`, :func:`resid_aug_bwd_plain`. Returns ``(dh0, dx0,
    readout, grads)``: the cotangents of the initial ``h`` and ``x``, the
    readout's four gradients and every leaf's gradient per layer."""
    tfwd = resid_jvp_plain(leaves, fwd, upd, tx0)
    ro, dh_fin, dth_fin = head_grads(params, fwd.h_fin, tfwd.h_fin, g_e)
    dh0, dx0, _, grads = resid_aug_bwd_plain(leaves, fwd, tfwd, upd, dh_fin, dth_fin)
    return dh0, dx0, ro, grads


def fused_bwd(params: ModelParams, leaves: dict, fwd: FwdOut, upd: Sequence[float], tx0, g_e, *,
              leaves_t: Optional[dict] = None):
    """#12, the fused training backward of one chunk: the gradient of ``S =
    sum_b g_e[b] e[b] - e_dot`` along ``x_dot = tx0 (3, B, N)`` from the
    primal's streams ``fwd`` (with ``h_fin``), as :func:`fused_bwd_block`
    then :func:`fused_bwd_grads`: two launches. Returns ``(dh0, dx0,
    readout, grads)`` as :func:`fused_bwd_plain`, which CPU tensors take."""
    if tx0.device.type == "cpu":
        return fused_bwd_plain(params, leaves, fwd, upd, tx0, g_e)
    dh0, dx0, tfwd, rows, rows_t, t_rows, ro_part = fused_bwd_block(
        params, leaves, fwd, upd, tx0, g_e, leaves_t=leaves_t)
    grads, ro = fused_bwd_grads(params, leaves, fwd, tfwd, rows, rows_t, t_rows, ro_part)
    return dh0, dx0, ro, grads


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
    kernels (JAX ``make_ef_train2``, ``train2_ef.py:118-2074``), in its four
    modes.

    ``aug_mode="resid"`` (the default) and ``"retrace"``: the primal is
    :func:`resid_ef.resid_energy_forces` (K1, the readout seed and K2 per
    ``chunk``), which keeps no streams; the ``torch.autograd.Function`` saves
    ``h``, ``x`` and the parameters (JAX ``:2057-2062``). The backward runs
    per chunk of ``aug_chunk`` molecules (a ragged last chunk is fine):
    ``"resid"`` #18 (:func:`aug_fwd`, the jvp of the residual-saving forward,
    streaming both residual sets), the torch head and #19 (:func:`aug_bwd`,
    #10's launches); ``"retrace"`` #16 (:func:`retrace_fwd`, boundaries
    only), the head and #17 (:func:`retrace_bwd`, which re-forwards each
    layer and keeps one layer's residuals alive).

    ``"shared"`` and ``"fused"``: the primal keeps its boundaries and
    residuals across the autograd boundary. ``"shared"``: the backward per
    chunk is #9 (:func:`resid_jvp`), the torch head and #10
    (:func:`resid_aug_bwd`); ``"fused"``: it is #12 (:func:`fused_bwd`).
    ``fused_primal`` (default ``aug_mode == "fused"``, the JAX rule
    ``:2027-2032``): the primal is #11 (:func:`fused_primal`) and not #7 + #8
    (:func:`shared_fwd`, :func:`shared_bwd`); either primal combines with
    either backward. With #11 the energy the loss sees is the f32 torch
    readout on ``h_fin``, as JAX reads it through XLA (``:1367-1377``).
    ``shared_chunk`` bounds the molecules whose tangent streams and rows are
    alive at once: the primal and the backward run per chunk of that many
    molecules.

    The bf16 tier, JAX's production setting (``edge_matmul_dtype`` and
    ``resid_dtype`` both bf16, ``resid_lowp`` None or ``resid_ef.RESID_LOWP``),
    runs in ``aug_mode="fused"``: every edge product of #11 and #12 rounds both
    operands to bf16 (f32 sums), the residual streams of the primal and of the
    tangent forward are bf16 but r and t (``resid_ef.stream_dtype``), and the
    contraction rounds both operands of each term of the four edge leaves;
    node products, boundary states, the readout and the energy the loss sees
    stay f32, as in JAX (``:1239-1385``, ``:1750-1901``). With ``fused_primal``
    False the tier raises, as in every other mode.

    Not ported yet, and raising when asked for: the bf16 tier in the
    ``"shared"``, ``"resid"`` and ``"retrace"`` modes (their kernels #7-#10 and
    #16-#19 have no bf16 instantiation yet), bf16 node products
    (``matmul_dtype``), any other combination of the tier's keywords, and the
    TPU-only MXU pooling ``spatial_mode``. Accepted with no counterpart:
    ``batch_tile`` and ``aug_batch_tile`` (the kernels take one molecule per
    block), ``pad_atoms`` (the kernels take N as it comes, unpadded),
    ``precision`` and ``edge_precision`` (f32 products are f32 to within
    3xTF32's rounding) and ``interpret`` (CPU tensors take the plain versions).
    ``fused_primal`` and ``shared_chunk`` are read only in the modes that keep
    the primal's streams.
    """
    if aug_mode not in ("retrace", "resid", "shared", "fused"):
        raise ValueError(f"unknown aug_mode {aug_mode!r}")
    bf16 = _bf16_edge_tier("make_ef_train2", matmul_dtype=matmul_dtype,
                           edge_matmul_dtype=edge_matmul_dtype, resid_dtype=resid_dtype,
                           resid_lowp=resid_lowp, lowp=resid_ef.RESID_LOWP)
    if bf16 and (aug_mode != "fused" or fused_primal is False):
        raise NotImplementedError(
            f"make_ef_train2: the bf16 tier (edge_matmul_dtype and resid_dtype bf16) runs in "
            f"aug_mode='fused' with the fused primal only; aug_mode={aug_mode!r}"
            f"{', fused_primal=False' if aug_mode == 'fused' else ''} is not ported in that "
            "tier yet (ROADMAP.md, Queue 2 B1)")
    if spatial_mode is not None:
        raise NotImplementedError("make_ef_train2: spatial_mode is a TPU-only probe")
    # shared and fused modes carry the primal's streams to the backward
    streams = aug_mode in ("shared", "fused")
    use_fused_primal = aug_mode == "fused" if fused_primal is None else fused_primal

    def prep(params, h):
        upd = [1.0 if u else 0.0 for u in per_layer(update, len(params.layers))]
        leaves = wide_stack(params, n_heads)
        leaves_t = transposed(leaves) if h.is_cuda else None
        return upd, leaves, leaves_t, embed(params, h.float()).contiguous()

    def chunks(B, step):
        step = step or B
        return [slice(s, s + step) for s in range(0, B, step)]

    def primal(params, h, x, keep: bool):
        """``(e, f)`` and, with ``keep``, each chunk's ``FwdOut``."""
        if not streams:
            e, f = resid_ef.resid_energy_forces(params, h, x, n_heads=n_heads, update=update,
                                                chunk=chunk)
            return e, f, []
        upd, leaves, leaves_t, h0 = prep(params, h)
        es, fs, fwds = [], [], []
        for sl in chunks(h.shape[0], shared_chunk):
            xs = x[sl].permute(2, 0, 1).float().contiguous()
            if use_fused_primal:
                fwd, _, dx = _fused_primal(params, leaves, h0[sl].contiguous(), xs, upd,
                                           leaves_t=leaves_t, bf16=bf16)
                e = readout(params, fwd.h_fin).sum(dim=(-2, -1))
            else:
                fwd = shared_fwd(leaves, h0[sl].contiguous(), xs, upd)
                e, dh_fin = _readout_seed(params, fwd.h_fin, None)
                dx = shared_bwd(leaves, fwd, upd, dh_fin, leaves_t=leaves_t)
            es.append(e)
            fs.append(-dx.permute(1, 2, 0))
            if keep:
                fwds.append(fwd)
        return torch.cat(es), torch.cat(fs), fwds

    def chunk_grads(params, leaves, leaves_t, upd, fwd, h0, xs, tx0, g_e):
        """One chunk's ``(dh0, dx0, readout, grads)``: from the primal's
        streams ``fwd`` (shared, fused) or from the chunk's inputs ``h0``,
        ``xs`` (resid, retrace)."""
        if aug_mode == "fused":
            return fused_bwd(params, leaves, fwd, upd, tx0, g_e.float().contiguous(),
                             leaves_t=leaves_t)
        if aug_mode == "shared":
            tfwd = resid_jvp(leaves, fwd, upd, tx0)
        else:
            fwd, tfwd = (aug_fwd if aug_mode == "resid" else retrace_fwd)(leaves, h0, xs, upd,
                                                                          tx0)
        ro, dh_fin, dth_fin = head_grads(params, fwd.h_fin, tfwd.h_fin, g_e)
        bwd = retrace_bwd if aug_mode == "retrace" else (
            aug_bwd if aug_mode == "resid" else resid_aug_bwd)
        dh0, dx0, _, g = bwd(leaves, fwd, tfwd, upd, dh_fin, dth_fin, leaves_t=leaves_t)
        return dh0, dx0, ro, g

    class EF(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, x, *flat):
            params = _unflat_params(flat, (len(flat) - 6) // resid_ef._LAYER_TENSORS)
            e, f, ctx.fwds = primal(params, h, x, keep=True)
            ctx.save_for_backward(h, x, *flat)
            return e, f

        @staticmethod
        @once_differentiable
        def backward(ctx, g_e, g_f):
            h, x, *flat = ctx.saved_tensors
            params = _unflat_params(flat, (len(flat) - 6) // resid_ef._LAYER_TENSORS)
            upd, leaves, leaves_t, h0 = prep(params, h)
            B, N, _ = h.shape
            g_e = torch.zeros(B, device=h.device) if g_e is None else g_e
            g_f = torch.zeros(B, N, 3, device=h.device) if g_f is None else g_f
            dh0s, dxs, ro_sum, layer = [], [], None, None
            sls = chunks(B, shared_chunk if streams else aug_chunk)
            for sl, fwd in zip(sls, ctx.fwds if streams else [None] * len(sls)):
                # F = -dE/dx: the minus lives in the head's -e_dot, so the seed is +g_f
                tx0 = g_f[sl].permute(2, 0, 1).float().contiguous()
                xs = x[sl].permute(2, 0, 1).float().contiguous()
                dh0, dx0, ro, g = chunk_grads(params, leaves, leaves_t, upd, fwd,
                                              h0[sl].contiguous(), xs, tx0, g_e[sl])
                dh0s.append(dh0)
                dxs.append(dx0.permute(1, 2, 0))
                ro_sum = ro if ro_sum is None else [a + b for a, b in zip(ro_sum, ro)]
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
            d_params += list(ro_sum)
            return ((dh2 @ params.w_embed.T).reshape(h.shape), torch.cat(dxs), *d_params)

    def ef(params: ModelParams, h, x):
        flat = flat_params(params)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (h, x, *flat)):
            return EF.apply(h, x, *flat)
        with torch.no_grad():
            return primal(params, h, x, keep=False)[:2]

    return ef
