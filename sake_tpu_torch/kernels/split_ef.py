"""The split edge pipeline: E + F with the O(N^2) middle of each layer in
small CUDA ops (#25-#28) and the node-level math in torch.

Port of ``sake_tpu/kernels/split_ef.py``. Two ops per layer:

- ``edge_att`` (#25 forward, #26 pullback): positions and the node-level
  halves ``a_j, a_i (B, N, R)``, ``o_j, o_i (B, N, H)`` -> edge features
  ``h_e (B, N, N, H)`` and semantic attention ``att (B, N, N, K)``;
- ``coeff_pool`` (#25, #26): positions, ``h_e`` and ``att`` -> the pooled
  planes ``(B, N, C) x 3`` and the sender-summed attended edges ``(B, N,
  H*K)``;

or one merged ``edge_pool`` op (#27 forward, #28 pullback) from the first
op's inputs to the second's outputs, ``h_e`` and ``att`` never leaving the
kernel. :func:`split_energy_forces` composes the first two,
:func:`merged_energy_forces` the third; both keep the JAX keywords.

- :func:`edge_att_body`, :func:`coeff_pool_body` and :func:`merged_body`
  are the JAX ``_edge_att_body`` (``:56-75``), ``_coeff_pool_body``
  (``:101-116``) and ``_merged_body`` (``:394-403``), line by line: the plain
  versions of the forward kernels. Their ``torch.func.vjp`` is the plain
  version of each pullback, as the JAX backward kernels take ``jax.vjp`` of
  the bodies.
- :func:`edge_att_fwd`, :func:`coeff_pool_fwd`, :func:`merged_fwd` and the
  pullbacks :func:`edge_att_bwd`, :func:`coeff_pool_bwd`,
  :func:`merged_bwd` (``csrc/split_fwd.cu``, ``csrc/split_bwd.cu``, body in
  ``csrc/split_edge.cuh``) take their plain versions only for CPU tensors;
  on a CUDA tensor they launch their kernel or raise. The weight cotangents
  come from the pullback's per-edge rows (``SPLIT_ROWS``) summed by the
  sparse contraction kernel (``csrc/sparse_contract.cu``), only when asked.
  A forward and a pullback each take one of two kernels by the shape and the
  direction (:func:`tensor_core_route`): at aspirin's widths the tensor-core
  one (``64 // N`` receiver rows as one 64-row tile, the x-mixing, and for a
  pullback its transpose, on ``wgmma``, the edge products on ``mma.sync``, all
  in 3xTF32), elsewhere the CUDA-core one; each launch counts in the wrapper's
  ``.launches`` and under its route in ``.routes``.

The hidden-major / head-minor outer product ``he_att[..., h*K + k] =
h_e[..., h] * att[..., k]`` is a broadcast here and an index in the
kernels, so the ops take no ``e_rep`` or ``e_tile`` (the JAX Mosaic
workaround, :func:`head_expansion_matrices`) and those two JAX cotangents
have no counterpart. The ops are first order, like the JAX ``custom_vjp``
(``:23-25``): a second derivative through them raises rather than come out
wrong. ``batch_tile_edge``, ``batch_tile_pool``, ``io_tile``, ``chunk``
and ``interpret`` only shape the TPU grid and are accepted and ignored,
except that ``io_tile % chunk`` must be 0, as JAX asserts (``:420``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from sake_tpu_torch.kernels import build
from sake_tpu_torch.kernels.functional import (
    EPSILON,
    INF,
    ModelParams,
    _silu,
    embed,
    flat_params,
    per_layer,
    readout,
)
from sake_tpu_torch.kernels.leaves import head_expansion_matrices  # noqa: F401 (re-export)
from sake_tpu_torch.kernels.resid_ef import (
    _SMEM_LIMIT,
    ROUTES,
    _check_cuda,
    _require_cuda,
    _stream,
    _unflat_params,
)
from sake_tpu_torch.kernels.sparse_ef import _contract, _neg, xmix_planes

# the weights each op reads, in the JAX argument order
EDGE_ATT_WEIGHTS = ("rbf_m", "rbf_b", "w_r", "w_rr", "b0", "w1", "b1", "w_sem", "b_sem")
COEFF_POOL_WEIGHTS = ("w_xmix",)
MERGED_WEIGHTS = EDGE_ATT_WEIGHTS + COEFF_POOL_WEIGHTS
N_BATCHED = {"edge_att": 7, "coeff_pool": 5, "merged": 7}
WEIGHTS = {"edge_att": EDGE_ATT_WEIGHTS, "coeff_pool": COEFF_POOL_WEIGHTS,
           "merged": MERGED_WEIGHTS}
_OPS = {"edge_att": 0, "coeff_pool": 1, "merged": 2}  # sake::SplitOp

# Per-edge cotangent rows (E = B * N * N, width) the pullbacks write for the
# weight cotangents, in kernel order (``SplitRow`` in ``csrc/split_edge.cuh``).
SPLIT_ROWS = ("q_m", "q_b", "filt", "d_e0", "r", "se", "d_h_e", "h_e", "d_sem", "he_att", "d_xm")
# Each weight's cotangent as a sum over edges of a^T g (a None: a row sum).
GRAD_TERMS = {
    "rbf_m": ((None, "q_m"),), "rbf_b": ((None, "q_b"),), "w_r": (("filt", "d_e0"),),
    "w_rr": (("r", "d_e0"),), "b0": ((None, "d_e0"),), "w1": (("se", "d_h_e"),),
    "b1": ((None, "d_h_e"),), "w_sem": (("h_e", "d_sem"),), "b_sem": ((None, "d_sem"),),
    "w_xmix": (("he_att", "d_xm"),),
}


# --------------------------------------------------------------------------
# The plain bodies (JAX shapes: x planes (B, N, 1), d[b, i, j] = x_j - x_i)
# --------------------------------------------------------------------------


def _geometry(x0, x1, x2):
    d = [p[:, None, :, :] - p[:, :, None, :] for p in (x0, x1, x2)]
    r = torch.sqrt(torch.relu(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) + EPSILON)
    return d, r


def edge_att_body(x0, x1, x2, a_j, a_i, o_j, o_i, rbf_m, rbf_b, w_r, w_rr, b0, w1, b1, w_sem,
                  b_sem):
    """(B, N, 1) x 3 positions + node-level halves -> ``(h_e (B, N, N, H),
    att (B, N, N, K))``; ``a_i`` carries ``b_in``."""
    N = a_j.shape[1]
    d, r = _geometry(x0, x1, x2)
    pre = a_j[:, None] + a_i[:, :, None]
    rbf = torch.exp(-rbf_b * (torch.exp(-r) - rbf_m) ** 2)
    filtered = rbf * pre
    o_f = filtered @ w_r
    e0 = o_j[:, None] + o_i[:, :, None] + o_f + r * w_rr + b0
    h_e = _silu(e0) @ w1 + b1
    sem = h_e @ w_sem + b_sem
    # celu with alpha 2; the branch not taken cannot overflow (see sparse_ef._neg)
    logits = torch.where(sem > 0, sem, 2.0 * (torch.exp(_neg(sem) / 2.0) - 1.0))
    eye = torch.eye(N, dtype=logits.dtype, device=logits.device)
    logits = logits - INF * eye[None, :, :, None]
    att = torch.softmax(logits, dim=-2)
    return h_e, att


def coeff_pool_body(x0, x1, x2, h_e, att, w_xmix):
    """-> ``(pooled0, pooled1, pooled2 (B, N, C), hatt_sum (B, N, H*K))``."""
    B, N, _, H = h_e.shape
    K = att.shape[-1]
    d, r = _geometry(x0, x1, x2)
    h_e_att = (h_e[..., :, None] * att[..., None, :]).reshape(B, N, N, H * K)
    coeff = torch.tanh(h_e_att @ w_xmix)
    inv_r = 1.0 / (r + 1e-5)
    pooled = [(coeff * (d[k] * inv_r)).sum(dim=-2) for k in range(3)]
    hatt_sum = h_e_att.sum(dim=-2)
    return pooled[0], pooled[1], pooled[2], hatt_sum


def merged_body(x0, x1, x2, a_j, a_i, o_j, o_i, rbf_m, rbf_b, w_r, w_rr, b0, w1, b1, w_sem,
                b_sem, w_xmix):
    """The whole O(N^2) middle: the edge_att body's inputs -> the coeff_pool
    body's outputs."""
    h_e, att = edge_att_body(x0, x1, x2, a_j, a_i, o_j, o_i, rbf_m, rbf_b, w_r, w_rr, b0, w1,
                             b1, w_sem, b_sem)
    return coeff_pool_body(x0, x1, x2, h_e, att, w_xmix)


BODIES = {"edge_att": edge_att_body, "coeff_pool": coeff_pool_body, "merged": merged_body}


def vjp_plain(kind: str, args, cots, weights: bool = False):
    """Plain version of a pullback: ``torch.func.vjp`` of the op's body at
    ``args`` (batched inputs, then weights) on the output cotangents
    ``cots``. Returns ``(batched cotangents, weight cotangents or None)``."""
    nb = N_BATCHED[kind]
    _, fn = torch.func.vjp(BODIES[kind], *args)
    g = fn(tuple(cots))
    return tuple(g[:nb]), (tuple(g[nb:]) if weights else None)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _dims(kind, args):
    """``(B, N, R, H, K, C)`` of an op's arguments (0 for a width it lacks)."""
    w = dict(zip(WEIGHTS[kind], args[N_BATCHED[kind]:]))
    B, N = args[0].shape[:2]
    if kind == "coeff_pool":
        H, K = args[3].shape[-1], args[4].shape[-1]
        return B, N, 0, H, K, w["w_xmix"].shape[-1]
    R, H, K = args[3].shape[-1], args[5].shape[-1], w["w_sem"].shape[-1]
    return B, N, R, H, K, (w["w_xmix"].shape[-1] if kind == "merged" else 0)


def _shapes(kind, dims):
    """Expected shapes of an op's batched inputs and of every weight."""
    B, N, R, H, K, C = dims
    xs = [(B, N, 1)] * 3
    batched = (xs + [(B, N, N, H), (B, N, N, K)] if kind == "coeff_pool"
               else xs + [(B, N, R), (B, N, R), (B, N, H), (B, N, H)])
    weights = dict(rbf_m=(R,), rbf_b=(R,), w_r=(R, H), w_rr=(H,), b0=(H,), w1=(H, H), b1=(H,),
                   w_sem=(H, K), b_sem=(K,), w_xmix=(H * K, C))
    return batched, weights


def tensor_core_route(kind, dims, pull: bool) -> bool:
    """Whether the op's pullback (``pull``) or forward takes its tensor-core
    kernel at ``dims`` (``(B, N, R, H, K, C)``; the kernel sources'
    ``split_bwd_tc`` and ``split_fwd_tc``: H * K = 256, C = 256 where the op
    mixes x, R and H at most 64, N at most 64 and the direction's carve within
    one block), else its CUDA-core kernel: an index into ``ROUTES``."""
    lib = build.load()
    return bool((lib.sake_split_bwd_tc if pull else lib.sake_split_fwd_tc)(_OPS[kind], *dims))


def _route(kind, args, pull: bool) -> str:
    return ROUTES[tensor_core_route(kind, _dims(kind, args), pull)]


def _check_planes(name, planes, pull, H, K, C, dev):
    """The planes the direction reads: the forward's, and the pullback's where
    ``pull``."""
    HK = H * K
    for n, a, shape in (("forward", planes[0], (HK // 8, 2, C // 8, 2, 8, 4)),
                        ("pullback", planes[1], (C // 8, 2, HK // 8, 2, 8, 4)))[:1 + pull]:
        _check_cuda(f"the {n} x-mixing planes", a, shape, dev)
        if a.data_ptr() % 16:  # the ring's bulk copies need 16-byte addresses
            raise ValueError(f"{name}: the {n} x-mixing planes must start 16-byte aligned")


def _setup(name, kind, args, pull):
    """Checks shared by the launches; ``(lib, dims, input pointers, weight
    pointers, the tensors they point to)``. The pullback also reads the
    transposes, made here; where the direction's tensor-core route mixes x, the
    kernel reads the packed planes of w_xmix
    (:func:`~sake_tpu_torch.kernels.sparse_ef.xmix_planes`, once a call; for
    the forward only its own, the pullback's slot None); the caller keeps the
    last item alive until its launch is queued."""
    _require_cuda(name, args[0])
    dims = _dims(kind, args)
    nb = N_BATCHED[kind]
    dev = args[0].device
    batched, wshape = _shapes(kind, dims)
    for i, (t, s) in enumerate(zip(args[:nb], batched)):
        _check_cuda(f"{name} input {i}", t, s, dev)
    w = dict(zip(WEIGHTS[kind], args[nb:]))
    for n, t in w.items():
        _check_cuda(n, t, wshape[n], dev)
    lib = build.load()
    if lib.sake_split_smem_bytes(_OPS[kind], int(pull), *dims) > _SMEM_LIMIT:
        raise ValueError(f"{name}: N={dims[1]} at these widths exceeds one block's shared memory")
    ins = list(args[:3]) + ([None] * 4 + list(args[3:5]) if kind == "coeff_pool"
                            else list(args[3:7]) + [None, None])
    ts = {}
    if pull:
        for n, src in (("t_r", "w_r"), ("t_1", "w1"), ("t_sem", "w_sem"), ("t_xmix", "w_xmix")):
            if src in w:
                ts[n] = w[src].T.contiguous()
    wp = [w.get(n) for n in MERGED_WEIGHTS] + [ts.get(n) for n in ("t_r", "t_1", "t_sem", "t_xmix")]
    planes = [None, None]
    if "w_xmix" in w and tensor_core_route(kind, dims, pull):
        planes = xmix_planes(w["w_xmix"], pull)
        _check_planes(name, planes, pull, *dims[3:], dev)
    wp += planes
    return lib, dims, _ptrs_opt(ins), _ptrs_opt(wp), (ins, wp)


def _ptrs_opt(ts):
    return (ctypes.c_void_p * len(ts))(*[None if t is None else t.data_ptr() for t in ts])


def _launch_fwd(name, kind, args):
    lib, dims, ins, wp, _alive = _setup(name, kind, args, False)
    B, N, R, H, K, C = dims
    dev = args[0].device
    if kind == "edge_att":
        outs = (torch.empty(B, N, N, H, device=dev), torch.empty(B, N, N, K, device=dev))
        ptrs = [*outs, None, None, None, None]
    else:
        outs = (*(torch.empty(B, N, C, device=dev) for _ in range(3)),
                torch.empty(B, N, H * K, device=dev))
        ptrs = [None, None, *outs]
    err = lib.sake_split_fwd(_OPS[kind], ins, wp, _ptrs_opt(ptrs), *dims, _stream(dev))
    build.check(lib, err, name)
    return outs


def _row_widths(kind, dims):
    B, N, R, H, K, C = dims
    widths = dict(q_m=R, q_b=R, filt=R, d_e0=H, r=1, se=H, d_h_e=H, h_e=H, d_sem=K,
                  he_att=H * K, d_xm=C)
    ea, cp = SPLIT_ROWS[:9], SPLIT_ROWS[9:]
    names = {"edge_att": ea, "coeff_pool": cp, "merged": ea + cp}[kind]
    return {n: widths[n] for n in names}


def _launch_bwd(name, kind, args, cots, weights):
    lib, dims, ins, wp, _alive = _setup(name, kind, args, True)
    B, N, R, H, K, C = dims
    dev = args[0].device
    nb = N_BATCHED[kind]
    if kind == "edge_att":
        _check_cuda("g_h_e", cots[0], (B, N, N, H), dev)
        _check_cuda("g_att", cots[1], (B, N, N, K), dev)
        gp = [cots[0], cots[1], None, None, None, None]
    else:
        for k in range(3):
            _check_cuda(f"g_pooled{k}", cots[k], (B, N, C), dev)
        _check_cuda("g_hatt_sum", cots[3], (B, N, H * K), dev)
        gp = [None, None, *cots]
    outs = tuple(torch.empty_like(a) for a in args[:nb])
    if kind == "coeff_pool":
        optrs = [*outs[:3], None, None, None, None, outs[3], outs[4]]
    else:
        optrs = [*outs, None, None]
    rows = None
    if weights:
        rows = {n: torch.empty(B * N * N, wd, device=dev)
                for n, wd in _row_widths(kind, dims).items()}
    rptrs = None if rows is None else _ptrs_opt([rows.get(n) for n in SPLIT_ROWS])
    err = lib.sake_split_bwd(_OPS[kind], ins, wp, _ptrs_opt(gp), _ptrs_opt(optrs), rptrs, *dims,
                             _stream(dev))
    build.check(lib, err, name)
    if rows is None:
        return outs, None
    w = dict(zip(WEIGHTS[kind], args[nb:]))
    shapes = {n: (1, t.numel()) if t.dim() == 1 else tuple(t.shape) for n, t in w.items()}
    dW = _contract(lib, rows, {n: GRAD_TERMS[n] for n in w}, shapes, B * N * N, dev)
    return outs, tuple(dW[n].view(w[n].shape) for n in w)


def edge_att_fwd(*args):
    """#25, the edge_att body: ``(x0, x1, x2 (B, N, 1), a_j, a_i (B, N, R),
    o_j, o_i (B, N, H), *EDGE_ATT_WEIGHTS) -> (h_e, att)``. CPU tensors take
    the plain version; on the card the kernel of :func:`tensor_core_route`."""
    if args[0].device.type == "cpu":
        return edge_att_body(*args)
    out = _launch_fwd("edge_att_fwd", "edge_att", args)
    edge_att_fwd.launches += 1
    edge_att_fwd.routes[_route("edge_att", args, False)] += 1
    return out


def coeff_pool_fwd(*args):
    """#25, the coeff_pool body: ``(x0, x1, x2, h_e, att, w_xmix) ->
    (pooled0, pooled1, pooled2, hatt_sum)``. CPU tensors take the plain
    version; on the card the kernel of :func:`tensor_core_route`."""
    if args[0].device.type == "cpu":
        return coeff_pool_body(*args)
    out = _launch_fwd("coeff_pool_fwd", "coeff_pool", args)
    coeff_pool_fwd.launches += 1
    coeff_pool_fwd.routes[_route("coeff_pool", args, False)] += 1
    return out


def merged_fwd(*args):
    """#27: the edge_att inputs and ``w_xmix`` -> the coeff_pool outputs in
    one kernel. CPU tensors take the plain version; on the card the kernel of
    :func:`tensor_core_route`."""
    if args[0].device.type == "cpu":
        return merged_body(*args)
    out = _launch_fwd("merged_fwd", "merged", args)
    merged_fwd.launches += 1
    merged_fwd.routes[_route("merged", args, False)] += 1
    return out


def edge_att_bwd(args, cots, weights: bool = False):
    """#26 for the edge_att op: from the cotangents ``(g_h_e, g_att)``, the
    cotangents of the 7 batched inputs and, with ``weights``, of the 9
    weights (else None). CPU tensors take the plain version; on the card the
    kernel of :func:`tensor_core_route`."""
    if args[0].device.type == "cpu":
        return vjp_plain("edge_att", args, cots, weights)
    out = _launch_bwd("edge_att_bwd", "edge_att", args, cots, weights)
    edge_att_bwd.launches += 1
    edge_att_bwd.routes[_route("edge_att", args, True)] += 1
    return out


def coeff_pool_bwd(args, cots, weights: bool = False):
    """#26 for the coeff_pool op: from ``(g_pooled0..2, g_hatt_sum)``, the
    cotangents of ``(x0, x1, x2, h_e, att)`` and, with ``weights``, of
    ``w_xmix``. CPU tensors take the plain version; on the card the kernel of
    :func:`tensor_core_route`."""
    if args[0].device.type == "cpu":
        return vjp_plain("coeff_pool", args, cots, weights)
    out = _launch_bwd("coeff_pool_bwd", "coeff_pool", args, cots, weights)
    coeff_pool_bwd.launches += 1
    coeff_pool_bwd.routes[_route("coeff_pool", args, True)] += 1
    return out


def merged_bwd(args, cots, weights: bool = False):
    """#28: the pullback of :func:`merged_fwd`, recomputing h_e and att
    inside. CPU tensors take the plain version; on the card the kernel of
    :func:`tensor_core_route`."""
    if args[0].device.type == "cpu":
        return vjp_plain("merged", args, cots, weights)
    out = _launch_bwd("merged_bwd", "merged", args, cots, weights)
    merged_bwd.launches += 1
    merged_bwd.routes[_route("merged", args, True)] += 1
    return out


for _fn in (edge_att_fwd, coeff_pool_fwd, merged_fwd, edge_att_bwd, coeff_pool_bwd, merged_bwd):
    _fn.launches = 0
    _fn.routes = dict.fromkeys(ROUTES, 0)
FWD = {"edge_att": edge_att_fwd, "coeff_pool": coeff_pool_fwd, "merged": merged_fwd}
BWD = {"edge_att": edge_att_bwd, "coeff_pool": coeff_pool_bwd, "merged": merged_bwd}


# --------------------------------------------------------------------------
# The differentiable ops (JAX ``custom_vjp``, ``:221-290``, ``:406-532``)
# --------------------------------------------------------------------------


class _SplitOp(torch.autograd.Function):
    """One split op: forward by its forward kernel, backward by its pullback
    kernel; the weight cotangents only when ``needs_input_grad`` asks for
    one of them. First order: a backward that records a graph raises."""

    @staticmethod
    def forward(ctx, kind, *args):
        args = tuple(a.contiguous() for a in args)
        ctx.kind = kind
        ctx.save_for_backward(*args)
        return FWD[kind](*args)

    @staticmethod
    def backward(ctx, *cots):
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"split {ctx.kind} op: first order only, like the JAX custom_vjp; a second "
                "derivative through it is not supported")
        args = ctx.saved_tensors
        nb = N_BATCHED[ctx.kind]
        weights = any(ctx.needs_input_grad[1 + nb:])
        gb, gw = BWD[ctx.kind](args, tuple(g.contiguous() for g in cots), weights)
        return (None, *gb, *(gw if weights else (None,) * (len(args) - nb)))


def _check_shapes(name, got, want):
    if tuple(got) != tuple(want):
        raise ValueError(f"{name}: shape {tuple(got)}, the op was built for {tuple(want)}")


def make_edge_att_op(N, R, H, K, *, batch_tile=16, interpret=False):
    """The differentiable edge + attention op for fixed widths: ``op(x0, x1,
    x2, a_j, a_i, o_j, o_i, *EDGE_ATT_WEIGHTS) -> (h_e, att)``."""

    def op(*args):
        _check_shapes("edge_att a_j", args[3].shape[1:], (N, R))
        _check_shapes("edge_att o_j", args[5].shape[1:], (N, H))
        _check_shapes("edge_att w_sem", args[14].shape, (H, K))
        return _SplitOp.apply("edge_att", *args)

    return op


def make_coeff_pool_op(N, H, K, C, *, batch_tile=8, interpret=False):
    """The differentiable coefficient + pooling op: ``op(x0, x1, x2, h_e, att,
    w_xmix) -> (pooled0, pooled1, pooled2, hatt_sum)``."""

    def op(*args):
        _check_shapes("coeff_pool h_e", args[3].shape[1:], (N, N, H))
        _check_shapes("coeff_pool w_xmix", args[5].shape, (H * K, C))
        return _SplitOp.apply("coeff_pool", *args)

    return op


def make_edge_pool_op(N, R, H, K, C, *, io_tile=64, chunk=2, interpret=False):
    """The differentiable merged op: ``op(x0, x1, x2, a_j, a_i, o_j, o_i,
    *EDGE_ATT_WEIGHTS, w_xmix) -> (pooled0, pooled1, pooled2, hatt_sum)``."""
    if io_tile % chunk:
        raise ValueError(f"io_tile ({io_tile}) must be a multiple of chunk ({chunk})")

    def op(*args):
        _check_shapes("edge_pool a_j", args[3].shape[1:], (N, R))
        _check_shapes("edge_pool o_j", args[5].shape[1:], (N, H))
        _check_shapes("edge_pool w_xmix", args[16].shape, (H * K, C))
        return _SplitOp.apply("merged", *args)

    return op


# --------------------------------------------------------------------------
# The entry points
# --------------------------------------------------------------------------


def edge_weights(lp, F: int, R: int) -> tuple:
    """A layer's ``EDGE_ATT_WEIGHTS`` in the JAX call order (``:330-334``)."""
    e = lp.edge
    return (e.rbf_means, e.rbf_betas, e.w_out0[2 * F : 2 * F + R], e.w_out0[2 * F + R],
            e.b_out0, e.w_out1, e.b_out1, lp.w_sem, lp.b_sem)


def _energy(params: ModelParams, h, x, update, middle):
    """The JAX entry points' shared body (``:318-384``, ``:558-620``): per
    layer the node-level halves, ``middle(xp, a_j, a_i, o_j, o_i, lp) ->
    (pooled0..2, hatt_sum)``, then the node update, the post MLP and the
    position update in torch; the raw energy ``(B,)``."""
    updates = per_layer(update, len(params.layers))
    N = h.shape[1]
    F = params.w_embed.shape[-1]
    xp = [x[..., k : k + 1] for k in range(3)]
    hc = embed(params, h.float())
    vp = None
    for lp, upd in zip(params.layers, updates):
        e = lp.edge
        HK = lp.w_xmix.shape[0]
        a_j = hc @ e.w_in[:F]
        a_i = hc @ e.w_in[F:] + e.b_in
        o_j = hc @ e.w_out0[:F]
        o_i = hc @ e.w_out0[F : 2 * F]
        p0, p1, p2, hatt_sum = middle(xp, a_j, a_i, o_j, o_i, lp)
        pooled = [p0, p1, p2]
        agg_node = hatt_sum @ lp.w_node0[F : F + HK]
        norm = [pk / float(N) for pk in pooled]
        pool_sq = norm[0] ** 2 + norm[1] ** 2 + norm[2] ** 2
        h_comb = _silu(_silu(pool_sq @ lp.w_post0 + lp.b_post0) @ lp.w_post1 + lp.b_post1)
        node_pre = hc @ lp.w_node0[:F] + agg_node + h_comb @ lp.w_node0[F + HK :] + lp.b_node0
        upd_val = _silu(node_pre) @ lp.w_node1 + lp.b_node1
        hc = hc + _silu(upd_val)
        if upd:
            delta = [pk @ lp.w_vmix / float(N) for pk in pooled]
            if vp is not None:
                gate = 2.0 * torch.sigmoid(_silu(hc @ lp.w_vel0 + lp.b_vel0) @ lp.w_vel1)
                vp = [gate * vk + dk for vk, dk in zip(vp, delta)]
            else:
                vp = delta
            xp = [xk + vk for xk, vk in zip(xp, vp)]
    return readout(params, hc).sum(dim=(-2, -1))


def _energy_forces(params: ModelParams, h, x, update, middle):
    """Detached ``(e (B,), f (B, N, 3))``: :func:`_energy` with ``F`` by
    ``torch.autograd.grad`` of the summed energy. The parameters go in
    detached, so the ops pull back only the batched inputs."""
    params = _unflat_params([t.detach() for t in flat_params(params)], len(params.layers))
    with torch.enable_grad():
        xg = x.detach().float().requires_grad_(True)
        energy = _energy(params, h, xg, update, middle)
        (g,) = torch.autograd.grad(energy.sum(), xg)
    return energy.detach(), -g


def _widths(params: ModelParams, h, n_heads: int):
    N, F = h.shape[1], params.w_embed.shape[-1]
    lp = params.layers[0]
    return N, lp.edge.w_in.shape[-1], lp.edge.w_out0.shape[-1], n_heads, lp.w_xmix.shape[-1], F


def _split_middle(params: ModelParams, h, n_heads: int, batch_tile_edge=16, batch_tile_pool=8,
                  interpret=False):
    """A layer's middle through the edge_att and coeff_pool ops."""
    N, R, H, K, C, F = _widths(params, h, n_heads)
    edge_att = make_edge_att_op(N, R, H, K, batch_tile=batch_tile_edge, interpret=interpret)
    coeff_pool = make_coeff_pool_op(N, H, K, C, batch_tile=batch_tile_pool, interpret=interpret)

    def middle(xp, a_j, a_i, o_j, o_i, lp):
        h_e, att = edge_att(*xp, a_j, a_i, o_j, o_i, *edge_weights(lp, F, R))
        return coeff_pool(*xp, h_e, att, lp.w_xmix)

    return middle


def _merged_middle(params: ModelParams, h, n_heads: int, io_tile=64, chunk=2, interpret=False):
    """A layer's middle through the merged op."""
    N, R, H, K, C, F = _widths(params, h, n_heads)
    edge_pool = make_edge_pool_op(N, R, H, K, C, io_tile=io_tile, chunk=chunk,
                                  interpret=interpret)

    def middle(xp, a_j, a_i, o_j, o_i, lp):
        return edge_pool(*xp, a_j, a_i, o_j, o_i, *edge_weights(lp, F, R), lp.w_xmix)

    return middle


def split_energy_forces(
    params: ModelParams,
    h: torch.Tensor,  # (B, N, F_in)
    x: torch.Tensor,  # (B, N, 3)
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    batch_tile_edge: int = 16,
    batch_tile_pool: int = 8,
    interpret: bool = False,
):
    """Raw ``E (B,)`` and ``F = -dE/dx (B, N, 3)`` with each layer's edge
    pipeline in the edge_att and coeff_pool ops (#25, #26) and the
    node-level math in torch."""
    middle = _split_middle(params, h, n_heads, batch_tile_edge=batch_tile_edge,
                           batch_tile_pool=batch_tile_pool, interpret=interpret)
    return _energy_forces(params, h, x, update, middle)


def merged_energy_forces(
    params: ModelParams,
    h: torch.Tensor,  # (B, N, F_in)
    x: torch.Tensor,  # (B, N, 3)
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    io_tile: int = 64,
    chunk: int = 2,
    interpret: bool = False,
):
    """Raw ``E (B,)`` and ``F (B, N, 3)`` with the merged edge-pipeline op
    (#27, #28): one kernel per layer and direction, node-level math in
    torch."""
    middle = _merged_middle(params, h, n_heads, io_tile=io_tile, chunk=chunk,
                            interpret=interpret)
    return _energy_forces(params, h, x, update, middle)


def model_energy(params: ModelParams, h, x, *, n_heads: int = 4,
                 update: Sequence[bool] | bool = True, merged: bool = False):
    """The raw energy ``(B,)`` through the split ops (``merged=False``) or the
    merged op, differentiable once in ``params``, ``h`` and ``x``: the
    weight cotangents of the edge ops come from their pullback kernels' rows
    and the contraction. The entry points' energy, with its graph."""
    make = _merged_middle if merged else _split_middle
    return _energy(params, h, x, update, make(params, h, n_heads))
