"""Residual-saving E+F: the layer forward that saves residuals, its
hand-derived pullback, and the K1/K2 CUDA kernels that run them.

Port of ``sake_tpu/kernels/resid_ef.py``:

- :func:`layer_fwd_resid` (JAX ``:147-320``) and :func:`layer_bwd_resid`
  (JAX ``:387-676``, input cotangents only) are the plain PyTorch versions
  of one layer. The CUDA kernels compute the same functions.
- :func:`resid_fwd` (K1, ``csrc/resid_fwd.cu``, replacing the JAX
  ``fwd_kernel`` at ``:1099``) runs ``layer_fwd_resid`` over depth;
  :func:`resid_bwd` (K2, ``csrc/resid_bwd.cu``, replacing ``bwd_kernel``
  at ``:1211``) runs ``layer_bwd_resid`` in reverse. Each takes its plain
  stack (:func:`resid_fwd_plain` / :func:`resid_bwd_plain`) only for CPU
  tensors; on a CUDA tensor it launches the kernel or raises.
- :func:`resid_energy_forces` (JAX ``:978-1330``) orchestrates embed, K1,
  the readout and its seed (plain torch, as the JAX package ran them
  outside Pallas), K2 and ``F = -dx``, per batch chunk so residual memory
  stays bounded.

The JAX package's TPU-only probes (``SAKE_ABLATE``/``geomfold``, the MXU
pooling ``spat``/``mm_pool``, ``pool_dtype``) have no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from sake_tpu_torch.kernels import build
from sake_tpu_torch.kernels.functional import (
    EPSILON,
    INF,
    ModelParams,
    _silu,
    embed,
    per_layer,
    readout,
)
from sake_tpu_torch.kernels.leaves import LEAF_NAMES, layer_leaves, transposed, wide_stack

# Residuals in kernel-boundary order. Edge residuals are (depth, B, N*N, ch),
# node residuals (depth, B, N, ch).
EDGE_RESIDS = ("r", "t", "rbf", "e0", "h_e", "sem_pre", "att", "coeff")
NODE_RESIDS = ("pool0", "pool1", "pool2", "ps0", "ps1", "node_pre", "uv",
               "g0", "g1")
RESIDS = EDGE_RESIDS + NODE_RESIDS


def edge_channels(R, H, K, C):
    return dict(r=1, t=1, rbf=R, e0=H, h_e=H, sem_pre=K, att=K, coeff=C)


def node_channels(p: dict, C: int):
    """Node residual widths, read off one layer's (or the stacked) leaves."""
    w = lambda name: p[name].shape[-1]
    return dict(pool0=C, pool1=C, pool2=C, ps0=w("w_post0"), ps1=w("w_post1"),
                node_pre=w("w_node_h"), uv=w("w_node1"), g0=w("w_vel0"), g1=1)


def _dsilu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def layer_fwd_resid(p: dict, h, xp, vp, upd, *, n_real=None, mask=None):
    """One layer's forward and the residuals the backward reads.

    ``p``: one layer's leaves (``leaves.split_layer``); ``h (B, N, F)``;
    ``xp``/``vp``: 3 planes ``(B, N, 1)``; ``upd`` in [0, 1] gates the x/v
    update; ``mask``: ``(B, N, N, 1)`` edge mask or None; ``n_real``: real
    atoms when the last ``N - n_real`` are padding (pad senders masked,
    divisor ``n_real``). Returns ``(h_out, xp_out, vp_out, resid)``.
    """
    B, N, F = h.shape
    n_eff = float(n_real if n_real is not None else N)

    d0 = [pk[:, None, :, :] - pk[:, :, None, :] for pk in xp]
    r = torch.sqrt(torch.relu(d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2]) + EPSILON)

    a_j = h @ p["w_in_j"] + p["b_in"]
    a_i = h @ p["w_in_i"]
    pre = a_j[:, None, :, :] + a_i[:, :, None, :]
    t = torch.exp(-r)
    rbf = torch.exp(-p["rbf_b"] * (t - p["rbf_m"]) ** 2)
    o_j = h @ p["w_o_j"]
    o_i = h @ p["w_o_i"]
    o_f = (rbf * pre) @ p["w_o_f"]
    e0 = o_j[:, None] + o_i[:, :, None] + o_f + r * p["w_o_r"][0] + p["b_o0"]
    h_e = _silu(e0) @ p["w_o1"] + p["b_o1"]

    sem_pre = h_e @ p["w_sem"] + p["b_sem"]
    logits = torch.where(sem_pre > 0, sem_pre, 2.0 * (torch.exp(sem_pre / 2.0) - 1.0))
    eye = torch.eye(N, dtype=h.dtype, device=h.device)
    logits = logits - INF * eye[None, :, :, None]
    if mask is not None:
        logits = logits - INF * (1.0 - mask)
    elif n_real is not None and n_real < N:
        pad = (torch.arange(N, device=h.device) >= n_real).to(h.dtype)
        logits = logits - INF * pad[None, None, :, None]
    att = torch.softmax(logits, dim=-2)  # raw softmax: the saved residual
    if mask is not None:
        att_s = att * mask
        denom = att_s.sum(dim=-2, keepdim=True)
        att2 = att_s / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    else:
        att2 = att

    K = att.shape[-1]
    H = h_e.shape[-1]
    h_e_att = (h_e[..., :, None] * att2[..., None, :]).reshape(B, N, N, H * K)
    coeff = torch.tanh(h_e_att @ p["w_xmix"])
    if mask is not None:
        coeff = coeff * mask
    inv_r = 1.0 / (r + 1e-5)
    pooled = [(coeff * (d0[k] * inv_r)).sum(dim=-2) for k in range(3)]
    if mask is not None:
        count = mask.sum(dim=-2)
        norm = [pk / (count + 1e-8) for pk in pooled]
    else:
        norm = [pk / n_eff for pk in pooled]
    pool_sq = norm[0] ** 2 + norm[1] ** 2 + norm[2] ** 2
    ps0 = pool_sq @ p["w_post0"] + p["b_post0"]
    ps1 = _silu(ps0) @ p["w_post1"] + p["b_post1"]
    h_comb = _silu(ps1)

    hatt_sum = h_e_att.sum(dim=-2)
    node_pre = (h @ p["w_node_h"] + hatt_sum @ p["w_node_agg"]
                + h_comb @ p["w_node_comb"] + p["b_node0"])
    uv = _silu(node_pre) @ p["w_node1"] + p["b_node1"]
    h_out = h + _silu(uv)

    dv_denom = (count + 1e-10) if mask is not None else n_eff
    delta = [pk @ p["w_vmix"] / dv_denom for pk in pooled]
    g0 = h_out @ p["w_vel0"] + p["b_vel0"]
    g1 = _silu(g0) @ p["w_vel1"]
    gate = 2.0 * torch.sigmoid(g1)
    v_new = [gate * vk + dk for vk, dk in zip(vp, delta)]
    x_new = [xk + vk for xk, vk in zip(xp, v_new)]
    xp_out = [xk + upd * (xn - xk) for xk, xn in zip(xp, x_new)]
    vp_out = [vk + upd * (vn - vk) for vk, vn in zip(vp, v_new)]

    e2 = lambda a: a.reshape(B, N * N, -1)
    resid = dict(
        r=e2(r), t=e2(t), rbf=e2(rbf), e0=e2(e0), h_e=e2(h_e),
        sem_pre=e2(sem_pre), att=e2(att), coeff=e2(coeff),
        pool0=pooled[0], pool1=pooled[1], pool2=pooled[2],
        ps0=ps0, ps1=ps1, node_pre=node_pre, uv=uv, g0=g0, g1=g1,
    )
    return h_out, xp_out, vp_out, resid


def layer_bwd_resid(p: dict, resid: dict, h_in, xp, vp, upd, d_h_out, d_xp_out,
                    d_vp_out, *, n_real=None, mask=None):
    """Hand-derived pullback of :func:`layer_fwd_resid` w.r.t. its inputs
    ``(h, xp, vp)``; the parameters are constants. Only ``a_j``/``a_i`` are
    recomputed from ``h_in``; every nonlinearity is evaluated on the saved
    residuals. Returns ``(d_h, d_xp, d_vp)``."""
    B, N, F = h_in.shape
    C = p["w_xmix"].shape[-1]
    n_eff = float(n_real if n_real is not None else N)

    e4 = lambda a: a.reshape(B, N, N, -1)
    r, t, rbf, e0, h_e, sem_pre, att, coeff = (
        e4(resid[n]) for n in EDGE_RESIDS
    )
    pooled = [resid["pool0"], resid["pool1"], resid["pool2"]]
    ps0, ps1, node_pre, uv, g0, g1 = (
        resid[n] for n in ("ps0", "ps1", "node_pre", "uv", "g0", "g1")
    )

    d0 = [pk[:, None, :, :] - pk[:, :, None, :] for pk in xp]
    inv_r = 1.0 / (r + 1e-5)

    # position/velocity gates: x_out = x + upd*v_new; v_out = v + upd*(v_new - v)
    d_v_new = [upd * (dxk + dvk) for dxk, dvk in zip(d_xp_out, d_vp_out)]
    sig_g1 = torch.sigmoid(g1)
    gate = 2.0 * sig_g1
    d_gate = sum(dvn * vk for dvn, vk in zip(d_v_new, vp))
    d_vp = [gate * dvn + (1.0 - upd) * dvk for dvn, dvk in zip(d_v_new, d_vp_out)]
    d_xp = list(d_xp_out)

    # gate MLP
    d_g1 = d_gate * 2.0 * sig_g1 * (1.0 - sig_g1)
    d_g0 = (d_g1 @ p["w_vel1"].T) * _dsilu(g0)
    dho = d_h_out + d_g0 @ p["w_vel0"].T

    if mask is not None:
        count = mask.sum(dim=-2)
        dv_denom, pool_denom = count + 1e-10, count + 1e-8
    else:
        dv_denom = pool_denom = n_eff
    d_pooled = [(dd @ p["w_vmix"].T) / dv_denom for dd in d_v_new]

    # h_out = h_in + silu(uv); node MLP
    d_uv = dho * _dsilu(uv)
    d_node_pre = (d_uv @ p["w_node1"].T) * _dsilu(node_pre)
    d_h = dho + d_node_pre @ p["w_node_h"].T
    d_hatt = d_node_pre @ p["w_node_agg"].T
    d_ps1 = (d_node_pre @ p["w_node_comb"].T) * _dsilu(ps1)
    d_ps0 = (d_ps1 @ p["w_post1"].T) * _dsilu(ps0)
    d_pool_sq = d_ps0 @ p["w_post0"].T

    # pool_sq = sum_k (pooled_k / denom)^2
    pd2 = pool_denom * pool_denom
    d_pooled = [d_pooled[k] + 2.0 * pooled[k] * d_pool_sq / pd2 for k in range(3)]

    # pooled_k = sum_j coeff * u_k
    u = [dk * inv_r for dk in d0]
    dp = [dpk[:, :, None, :] for dpk in d_pooled]
    d_coeff = dp[0] * u[0] + dp[1] * u[1] + dp[2] * u[2]
    d_u = [(coeff * dp[k]).sum(dim=-1, keepdim=True) for k in range(3)]
    d_d0 = [du * inv_r for du in d_u]
    d_ir = d_u[0] * d0[0] + d_u[1] * d0[1] + d_u[2] * d0[2]
    d_r = -(inv_r * inv_r) * d_ir

    # coeff = tanh(he_att @ w_xmix) [* mask]; the saved coeff is masked
    d_xm = d_coeff * (1.0 - coeff * coeff)
    if mask is not None:
        d_xm = d_xm * mask
    d_he_att = d_xm @ p["w_xmix"].T + d_hatt[:, :, None, :]

    # he_att[..., h*K + k] = h_e[..., h] * att2[..., k]
    K = att.shape[-1]
    H = h_e.shape[-1]
    if mask is not None:
        att_s = att * mask
        denom = att_s.sum(dim=-2, keepdim=True)
        dg = torch.where(denom == 0.0, torch.ones_like(denom), denom)
        att2 = att_s / dg
    else:
        att2 = att
    d_he_att4 = d_he_att.reshape(B, N, N, H, K)
    d_h_e = (d_he_att4 * att2[..., None, :]).sum(dim=-1)
    d_att2 = (d_he_att4 * h_e[..., :, None]).sum(dim=-2)
    if mask is not None:
        live = (denom != 0.0).to(att.dtype)
        d_att = (d_att2 / dg
                 - live * (d_att2 * att_s).sum(dim=-2, keepdim=True) / (dg * dg)) * mask
    else:
        d_att = d_att2

    # softmax over senders, celu2
    d_logits = att * (d_att - (d_att * att).sum(dim=-2, keepdim=True))
    dcelu = torch.where(sem_pre > 0, torch.ones_like(sem_pre), torch.exp(sem_pre / 2.0))
    d_h_e = d_h_e + (d_logits * dcelu) @ p["w_sem"].T

    # h_e = silu(e0) @ w_o1 + b_o1
    d_e0 = (d_h_e @ p["w_o1"].T) * _dsilu(e0)

    # e0 = o_j[j] + o_i[i] + o_f + r * w_o_r + b_o0
    d_o_j = d_e0.sum(dim=-3)
    d_o_i = d_e0.sum(dim=-2)
    d_r = d_r + (d_e0 * p["w_o_r"][0]).sum(dim=-1, keepdim=True)
    d_filtered = d_e0 @ p["w_o_f"].T
    a_j = h_in @ p["w_in_j"] + p["b_in"]
    a_i = h_in @ p["w_in_i"]
    pre = a_j[:, None, :, :] + a_i[:, :, None, :]
    d_rbf = d_filtered * pre
    d_pre = d_filtered * rbf
    d_h = (d_h + d_pre.sum(dim=-3) @ p["w_in_j"].T + d_pre.sum(dim=-2) @ p["w_in_i"].T
           + d_o_j @ p["w_o_j"].T + d_o_i @ p["w_o_i"].T)

    # rbf = exp(-b (t - m)^2), t = exp(-r)
    d_t = (d_rbf * rbf * (-2.0 * p["rbf_b"] * (t - p["rbf_m"]))).sum(dim=-1, keepdim=True)
    d_r = d_r + (-t) * d_t

    # r = sqrt(relu(s) + eps), s = |d0|^2, d0[b, i, j] = x[b, j] - x[b, i]
    d_s = d_r * (0.5 / r) * (r * r > EPSILON).to(r.dtype)
    for k in range(3):
        dd = d_d0[k] + 2.0 * d0[k] * d_s
        d_xp[k] = d_xp[k] + dd.sum(dim=-3) - dd.sum(dim=-2)
    return d_h, d_xp, d_vp


# --------------------------------------------------------------------------
# Layer stacks: plain versions and the K1/K2 kernel wrappers.
# Coordinates cross as (3, B, N) plane stacks.
# --------------------------------------------------------------------------


class FwdOut(NamedTuple):
    bh: torch.Tensor  # (depth, B, N, F) h entering each layer
    bx: torch.Tensor  # (depth, 3, B, N)
    bv: torch.Tensor  # (depth, 3, B, N)
    h_fin: torch.Tensor  # (B, N, F)
    x_fin: torch.Tensor  # (3, B, N)
    v_fin: torch.Tensor  # (3, B, N)
    resid: dict  # name -> (depth, B, N*N | N, ch)


def _planes(s):
    return [s[k][..., None] for k in range(3)]


def _unplanes(ps):
    return torch.stack([pk[..., 0] for pk in ps])


def resid_fwd_plain(leaves: dict, h0, xs, v0, upd: Sequence[float], mask=None) -> FwdOut:
    """Plain version of K1: :func:`layer_fwd_resid` over depth."""
    h, xp, vp = h0, _planes(xs), _planes(v0)
    bh, bx, bv, res = [], [], [], {n: [] for n in RESIDS}
    for l, u in enumerate(upd):
        bh.append(h)
        bx.append(_unplanes(xp))
        bv.append(_unplanes(vp))
        h, xp, vp, r = layer_fwd_resid(layer_leaves(leaves, l), h, xp, vp, u, mask=mask)
        for n in RESIDS:
            res[n].append(r[n])
    return FwdOut(torch.stack(bh), torch.stack(bx), torch.stack(bv), h,
                  _unplanes(xp), _unplanes(vp),
                  {n: torch.stack(v) for n, v in res.items()})


def resid_bwd_plain(leaves: dict, fwd: FwdOut, upd: Sequence[float], dh, dx, dv,
                    mask=None):
    """Plain version of K2: :func:`layer_bwd_resid` in reverse depth.
    Returns the cotangents of the initial ``(h, x, v)``."""
    dxp, dvp = _planes(dx), _planes(dv)
    for l in reversed(range(len(upd))):
        dh, dxp, dvp = layer_bwd_resid(
            layer_leaves(leaves, l), {n: a[l] for n, a in fwd.resid.items()},
            fwd.bh[l], _planes(fwd.bx[l]), _planes(fwd.bv[l]), upd[l],
            dh, dxp, dvp, mask=mask,
        )
    return dh, _unplanes(dxp), _unplanes(dvp)


_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def _dims(leaves: dict, h0):
    B, N, F = h0.shape
    depth, _, R = leaves["w_in_j"].shape
    H = leaves["w_o_j"].shape[-1]
    K = leaves["w_sem"].shape[-1]
    C = leaves["w_xmix"].shape[-1]
    return B, N, F, H, R, K, C, depth


def _leaf_shapes(F, H, R, K, C):
    HK = H * K
    return dict(
        w_in_j=(F, R), w_in_i=(F, R), b_in=(1, R), rbf_m=(1, R), rbf_b=(1, R),
        w_o_j=(F, H), w_o_i=(F, H), w_o_f=(R, H), w_o_r=(1, H), b_o0=(1, H),
        w_o1=(H, H), b_o1=(1, H), w_sem=(H, K), b_sem=(1, K), w_xmix=(HK, C),
        w_post0=(C, H), b_post0=(1, H), w_post1=(H, H), b_post1=(1, H),
        w_node_h=(F, H), w_node_agg=(HK, H), w_node_comb=(H, H), b_node0=(1, H),
        w_node1=(H, F), b_node1=(1, F), w_vmix=(C, 1), w_vel0=(F, H),
        b_vel0=(1, H), w_vel1=(H, 1),
    )


def _check_cuda(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous float32 tensor on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel expects {tuple(shape)}")


def _check_leaves(leaves, dims, device):
    B, N, F, H, R, K, C, depth = dims
    for name, shape in _leaf_shapes(F, H, R, K, C).items():
        _check_cuda(name, leaves[name], (depth, *shape), device)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _strides(leaves):
    return (ctypes.c_longlong * len(LEAF_NAMES))(
        *[leaves[n][0].numel() for n in LEAF_NAMES]
    )


def _resid_shapes(dims, leaves):
    B, N, F, H, R, K, C, depth = dims
    ech = edge_channels(R, H, K, C)
    nch = node_channels(leaves, C)
    return {
        **{n: (depth, B, N * N, ech[n]) for n in EDGE_RESIDS},
        **{n: (depth, B, N, nch[n]) for n in NODE_RESIDS},
    }


def resid_fwd(leaves: dict, h0, xs, v0, upd: Sequence[float], mask=None) -> FwdOut:
    """K1: the layer stack's forward with residuals. ``leaves`` from
    :func:`leaves.wide_stack`; ``h0 (B, N, F)``; ``xs``, ``v0 (3, B, N)``;
    ``upd``: per-layer update gates. CPU tensors take the plain version."""
    if h0.device.type == "cpu":
        return resid_fwd_plain(leaves, h0, xs, v0, upd, mask=mask)
    if not h0.is_cuda:
        raise ValueError(f"resid_fwd: unsupported device {h0.device}")
    if mask is not None:
        raise NotImplementedError("resid_fwd: the CUDA kernel takes no edge mask yet")
    dims = _dims(leaves, h0)
    B, N, F, H, R, K, C, depth = dims
    dev = h0.device
    _check_cuda("h0", h0, (B, N, F), dev)
    _check_cuda("xs", xs, (3, B, N), dev)
    _check_cuda("v0", v0, (3, B, N), dev)
    _check_leaves(leaves, dims, dev)
    if F != H or len(upd) != depth:
        raise ValueError("resid_fwd: needs hidden width == feature width and one gate per layer")
    lib = build.load()
    if lib.sake_resid_fwd_smem_bytes(*dims) > _SMEM_LIMIT:
        raise ValueError(f"resid_fwd: N={N} at these widths exceeds one block's shared memory")
    empty = lambda *s: torch.empty(s, device=dev, dtype=torch.float32)
    out = FwdOut(
        empty(depth, B, N, F), empty(depth, 3, B, N), empty(depth, 3, B, N),
        empty(B, N, F), empty(3, B, N), empty(3, B, N),
        {n: empty(*s) for n, s in _resid_shapes(dims, leaves).items()},
    )
    upd_t = torch.tensor(list(upd), dtype=torch.float32, device=dev)
    err = lib.sake_resid_fwd(
        h0.data_ptr(), xs.data_ptr(), v0.data_ptr(), upd_t.data_ptr(),
        _ptrs([leaves[n] for n in LEAF_NAMES]), _strides(leaves),
        out.bh.data_ptr(), out.bx.data_ptr(), out.bv.data_ptr(),
        out.h_fin.data_ptr(), out.x_fin.data_ptr(), out.v_fin.data_ptr(),
        _ptrs([out.resid[n] for n in RESIDS]),
        *dims, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "resid_fwd")
    resid_fwd.launches += 1
    return out


resid_fwd.launches = 0


def resid_bwd(leaves: dict, fwd: FwdOut, upd: Sequence[float], dh, dx, dv, mask=None,
              *, leaves_t: Optional[dict] = None):
    """K2: pullback of the layer stack from the cotangents of the final
    ``(h (B, N, F), x (3, B, N), v (3, B, N))`` to those of the initial
    state, reading K1's residuals. CPU tensors take the plain version.
    ``leaves_t``: ``leaves.transposed(leaves)``, built here when not given;
    pass it to build it once for several launches."""
    if dh.device.type == "cpu":
        return resid_bwd_plain(leaves, fwd, upd, dh, dx, dv, mask=mask)
    if not dh.is_cuda:
        raise ValueError(f"resid_bwd: unsupported device {dh.device}")
    if mask is not None:
        raise NotImplementedError("resid_bwd: the CUDA kernel takes no edge mask yet")
    dims = _dims(leaves, fwd.h_fin)
    B, N, F, H, R, K, C, depth = dims
    dev = dh.device
    _check_leaves(leaves, dims, dev)
    _check_cuda("bh", fwd.bh, (depth, B, N, F), dev)
    _check_cuda("bx", fwd.bx, (depth, 3, B, N), dev)
    _check_cuda("bv", fwd.bv, (depth, 3, B, N), dev)
    for n, s in _resid_shapes(dims, leaves).items():
        _check_cuda(n, fwd.resid[n], s, dev)
    _check_cuda("dh", dh, (B, N, F), dev)
    _check_cuda("dx", dx, (3, B, N), dev)
    _check_cuda("dv", dv, (3, B, N), dev)
    if F != H or len(upd) != depth:
        raise ValueError("resid_bwd: needs hidden width == feature width and one gate per layer")
    lib = build.load()
    if lib.sake_resid_bwd_smem_bytes(*dims) > _SMEM_LIMIT:
        raise ValueError(f"resid_bwd: N={N} at these widths exceeds one block's shared memory")
    if leaves_t is None:
        leaves_t = transposed(leaves)
    for name, shape in _leaf_shapes(F, H, R, K, C).items():
        _check_cuda(f"{name}.T", leaves_t[name], (depth, *shape[::-1]), dev)
    dh_out = torch.empty_like(dh)
    dx_out = torch.empty_like(dx)
    dv_out = torch.empty_like(dv)
    upd_t = torch.tensor(list(upd), dtype=torch.float32, device=dev)
    err = lib.sake_resid_bwd(
        fwd.bh.data_ptr(), fwd.bx.data_ptr(), fwd.bv.data_ptr(), upd_t.data_ptr(),
        _ptrs([leaves[n] for n in LEAF_NAMES]), _ptrs([leaves_t[n] for n in LEAF_NAMES]),
        _strides(leaves),
        _ptrs([fwd.resid[n] for n in RESIDS]),
        dh.data_ptr(), dx.data_ptr(), dv.data_ptr(),
        dh_out.data_ptr(), dx_out.data_ptr(), dv_out.data_ptr(),
        *dims, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "resid_bwd")
    resid_bwd.launches += 1
    return dh_out, dx_out, dv_out


resid_bwd.launches = 0


def _readout_seed(params: ModelParams, h_fin, node_mask):
    """Raw energy per molecule and its cotangent on ``h_fin``."""
    with torch.enable_grad():
        hf = h_fin.detach().requires_grad_(True)
        out = readout(params, hf)
        if node_mask is not None:
            out = out * node_mask[..., None]
        e = out.sum(dim=(-2, -1))
        (dh,) = torch.autograd.grad(e.sum(), hf)
    return e.detach(), dh.contiguous()


@torch.no_grad()
def resid_energy_forces(
    params: ModelParams,
    h: torch.Tensor,  # (B, N, F_in)
    x: torch.Tensor,  # (B, N, 3)
    mask: Optional[torch.Tensor] = None,  # (B, N, N) edge mask
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    chunk: Optional[int] = 512,
):
    """Raw (uncolored) ``E (B,)`` and ``F = -dE/dx (B, N, 3)`` through K1,
    the readout seed and K2. ``chunk`` bounds how many molecules' residuals
    are alive at once (f32: about 5.3 MB per aspirin molecule at depth 6)."""
    B = h.shape[0]
    upd = [1.0 if u else 0.0 for u in per_layer(update, len(params.layers))]
    leaves = wide_stack(params, n_heads)
    leaves_t = transposed(leaves) if x.is_cuda else None  # K2's layout, once per call
    h0 = embed(params, h.float())
    node_mask = torch.diagonal(mask, dim1=-2, dim2=-1) if mask is not None else None
    step = chunk or B
    es, fs = [], []
    for s in range(0, B, step):
        sl = slice(s, s + step)
        xs = x[sl].permute(2, 0, 1).float().contiguous()
        zeros = torch.zeros_like(xs)
        m4 = mask[sl][..., None] if mask is not None else None
        fwd = resid_fwd(leaves, h0[sl].contiguous(), xs, zeros, upd, mask=m4)
        e, dh_fin = _readout_seed(
            params, fwd.h_fin, node_mask[sl] if node_mask is not None else None
        )
        _, dx, _ = resid_bwd(leaves, fwd, upd, dh_fin, zeros, zeros, mask=m4,
                             leaves_t=leaves_t)
        es.append(e)
        fs.append(-dx.permute(1, 2, 0))
    return torch.cat(es), torch.cat(fs)
