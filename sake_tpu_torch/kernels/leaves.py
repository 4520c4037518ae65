"""The per-layer weight layout the resid_ef kernels read.

Port of ``sake_tpu/kernels/depthgrid_ef.py:100-143`` (``_LEAF_NAMES``,
``_split_layer``, ``wide_stack``) and ``sake_tpu/kernels/split_ef.py:83-98``
(``head_expansion_matrices``). Concatenated weights are split at their
segment boundaries and biases become ``(1, dim)`` rows, so each layer
crosses the kernel boundary as 29 2D leaves, stacked over depth.
"""

from __future__ import annotations

import torch

from sake_tpu_torch.kernels.functional import LayerParams, ModelParams

# Order of the per-layer leaves as they cross the kernel boundary.
LEAF_NAMES = (
    "w_in_j", "w_in_i", "b_in", "rbf_m", "rbf_b",
    "w_o_j", "w_o_i", "w_o_f", "w_o_r", "b_o0", "w_o1", "b_o1",
    "w_sem", "b_sem", "w_xmix",
    "w_post0", "b_post0", "w_post1", "b_post1",
    "w_node_h", "w_node_agg", "w_node_comb", "b_node0", "w_node1", "b_node1",
    "w_vmix", "w_vel0", "b_vel0", "w_vel1",
)


def split_layer(lp: LayerParams, F: int, n_heads: int) -> dict:
    """One ``LayerParams`` -> dict of the 29 kernel leaves."""
    e = lp.edge
    R = e.w_in.shape[-1]
    HK = e.w_out0.shape[-1] * n_heads
    return dict(
        w_in_j=e.w_in[:F], w_in_i=e.w_in[F:], b_in=e.b_in[None],
        rbf_m=e.rbf_means[None], rbf_b=e.rbf_betas[None],
        w_o_j=e.w_out0[:F], w_o_i=e.w_out0[F : 2 * F],
        w_o_f=e.w_out0[2 * F : 2 * F + R],
        w_o_r=e.w_out0[2 * F + R][None], b_o0=e.b_out0[None],
        w_o1=e.w_out1, b_o1=e.b_out1[None],
        w_sem=lp.w_sem, b_sem=lp.b_sem[None], w_xmix=lp.w_xmix,
        w_post0=lp.w_post0, b_post0=lp.b_post0[None],
        w_post1=lp.w_post1, b_post1=lp.b_post1[None],
        w_node_h=lp.w_node0[:F], w_node_agg=lp.w_node0[F : F + HK],
        w_node_comb=lp.w_node0[F + HK :], b_node0=lp.b_node0[None],
        w_node1=lp.w_node1, b_node1=lp.b_node1[None],
        w_vmix=lp.w_vmix, w_vel0=lp.w_vel0, b_vel0=lp.b_vel0[None],
        w_vel1=lp.w_vel1,
    )


def wide_stack(params: ModelParams, n_heads: int) -> dict:
    """``{name: (depth, rows, cols)}`` contiguous f32 stacks, in
    ``LEAF_NAMES`` order."""
    F = params.w_embed.shape[-1]
    per_layer = [split_layer(lp, F, n_heads) for lp in params.layers]
    return {
        name: torch.stack([d[name] for d in per_layer]).float().contiguous()
        for name in LEAF_NAMES
    }


def transposed(leaves: dict) -> dict:
    """``{name: (depth, cols, rows)}`` contiguous copies of a ``wide_stack``:
    the K2 kernel reads them for its products against ``W.T``."""
    return {name: a.transpose(1, 2).contiguous() for name, a in leaves.items()}


def layer_leaves(leaves: dict, layer: int) -> dict:
    """One layer's 2D leaves out of a ``wide_stack``."""
    return {name: a[layer] for name, a in leaves.items()}


def head_expansion_matrices(H: int, K: int, device=None):
    """0/1 matrices with ``E_rep[h, h*K+k] = 1`` and ``E_tile[k, h*K+k] = 1``,
    so ``(h_e @ E_rep) * (att @ E_tile)`` is the hidden-major / head-minor
    outer product. The port computes that product by broadcasting (and the
    CUDA kernels by indexing ``h*K + k``); these matrices document the
    layout and let a test tie it to the JAX package's."""
    e_rep = torch.zeros(H, H * K, device=device)
    e_tile = torch.zeros(K, H * K, device=device)
    for h in range(H):
        for k in range(K):
            e_rep[h, h * K + k] = 1.0
            e_tile[k, h * K + k] = 1.0
    return e_rep, e_tile
