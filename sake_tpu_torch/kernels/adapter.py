"""Weights crossing over from the JAX package.

Port of ``sake_tpu/kernels/adapter.py``. The linen tree arrives as nested
dicts of numpy arrays (``jax.device_get`` / ``np.asarray`` on the JAX
side) or of torch tensors (:func:`linen_tree` of a port module, whose
parameter names mirror the linen tree); nothing here imports JAX. Layers without an update head get zero
placeholders for ``w_vmix``/``w_vel0``/``b_vel0``/``w_vel1``, as in the
JAX adapter. ``log_gamma`` is not carried: the dense forward never reads it.
"""

from __future__ import annotations

import numpy as np
import torch

from sake_tpu_torch.kernels.functional import CFConvParams, LayerParams, ModelParams


def _t(a, device):
    """A fresh f32 leaf tensor with the values of ``a`` (numpy or torch)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32).clone()
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def layer_params_from_linen(lp, device=None) -> LayerParams:
    """Convert one ``DenseSAKELayer`` linen subtree."""
    t = lambda a: _t(a, device)
    edge = lp["edge_model"]
    cf = CFConvParams(
        w_in=t(edge["mlp_in"]["kernel"]),
        b_in=t(edge["mlp_in"]["bias"]),
        rbf_means=t(edge["kernel"]["means"]),
        rbf_betas=t(edge["kernel"]["betas"]),
        w_out0=t(edge["mlp_out"]["dense_0"]["kernel"]),
        b_out0=t(edge["mlp_out"]["dense_0"]["bias"]),
        w_out1=t(edge["mlp_out"]["dense_1"]["kernel"]),
        b_out1=t(edge["mlp_out"]["dense_1"]["bias"]),
    )
    hidden = cf.w_out1.shape[-1]
    n_coeff = lp["x_mixing"]["kernel"].shape[-1]
    f_out = lp["node_mlp"]["dense_1"]["kernel"].shape[-1]
    zeros = lambda *s: torch.zeros(s, device=device)
    # velocity_mlp_* exist only on update layers that receive a velocity:
    # flax creates them at first use, and the first update layer sees v=None
    has_update = "v_mixing" in lp
    has_vel = "velocity_mlp_hidden" in lp
    return LayerParams(
        edge=cf,
        w_sem=t(lp["semantic_mlp"]["kernel"]),
        b_sem=t(lp["semantic_mlp"]["bias"]),
        w_xmix=t(lp["x_mixing"]["kernel"]),
        w_post0=t(lp["post_norm_mlp"]["dense_0"]["kernel"]),
        b_post0=t(lp["post_norm_mlp"]["dense_0"]["bias"]),
        w_post1=t(lp["post_norm_mlp"]["dense_1"]["kernel"]),
        b_post1=t(lp["post_norm_mlp"]["dense_1"]["bias"]),
        w_node0=t(lp["node_mlp"]["dense_0"]["kernel"]),
        b_node0=t(lp["node_mlp"]["dense_0"]["bias"]),
        w_node1=t(lp["node_mlp"]["dense_1"]["kernel"]),
        b_node1=t(lp["node_mlp"]["dense_1"]["bias"]),
        w_vmix=t(lp["v_mixing"]["kernel"]) if has_update else zeros(n_coeff, 1),
        w_vel0=(t(lp["velocity_mlp_hidden"]["kernel"]) if has_vel
                else zeros(f_out, hidden)),
        b_vel0=(t(lp["velocity_mlp_hidden"]["bias"]) if has_vel
                else zeros(hidden)),
        w_vel1=(t(lp["velocity_mlp_out"]["kernel"]) if has_vel
                else zeros(hidden, 1)),
    )


def model_params_from_linen(params, device=None) -> ModelParams:
    """Convert a ``SAKEModel`` linen tree of numpy arrays
    (``{"params": {...}}`` or the inner dict) to torch ``ModelParams``."""
    tree = params.get("params", params)
    n_layers = sum(1 for k in tree if k.startswith("layer_"))
    t = lambda a: _t(a, device)
    return ModelParams(
        w_embed=t(tree["embedding_in"]["kernel"]),
        b_embed=t(tree["embedding_in"]["bias"]),
        layers=tuple(
            layer_params_from_linen(tree[f"layer_{i}"], device)
            for i in range(n_layers)
        ),
        w_out0=t(tree["embedding_out"]["dense_0"]["kernel"]),
        b_out0=t(tree["embedding_out"]["dense_0"]["bias"]),
        w_out1=t(tree["embedding_out"]["dense_1"]["kernel"]),
        b_out1=t(tree["embedding_out"]["dense_1"]["bias"]),
    )


def kernel_params_from_linen(params, device=None) -> dict:
    """A ``QM9Model`` linen tree (``backbone`` + ``head``) -> the kernel
    backbone's training parameters ``{"kp": ModelParams, "head": {"dense_i":
    {"kernel", "bias"}}}`` (JAX ``tasks/qm9.py:156-159``); ``"head"`` is
    None for a head without its MLP."""
    tree = params.get("params", params)
    mlp = tree.get("head", {}).get("head")
    head = None if mlp is None else {
        name: {leaf: _t(a, device) for leaf, a in dense.items()} for name, dense in mlp.items()
    }
    return {"kp": model_params_from_linen(tree["backbone"], device), "head": head}


def linen_tree(module: torch.nn.Module) -> dict:
    """A module's parameters as the nested dict of their linen names
    (``layer_0.edge_model.mlp_in.kernel`` -> ``tree["layer_0"]["edge_model"]
    ["mlp_in"]["kernel"]``), sharing the module's tensors."""
    tree = {}
    for name, prm in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = prm
    return tree


def params_from_jax(mp, device=None) -> ModelParams:
    """A JAX ``ModelParams`` whose leaves are numpy arrays -> torch
    ``ModelParams`` (field names and order are the same in both packages)."""
    t = lambda a: _t(a, device)
    layers = tuple(
        LayerParams(
            edge=CFConvParams(*(t(a) for a in lp.edge)),
            **{k: t(getattr(lp, k)) for k in LayerParams._fields if k != "edge"},
        )
        for lp in mp.layers
    )
    return ModelParams(
        layers=layers,
        **{k: t(getattr(mp, k)) for k in ModelParams._fields if k != "layers"},
    )


def load_linen_params(module: torch.nn.Module, params) -> None:
    """Copy a linen tree of numpy arrays or tensors into a module whose
    parameter names mirror the linen tree (``layer_0.edge_model.mlp_in.kernel``
    <-> ``tree["layer_0"]["edge_model"]["mlp_in"]["kernel"]``). Every module
    parameter must be present in the tree, with the same shape, and every
    leaf of the tree must be a module parameter (a leaf the module lacks,
    such as a velocity gate of a model initialised with a ``v``, raises)."""
    tree = params.get("params", params)
    names = {name for name, _ in module.named_parameters()}

    def leaves(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield ".".join(path + (k,))

    extra = sorted(set(leaves(tree, ())) - names)
    if extra:
        raise ValueError(f"linen leaves the module lacks: {', '.join(extra)}")
    with torch.no_grad():
        for name, prm in module.named_parameters():
            node = tree
            for part in name.split("."):
                node = node[part]
            src = _t(node, prm.device)
            if tuple(src.shape) != tuple(prm.shape):
                raise ValueError(f"{name}: linen {tuple(src.shape)} vs module {tuple(prm.shape)}")
            prm.copy_(src)
