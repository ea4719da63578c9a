"""Parameters of the JAX package's models as state dicts of the port's.

`lm_params_from_jax`: the LM.

The reference keeps each block's parameters stacked over layers under
`params["blocks"]` (leading axis L); the port keeps one module per layer
with the same names. `lm_params_from_jax` maps the one onto the other, so
both packages can run the same weights: the attention's leaves (GQA's
`attn.{wq,wk,wv,wo}`, MLA's `attn.{wdq,wuq,wdkv,wukv,wo}.w` and
`attn.{q_norm,kv_norm}.g`), the FFN's (SwiGLU's `ffn.{wi,wg,wo}.w`, a
MoE's `ffn.router.w` and its expert stacks `ffn.{wi,wg,wo}`, (L, E, ...)
in the reference) and an untied `head.w`.

`bert4rec_params_from_jax`: the BERT4Rec encoder, an LM tree of
`bert4rec_encoder_cfg(cfg)`. `gnn_params_from_jax`: a GNN's nested dicts
and lists (`layers`, `blocks`, an MLP's `layers`) as dotted paths, list i
as `<i>`, the names of the port's GNN modules.

Each takes the tree as numpy arrays (or anything `np.asarray` reads) and
imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import GNNConfig, LMConfig, RecsysConfig

__all__ = ["lm_params_from_jax", "bert4rec_params_from_jax",
           "gnn_params_from_jax"]


def _leaves(tree, prefix=""):
    items = (tree.items() if isinstance(tree, dict)
             else ((str(i), node) for i, node in enumerate(tree)))
    for key, node in items:
        if isinstance(node, (dict, list, tuple)):
            yield from _leaves(node, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", node


def lm_params_from_jax(tree: dict, cfg: LMConfig) -> dict:
    """The reference's `lm_init` tree → a state dict for `LM(cfg)`:
    `blocks.<path>` of shape (L, ...) becomes `blocks.<i>.<path>` for each
    layer i; every other leaf keeps its path. Raises ValueError when the
    stacked axis is not cfg.n_layers long."""
    out = {}
    for path, leaf in _leaves(tree):
        arr = np.asarray(leaf)
        if path.startswith("blocks."):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{path}: {arr.shape[0]} stacked layers, "
                                 f"config has {cfg.n_layers}")
            rest = path[len("blocks."):]
            for i in range(cfg.n_layers):
                out[f"blocks.{i}.{rest}"] = torch.tensor(arr[i])
        else:
            out[path] = torch.tensor(arr)
    return out


def bert4rec_params_from_jax(tree: dict, cfg: RecsysConfig) -> dict:
    """The reference's `bert4rec.init` tree → a state dict for the port's
    encoder (`models.bert4rec.init(cfg)`)."""
    from repro_torch.models.bert4rec import bert4rec_encoder_cfg
    return lm_params_from_jax(tree, bert4rec_encoder_cfg(cfg))


def gnn_params_from_jax(tree: dict, cfg: GNNConfig) -> dict:
    """The reference's GNN init tree → a state dict for the port's module of
    `cfg.model`: nested dicts and lists flattened into dotted paths. Raises
    ValueError when the tree's layer list is not cfg.n_layers long."""
    stack = "blocks" if cfg.model == "dimenet" else "layers"
    if len(tree[stack]) != cfg.n_layers:
        raise ValueError(f"{stack}: {len(tree[stack])} layers, config has "
                         f"{cfg.n_layers}")
    return {path: torch.tensor(np.asarray(leaf))
            for path, leaf in _leaves(tree)}
