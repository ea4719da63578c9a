"""Parameters of the JAX package's LM as a state dict of the port's `LM`.

The reference keeps each block's parameters stacked over layers under
`params["blocks"]` (leading axis L); the port keeps one module per layer
with the same names. `lm_params_from_jax` maps the one onto the other, so
both packages can run the same weights: the attention's leaves (GQA's
`attn.{wq,wk,wv,wo}`, MLA's `attn.{wdq,wuq,wdkv,wukv,wo}.w` and
`attn.{q_norm,kv_norm}.g`), the FFN's (SwiGLU's `ffn.{wi,wg,wo}.w`, a
MoE's `ffn.router.w` and its expert stacks `ffn.{wi,wg,wo}`, (L, E, ...)
in the reference) and an untied `head.w`. It takes the tree as numpy arrays
(or anything `np.asarray` reads) and imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import LMConfig

__all__ = ["lm_params_from_jax"]


def _leaves(tree, prefix=""):
    for key, node in tree.items():
        if isinstance(node, dict):
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
