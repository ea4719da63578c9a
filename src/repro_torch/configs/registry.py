"""Architecture registry of the port: `--arch <id>` resolution for all ten
architectures of the JAX package's registry, in its order: five LMs,
four GNNs and bert4rec."""
from __future__ import annotations

from repro_torch.config import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES
from . import (bert4rec, chatglm3_6b, gnn_archs, granite_moe_3b_a800m,
               minicpm3_4b, qwen2_1_5b, qwen3_moe_30b_a3b)

__all__ = ["ARCHS", "get_config", "shapes_for", "arch_ids"]

ARCHS = {
    "qwen2-1.5b": (qwen2_1_5b.config, qwen2_1_5b.reduced),
    "chatglm3-6b": (chatglm3_6b.config, chatglm3_6b.reduced),
    "minicpm3-4b": (minicpm3_4b.config, minicpm3_4b.reduced),
    "qwen3-moe-30b-a3b": (qwen3_moe_30b_a3b.config, qwen3_moe_30b_a3b.reduced),
    "granite-moe-3b-a800m": (granite_moe_3b_a800m.config,
                             granite_moe_3b_a800m.reduced),
    "equiformer-v2": (gnn_archs.equiformer_v2, gnn_archs.equiformer_v2_reduced),
    "nequip": (gnn_archs.nequip, gnn_archs.nequip_reduced),
    "gatedgcn": (gnn_archs.gatedgcn, gnn_archs.gatedgcn_reduced),
    "dimenet": (gnn_archs.dimenet, gnn_archs.dimenet_reduced),
    "bert4rec": (bert4rec.config, bert4rec.reduced),
}


def arch_ids() -> list[str]:
    return list(ARCHS)


def get_config(arch: str, *, reduced: bool = False):
    """The config of `arch` (an LMConfig, GNNConfig or RecsysConfig), its
    reduced same-family config with `reduced`."""
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    full, red = ARCHS[arch]
    return red() if reduced else full()


def shapes_for(arch: str) -> dict:
    """The shape registry of `arch`'s family (KeyError for an unknown
    id)."""
    cfg = get_config(arch)
    if cfg.family == "lm":
        return LM_SHAPES
    if cfg.family == "gnn":
        return GNN_SHAPES
    return RECSYS_SHAPES
