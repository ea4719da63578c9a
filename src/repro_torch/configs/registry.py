"""Architecture registry of the port: `--arch <id>` resolution.

The five LM architectures of the JAX package's registry, in its order.
Its GNN and recsys ids (equiformer-v2, nequip, gatedgcn, dimenet,
bert4rec) wait for the slices that ROADMAP.md (Queue 1) lists."""
from __future__ import annotations

from repro_torch.config import LM_SHAPES, LMConfig
from . import (chatglm3_6b, granite_moe_3b_a800m, minicpm3_4b, qwen2_1_5b,
               qwen3_moe_30b_a3b)

__all__ = ["ARCHS", "get_config", "shapes_for", "arch_ids"]

ARCHS = {
    "qwen2-1.5b": (qwen2_1_5b.config, qwen2_1_5b.reduced),
    "chatglm3-6b": (chatglm3_6b.config, chatglm3_6b.reduced),
    "minicpm3-4b": (minicpm3_4b.config, minicpm3_4b.reduced),
    "qwen3-moe-30b-a3b": (qwen3_moe_30b_a3b.config, qwen3_moe_30b_a3b.reduced),
    "granite-moe-3b-a800m": (granite_moe_3b_a800m.config,
                             granite_moe_3b_a800m.reduced),
}


def arch_ids() -> list[str]:
    return list(ARCHS)


def get_config(arch: str, *, reduced: bool = False) -> LMConfig:
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported yet (ported: "
                       f"{sorted(ARCHS)}); ROADMAP.md Queue 1 lists what "
                       "remains")
    full, red = ARCHS[arch]
    return red() if reduced else full()


def shapes_for(arch: str) -> dict:
    """The shape registry of `arch`'s family: LM_SHAPES for every id here
    (KeyError for an id that is not)."""
    get_config(arch)
    return LM_SHAPES
