"""Config dataclasses of the three model families and their shape
registries.

Copies of the JAX package's `config.py` (pure dataclasses; the port
imports nothing of that package): `GNNConfig`, `RecsysConfig`,
`GNN_SHAPES` and `RECSYS_SHAPES` exactly, and `LMConfig` with the fields
that the decode, prefill and train paths and `n_params` read, with the
reference's defaults, the MoE dispatch knobs (`moe_group`, the dispatch
group of prefill and training; `moe_pad_to`, dead expert slots) among
them, and `seq_parallel`, which the sharding policy reads. The LM
config has no `unroll`: the reference unrolls its layer scan only for
the dry run's cost analysis, and the port's dry run traces eager layers
at full depth. Every architecture has a module in
`repro_torch/configs/` with `config()` (the published hyperparameters)
and `reduced()` (a tiny same-family config for CPU tests);
`configs/registry.py` resolves `--arch`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["LMConfig", "GNNConfig", "RecsysConfig", "LM_SHAPES", "GNN_SHAPES",
           "RECSYS_SHAPES"]


@dataclasses.dataclass
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    attention: str = "gqa"           # "gqa" | "mla"
    qkv_bias: bool = False
    rope_frac: float = 1.0           # chatglm3 '2d rope' = 0.5
    max_seq: int = 524_288
    moe_experts: int = 0
    moe_top_k: int = 0
    tie_embeddings: bool = False
    remat: bool = True               # checkpoint each block in the backward
    grad_accum: int = 1              # microbatches per train step
    loss_chunk: int = 1024           # sequence chunking of the CE loss
    cp_degree: int = 0               # context-parallel attention blocks
    q_chunk: int = 512               # flash_attention query block
    k_chunk: int = 1024              # flash_attention key block
    moe_group: int = 512             # MoE dispatch group size
    moe_pad_to: int = 0              # pad expert count (EP divisibility)
    seq_parallel: bool = False       # S-sharded residual stream (Megatron-SP)
    # MLA fields
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    family: str = "lm"

    def n_params(self) -> int:
        """Total parameter count (for 6·N·D roofline bookkeeping)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        if self.attention == "mla":
            attn = (d * self.q_lora_rank
                    + self.q_lora_rank * self.n_heads
                    * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_head_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        else:
            attn = (d * self.n_heads * self.head_dim
                    + 2 * d * self.n_kv_heads * self.head_dim
                    + self.n_heads * self.head_dim * d)
        if self.moe_experts:
            ffn = self.moe_experts * 3 * d * f + d * self.moe_experts
        else:
            ffn = 3 * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn + 2 * d) + emb + d

    def n_active_params(self) -> int:
        """Active per-token params (MoE: top-k experts only)."""
        if not self.moe_experts:
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        dense_total = self.n_params() - L * self.moe_experts * 3 * d * f
        return dense_total + L * self.moe_top_k * 3 * d * f


@dataclasses.dataclass
class GNNConfig:
    name: str
    model: str                        # gatedgcn | nequip | equiformer_v2 | dimenet
    n_layers: int
    d_hidden: int
    extra: dict = dataclasses.field(default_factory=dict)
    family: str = "gnn"


@dataclasses.dataclass
class RecsysConfig:
    name: str
    embed_dim: int
    n_blocks: int
    n_heads: int
    seq_len: int
    n_items: int
    unroll: bool = False
    q_chunk: int = 128
    k_chunk: int = 256
    batch_chunk: int = 256           # cloze CE batch chunking
    family: str = "recsys"


# (shape_id → spec) per family
LM_SHAPES: dict[str, dict[str, Any]] = {
    "train_4k":    {"kind": "train",   "seq_len": 4096,    "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32_768,  "global_batch": 32},
    "decode_32k":  {"kind": "decode",  "seq_len": 32_768,  "global_batch": 128},
    "long_500k":   {"kind": "decode",  "seq_len": 524_288, "global_batch": 1},
}

GNN_SHAPES: dict[str, dict[str, Any]] = {
    "full_graph_sm": {"kind": "full",  "n_nodes": 2_708, "n_edges": 10_556,
                      "d_feat": 1_433},
    "minibatch_lg":  {"kind": "sampled", "n_nodes": 232_965,
                      "n_edges": 114_615_892, "batch_nodes": 1_024,
                      "fanout": (15, 10)},
    "ogb_products":  {"kind": "full", "n_nodes": 2_449_029,
                      "n_edges": 61_859_140, "d_feat": 100},
    "molecule":      {"kind": "batched", "n_nodes": 30, "n_edges": 64,
                      "batch": 128},
}

RECSYS_SHAPES: dict[str, dict[str, Any]] = {
    "train_batch":    {"kind": "train", "batch": 65_536},
    "serve_p99":      {"kind": "serve", "batch": 512},
    "serve_bulk":     {"kind": "serve", "batch": 262_144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}
