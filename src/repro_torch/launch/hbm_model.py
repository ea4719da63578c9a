"""Analytic least HBM traffic of an (arch x shape) cell: the roofline's
memory term.

Torch counterpart of `repro.launch.hbm_model`, with its arithmetic over
the port's `config.py` and bundles. It counts the bytes a perfect
implementation must move per device in one step, not the bytes it must
hold, so it cannot say whether a cell fits a card:

  train   : params read (fwd + bwd + remat-fwd) + grad write/read + Adam
            m/v read + write, + each boundary activation written + read
            once, + flash K/V streamed S/q_chunk times, + the logits slab
  prefill : params read once + activations once + K/V streaming
  decode  : params read once + KV cache read once + one slot written
  gnn     : params + node features read per layer per edge-endpoint
            gather + messages written / read once
  recsys  : the encoder like a small LM + the vocab-shard logits slab

The mesh is read only through `.size` and `.shape` (a mapping of axis name
to size; "model" is the tensor-parallel axis, the rest data-parallel), as
the reference reads a jax Mesh: `launch.mesh.MeshShape` gives one. The
figure over `roofline.HW["hbm_bw"]` is a step's memory time on the card.
"""
from __future__ import annotations

from repro_torch.config import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES
from repro_torch.data.sampler import sampled_shape

__all__ = ["hbm_floor_bytes"]

_B16, _B32 = 2, 4


def _lm_floor(cfg, shape_id, n_dp, n_tp, chips):
    spec = LM_SHAPES[shape_id]
    kind, b, s = spec["kind"], spec["global_batch"], spec["seq_len"]
    p_dev32 = cfg.n_params() * _B32 / chips            # sharded f32 master
    d = cfg.d_model
    if kind == "decode":
        tok_dev = max(b // n_dp, 1)
        if cfg.attention == "mla":
            cache_row = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        else:
            cache_row = 2 * cfg.n_kv_heads * cfg.head_dim
        cache_dev = b * s * cache_row * cfg.n_layers * _B16 / chips * n_dp \
            if b >= n_dp else b * s * cache_row * cfg.n_layers * _B16 / chips
        # params for active experts only on the read path
        p_read = cfg.n_active_params() * _B16 / chips if cfg.moe_experts \
            else cfg.n_params() * _B16 / chips
        return p_read + cache_dev * 1.0 + tok_dev * d * _B16 * 8
    tok_dev = b * s // n_dp
    act = cfg.n_layers * tok_dev * d * _B16
    kv_dim = (cfg.n_kv_heads * cfg.head_dim if cfg.attention != "mla"
              else cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    kv_stream = (cfg.n_layers * 2 * tok_dev * kv_dim * _B16
                 * max(s // max(cfg.q_chunk, 1), 1))
    logits = tok_dev * (cfg.vocab // n_tp) * _B32 * 2
    if kind == "prefill":
        return cfg.n_params() * _B16 / chips + 6 * act + kv_stream + \
            tok_dev // s * (cfg.vocab // n_tp) * _B32
    # train: 3 param reads (fwd, bwd, remat) + grad w/r + m/v r/w ≈ 9 passes
    return 9 * p_dev32 + 14 * act + 3 * kv_stream + logits


def _gnn_floor(cfg, shape_id, n_dp):
    spec = GNN_SHAPES[shape_id]
    if spec["kind"] == "sampled":
        n, e = sampled_shape(spec["batch_nodes"], spec["fanout"])
    elif spec["kind"] == "batched":
        n = spec["batch"] * spec["n_nodes"]
        e = spec["batch"] * spec["n_edges"]
    else:
        n, e = spec["n_nodes"], spec["n_edges"]
    c = cfg.d_hidden
    if cfg.model == "equiformer_v2":
        c = c * (cfg.extra.get("l_max", 6) + 1) ** 2
    elif cfg.model == "nequip":
        c = c * (cfg.extra.get("l_max", 2) + 1) ** 2
    n_dev, e_dev = n / n_dp, e / n_dp
    per_layer = (2 * e_dev * c * _B32        # gather src + scatter msg
                 + 2 * n_dev * c * _B32)     # node read + write
    return cfg.n_layers * per_layer * 3      # fwd + bwd + remat-ish


def _recsys_floor(cfg, shape_id, n_dp, n_tp, chips):
    spec = RECSYS_SHAPES[shape_id]
    kind, b = spec["kind"], spec["batch"]
    d = cfg.embed_dim
    s = cfg.seq_len
    b_dev = max(b // n_dp, 1)
    enc = cfg.n_blocks * b_dev * s * d * _B32 * 10
    table_rows = b_dev * s * d * _B32            # gathered embeddings
    if kind == "train":
        m = max(int(s * 0.15 * 1.3), 4)
        logits = 3 * b_dev * m * (cfg.n_items // n_tp) * _B32
        table_opt = cfg.n_items * d * _B32 * 9 / chips
        return 3 * enc + table_rows + logits + table_opt
    if kind == "retrieval":
        n_cand = spec["n_candidates"]
        return enc + table_rows + n_cand * d * _B32 / n_tp
    logits = b_dev * (cfg.n_items // n_tp) * _B32
    return enc + table_rows + logits


def hbm_floor_bytes(bundle, shape_id: str, mesh) -> float:
    """The least HBM bytes one device moves in a step of `bundle`'s model
    at `shape_id`, on `mesh` (`.size` devices, `.shape["model"]` of them
    tensor-parallel)."""
    chips = mesh.size
    n_tp = mesh.shape.get("model", 1)
    n_dp = chips // n_tp
    cfg = bundle.cfg
    if bundle.family == "lm":
        return float(_lm_floor(cfg, shape_id, n_dp, n_tp, chips))
    if bundle.family == "gnn":
        return float(_gnn_floor(cfg, shape_id, n_dp))
    return float(_recsys_floor(cfg, shape_id, n_dp, n_tp, chips))
