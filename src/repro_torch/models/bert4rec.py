"""BERT4Rec [arXiv:1904.06690]: a bidirectional transformer over user item
sequences, cloze (masked-item) training, and dot-product scoring against
the item table (tied to the input embedding).

    model = init(cfg, seed=0, device="cpu")
    loss, metrics = cloze_loss(model, batch, cfg)       # differentiable
    vals, idx = score_next(model, ids, cfg)             # top-10 items
    scores = score_candidates(model, ids, candidate_ids, cfg)

The item table is the hot object (n_items = 10⁶ at full size): the loss
takes logits only at the M ≪ S masked positions, in batch chunks of
`cfg.batch_chunk` rows, each under checkpoint when gradients are on (the
reference's `jax.checkpoint` under `scan`), so one (chunk · M, n_items)
float32 slab is live at a time. Its gold logit is `core.gold_logit`. Under
a mesh the logits are placed by the reference's `logits_btv`, `logits_bv`
and `parts_bpv` rules. `score_next` scores the last position against the
whole table in one product and takes its top-k with `iterative_top_k`: k
passes of (max, mask), a tie going to the lower item, as `jax.lax.top_k`
orders them (`torch.topk` promises no order among ties).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.config import LMConfig, RecsysConfig
from repro_torch.distributed.sharding import constrain, current_rules, full
from repro_torch.nn import core, transformer as T

__all__ = ["bert4rec_encoder_cfg", "init", "cloze_loss", "iterative_top_k",
           "two_stage_top_k", "score_next", "score_candidates"]

MASK_ID = 0   # item id 0 reserved as [MASK]; real items are 1..n_items-1


def bert4rec_encoder_cfg(cfg: RecsysConfig) -> LMConfig:
    d = cfg.embed_dim
    return LMConfig(name=cfg.name + "-enc", n_layers=cfg.n_blocks, d_model=d,
                    n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
                    head_dim=d // cfg.n_heads, d_ff=4 * d,
                    vocab=cfg.n_items, tie_embeddings=True,
                    max_seq=cfg.seq_len, q_chunk=cfg.q_chunk,
                    k_chunk=cfg.k_chunk, rope_frac=1.0, remat=False)


def init(cfg: RecsysConfig, *, seed: int = 0, device,
         dtype=torch.float32) -> T.LM:
    """The encoder (an `LM` with tied embeddings) with weights drawn from a
    torch.Generator seeded with `seed` on `device`."""
    return T.lm_init(bert4rec_encoder_cfg(cfg), seed=seed, device=device,
                     dtype=dtype)


def _encode(model: T.LM, ids: torch.Tensor, dtype) -> torch.Tensor:
    return T.encoder_forward(model, ids, dtype=dtype)


def _cloze_chunk(table: torch.Tensor, hc: torch.Tensor, tc: torch.Tensor,
                 vc: torch.Tensor) -> torch.Tensor:
    """Summed cross entropy of one batch chunk's valid masked positions,
    from float32 logits."""
    logits = constrain(hc @ table.to(hc.dtype).T, "logits_btv").float()
    nll = torch.logsumexp(logits, dim=-1) - core.gold_logit(logits, tc)
    return torch.where(vc, nll, torch.zeros_like(nll)).sum()


def cloze_loss(model: T.LM, batch: dict, cfg: RecsysConfig, *,
               dtype=torch.float32, batch_chunk: int | None = None):
    """batch: {ids (B,S), mask_idx (B,M), mask_targets (B,M), mask_valid
    (B,M)}, masked positions carrying item 0 ([MASK]). The mean cross
    entropy over the valid masked positions; returns (loss, {"nll"})."""
    h = _encode(model, batch["ids"], dtype)
    idx = batch["mask_idx"].long()
    hm = h.gather(1, idx[..., None].expand(*idx.shape, h.shape[-1]))
    b = hm.shape[0]
    ck = min(batch_chunk or cfg.batch_chunk, b)
    table = model.embed.table
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, b, ck):
        args = (table, hm[c0:c0 + ck], batch["mask_targets"][c0:c0 + ck],
                batch["mask_valid"][c0:c0 + ck])
        if torch.is_grad_enabled():
            total = total + checkpoint(_cloze_chunk, *args,
                                       use_reentrant=False)
        else:
            total = total + _cloze_chunk(*args)
    loss = total / torch.clamp(batch["mask_valid"].sum(), min=1)
    return loss, {"nll": loss}


def iterative_top_k(x: torch.Tensor, k: int):
    """(values, indices int32) of the k largest entries along the last
    axis, descending, a tie going to the lower index: k passes of (max,
    mask the taken entry with -inf) over a copy of x, as the reference's
    `iterative_top_k` (and `jax.lax.top_k`) order them; `torch.max` over a
    dimension returns the first maximal index."""
    x = x.clone()
    vals, idxs = [], []
    for _ in range(k):
        v, i = torch.max(x, dim=-1)
        vals.append(v)
        idxs.append(i.to(torch.int32))
        x.scatter_(-1, i[..., None], -torch.inf)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def two_stage_top_k(scores: torch.Tensor, k: int, n_parts: int):
    """top-k over a score matrix split into `n_parts` vocab parts: each
    part's local top-k, then a (B, parts·k) merge; the same result as one
    global top-k (`iterative_top_k` when n_parts <= 1 or does not divide
    the vocab)."""
    b, v = scores.shape
    if n_parts <= 1 or v % n_parts:
        return iterative_top_k(full(scores), k)
    if isinstance(scores, DTensor):
        return _sharded_top_k(constrain(scores.reshape(b, n_parts,
                                                       v // n_parts),
                                        "parts_bpv"), k)
    lv, li = iterative_top_k(scores.reshape(b, n_parts, v // n_parts), k)
    return _merge_parts(lv, li, v // n_parts, k)


def _merge_parts(lv, li, part: int, k: int):
    """The top-k of parts' local top-k (B, n, k), part i holding items
    [i·part, (i + 1)·part)."""
    b, n, _ = lv.shape
    gi = (torch.arange(n, dtype=li.dtype, device=li.device)[None, :, None]
          * part + li).reshape(b, n * k)
    fv, fi = iterative_top_k(lv.reshape(b, n * k), k)
    return fv, gi.gather(1, fi.long())


def _sharded_top_k(sh: DTensor, k: int):
    """`two_stage_top_k` on a (B, parts, V / parts) DTensor: each rank's
    parts' top-k on its own shard (as GSPMD partitions the reference's
    reshape), the (B, parts, k) values and indices all-gathered, and the
    merge; plain (values, indices) of the whole batch."""
    from torch.distributed.tensor import Replicate
    mesh, pl = sh.device_mesh, list(sh.placements)
    lv, li = iterative_top_k(sh.to_local(), k)
    lv, li = (DTensor.from_local(t, mesh, pl, run_check=False)
              .redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
              for t in (lv, li))
    return _merge_parts(lv, li, sh.shape[2], k)


@torch.no_grad()
def score_next(model: T.LM, ids: torch.Tensor, cfg: RecsysConfig, *,
               dtype=torch.float32, top_k: int = 10,
               n_parts: int | None = None):
    """Online inference: the last position's hidden state against the whole
    item table, (values, indices) of its top_k items. `n_parts` None takes
    the `model` axis of the current sharding context as the reference does
    (one part without a mesh); on a mesh each rank's top-k runs on its own
    vocab shard and the result is the whole batch's, plain."""
    h = _encode(model, ids, dtype)[:, -1]
    scores = constrain(h @ model.embed.table.to(h.dtype).T, "logits_bv")
    if n_parts is None:
        ctx = current_rules()
        n_parts = 1 if ctx is None else dict(zip(
            ctx[0].mesh_dim_names, ctx[0].shape)).get("model", 1)
    return two_stage_top_k(scores, top_k, n_parts)


@torch.no_grad()
def score_candidates(model: T.LM, ids: torch.Tensor,
                     candidate_ids: torch.Tensor, cfg: RecsysConfig, *,
                     dtype=torch.float32) -> torch.Tensor:
    """Retrieval scoring: (B,S) histories × (N_cand,) candidates →
    (B, N_cand), one product against the gathered candidate embeddings."""
    h = _encode(model, ids, dtype)[:, -1]
    cand = core.embed(model.embed, candidate_ids, dtype=h.dtype)
    return h @ cand.T
