"""Decoder-only transformer: pre-norm blocks in a `ModuleList` (the
reference scans over stacked layer parameters), GQA (with partial rotary)
or MLA attention, a SwiGLU or MoE FFN, and the LM head (tied to the
embedding, or a `head` Dense); the forward pass, the chunked next-token
loss (+ 0.01 · the MoE aux loss), prefill logits and the decode step; and
the bidirectional encoder of the same stack (`encoder_forward`, BERT4Rec).

    model = lm_init(cfg, seed=0, device="cpu")
    loss, metrics = lm_loss(model, tokens)        # differentiable
    logits = lm_prefill_logits(model, tokens)     # (B, 1, V)
    caches = lm_init_caches(cfg, batch, max_len, device="cpu")
    logits, caches = lm_decode_step(model, token, caches, lengths)

With `cfg.remat` each block runs under `torch.utils.checkpoint` when
gradients are on (the reference's `jax.checkpoint`); prefill and decode
run under `torch.no_grad()`.

Caches are stacked over layers, as the reference stacks them: GQA's
{"k", "v"} each (L, B, S, Hkv, D), MLA's {"c_kv" (L, B, S, kv_lora_rank),
"k_rope" (L, B, S, qk_rope_head_dim)}; layer i reads and writes the
contiguous view [i]. A MoE block routes prefill and training in groups of
`cfg.moe_group` positions and a decode step over the batch, in groups of
the reference's default 512 rows (`nn/moe.py`).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import LMConfig
from repro_torch.distributed.sharding import (P, constrain, current_rules,
                                             divides, to_placements)
from . import attention as attn
from . import core
from .moe import MoE, moe_ffn

__all__ = ["Block", "LM", "lm_init", "lm_forward", "lm_loss",
           "lm_prefill_logits", "lm_init_caches", "lm_decode_step",
           "encoder_forward"]


class Block(nn.Module):
    """ln1, attn (GQA or MLA), ln2, ffn (SwiGLU or MoE): the reference's
    `_block_init`."""

    def __init__(self, cfg: LMConfig, *, gen: torch.Generator, device,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.ln1 = core.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.ln2 = core.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        if cfg.attention == "mla":
            self.attn = attn.MLA(cfg, **kw)
        else:
            self.attn = attn.GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, qkv_bias=cfg.qkv_bias,
                                 rope_frac=cfg.rope_frac, **kw)
        if cfg.moe_experts:
            self.ffn = MoE(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                           pad_to=cfg.moe_pad_to, **kw)
        else:
            self.ffn = core.SwiGLU(cfg.d_model, cfg.d_ff, **kw)


class LM(nn.Module):
    """Parameters: embed.table, blocks.{i}.{ln1,ln2,attn,ffn}, ln_f.g and,
    when the embeddings are not tied, head.w — the reference's tree
    paths."""

    def __init__(self, cfg: LMConfig, *, gen: torch.Generator, device,
                 dtype=torch.float32, place=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.embed = core.Embedding(cfg.vocab, cfg.d_model, **kw)
        place = place or (lambda blk: blk)
        self.blocks = nn.ModuleList(place(Block(cfg, **kw))
                                    for _ in range(cfg.n_layers))
        self.ln_f = core.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.head = (None if cfg.tie_embeddings
                     else core.Dense(cfg.d_model, cfg.vocab, **kw))


def lm_init(cfg: LMConfig, *, seed: int = 0, device,
            dtype=torch.float32, place=None) -> LM:
    """A model with weights drawn from a torch.Generator seeded with `seed`
    on `device`, stored in `dtype`. The reference casts each weight to the
    activation dtype at every use, so weights stored in that dtype give
    the same numbers. `place(block)`, when given, is applied to each block
    as soon as it is drawn (placing its parameters on a mesh, so that no
    card holds the whole model at once)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return LM(cfg, gen=gen, device=device, dtype=dtype,
                  place=place).eval()


def lm_init_caches(cfg: LMConfig, batch: int, max_len: int, *,
                   dtype=torch.bfloat16, device) -> dict:
    """Zero caches stacked over layers: GQA {"k", "v"} (L, B, S, Hkv, D);
    MLA {"c_kv" (L, B, S, r), "k_rope" (L, B, S, dr)}.

    Under a sharding context with a `cache_bsnd` (GQA) or `mla_cache`
    (MLA) rule that divides the cache, the caches are DTensors placed by
    it, each rank allocating its own block only. The reference constrains
    the cache after each functional write; here the cache is written in
    place, so it is placed once, when it is made. An MLA cache keeps the
    rule's batch entry only (its rows split over data, S whole), and its
    decode stays the plain step on each rank's rows."""
    if cfg.attention == "mla":
        one = {"c_kv": cfg.kv_lora_rank, "k_rope": cfg.qk_rope_head_dim}
        shapes = {name: (cfg.n_layers, batch, max_len, width)
                  for name, width in one.items()}
        rule = _cache_rule("mla_cache", keep_seq=False)
    else:
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        shapes = {"k": shape, "v": shape}
        rule = _cache_rule("cache_bsnd", keep_seq=True)
    return {name: _zeros(shp, rule, dtype, device)
            for name, shp in shapes.items()}


def _cache_rule(name: str, *, keep_seq: bool):
    """(mesh, the spec of a layer-stacked cache) from the current sharding
    context's rule `name`, or None."""
    ctx = current_rules()
    if ctx is None or ctx[1].get(name) is None:
        return None
    mesh, rules = ctx
    spec = tuple(rules[name])
    if not keep_seq:
        spec = spec[:1] + (None,) * (len(spec) - 1)
    return mesh, P(None, *spec)


def _zeros(shape, rule, dtype, device):
    if rule is not None:
        mesh, spec = rule
        if divides(shape, spec, mesh):
            from torch.distributed.tensor import zeros
            return zeros(shape, dtype=dtype, device_mesh=mesh,
                         placements=to_placements(spec, mesh))
    return torch.zeros(shape, dtype=dtype, device=device)


def _logits(model: LM, h: torch.Tensor) -> torch.Tensor:
    if model.head is None:
        out = h @ model.embed.table.to(h.dtype).T
    else:
        out = core.dense(model.head, h)
    return constrain(out, "logits_btv")


def _ffn(blk: Block, cfg: LMConfig, y: torch.Tensor, **moe_kw):
    """The block's FFN output and its aux loss (None for a dense FFN)."""
    if cfg.moe_experts:
        return moe_ffn(blk.ffn, y, n_experts=cfg.moe_experts,
                       top_k=cfg.moe_top_k, **moe_kw)
    return core.swiglu(blk.ffn, y), None


def _block_apply(blk: Block, cfg: LMConfig, x: torch.Tensor):
    y = core.rmsnorm(blk.ln1, x)
    # GQA takes cfg.cp_degree (cp_attention); MLA, as the reference's,
    # has no context-parallel form
    cp = {} if cfg.attention == "mla" else {"cp_degree": cfg.cp_degree}
    x = x + blk.attn(y, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk, **cp)
    x = constrain(x, "act_btd")
    y = core.rmsnorm(blk.ln2, x)
    f, aux = _ffn(blk, cfg, y, group_size=cfg.moe_group)
    return constrain(x + f, "act_btd"), aux


def lm_forward(model: LM, tokens: torch.Tensor, *, dtype=torch.bfloat16):
    """tokens (B, S) → hidden (B, S, d_model) in `dtype`, aux loss (float32:
    the sum of the MoE blocks' Switch losses, zero for dense blocks)."""
    cfg = model.cfg
    x = constrain(core.embed(model.embed, tokens, dtype=dtype), "act_btd")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in model.blocks:
        if remat:
            x, a = checkpoint(_block_apply, blk, cfg, x, use_reentrant=False)
        else:
            x, a = _block_apply(blk, cfg, x)
        if a is not None:
            aux = aux + a
    return core.rmsnorm(model.ln_f, x), aux


def _ce_chunk(model: LM, h: torch.Tensor, targets: torch.Tensor):
    """Summed cross entropy of one sequence chunk, from float32 logits
    (the gold logit by `core.gold_logit`)."""
    logits = _logits(model, h).float()
    return (torch.logsumexp(logits, dim=-1)
            - core.gold_logit(logits, targets)).sum()


def lm_loss(model: LM, tokens: torch.Tensor, *, dtype=torch.bfloat16):
    """Next-token cross entropy (+ 0.01 · the MoE aux loss), over sequence
    chunks of `cfg.loss_chunk` positions, each under checkpoint when
    gradients are on, so at most one (B, chunk, V) float32 logits slab is
    live. Returns (loss, {"nll", "aux"})."""
    h, aux = lm_forward(model, tokens, dtype=dtype)
    h, targets = h[:, :-1], tokens[:, 1:]
    b, s = targets.shape
    ck = min(model.cfg.loss_chunk, s)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, ck):
        hc, tc = h[:, c0:c0 + ck], targets[:, c0:c0 + ck]
        if torch.is_grad_enabled():
            total = total + checkpoint(_ce_chunk, model, hc, tc,
                                       use_reentrant=False)
        else:
            total = total + _ce_chunk(model, hc, tc)
    nll = total / (b * s)
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


@torch.no_grad()
def lm_prefill_logits(model: LM, tokens: torch.Tensor, *,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """Serve prefill: logits (B, 1, V) of the last position only."""
    h, _ = lm_forward(model, tokens, dtype=dtype)
    return _logits(model, h[:, -1:])


@torch.no_grad()
def lm_decode_step(model: LM, token: torch.Tensor, caches: dict,
                   lengths: torch.Tensor, *, dtype=torch.bfloat16,
                   use_kernel: bool = True):
    """token (B,) last generated token; caches stacked (L, ...), written in
    place at position lengths[b]; lengths (B,) int32 current fill.
    Returns (logits (B, V) in `dtype`, caches). `use_kernel=False` runs
    GQA attention through its plain version on any device (MLA decode is
    plain torch either way)."""
    cfg = model.cfg
    x = core.embed(model.embed, token[:, None], dtype=dtype)
    for i, blk in enumerate(model.blocks):
        y = core.rmsnorm(blk.ln1, x)
        if cfg.attention == "mla":
            x = x + blk.attn.decode(y, caches["c_kv"][i],
                                    caches["k_rope"][i], lengths)
        else:
            x = x + blk.attn.decode(y, caches["k"][i], caches["v"][i],
                                    lengths, use_kernel=use_kernel)
        y = core.rmsnorm(blk.ln2, x)
        # a decode step groups its MoE over the batch, in groups of the
        # reference's default size (not cfg.moe_group)
        x = x + _ffn(blk, cfg, y)[0]
    h = core.rmsnorm(model.ln_f, x)
    return _logits(model, h)[:, 0], caches


def encoder_forward(model: LM, ids: torch.Tensor, *,
                    dtype=torch.float32) -> torch.Tensor:
    """The non-causal encoder (BERT4Rec): the same blocks with
    bidirectional GQA attention (`flash_attention(causal=False)`) and a
    SwiGLU FFN, no checkpointing (the reference's encoder has none); ids
    (B, S) → hidden (B, S, d_model) in `dtype` after the final RMSNorm."""
    cfg = model.cfg
    x = core.embed(model.embed, ids, dtype=dtype)
    for blk in model.blocks:
        y = core.rmsnorm(blk.ln1, x)
        x = x + blk.attn(y, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
                         causal=False)
        y = core.rmsnorm(blk.ln2, x)
        x = x + core.swiglu(blk.ffn, y)
    return core.rmsnorm(model.ln_f, x)
