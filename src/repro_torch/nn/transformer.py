"""Decoder-only transformer for LM decode serving: pre-norm GQA blocks in a
`ModuleList` (the reference scans over stacked layer parameters), SwiGLU
FFN, and the LM head tied to the embedding.

    model = lm_init(cfg, seed=0, device="cpu")
    caches = lm_init_caches(cfg, batch, max_len, device="cpu")
    logits, caches = lm_decode_step(model, token, caches, lengths)

Caches are stacked over layers, {"k", "v"} each (L, B, S, Hkv, D), as the
reference stacks them; layer i reads and writes the contiguous view [i].
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import LMConfig
from . import attention as attn
from . import core

__all__ = ["Block", "LM", "lm_init", "lm_init_caches", "lm_decode_step"]


class Block(nn.Module):
    def __init__(self, cfg: LMConfig, *, gen: torch.Generator, device,
                 dtype=torch.float32):
        super().__init__()
        if cfg.attention != "gqa" or cfg.moe_experts or cfg.rope_frac != 1.0:
            raise NotImplementedError(
                f"{cfg.name}: only dense GQA blocks with full rotary are "
                "ported; MLA, MoE and rope_frac < 1 wait for later slices "
                "(ROADMAP.md Queue 1)")
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.ln1 = core.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.ln2 = core.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.attn = attn.GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, qkv_bias=cfg.qkv_bias, **kw)
        self.ffn = core.SwiGLU(cfg.d_model, cfg.d_ff, **kw)


class LM(nn.Module):
    """Parameters: embed.table, blocks.{i}.{ln1,ln2,attn,ffn}, ln_f.g — the
    reference's tree paths. The LM head is the embedding (tied)."""

    def __init__(self, cfg: LMConfig, *, gen: torch.Generator, device,
                 dtype=torch.float32):
        super().__init__()
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: only tied embeddings are ported (ROADMAP.md "
                "Queue 1)")
        self.cfg = cfg
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.embed = core.Embedding(cfg.vocab, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.ln_f = core.RMSNorm(cfg.d_model, device=device, dtype=dtype)


def lm_init(cfg: LMConfig, *, seed: int = 0, device,
            dtype=torch.float32) -> LM:
    """A model with weights drawn from a torch.Generator seeded with `seed`
    on `device`, stored in `dtype`. The reference casts each weight to the
    activation dtype at every use, so weights stored in that dtype give
    the same numbers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return LM(cfg, gen=gen, device=device, dtype=dtype).eval()


def lm_init_caches(cfg: LMConfig, batch: int, max_len: int, *,
                   dtype=torch.bfloat16, device) -> dict:
    """Zero caches stacked over layers: {"k", "v"}, (L, B, S, Hkv, D)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name in ("k", "v")}


def _logits(model: LM, h: torch.Tensor) -> torch.Tensor:
    return h @ model.embed.table.to(h.dtype).T


@torch.no_grad()
def lm_decode_step(model: LM, token: torch.Tensor, caches: dict,
                   lengths: torch.Tensor, *, dtype=torch.bfloat16,
                   use_kernel: bool = True):
    """token (B,) last generated token; caches stacked (L, ...), written in
    place at position lengths[b]; lengths (B,) int32 current fill.
    Returns (logits (B, V) in `dtype`, caches). `use_kernel=False` runs
    attention through its plain version on any device."""
    x = core.embed(model.embed, token[:, None], dtype=dtype)
    for i, blk in enumerate(model.blocks):
        y = core.rmsnorm(blk.ln1, x)
        x = x + blk.attn.decode(y, caches["k"][i], caches["v"][i], lengths,
                                use_kernel=use_kernel)
        y = core.rmsnorm(blk.ln2, x)
        x = x + core.swiglu(blk.ffn, y)
    h = core.rmsnorm(model.ln_f, x)
    return _logits(model, h)[:, 0], caches
