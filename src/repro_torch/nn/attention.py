"""Attention for the LM: GQA (the four projections, flash-style chunked
causal attention for train and prefill, the KV cache, and one decode step
over the cache) and MLA (compressed latent attention: the expanded path
for train and prefill, the absorbed path for decode).

`flash_attention` is the reference's exact online softmax over query and
key blocks (plain jnp there, plain torch here): float32 scores and
accumulators, each query block's key sweep under activation checkpointing
so the backward keeps O(S) memory.

The reference writes the new K/V row with a functional `.at[].set`, which
copies the cache per layer. Here the cache is preallocated once and the
step writes the row in place (same values, same positions), so a 30 GB
cache is never copied. GQA decode attention runs through
`kernels.ops.decode_attention`: the hand-written CUDA kernel on the card,
its plain version on the CPU. MLA decode is plain torch, as the
reference's is plain jnp: scores are taken in the latent space, in
float32, against a (B, S, kv_lora_rank) cache plus a (B, S, rope) one, and
its new latent row is written in place too.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from . import core

__all__ = ["GQA", "MLA", "flash_attention", "cp_attention", "init_kv_cache",
           "init_mla_cache"]

_NEG = -1e30


# --------------------------------------------------------------------- flash
def _flash_block(q, k, v, m, l, acc, mask):
    """One (qc x kc) block update of the online softmax. q (B,N,G,qc,D),
    k/v (B,N,kc,D), all float32; mask (qc, kc) or None (every pair
    attends)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bngqd,bnkd->bngqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, _NEG)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + torch.einsum("bngqk,bnkd->bngqd", p, v)
    return m_new, l_new, acc_new


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    k_chunk: int = 1024) -> torch.Tensor:
    """q (B,S,H,D); k, v (B,S,N,D) with H = N·G (query head h reads KV
    head h // G). Exact, O(S) memory; returns (B,S,H,D) in q's dtype.

    The sequence is padded to multiples of the chunks; padded keys are
    masked with -1e30, padded queries dropped. Query heads are grouped as
    (B,N,G,qc,D) against (B,N,kc,D): K and V are never repeated. With
    `causal`, key blocks wholly above a query block's diagonal are
    skipped: they would add exp(-1e30 - m) = 0 to every sum, because key
    block 0 gives every causal row a finite running max first, so the
    result is unchanged."""
    b, s, h, d = q.shape
    n = k.shape[2]
    g = h // n
    qc, kc = min(q_chunk, s), min(k_chunk, s)
    nq, nk = -(-s // qc), -(-s // kc)
    # (nq, B, N, G, qc, D) and (nk, B, N, kc, D), float32 as the
    # reference's scores and accumulators are
    qb = (nn.functional.pad(q.float(), (0, 0, 0, 0, 0, nq * qc - s))
          .reshape(b, nq, qc, n, g, d).permute(1, 0, 3, 4, 2, 5)
          .contiguous())
    kb, vb = ((nn.functional.pad(t.float(), (0, 0, 0, 0, 0, nk * kc - s))
               .reshape(b, nk, kc, n, d).permute(1, 0, 3, 2, 4).contiguous())
              for t in (k, v))
    pos = torch.arange(max(nq * qc, nk * kc), device=q.device)

    def k_sweep(qi, qblk, kb, vb):
        q0 = qi * qc
        m = torch.full((b, n, g, qc), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, n, g, qc, d), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            k0 = ki * kc
            if causal and k0 > q0 + qc - 1:
                break                   # this block and all later ones
            mask = None
            if k0 + kc > s:             # padded keys in this block
                mask = (pos[k0:k0 + kc] < s)[None, :]
            if causal and k0 + kc - 1 > q0:     # crosses the diagonal
                below = pos[q0:q0 + qc, None] >= pos[None, k0:k0 + kc]
                mask = below if mask is None else mask & below
            m, l, acc = _flash_block(qblk, kb[ki], vb[ki], m, l, acc, mask)
        return acc / torch.clamp(l, min=1e-30)[..., None]

    outs = []
    for qi in range(nq):
        if torch.is_grad_enabled():
            # rematerialise the sweep in the backward (the reference's
            # jax.checkpoint): autograd would otherwise keep every block's
            # (qc, kc) softmax, O(S^2 / qc / kc) of them
            o = checkpoint(k_sweep, qi, qb[qi], kb, vb, use_reentrant=False)
        else:
            o = k_sweep(qi, qb[qi], kb, vb)
        outs.append(o)
    # (nq, B, N, G, qc, D) -> (B, S, H, D)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(
        b, nq * qc, h, d)[:, :s]
    return out.to(q.dtype)


# ----------------------------------------------------------------------- GQA
def cp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mp: int, *, causal: bool = True) -> torch.Tensor:
    """Blockwise context-parallel attention (the reference's
    `cp_attention`): the queries split into `mp` sequence blocks, each
    against the whole K and V, with float32 scores and a plain softmax.
    q (B, S, H, D), k, v (B, S, Hkv, D), S a multiple of mp → (B, S, H, D)
    in q's dtype.

    The blocks run one after another, so memory holds one (B, S/mp, H, S)
    float32 score slab at a time, the reference's one slab a device. The
    reference places block i on device i of its `model` axis with
    `constrain(qb, "cp_qblocks")`; here the block loop is where that
    placement will go once the port has `constrain` (ROADMAP.md Queue 1)."""
    b, s, h, d = q.shape
    n = k.shape[2]
    g, sb = h // n, s // mp
    kf, vf = k.float(), v.float()
    kpos = torch.arange(s, device=q.device)
    blocks = []
    for i in range(mp):
        qb = q[:, i * sb:(i + 1) * sb].reshape(b, sb, n, g, d).float()
        scores = torch.einsum("bqngd,bsnd->bqngs", qb, kf) / math.sqrt(d)
        if causal:
            qpos = i * sb + torch.arange(sb, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]             # (sb, S)
            scores = scores.masked_fill(~mask[None, :, None, None, :],
                                        _NEG)
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("bqngs,bsnd->bqngd", p, vf)
        blocks.append(o.reshape(b, sb, h, d).to(q.dtype))
    return torch.cat(blocks, dim=1)


class GQA(nn.Module):
    """Grouped-query attention: n_heads query heads share n_kv KV heads."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 *, qkv_bias: bool = False, rope_frac: float = 1.0,
                 gen: torch.Generator, device, dtype=torch.float32):
        super().__init__()
        if n_heads % n_kv:
            raise ValueError(f"n_heads {n_heads} is not a multiple of "
                             f"n_kv {n_kv}")
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        self.rope_frac = rope_frac
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.wq = core.Dense(d_model, n_heads * head_dim, bias=qkv_bias, **kw)
        self.wk = core.Dense(d_model, n_kv * head_dim, bias=qkv_bias, **kw)
        self.wv = core.Dense(d_model, n_kv * head_dim, bias=qkv_bias, **kw)
        self.wo = core.Dense(n_heads * head_dim, d_model, **kw)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, S, d_model), positions (B, S) or (S,) → q (B, S, H, D),
        k and v (B, S, Hkv, D); q and k rotated on their first
        rope_frac of D."""
        b, s, _ = x.shape
        h, n, d = self.n_heads, self.n_kv, self.head_dim
        q = core.dense(self.wq, x).reshape(b, s, h, d)
        k = core.dense(self.wk, x).reshape(b, s, n, d)
        v = core.dense(self.wv, x).reshape(b, s, n, d)
        cos, sin, rot = core.rope_angles(d, positions, frac=self.rope_frac)
        return (core.apply_rope(q, cos, sin, rot),
                core.apply_rope(k, cos, sin, rot), v)

    def forward(self, x: torch.Tensor, *, q_chunk: int = 512,
                k_chunk: int = 1024, causal: bool = True,
                cp_degree: int = 0) -> torch.Tensor:
        """Self-attention over the whole sequence (the reference's
        `gqa_attention`; with `causal=False` the bidirectional attention of
        its `encoder_forward`): x (B, S, d_model) at positions 0..S-1 → y
        (B, S, d_model). With `cp_degree` set and S a multiple of it, the
        attention is `cp_attention` over that many query blocks, as in the
        reference; else `flash_attention`."""
        b, s, _ = x.shape
        q, k, v = self.qkv(x, torch.arange(s, device=x.device))
        if cp_degree and s % cp_degree == 0:
            o = cp_attention(q, k, v, cp_degree, causal=causal)
        else:
            o = flash_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                                k_chunk=k_chunk)
        return core.dense(self.wo, o.reshape(b, s, self.n_heads
                                             * self.head_dim))

    @torch.no_grad()
    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, lengths: torch.Tensor, *,
               use_kernel: bool = True) -> torch.Tensor:
        """x (B, 1, d_model): one new token per row; k_cache, v_cache
        (B, S, Hkv, D), lengths (B,) int32 current fill (< S). Writes the
        new K/V at position lengths[b] in place, attends over lengths + 1
        positions, and returns y (B, 1, d_model)."""
        b = x.shape[0]
        q, k_new, v_new = self.qkv(x, lengths[:, None])
        bidx = torch.arange(b, device=x.device)
        pos = lengths.long()
        k_cache[bidx, pos] = k_new[:, 0].to(k_cache.dtype)
        v_cache[bidx, pos] = v_new[:, 0].to(v_cache.dtype)
        o = kops.decode_attention(q[:, 0], k_cache, v_cache, lengths + 1,
                                  use_kernel=use_kernel)
        return core.dense(self.wo,
                          o.reshape(b, 1, self.n_heads * self.head_dim))


def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int, *,
                  dtype=torch.bfloat16, device) -> dict:
    """Zero K and V caches, (batch, max_len, n_kv, head_dim) each."""
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ----------------------------------------------------------------------- MLA
class MLA(nn.Module):
    """Multi-head latent attention (minicpm3): queries through a low-rank
    q_lora bottleneck, keys and values through one shared kv_lora latent
    plus one rotary key of qk_rope_head_dim for all heads. Parameters carry
    the reference's names: wdq, q_norm, wuq, wdkv, kv_norm, wukv, wo."""

    def __init__(self, cfg, *, gen: torch.Generator, device,
                 dtype=torch.float32):
        super().__init__()
        h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_head_dim,
                         cfg.qk_rope_head_dim, cfg.v_head_dim)
        self.n_heads, self.dn, self.dr, self.dv = h, dn, dr, dv
        self.rank = cfg.kv_lora_rank
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.wdq = core.Dense(cfg.d_model, cfg.q_lora_rank, **kw)
        self.q_norm = core.RMSNorm(cfg.q_lora_rank, device=device,
                                   dtype=dtype)
        self.wuq = core.Dense(cfg.q_lora_rank, h * (dn + dr), **kw)
        self.wdkv = core.Dense(cfg.d_model, cfg.kv_lora_rank + dr, **kw)
        self.kv_norm = core.RMSNorm(cfg.kv_lora_rank, device=device,
                                    dtype=dtype)
        self.wukv = core.Dense(cfg.kv_lora_rank, h * (dn + dv), **kw)
        self.wo = core.Dense(h * dv, cfg.d_model, **kw)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, S, d_model) → q_nope (B, S, H, dn), rotated q_rope
        (B, S, H, dr), the normalised latent c_kv (B, S, r) and the rotated
        shared key k_rope (B, S, 1, dr)."""
        b, s, _ = x.shape
        h, dn, dr = self.n_heads, self.dn, self.dr
        cos, sin, rot = core.rope_angles(dr, positions)
        q = core.dense(self.wuq, core.rmsnorm(self.q_norm,
                                              core.dense(self.wdq, x)))
        q = q.reshape(b, s, h, dn + dr)
        q_nope = q[..., :dn]
        q_rope = core.apply_rope(q[..., dn:], cos, sin, rot)
        dkv = core.dense(self.wdkv, x)
        c_kv = core.rmsnorm(self.kv_norm, dkv[..., :self.rank])
        k_rope = core.apply_rope(dkv[..., self.rank:].reshape(b, s, 1, dr),
                                 cos, sin, rot)
        return q_nope, q_rope, c_kv, k_rope

    def forward(self, x: torch.Tensor, *, q_chunk: int = 512,
                k_chunk: int = 1024) -> torch.Tensor:
        """The expanded path (the reference's `mla_attention`): the latent
        expanded to per-head keys and values, V zero-padded to dn + dr so
        one causal `flash_attention` serves both; x (B, S, d_model) at
        positions 0..S-1 → y (B, S, d_model)."""
        b, s, _ = x.shape
        h, dn, dr, dv = self.n_heads, self.dn, self.dr, self.dv
        q_nope, q_rope, c_kv, k_rope = self.qkv(
            x, torch.arange(s, device=x.device))
        kv = core.dense(self.wukv, c_kv).reshape(b, s, h, dn + dv)
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([kv[..., :dn], k_rope.expand(b, s, h, dr)], -1)
        v = nn.functional.pad(kv[..., dn:], (0, dn + dr - dv))
        o = flash_attention(q, k, v, causal=True, q_chunk=q_chunk,
                            k_chunk=k_chunk)
        return core.dense(self.wo, o[..., :dv].reshape(b, s, h * dv))

    @torch.no_grad()
    def decode(self, x: torch.Tensor, c_cache: torch.Tensor,
               kr_cache: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """The absorbed path (the reference's `mla_decode`): x (B, 1,
        d_model), c_cache (B, S, r), kr_cache (B, S, dr), lengths (B,) int32
        current fill (< S). Writes the new latent and rotary key at
        position lengths[b] in place, then scores q_nope·W_uk·c_kv +
        q_rope·k_rope over lengths + 1 positions and returns
        (softmax·c_kv)·W_uv through wo, all in float32 until wo."""
        b = x.shape[0]
        h, dn, dv, r = self.n_heads, self.dn, self.dv, self.rank
        q_nope, q_rope, c_new, kr_new = self.qkv(x, lengths[:, None])
        bidx = torch.arange(b, device=x.device)
        pos = lengths.long()
        c_cache[bidx, pos] = c_new[:, 0].to(c_cache.dtype)
        kr_cache[bidx, pos] = kr_new[:, 0, 0].to(kr_cache.dtype)
        wukv = self.wukv.w.float().reshape(r, h, dn + dv)
        w_uk, w_uv = wukv[..., :dn], wukv[..., dn:]
        c_kv = c_cache.float()
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk)
        s_lat = torch.einsum("bhr,bsr->bhs", q_lat, c_kv)
        s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                              kr_cache.float())
        scores = (s_lat + s_rope) * (1.0 / math.sqrt(dn + self.dr))
        live = (torch.arange(c_cache.shape[1], device=x.device)[None, None, :]
                < (lengths + 1)[:, None, None])
        p = torch.softmax(torch.where(live, scores, _NEG), dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", p, c_kv)
        o = torch.einsum("bhr,rhd->bhd", o_lat, w_uv)
        return core.dense(self.wo, o.reshape(b, 1, h * dv).to(x.dtype))


def init_mla_cache(batch: int, max_len: int, kv_lora_rank: int,
                   rope_dim: int, *, dtype=torch.bfloat16, device) -> dict:
    """Zero MLA caches: {"c_kv" (batch, max_len, kv_lora_rank), "k_rope"
    (batch, max_len, rope_dim)}."""
    return {"c_kv": torch.zeros((batch, max_len, kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, rope_dim), dtype=dtype,
                                  device=device)}
