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
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import all_gather, constrain, full
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels.flash_decode import (flash_decode_merge,
                                              flash_decode_partials)
from . import core

__all__ = ["GQA", "MLA", "flash_attention", "cp_attention", "init_kv_cache",
           "init_mla_cache", "split_heads", "sharded_gqa_decode"]

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


def _pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    """t with n zeros appended along its last dim, by a concatenation
    (some torch releases place a DTensor's `pad` wrongly)."""
    return torch.cat([t, torch.zeros(t.shape[:-1] + (n,), dtype=t.dtype,
                                     device=t.device)], dim=-1)


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
    result is unchanged. DTensor q, k, v run on each rank's own (batch,
    head) block (`_per_head_block`)."""
    if isinstance(q, DTensor):
        return _per_head_block(flash_attention, q, k, v, causal=causal,
                               q_chunk=q_chunk, k_chunk=k_chunk)
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


def split_heads(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """t (..., n·d) → (..., n, d). A DTensor split along its last dim over
    a mesh dim whose size does not divide n is first gathered along that
    mesh dim: a shard holding part of a head cannot become a head shard
    (some torch releases refuse the view; GSPMD would gather too)."""
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, t.dim() - 1
        pl = [Replicate() if isinstance(p, Shard)
              and p.dim in (last, -1) and n % mesh.size(i) else p
              for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(*t.shape[:-1], n, d)


def _per_head_block(fn, q: DTensor, k, v, **kw) -> DTensor:
    """fn(q, k, v) (B, S, H, D) on each rank's own (batch, head) block, as
    GSPMD partitions attention whose batch is split over data and heads
    over model: q, k and v are placed alike — a mesh dim that splits q's
    batch (dim 0) or its heads (dim 2, where the KV heads split too) splits
    all three so, any other is replicated — and the block's attention runs
    on plain local tensors (query head j reads KV head j // G there too).
    DTensor would otherwise flatten the batch and heads, split over two
    mesh dims, into one einsum batch, which some torch releases refuse."""
    mesh = q.device_mesh
    pl = []
    for i, p in enumerate(q.placements):
        size = mesh.size(i)
        keep = isinstance(p, Shard) and (
            (p.dim == 0 and q.shape[0] % size == 0)
            or (p.dim == 2 and q.shape[2] % size == 0
                and k.shape[2] % size == 0))
        pl.append(Shard(p.dim) if keep else Replicate())
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    o = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
    return DTensor.from_local(o, mesh, pl, run_check=False)


# ----------------------------------------------------------------------- GQA
def cp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mp: int, *, causal: bool = True) -> torch.Tensor:
    """Blockwise context-parallel attention (the reference's
    `cp_attention`): the queries split into `mp` sequence blocks, each
    against the whole K and V, with float32 scores and a plain softmax.
    q (B, S, H, D), k, v (B, S, Hkv, D), S a multiple of mp → (B, S, H, D)
    in q's dtype.

    The blocks run one after another, so memory holds one (B, S/mp, H, S)
    float32 score slab at a time, the reference's one slab a device. As in
    the reference, the blocks (B, mp, S/mp, Hkv, G, D) are placed by
    `constrain(qb, "cp_qblocks")`, block i on rank i of the `model` axis
    under a mesh."""
    b, s, h, d = q.shape
    n = k.shape[2]
    g, sb = h // n, s // mp
    kf, vf = k.float(), v.float()
    kpos = torch.arange(s, device=q.device)
    qblocks = constrain(q.reshape(b, mp, sb, n, g, d), "cp_qblocks")
    blocks = []
    for i in range(mp):
        qb = qblocks[:, i].float()
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
        h, n, d = self.n_heads, self.n_kv, self.head_dim
        q = split_heads(core.dense(self.wq, x), h, d)
        k = split_heads(core.dense(self.wk, x), n, d)
        v = split_heads(core.dense(self.wv, x), n, d)
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
        q = constrain(q, "q_bshd")
        k, v = constrain(k, "kv_bshd"), constrain(v, "kv_bshd")
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
        if isinstance(k_cache, DTensor):
            o = sharded_gqa_decode(q[:, 0], k_new[:, 0], v_new[:, 0],
                                    k_cache, v_cache, lengths, like=x,
                                    use_kernel=use_kernel)
        else:
            bidx = torch.arange(b, device=x.device)
            pos = lengths.long()
            k_cache[bidx, pos] = k_new[:, 0].to(k_cache.dtype)
            v_cache[bidx, pos] = v_new[:, 0].to(v_cache.dtype)
            o = kops.decode_attention(q[:, 0], k_cache, v_cache,
                                      lengths + 1, use_kernel=use_kernel)
        return core.dense(self.wo,
                          o.reshape(b, 1, self.n_heads * self.head_dim))


# ------------------------------------------------------ sharded decode caches
def _block_of(cache: DTensor):
    """This rank's block of a cache DTensor sharded along B (dim 0) and S
    (dim 1) only: ((batch offset, rows), (position offset, positions),
    the mesh dims that split B, those that split S)."""
    mesh, shape = cache.device_mesh, cache.shape
    coord = mesh.get_coordinate()
    spans, dims = {0: [0, shape[0]], 1: [0, shape[1]]}, {0: [], 1: []}
    for i, pl in enumerate(cache.placements):
        if not isinstance(pl, Shard):
            continue
        if pl.dim not in (0, 1):
            raise ValueError(f"a decode cache is sharded along B and S "
                             f"only, not {cache.placements}")
        off, n = spans[pl.dim]
        if n % mesh.size(i):
            raise ValueError(f"cache dim {pl.dim} of {n} does not split "
                             f"over {mesh.size(i)} ranks")
        n //= mesh.size(i)
        spans[pl.dim] = [off + coord[i] * n, n]
        dims[pl.dim].append(i)
    return tuple(spans[0]), tuple(spans[1]), dims[0], dims[1]


def _write_row(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
               s_off: int) -> None:
    """cache[b, pos[b] - s_off] = new[b] for the rows whose position lies
    in this block [s_off, s_off + S_local), in place and with no host sync
    (a row outside writes its slot's old value back)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = pos.long() - s_off
    inside = (idx >= 0) & (idx < cache.shape[1])
    idx = idx.clamp(0, cache.shape[1] - 1)
    keep = cache[rows, idx]
    cache[rows, idx] = torch.where(inside.reshape((-1,) + (1,) * (keep.dim()
                                                                   - 1)),
                                   new.to(cache.dtype), keep)


def _rows_out(o: torch.Tensor, cache: DTensor, b_dims, like):
    """The local rows `o` of a decode output as a tensor like `like`: a
    DTensor sharded along B as the cache is (replicated over the other
    mesh dims) when `like` is one, else the whole plain tensor."""
    mesh = cache.device_mesh
    pl = [Shard(0) if i in b_dims else Replicate() for i in range(mesh.ndim)]
    out = DTensor.from_local(o, mesh, pl, run_check=False)
    return out if isinstance(like, DTensor) else out.full_tensor()


def sharded_gqa_decode(q, k_new, v_new, k_cache: DTensor,
                        v_cache: DTensor, lengths, *, like,
                        use_kernel: bool = True):
    """Decode attention over a cache DTensor sharded along B and S (the
    policy's `cache_bsnd`): each rank writes the new K/V row where its
    block holds position lengths[b], runs `flash_decode_partials` over its
    block at the block's offset, all-gathers the (B, H, D + 2) float32
    partial rows over the mesh dims that split S, and merges them with
    `flash_decode_merge` (`distributed.context_parallel`'s lanes, with
    collectives in place of a host loop). q (B, H, D), k_new, v_new
    (B, Hkv, D), lengths (B,) whole or DTensors; returns (B, H, D) like
    `like`. `use_kernel=False` runs the partials and the merge through
    their plain versions (`kernels.ref`), on any device."""
    (b0, nb), (s0, _), b_dims, s_dims = _block_of(k_cache)
    rows = slice(b0, b0 + nb)
    q, lengths = full(q)[rows], full(lengths)[rows]
    k_loc, v_loc = k_cache.to_local(), v_cache.to_local()
    _write_row(k_loc, full(k_new)[rows], lengths, s0)
    _write_row(v_loc, full(v_new)[rows], lengths, s0)
    partials, merge = ((flash_decode_partials, flash_decode_merge)
                       if use_kernel else (ref.flash_decode_partials_ref,
                                           ref.flash_decode_merge_ref))
    part = partials(q, k_loc, v_loc, lengths + 1, s0)[:, :, None]
    mesh = k_cache.device_mesh
    for i in reversed(s_dims):      # innermost first: blocks in S order
        if mesh.size(i) > 1:
            part = all_gather(part, 2, (mesh, i))
    o = merge(part.contiguous(), q.dtype)
    return _rows_out(o, k_cache, b_dims, like)


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
        h, dn, dr = self.n_heads, self.dn, self.dr
        cos, sin, rot = core.rope_angles(dr, positions)
        q = core.dense(self.wuq, core.rmsnorm(self.q_norm,
                                              core.dense(self.wdq, x)))
        q = split_heads(q, h, dn + dr)
        q_nope = q[..., :dn]
        q_rope = core.apply_rope(q[..., dn:], cos, sin, rot)
        dkv = core.dense(self.wdkv, x)
        c_kv = core.rmsnorm(self.kv_norm, dkv[..., :self.rank])
        k_rope = core.apply_rope(split_heads(dkv[..., self.rank:], 1, dr),
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
        kv = split_heads(core.dense(self.wukv, c_kv), h, dn + dv)
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([kv[..., :dn], k_rope.expand(b, s, h, dr)], -1)
        v = _pad_last(kv[..., dn:], dn + dr - dv)
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
        q_nope, q_rope, c_new, kr_new = self.qkv(x, lengths[:, None])
        if isinstance(c_cache, DTensor):
            # rows split over data, S whole (the port places an MLA cache
            # with the `mla_cache` rule's batch entry only): each rank
            # decodes its own rows, as GSPMD partitions the plain step
            (b0, nb), _, b_dims, s_dims = _block_of(c_cache)
            if s_dims:
                raise ValueError("an MLA decode cache is split along B "
                                 "only")
            rows = slice(b0, b0 + nb)
            lens = full(lengths)[rows]
            c_loc, kr_loc = c_cache.to_local(), kr_cache.to_local()
            _write_row(c_loc, full(c_new)[rows, 0], lens, 0)
            _write_row(kr_loc, full(kr_new)[rows, 0, 0], lens, 0)
            o = self._attend(full(q_nope)[rows], full(q_rope)[rows], c_loc,
                             kr_loc, lens)
            o = _rows_out(o, c_cache, b_dims, like=x)
        else:
            bidx = torch.arange(b, device=x.device)
            pos = lengths.long()
            c_cache[bidx, pos] = c_new[:, 0].to(c_cache.dtype)
            kr_cache[bidx, pos] = kr_new[:, 0, 0].to(kr_cache.dtype)
            o = self._attend(q_nope, q_rope, c_cache, kr_cache, lengths)
        return core.dense(self.wo, o.reshape(b, 1, -1).to(x.dtype))

    def _attend(self, q_nope, q_rope, c_cache, kr_cache, lengths):
        """The absorbed scores and output of one decode step, float32:
        q_nope (B, 1, H, dn), q_rope (B, 1, H, dr), the caches after the
        write, lengths (B,) the fill before it → (B, H, dv)."""
        h, dn, dv, r = self.n_heads, self.dn, self.dv, self.rank
        wukv = full(self.wukv.w).float().reshape(r, h, dn + dv)
        w_uk, w_uv = wukv[..., :dn], wukv[..., dn:]
        c_kv = c_cache.float()
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk)
        s_lat = torch.einsum("bhr,bsr->bhs", q_lat, c_kv)
        s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                              kr_cache.float())
        scores = (s_lat + s_rope) * (1.0 / math.sqrt(dn + self.dr))
        live = (torch.arange(c_cache.shape[1],
                             device=c_cache.device)[None, None, :]
                < (lengths + 1)[:, None, None])
        p = torch.softmax(torch.where(live, scores, _NEG), dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", p, c_kv)
        return torch.einsum("bhr,rhd->bhd", o_lat, w_uv)


def init_mla_cache(batch: int, max_len: int, kv_lora_rank: int,
                   rope_dim: int, *, dtype=torch.bfloat16, device) -> dict:
    """Zero MLA caches: {"c_kv" (batch, max_len, kv_lora_rank), "k_rope"
    (batch, max_len, rope_dim)}."""
    return {"c_kv": torch.zeros((batch, max_len, kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, rope_dim), dtype=dtype,
                                  device=device)}
