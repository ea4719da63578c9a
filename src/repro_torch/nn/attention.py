"""GQA attention for the LM decode path: the four projections, the KV
cache, and one decode step over the cache.

The reference writes the new K/V row with a functional `.at[].set`, which
copies the cache per layer. Here the cache is preallocated once and the
step writes the row in place (same values, same positions), so a 30 GB
cache is never copied. Attention runs through `kernels.ops.decode_attention`:
the hand-written CUDA kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from . import core

__all__ = ["GQA", "init_kv_cache"]


class GQA(nn.Module):
    """Grouped-query attention: n_heads query heads share n_kv KV heads."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 *, qkv_bias: bool = False, gen: torch.Generator, device,
                 dtype=torch.float32):
        super().__init__()
        if n_heads % n_kv:
            raise ValueError(f"n_heads {n_heads} is not a multiple of "
                             f"n_kv {n_kv}")
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.wq = core.Dense(d_model, n_heads * head_dim, bias=qkv_bias, **kw)
        self.wk = core.Dense(d_model, n_kv * head_dim, bias=qkv_bias, **kw)
        self.wv = core.Dense(d_model, n_kv * head_dim, bias=qkv_bias, **kw)
        self.wo = core.Dense(n_heads * head_dim, d_model, **kw)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, S, d_model), positions (B, S) → rotated q (B, S, H, D),
        rotated k and v (B, S, Hkv, D)."""
        b, s, _ = x.shape
        h, n, d = self.n_heads, self.n_kv, self.head_dim
        q = core.dense(self.wq, x).reshape(b, s, h, d)
        k = core.dense(self.wk, x).reshape(b, s, n, d)
        v = core.dense(self.wv, x).reshape(b, s, n, d)
        cos, sin = core.rope_angles(d, positions)
        return core.apply_rope(q, cos, sin), core.apply_rope(k, cos, sin), v

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
