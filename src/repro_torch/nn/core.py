"""NN primitives of the LM path: dense, RMSNorm, rotary, SwiGLU,
embeddings, and their initialisers.

Each layer is a small `nn.Module` whose parameters carry the JAX package's
names (`w`, `b`, `g`, `table`, and a dense weight kept as (d_in, d_out)),
so a JAX parameter tree maps onto a state dict by path
(`repro_torch.models.convert`). Every parameter is trainable; the decode
path runs under `torch.no_grad()`. The functions reproduce the reference's
numerics:

- `dense` casts the weight to x's dtype before the product;
- `rmsnorm` normalises in float32, casts to x's dtype, and only then
  multiplies by `g` (not `torch.nn.functional.rms_norm`'s order);
- `apply_rope` rotates interleaved pairs (dims 0::2 with 1::2) of the
  first `rot` dims, with cos and sin cast to x's dtype first.

Initialisers draw from an explicit `torch.Generator`; they follow the
reference's distributions, not its bits.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["normal_init", "Dense", "dense", "RMSNorm", "rmsnorm",
           "rope_angles", "apply_rope", "SwiGLU", "swiglu", "Embedding",
           "embed"]


# ----------------------------------------------------------------- init
def normal_init(gen: torch.Generator, shape, scale: float, *, device,
                dtype=torch.float32) -> torch.Tensor:
    """N(0, scale²) samples, drawn in float32 and cast to dtype."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


# ----------------------------------------------------------------- dense
class Dense(nn.Module):
    """y = x @ w (+ b); w (d_in, d_out) ~ N(0, 1/d_in), b = 0."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 gen: torch.Generator, device, dtype=torch.float32):
        super().__init__()
        self.w = nn.Parameter(normal_init(gen, (d_in, d_out),
                                          1.0 / math.sqrt(d_in),
                                          device=device, dtype=dtype))
        self.b = (nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype))
                  if bias else None)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


# ----------------------------------------------------------------- norms
class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device, dtype=torch.float32):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d, device=device, dtype=dtype))


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p.g.to(x.dtype)


# ----------------------------------------------------------------- rotary
def rope_angles(head_dim: int, positions: torch.Tensor,
                base: float = 10000.0, frac: float = 1.0):
    """Rotary angles for the first `frac` of head_dim (chatglm3's 2-D
    rotary uses frac = 0.5). positions: any int tensor; returns (cos, sin,
    rot) with rot = int(head_dim * frac) rounded down to even and cos/sin
    of shape positions.shape + (rot // 2,), frequencies taken over rot;
    computed on the fly (no (max_seq, rot/2) table)."""
    rot = int(head_dim * frac)
    rot -= rot % 2
    if rot == 0:
        z = torch.zeros(positions.shape + (0,), dtype=torch.float32,
                        device=positions.device)
        return z, z, 0
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / (base ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang), rot


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot: int) -> torch.Tensor:
    """x (..., S, H, D); rotary on interleaved pairs (dims 0::2 with 1::2)
    of dims [0, rot), the rest passed through. cos/sin broadcast over the
    head axis: (..., S, rot/2)."""
    if rot == 0:
        return x
    c = cos[..., :, None, :].to(x.dtype)
    si = sin[..., :, None, :].to(x.dtype)
    xr = x[..., :rot]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * c - x2 * si
    y2 = x2 * c + x1 * si
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    if rot == x.shape[-1]:
        return yr
    return torch.cat([yr, x[..., rot:]], dim=-1)


# ----------------------------------------------------------------- MLP
class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, gen: torch.Generator,
                 device, dtype=torch.float32):
        super().__init__()
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.wi = Dense(d_model, d_ff, **kw)
        self.wg = Dense(d_model, d_ff, **kw)
        self.wo = Dense(d_ff, d_model, **kw)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    g = dense(p.wg, x)
    return dense(p.wo, g * torch.sigmoid(g) * dense(p.wi, x))


# ----------------------------------------------------------------- embeddings
class Embedding(nn.Module):
    """table (vocab, d) ~ N(0, 0.02²)."""

    def __init__(self, vocab: int, d: int, *, gen: torch.Generator, device,
                 dtype=torch.float32):
        super().__init__()
        self.table = nn.Parameter(normal_init(gen, (vocab, d), 0.02,
                                              device=device, dtype=dtype))


def embed(p: Embedding, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the table in dtype (gathered, then cast: the same values as
    the reference's cast-then-gather)."""
    return p.table[ids.long()].to(dtype)
