"""NN primitives: dense, RMSNorm, LayerNorm, rotary, SwiGLU, the GELU
MLP, embeddings and the embedding bag, the row gather and the segment
sum and max (the reference's `x[idx]` and `jax.ops.segment_*`; inside
`shard_rows` on each rank's own rows, with collectives), and their
initialisers.

Each layer is a small `nn.Module` whose parameters carry the JAX package's
names (`w`, `b`, `g`, `table`, and a dense weight kept as (d_in, d_out)),
so a JAX parameter tree maps onto a state dict by path
(`repro_torch.models.convert`). Every parameter is trainable; the decode
path runs under `torch.no_grad()`. The functions reproduce the reference's
numerics:

- `dense` casts the weight to x's dtype before the product;
- `rmsnorm` normalises in float32, casts to x's dtype, and only then
  multiplies by `g` (not `torch.nn.functional.rms_norm`'s order);
- `layernorm` normalises in float32 (biased variance, eps 1e-5), casts
  to x's dtype, then scales by `g` and shifts by `b`;
- `apply_rope` rotates interleaved pairs (dims 0::2 with 1::2) of the
  first `rot` dims, with cos and sin cast to x's dtype first;
- `gelu` is the tanh approximation (`jax.nn.gelu(approximate=True)`),
  not torch's default erf form.

Initialisers draw from an explicit `torch.Generator`; they follow the
reference's distributions, not its bits.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import constrain

_rows = threading.local()

__all__ = ["normal_init", "uniform_init", "Dense", "dense", "RMSNorm",
           "rmsnorm", "LayerNorm", "layernorm", "rope_angles", "apply_rope",
           "SwiGLU", "swiglu", "gelu", "MLP", "mlp", "Embedding", "embed",
           "embedding_bag", "gold_logit", "shard_rows", "row_mesh",
           "gather_rows", "segment_sum", "segment_max"]


# ----------------------------------------------------------------- init
def normal_init(gen: torch.Generator, shape, scale: float, *, device,
                dtype=torch.float32) -> torch.Tensor:
    """N(0, scale²) samples, drawn in float32 and cast to dtype."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def uniform_init(gen: torch.Generator, shape, *, device,
                 dtype=torch.float32) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in = shape[0] (1 for a
    vector), drawn in float32 and cast to dtype."""
    fan_in = shape[0] if len(shape) > 1 else 1
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * (2 * bound) - bound).to(dtype)


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


class LayerNorm(nn.Module):
    def __init__(self, d: int, *, device, dtype=torch.float32):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p.g.to(x.dtype) + p.b.to(x.dtype)


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    return nn.functional.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """layers.<i> Dense(dims[i], dims[i + 1]), each with a bias unless
    `bias=False`: the reference's `mlp_init`."""

    def __init__(self, dims, *, bias: bool = True, gen: torch.Generator,
                 device, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1], bias=bias, gen=gen, device=device,
                  dtype=dtype) for i in range(len(dims) - 1))


def mlp(p: MLP, x: torch.Tensor, act=gelu, final_act: bool = False):
    """The dense layers in turn, `act` between them (and after the last with
    `final_act`)."""
    n = len(p.layers)
    for i, lp in enumerate(p.layers):
        x = dense(lp, x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


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
    the reference's cast-then-gather), by `embedding`, whose backward
    DTensor places in every torch release (an indexing backward it places
    only in some)."""
    out = nn.functional.embedding(ids.long(), p.table)
    if isinstance(out, DTensor):
        # a vocab-sharded table gives each rank its own rows' part:
        # reduce it before anything else reads it
        pl = [Replicate() if isinstance(q, Partial) else q
              for q in out.placements]
        if pl != list(out.placements):
            out = out.redistribute(out.device_mesh, pl)
    return out.to(dtype)


def gold_logit(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits[..., targets] (the cross entropy's gold term). On plain
    tensors a gather. On a mesh (DTensor logits) the reference's one-hot
    product, constrained as the logits (`logits_btv`), whose other terms
    are exact zeros (the same value): a gather along the tensor-parallel
    vocab axis would all-gather the logits."""
    if not isinstance(logits, DTensor):
        return logits.gather(-1, targets.long()[..., None])[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    onehot = constrain((targets.long()[..., None] == vocab)
                       .to(logits.dtype), "logits_btv")
    return (logits * onehot).sum(-1)


@contextlib.contextmanager
def shard_rows(mesh):
    """For the block, plain tensors are this rank's rows of tensors split
    evenly along their first axis over `mesh` (a one-dim `DeviceMesh`):
    `gather_rows`, `segment_sum` and `segment_max` then reach the other
    ranks' rows through collectives, as GSPMD partitions the reference's
    gathers and segment reductions. Thread-local; nested blocks restore
    the outer one."""
    prev = getattr(_rows, "mesh", None)
    _rows.mesh = mesh
    try:
        yield
    finally:
        _rows.mesh = prev


def row_mesh():
    """The mesh of the innermost `shard_rows` block of this thread, or
    None."""
    return getattr(_rows, "mesh", None)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] over the first axis: the node (or edge) rows an index needs.
    Inside `shard_rows`, x is this rank's rows: the ranks' rows are
    all-gathered and indexed by this rank's idx (global row numbers); the
    backward reduce-scatters each rank's partial sum to the rows' owners."""
    mesh = row_mesh()
    if mesh is not None:
        x = DTensor.from_local(x, mesh, [Shard(0)], run_check=False) \
            .redistribute(mesh, [Replicate()]) \
            .to_local(grad_placements=[Partial()])
    return x[idx.long()]


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[ids[e]] += values[e] over the first axis (`jax.ops.segment_sum`);
    0 for an empty segment. Inside `shard_rows`, values and ids are this
    rank's rows, num_segments the whole range: each rank's partial sum is
    reduce-scattered, and this rank's rows of the result come back (the
    whole result when num_segments does not split evenly). Padded rows
    must carry exact zeros."""
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return _reduced(out.index_add(0, ids.long(), values), "sum")


def segment_max(values: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """The largest values[e] of each segment over the first axis, -inf for
    an empty segment (`jax.ops.segment_max`; a torch `scatter_reduce("amax",
    include_self=False)` would keep the initial value, so it starts from
    -inf). Inside `shard_rows`, as `segment_sum` with a max over the
    ranks."""
    out = values.new_full((num_segments,) + values.shape[1:], -torch.inf)
    idx = ids.long().reshape((-1,) + (1,) * (values.dim() - 1))
    return _reduced(out.scatter_reduce(0, idx.expand_as(values), values,
                                       "amax", include_self=False), "max")


def _reduced(part: torch.Tensor, op: str) -> torch.Tensor:
    """`part`, a rank's partial over a whole segment range, reduced (`op`)
    over the ranks of the `shard_rows` block: this rank's rows where the
    range splits evenly, else the whole range. Outside a block, part."""
    mesh = row_mesh()
    if mesh is None:
        return part
    n = mesh.size()
    split = part.shape[0] % n == 0
    if op == "sum":
        total = DTensor.from_local(part, mesh, [Partial()], run_check=False)
        return total.redistribute(
            mesh, [Shard(0) if split else Replicate()]).to_local()
    # max: every rank's partial gathered, then the max over the ranks, so
    # the gradient reaches the rank whose rows hold each maximum
    whole = DTensor.from_local(part[None], mesh, [Shard(0)],
                               run_check=False).redistribute(
        mesh, [Replicate()]).to_local(grad_placements=[Partial()]).amax(0)
    if not split:
        return whole
    rows = part.shape[0] // n
    r = mesh.get_local_rank()
    return whole[r * rows:(r + 1) * rows]


def embedding_bag(p: Embedding, ids: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int, *, mode: str = "sum",
                  weights: torch.Tensor | None = None,
                  dtype=None) -> torch.Tensor:
    """Gather + segment reduce: ids and segment_ids (nnz,) are flat
    multi-hot indices and their bag ids; mode "sum", "mean" (over a bag's
    count, at least 1) or "max" (-inf for an empty bag). Returns
    (num_segments, d)."""
    vecs = p.table[ids.long()]
    if dtype is not None:
        vecs = vecs.to(dtype)
    if weights is not None:
        vecs = vecs * weights[:, None].to(vecs.dtype)
    if mode == "max":
        return segment_max(vecs, segment_ids, num_segments)
    out = segment_sum(vecs, segment_ids, num_segments)
    if mode == "mean":
        cnt = segment_sum(torch.ones_like(segment_ids, dtype=vecs.dtype),
                          segment_ids, num_segments)
        out = out / torch.clamp(cnt, min=1)[:, None]
    return out
