"""Mixture-of-Experts FFN: top-k routing with capacity per dispatch group,
and the einsum (GShard-style) dispatch and combine of the reference.

    y, aux = moe_ffn(moe, x, n_experts=E, top_k=k, group_size=512)

Tokens are taken in groups of `group_size` positions of a sequence (one
group of the whole sequence when it does not divide); a single-token
decode step (S == 1) groups over the batch instead, so a decode row's
output depends on the other rows of its batch, as the reference's does.
Each group routes with a float32 softmax over the router's logits, takes
the top-k experts (a tie goes to the lower expert index, as
`jax.lax.top_k` has it) and renormalises their gates. Capacity is
max(int(1.25 · g · k / E), 1) assignments an expert a group; a token's
rank within its expert is the exclusive cumsum in position-major order,
and assignments at or past capacity are dropped. The dispatch and combine
tensors and the expert GEMMs run in x's dtype, as the reference's do; the
Switch aux loss E · Σ_e f_e · P_e is taken over the first n_experts.

Plain torch, as the reference's is plain jnp: no kernel of its own. On a
mesh (DTensor x) each rank computes its own shard of the reference's
`moe_bsec` / `moe_becd` / `moe_becf` placements on local tensors
(`_sharded_moe_ffn`), and the partial outputs are summed over `model`.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from . import core

__all__ = ["MoE", "moe_ffn", "stable_top_k"]


class MoE(nn.Module):
    """router.w (d_model, n_experts); wi, wg (e_alloc, d_model, d_expert)
    ~ N(0, 1/d_model) and wo (e_alloc, d_expert, d_model) ~ N(0,
    1/d_expert), with e_alloc = max(pad_to, n_experts): padded expert slots
    exist for an expert-parallel axis and are never routed to."""

    def __init__(self, d_model: int, d_expert: int, n_experts: int, *,
                 pad_to: int = 0, gen: torch.Generator, device,
                 dtype=torch.float32):
        super().__init__()
        e_alloc = max(pad_to, n_experts)
        kw = dict(device=device, dtype=dtype)
        self.router = core.Dense(d_model, n_experts, gen=gen, **kw)
        s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_expert)
        self.wi = nn.Parameter(core.normal_init(
            gen, (e_alloc, d_model, d_expert), s_in, **kw))
        self.wg = nn.Parameter(core.normal_init(
            gen, (e_alloc, d_model, d_expert), s_in, **kw))
        self.wo = nn.Parameter(core.normal_init(
            gen, (e_alloc, d_expert, d_model), s_out, **kw))


def stable_top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, in
    descending order, a tie going to the lower index (`jax.lax.top_k`'s
    order; `torch.topk` promises none): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, group_size: int = 512):
    """x (B, S, D) → (y (B, S, D) in x's dtype, aux loss, a float32
    scalar). See the module docstring."""
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, group_size=group_size)
    if isinstance(x, DTensor):
        return _sharded_moe_ffn(p, x, **kw)
    return _moe(p.router.w, p.wi, p.wg, p.wo, x, n_alloc=p.wi.shape[0],
                **kw)


def _moe(router_w, wi, wg, wo, x, *, n_experts: int, top_k: int,
         capacity_factor: float, group_size: int, n_alloc: int,
         e0: int = 0):
    """The routing of x over all n_alloc experts and the expert products
    of the experts [e0, e0 + len(wi)) whose weights are given (all of
    them without a mesh; a rank's block under expert parallelism, or all
    experts at a slice of d_expert under tensor parallelism, whose y is
    then a partial sum). Returns (y, aux)."""
    b, s, d = x.shape
    decode = s == 1
    if decode:                  # group over the batch instead
        x = x.transpose(0, 1)
        b, s = s, b
    g = min(group_size, s)
    if s % g:
        g = s
    bg = b * (s // g)
    xg = x.reshape(bg, g, d)

    logits = (xg @ router_w.to(xg.dtype)).float()              # (BG,G,E)
    probs = torch.softmax(logits, dim=-1)
    gate, eid = stable_top_k(probs, top_k)                     # (BG,G,k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    cap = max(int(capacity_factor * g * top_k / n_experts), 1)

    experts = torch.arange(n_alloc, device=x.device)
    oh_e = (eid[..., None] == experts).float()                 # (BG,G,k,E)
    # rank of each assignment within (group, expert), position-major
    flat = oh_e.reshape(bg, g * top_k, n_alloc)
    ranks = torch.cumsum(flat, dim=1) - flat                   # exclusive
    rank_of = (flat * ranks).sum(-1).reshape(bg, g, top_k)
    keep = rank_of < cap
    # one-hot over capacity slots; a rank at or past cap matches none
    oh_c = (rank_of.long()[..., None]
            == torch.arange(cap, device=x.device)).float()     # (BG,G,k,C)

    mine = oh_e[..., e0:e0 + wi.shape[0]]                      # (BG,G,k,El)
    disp = torch.einsum("bske,bskc->bsec", mine, oh_c).to(x.dtype)
    comb = torch.einsum("bsk,bske,bskc->bsec", gate.to(x.dtype),
                        mine.to(x.dtype), oh_c.to(x.dtype))

    buf = torch.einsum("bsd,bsec->becd", xg, disp)             # (BG,E,C,D)
    h = torch.einsum("becd,edf->becf", buf, wg.to(buf.dtype))
    h = h * torch.sigmoid(h) * torch.einsum("becd,edf->becf", buf,
                                            wi.to(buf.dtype))
    out = torch.einsum("becf,efd->becd", h, wo.to(buf.dtype))
    y = torch.einsum("becd,bsec->bsd", out, comb).reshape(b, s, d)

    # Switch load-balance loss: E · Σ_e f_e · P_e
    fe = ((oh_e[..., :n_experts] * keep[..., None].float()).sum((1, 2))
          / (g * top_k))
    pe = probs.mean(1)                                          # (BG,E)
    aux = n_experts * (fe * pe).sum(-1).mean()
    if decode:
        y = y.transpose(0, 1)
    return y, aux


def _sharded_moe_ffn(p: MoE, x: DTensor, **kw):
    """`moe_ffn` on a mesh, each rank on its own shard as GSPMD partitions
    the reference's under its `moe_bsec` / `moe_becd` / `moe_becf` rules:
    rows split over the data-parallel mesh dims (a decode step's rows
    gathered: its one group spans the batch), the experts split over
    `model` where the policy placed them so (expert parallel), or every
    expert at a slice of d_expert (tensor parallel inside the experts);
    the experts' data-parallel (FSDP) dims gathered. Each rank routes its
    rows over all experts, runs its experts' products, and the partial
    outputs are summed over `model`; the aux loss is the mean over the
    row-split ranks of theirs."""
    from torch.distributed.tensor import Partial, Shard
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    model = names.index("model") if "model" in names else None
    decode = x.shape[1] == 1
    rows = [i for i, pl in enumerate(x.placements)
            if not decode and i != model and isinstance(pl, Shard)
            and pl.dim == 0]
    x_pl = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    pl_e = p.wi.placements[model] if model is not None else Replicate()
    split = isinstance(pl_e, Shard)
    # what a rank's local result is a part of: its rows' share of a sum
    # over the row-split dims, its experts' (or d_expert slice's) share
    # of one over model; the gradients of its local inputs likewise
    part = [Partial() if i in rows or (i == model and split)
            else Replicate() for i in range(mesh.ndim)]
    x_grad = [Partial() if i == model and split else x_pl[i]
              for i in range(mesh.ndim)]
    xl = x.redistribute(mesh, x_pl).to_local(grad_placements=x_grad)

    def local(w):
        """w with every mesh dim but `model` gathered; its gradient a
        partial sum over the row-split dims, and over model too unless w
        is split there (the router is whole on every rank, but each rank's
        routing reaches the output only through its own experts)."""
        keep = w.placements[model] if model is not None else Replicate()
        pl = [keep if i == model else Replicate() for i in range(mesh.ndim)]
        grad = [keep if i == model and isinstance(keep, Shard) else part[i]
                for i in range(mesh.ndim)]
        return w.redistribute(mesh, pl).to_local(grad_placements=grad)

    router = local(p.router.w)
    wi, wg, wo = local(p.wi), local(p.wg), local(p.wo)
    e0 = 0
    if split and pl_e.dim == 0:                            # expert parallel
        e0 = mesh.get_coordinate()[model] * wi.shape[0]
    y, aux = _moe(router, wi, wg, wo, xl, n_alloc=p.wi.shape[0], e0=e0,
                  **kw)
    y_pl = [Partial() if i == model and split else x_pl[i]
            for i in range(mesh.ndim)]
    y = DTensor.from_local(y, mesh, y_pl, run_check=False)
    # aux, whole on every rank of a row block, enters as a 1/n share of
    # a sum over the ranks that split rows or experts
    n = 1
    for i in range(mesh.ndim):
        if isinstance(part[i], Partial):
            n *= mesh.size(i)
    aux = DTensor.from_local(aux / n, mesh, part, run_check=False)
    return (y.redistribute(mesh, x_pl),
            aux.redistribute(mesh, [Replicate()] * mesh.ndim))
