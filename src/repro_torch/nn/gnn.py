"""Graph message-passing primitives (sums, means and softmax over edges,
on `core.gather_rows`, `core.segment_sum` / `core.segment_max`) and the
GatedGCN layer.

Padded edges point at node 0 with `edge_mask` False: their values are
replaced by exact zeros before any sum, so they add nothing (inside
`core.shard_rows`, every rank's partial sum adds exact zeros for them). A
node with no incoming edge gets 0 from a sum and -inf from a max. The
reference's sharding constraints (`constrain`) are no-ops on the plain
tensors these functions see.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.sharding import constrain
from . import core

__all__ = ["scatter_sum", "scatter_mean", "segment_softmax",
           "GatedGCNLayer", "gatedgcn_layer"]


def _masked(values: torch.Tensor, mask: torch.Tensor | None, fill=0.0):
    if mask is None:
        return values
    m = mask.reshape(mask.shape + (1,) * (values.dim() - mask.dim()))
    return torch.where(m, values, torch.full_like(values, fill))


def scatter_sum(values, dst, n_nodes: int, edge_mask=None):
    """Edge → node aggregation: out[dst[e]] += values[e]."""
    return core.segment_sum(_masked(values, edge_mask), dst, n_nodes)


def scatter_mean(values, dst, n_nodes: int, edge_mask=None):
    s = scatter_sum(values, dst, n_nodes, edge_mask)
    ones = _masked(values.new_ones(values.shape[0]), edge_mask)
    cnt = core.segment_sum(ones, dst, n_nodes)
    return s / torch.clamp(cnt, min=1)[:, None]


def segment_softmax(scores, dst, n_nodes: int, edge_mask=None):
    """Per-destination softmax over incoming edges (Equiformer's alpha).
    scores: (E,) or (E, H)."""
    scores = _masked(scores, edge_mask, -1e30)
    mx = core.segment_max(scores, dst, n_nodes)
    ex = _masked(torch.exp(scores - core.gather_rows(mx, dst)), edge_mask)
    z = core.segment_sum(ex, dst, n_nodes)
    return ex / torch.clamp(core.gather_rows(z, dst), min=1e-20)


# --------------------------------------------------------------- GatedGCN
class GatedGCNLayer(nn.Module):
    """A, B, C, U, V Dense(d, d) with biases; ln_h, ln_e LayerNorm(d)."""

    def __init__(self, d: int, *, gen: torch.Generator, device,
                 dtype=torch.float32):
        super().__init__()
        for name in "ABCUV":
            setattr(self, name, core.Dense(d, d, bias=True, gen=gen,
                                           device=device, dtype=dtype))
        self.ln_h = core.LayerNorm(d, device=device, dtype=dtype)
        self.ln_e = core.LayerNorm(d, device=device, dtype=dtype)


def gatedgcn_layer(p: GatedGCNLayer, h, e, src, dst, edge_mask,
                   n_nodes: int):
    """Bresson-Laurent gated GCN (arXiv:1711.07553 / 2003.00982):
      ê_ij = e_ij + ReLU(LN(A h_i + B h_j + C e_ij))
      η_ij = σ(ê_ij) / (Σ_j σ(ê_ij) + ε)
      ĥ_i  = h_i + ReLU(LN(U h_i + Σ_j η_ij ⊙ V h_j))
    (LayerNorm for BatchNorm, as the reference has it.)"""
    hi = core.gather_rows(h, dst)
    hj = core.gather_rows(h, src)
    e_new = core.dense(p.A, hi) + core.dense(p.B, hj) + core.dense(p.C, e)
    e_out = e + torch.relu(core.layernorm(p.ln_e, e_new))
    sig = torch.sigmoid(e_out)
    denom = scatter_sum(sig, dst, n_nodes, edge_mask) + 1e-6
    msg = sig * core.dense(p.V, hj)
    agg = scatter_sum(msg, dst, n_nodes, edge_mask) / denom
    h_out = h + torch.relu(core.layernorm(
        p.ln_h, core.dense(p.U, h) + agg))
    return constrain(h_out, "gnn_nodes"), e_out
