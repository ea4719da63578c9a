"""Plain torch versions of the bitmap kernels (correctness ground truth).

The kernel wrappers in `bitmap_intersect.py` run these for CPU tensors, and
`chip_smoke.py` holds the CUDA kernels against them on the card. Gather
indices are taken as `jnp` indexing takes them — a negative index counts
from the end, and the result is clamped into the table: the engine never
produces an out-of-range index, but neither the plain versions nor the
kernels may read past a table.
"""
from __future__ import annotations

import torch

from ..core.bitops import row_popcount

__all__ = ["bitmap_intersect_ref", "fused_expand_intersect_ref",
           "flash_decode_ref", "leaf_count_ref"]


def _jnp_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Indices into n rows as jnp takes them: negatives from the end, then
    clamped into [0, n-1]."""
    idx = idx.long()
    return torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[_jnp_index(idx, table.shape[0])]


def bitmap_intersect_ref(tables, idxs):
    """R[t] = AND_j tables[j][idxs[t, j]]; pop[t] = popcount(R[t]).
    tables: k × (S_j, W) int32; idxs (T, k) int32 → (R (T, W) int32,
    pop (T, 1) int32)."""
    r = None
    for j, tbl in enumerate(tables):
        rows = _gather_rows(tbl, idxs[:, j])
        r = rows if r is None else (r & rows)
    return r, row_popcount(r)[:, None]


def fused_expand_intersect_ref(tables, idx, rows, bitpos, *, slots):
    """Two-step version of the fused expand+intersect kernel: materialize
    the child index columns (parent columns gathered through `rows`, plus
    `bitpos` as the trailing slot), then AND the per-slot table rows and
    popcount — exactly `bitmap_intersect_ref` over the gathered columns."""
    parent = idx[_jnp_index(rows, idx.shape[0])]
    cols = torch.cat([parent, bitpos[:, None]], dim=1)
    idxs = torch.stack([cols[:, s] for s in slots], dim=1)
    return bitmap_intersect_ref(tables, idxs)


def flash_decode_ref(q, k, v, lengths=None):
    """Single-token GQA decode attention, in float32.

    q: (B, H, D); k, v: (B, S, Hkv, D); lengths: (B,) int valid cache
    lengths, None for S. Query head h reads KV head h // (H / Hkv); the
    scores are `q·k / sqrt(D)` (the scale rounded in float32, as the
    reference rounds it), softmaxed over the positions < lengths[b].
    Returns (B, H, D) in q's dtype. A row with lengths[b] == 0 has nothing
    to attend to and gives NaN."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    qg = q.reshape(b, hkv, group, d).float()
    scores = torch.einsum("bngd,bsnd->bngs", qg, k.float()) * scale
    if lengths is not None:
        pos = torch.arange(s, device=k.device)
        mask = pos[None, None, None, :] < lengths[:, None, None, None]
        scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngs,bsnd->bngd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def leaf_count_ref(bms: list, groups: list[list[int]]):
    """Per-row inclusion-exclusion terms for same-label white groups.
    bms: list of (T, W) bitmaps; groups index into bms. Returns (T, n_terms)
    int32."""
    terms = []
    for g in groups:
        if len(g) == 1:
            terms.append(row_popcount(bms[g[0]]))
        elif len(g) == 2:
            a, b = bms[g[0]], bms[g[1]]
            terms += [row_popcount(a), row_popcount(b), row_popcount(a & b)]
        else:
            a, b, c = bms[g[0]], bms[g[1]], bms[g[2]]
            terms += [row_popcount(a), row_popcount(b), row_popcount(c),
                      row_popcount(a & b), row_popcount(a & c),
                      row_popcount(b & c), row_popcount(a & b & c)]
    return torch.stack(terms, dim=1)
