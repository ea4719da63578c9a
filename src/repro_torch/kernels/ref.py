"""Plain torch versions of the kernels (correctness ground truth).

The kernel wrappers run these for CPU tensors, and `chip_smoke.py` holds
the CUDA kernels against them on the card. Gather
indices are taken as `jnp` indexing takes them — a negative index counts
from the end, and the result is clamped into the table: the engine never
produces an out-of-range index, but neither the plain versions nor the
kernels may read past a table.
"""
from __future__ import annotations

import torch

from ..core import bitops
from ..core.bitops import row_popcount

__all__ = ["bitmap_intersect_ref", "fused_expand_intersect_ref",
           "tile_intersect_ref", "expand_select_ref", "expand_intersect_ref",
           "flash_decode_ref", "flash_decode_split_ref",
           "flash_decode_partials_ref", "flash_decode_merge_ref",
           "leaf_count_ref"]


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


def _clear_cols(r, pop, cols, clear_slots):
    """The engine's same-label clears: for each c in clear_slots, clear bit
    cols[:, c] of each row (a negative entry clears nothing) and take the
    cleared bits off pop (T,)."""
    for c in clear_slots:
        r, was_set = bitops.clear_bit_rows_count(r, cols[:, c])
        pop = pop - was_set
    return r, pop


def tile_intersect_ref(tables, idx, slots, clear_slots=(), qid_slot=None):
    """The engine's pair-branch composition: stack the key columns
    idx[:, slots], `bitmap_intersect_ref`, then the same-label clears of
    idx[:, clear_slots]. With qid_slot (the superbatch's query lane) the
    tables are (Q, S_j, W) stacks and row t gathers
    tables[j][idx[t, qid_slot], idx[t, slots[j]]], each index taken as jnp
    takes it on its own axis. Returns (R (T, W) int32, pop (T,) int32)."""
    if qid_slot is None:
        idxs = torch.stack([idx[:, s] for s in slots], dim=1)
        r, pop = bitmap_intersect_ref(tables, idxs)
        return _clear_cols(r, pop[:, 0], idx, clear_slots)
    r = None
    for tbl, s in zip(tables, slots):
        q = _jnp_index(idx[:, qid_slot], tbl.shape[0])
        rows = tbl[q, _jnp_index(idx[:, s], tbl.shape[1])]
        r = rows if r is None else (r & rows)
    return _clear_cols(r, row_popcount(r), idx, clear_slots)


def expand_select_ref(r, start, n_out, idx):
    """`bitops.expand_select` and the child tile's index columns
    idx[rows] ++ bitpos. Returns (rows, bitpos, valid, total, child_idx)."""
    rows, bitpos, valid, total = bitops.expand_select(r, start, n_out)
    child = torch.cat([idx[rows.long()], bitpos[:, None]], dim=1)
    return rows, bitpos, valid, total, child


def expand_intersect_ref(r, start, n_out, idx, tables, slots,
                         clear_slots=()):
    """`expand_select_ref`, then `fused_expand_intersect_ref` over that
    selection, then the same-label clears of the child columns
    clear_slots. Returns (rows, bitpos, valid, total, child_idx, R2,
    pop2 (n_out,))."""
    rows, bitpos, valid, total, child = expand_select_ref(r, start, n_out,
                                                          idx)
    r2, pop2 = fused_expand_intersect_ref(tables, idx, rows, bitpos,
                                          slots=slots)
    r2, pop2 = _clear_cols(r2, pop2[:, 0], child, clear_slots)
    return rows, bitpos, valid, total, child, r2, pop2


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


def flash_decode_split_ref(q, k, v, lengths=None, *, chunk: int):
    """`flash_decode_ref` computed as the split kernels compute it, in
    float32: each chunk of `chunk` positions gives its partial rows
    (`flash_decode_partials_ref`: per query head its max score m, its sum
    l of exp(s - m) and acc = sum exp(s - m) v; an empty chunk m = -inf,
    l = 0, acc = 0), and the chunks merge with the log-sum-exp rescale
    exp(m_c - M) (`flash_decode_merge_ref`). The plain version of the
    combine kernel; tests use it, the main path does not. A row with
    lengths[b] == 0 gives 0/0 = NaN."""
    s = k.shape[1]
    parts = [flash_decode_partials_ref(q, k[:, c0:c0 + chunk],
                                       v[:, c0:c0 + chunk], lengths, c0)
             for c0 in range(0, s, chunk)]
    return flash_decode_merge_ref(torch.stack(parts, dim=2), q.dtype)


def flash_decode_partials_ref(q, k, v, lengths=None, offset: int = 0):
    """The decode partials of one block of cache positions [offset,
    offset + S), in float32: the reference's `_local_partials`
    (src/repro/distributed/context_parallel.py:33) and the plain version
    of `flash_decode_partials`. k, v (B, S, Hkv, D) hold the block; a
    position offset + p counts when it is < lengths[b] (every position
    with lengths None). Per (b, h) the row (acc[D], m, l): m the block's
    largest score q·k / sqrt(D), l = sum exp(s - m) and acc = sum
    exp(s - m) v. A block with no position counted gives (0, -inf, 0)
    where the reference carries m = -1e30. Returns (B, H, D + 2)
    float32."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    qg = q.reshape(b, hkv, h // hkv, d).float()
    sc = torch.einsum("bngd,bsnd->bngs", qg, k.float()) * scale
    if lengths is not None:
        pos = offset + torch.arange(s, device=k.device)
        valid = (pos[None, :] < lengths.long()[:, None])[:, None, None, :]
        sc = sc.masked_fill(~valid, float("-inf"))
    m = sc.amax(-1)                                        # (b, n, g)
    e = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m)[..., None])
    acc = torch.einsum("bngs,bsnd->bngd", e, v.float())
    return torch.cat([acc.reshape(b, h, d), m.reshape(b, h, 1),
                      e.sum(-1).reshape(b, h, 1)], dim=-1)


def flash_decode_merge_ref(partials, dtype):
    """n partial rows per (b, h), (B, H, n, D + 2) float32 as
    `flash_decode_partials_ref` gives them, merged into the output
    (B, H, D) in `dtype`: sum_i w_i acc_i / sum_i w_i l_i with w_i =
    exp(m_i - max_i m_i), an empty row (m = -inf) weighing 0 and its acc
    unread, as the kernel leaves it. The plain version of
    `flash_decode_merge`, and the reference's pmax / psum combine
    (context_parallel.py:66-71). A (b, h) whose rows are all empty gives
    0/0 = NaN."""
    d = partials.shape[-1] - 2
    acc, m, l = partials[..., :d], partials[..., d], partials[..., d + 1]
    acc = torch.where(torch.isinf(m)[..., None], 0.0, acc)
    m_all = m.amax(-1, keepdim=True)
    w = torch.where(torch.isinf(m), 0.0,
                    torch.exp(m - torch.where(torch.isinf(m_all), 0.0,
                                              m_all)))
    out = (w[..., None] * acc).sum(-2) / (w * l).sum(-1)[..., None]
    return out.to(dtype)


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
