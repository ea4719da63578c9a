"""Torch bitset utilities for the vectorized CEMR engine.

Candidate sets are bitmaps over per-label candidate spaces, stored as int32
tensors that hold the same bits as the reference's uint32 words
(`ndarray.view(np.int32)`): torch's uint32 lacks `~`, `>>`, `<<` and
indexing on the CPU. `>>` on int32 is arithmetic, so every right shift whose
high bits matter is masked. Every function is bit-exact against
`repro.core.bitops`.
"""
from __future__ import annotations

import torch

__all__ = ["popcount_words", "row_popcount", "onehot_word_mask",
           "clear_bit_rows", "clear_bit_rows_count", "expand_select",
           "nth_set_bit"]


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount (int32 bit pattern → int32), SWAR: torch has no
    popcount op. The masks keep the sign bit out of each arithmetic shift,
    and the int32 multiply wraps, so the final `>> 24` is masked to 8 bits."""
    x = words - ((words >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def row_popcount(bm: torch.Tensor) -> torch.Tensor:
    """(…, W) bitmap → (…,) int32 total set bits (int32 accumulator, as the
    reference keeps it: `torch.sum` of int32 would give int64)."""
    return popcount_words(bm).sum(dim=-1, dtype=torch.int32)


def onehot_word_mask(idx: torch.Tensor, n_words: int) -> torch.Tensor:
    """(T,) int32 bit positions → (T, n_words) int32 with that single bit set.
    Negative idx → all-zero row."""
    word = idx >> 5
    bit = idx & 31
    cols = torch.arange(n_words, dtype=torch.int32, device=idx.device)[None, :]
    hit = (cols == word[:, None]) & (idx >= 0)[:, None]
    one = torch.ones((), dtype=torch.int32, device=idx.device)
    return torch.where(hit, one << bit[:, None], torch.zeros_like(one))


def clear_bit_rows(bm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Clear bit `idx[t]` in row t of bitmap (T, W). idx<0 → no-op row."""
    return bm & ~onehot_word_mask(idx, bm.shape[-1])


def clear_bit_rows_count(bm: torch.Tensor, idx: torch.Tensor):
    """Like clear_bit_rows, but also return (T,) int32 with 1 where the bit
    was actually set."""
    mask = onehot_word_mask(idx, bm.shape[-1])
    was_set = ((bm & mask) != 0).any(dim=-1).to(torch.int32)
    return bm & ~mask, was_set


def nth_set_bit(word: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """(K,) int32 word, (K,) int32 rank → bit position of the rank-th set bit
    (0-based). Returns 0 when rank ≥ popcount(word), like the reference's
    argmax over an all-false row."""
    shifts = torch.arange(32, dtype=torch.int32, device=word.device)
    bits = (word[:, None] >> shifts[None, :]) & 1                 # (K, 32)
    cums = torch.cumsum(bits, dim=1, dtype=torch.int32)
    cond = (cums == rank[:, None] + 1) & (bits == 1)
    # argmax over an int tensor (not bool) returns the first maximum
    return torch.argmax(cond.to(torch.int32), dim=1).to(torch.int32)


def expand_select(bm: torch.Tensor, start, k: int):
    """Row-major enumeration of set bits of a (T, W) bitmap.

    Selects global set-bit ranks [start, start+k) in row-major order and
    returns (rows, bitpos, valid, total):
      rows   (k,) int32 source row of each selected bit
      bitpos (k,) int32 bit position (candidate-space index) of the bit
      valid  (k,) bool  rank < total
      total  ()   int32 total set bits in bm
    """
    dev = bm.device
    t_rows, n_words = bm.shape
    pc = popcount_words(bm)                                       # (T, W)
    row_counts = pc.sum(dim=1, dtype=torch.int32)
    cum = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                     torch.cumsum(row_counts, dim=0, dtype=torch.int32)])
    total = cum[-1]
    g = start + torch.arange(k, dtype=torch.int32, device=dev)
    rows = torch.clamp(
        torch.searchsorted(cum, g, right=True, out_int32=True) - 1,
        0, t_rows - 1)
    rows_l = rows.long()
    q = g - cum[rows_l]                                           # within-row
    pc_r = pc[rows_l]                                             # (k, W)
    pcc = torch.cumsum(pc_r, dim=1, dtype=torch.int32)
    word_idx = (pcc <= q[:, None]).sum(dim=1, dtype=torch.int32)
    word_idx = torch.clamp(word_idx, 0, n_words - 1)
    wi = word_idx.long()[:, None]
    q_in_word = q - torch.gather(pcc - pc_r, 1, wi)[:, 0]
    words = torch.gather(bm[rows_l], 1, wi)[:, 0]
    bit = nth_set_bit(words, q_in_word)
    bitpos = word_idx * 32 + bit
    valid = g < total
    return rows, bitpos, valid, total
