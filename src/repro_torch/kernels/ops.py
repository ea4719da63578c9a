"""Dispatch adapters between the callers and the kernels.

The bitmap adapters keep the reference's `(R, pop)` contract, with pop
flattened to (T,) int32, so the engine's contained-vertex prune never
re-reduces R: `make_intersect_fn` is the `VectorEngine(intersect_fn=...)`
hook, `make_fused_expand_intersect_fn` the reference's fused contract over
a given selection, which autotunes its word-block width when given none
(`autotune_words_per_block`, as the reference's does). The engine's own
kernel routes call the redesigned entry points (`tile_intersect`,
`expand_select`, `expand_intersect`) directly. `decode_attention` is the
LM decode path's attention. The wrappers pick the kernel or its plain
version by the tensors' device.
"""
from __future__ import annotations

from . import ref
from .bitmap_intersect import (autotune_words_per_block, bitmap_intersect,
                               fused_expand_intersect)
from .flash_decode import flash_decode

__all__ = ["make_intersect_fn", "make_fused_expand_intersect_fn",
           "autotune_words_per_block", "decode_attention"]


def make_intersect_fn():
    """Adapter for `VectorEngine(intersect_fn=...)`: (tables, idxs (T, k))
    → (R (T, W), pop (T,))."""

    def fn(tables, idxs):
        r, pop = bitmap_intersect(tables, idxs)
        return r, pop.reshape(-1)

    return fn


def make_fused_expand_intersect_fn(*, words_per_block: int | None = None):
    """The reference's fused contract: (tables, parent idx (Tin, K0), rows,
    bitpos, slots) → (R (T, W), pop (T,)), with no same-label clears, at
    `words_per_block`; None autotunes it for the call's (k, W) on the
    call's device."""

    def fn(tables, idx, rows, bitpos, slots):
        wpb = words_per_block
        if wpb is None:
            wpb = autotune_words_per_block(len(tables), tables[0].shape[1],
                                           device=rows.device)
        r, pop = fused_expand_intersect(tables, idx, rows, bitpos, slots,
                                        words_per_block=wpb)
        return r, pop.reshape(-1)

    return fn


def decode_attention(q, k, v, lengths=None, *, use_kernel: bool = True):
    """(B, H, D) single-token attention over a (B, S, Hkv, D) KV cache,
    through the kernel's wrapper (the CUDA kernel on the card, its plain
    version on the CPU), or with `use_kernel=False` through the plain
    version on any device — the counterpart of the reference's
    `use_pallas` flag, whose default is the other way round."""
    if use_kernel:
        return flash_decode(q, k, v, lengths)
    return ref.flash_decode_ref(q, k, v, lengths)
