"""Dispatch adapters between the engine and the bitmap kernels.

Both adapters keep the reference's `(R, pop)` contract, with pop flattened
to (T,) int32, so the engine's contained-vertex prune never re-reduces R.
The wrappers pick the kernel or its plain version by the tensors' device.
"""
from __future__ import annotations

from .bitmap_intersect import bitmap_intersect, fused_expand_intersect

__all__ = ["make_intersect_fn", "make_fused_expand_intersect_fn"]


def make_intersect_fn():
    """Adapter for `VectorEngine(intersect_fn=...)`: (tables, idxs (T, k))
    → (R (T, W), pop (T,))."""

    def fn(tables, idxs):
        r, pop = bitmap_intersect(tables, idxs)
        return r, pop.reshape(-1)

    return fn


def make_fused_expand_intersect_fn():
    """Adapter for `VectorEngine._make_expand_fused`: (tables, parent idx
    (Tin, K0), rows, bitpos, slots) → (R (T, W), pop (T,))."""

    def fn(tables, idx, rows, bitpos, slots):
        r, pop = fused_expand_intersect(tables, idx, rows, bitpos, slots)
        return r, pop.reshape(-1)

    return fn
