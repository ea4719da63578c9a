"""Leaf-level counting of aggregated embeddings (paper §4.3).

At the final enumeration level an aggregated embedding maps each white vertex
to a *set* of data vertices. The number of full embeddings it represents is
the number of injective selections.  Since label constraints make cross-label
collisions impossible, the count factorizes over labels:

    count = ∏_groups  N_inj(S_1, …, S_k)

For one same-label group, the injective-selection count is computed by Möbius
inversion over set partitions:

    N_inj = Σ_{π ⊢ [k]}  ∏_{B∈π} (−1)^{|B|−1} (|B|−1)! · |∩_{i∈B} S_i|

(k=1: |S|; k=2: |S1||S2| − |S1∩S2|; the encoder caps groups at 3, but the
reference engine's all-white mode can produce larger groups so the general
formula is implemented.)
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["injective_count", "count_leaf", "iter_injective"]


@lru_cache(maxsize=None)
def _partitions(k: int) -> tuple[tuple[tuple[int, ...], ...], ...]:
    """All set partitions of range(k) as tuples of blocks."""
    if k == 0:
        return ((),)
    out: list[tuple[tuple[int, ...], ...]] = []
    for sub in _partitions(k - 1):
        # new element k-1 joins an existing block or starts its own
        for bi in range(len(sub)):
            out.append(tuple(sub[:bi]) + (sub[bi] + (k - 1,),) + tuple(sub[bi + 1:]))
        out.append(sub + ((k - 1,),))
    return tuple(out)


def injective_count(sets: list[np.ndarray]) -> int:
    """Number of injective tuples (v_1..v_k), v_i ∈ S_i, all distinct.
    Sets are arrays of data-vertex ids (unique within each set)."""
    k = len(sets)
    if k == 0:
        return 1
    if k == 1:
        return int(sets[0].shape[0])
    if k == 2:
        inter = np.intersect1d(sets[0], sets[1], assume_unique=True)
        return int(sets[0].shape[0]) * int(sets[1].shape[0]) - int(inter.shape[0])
    total = 0
    for part in _partitions(k):
        term = 1
        for block in part:
            inter = sets[block[0]]
            for i in block[1:]:
                inter = np.intersect1d(inter, sets[i], assume_unique=True)
                if inter.shape[0] == 0:
                    break
            sz = int(inter.shape[0])
            if sz == 0 and len(block) > 1:
                term = 0
                break
            sign = -1 if (len(block) - 1) % 2 else 1
            fact = 1
            for f in range(2, len(block)):
                fact *= f
            term *= sign * fact * sz
        total += term
    return int(total)


def count_leaf(white_sets_by_label: dict[int, list[np.ndarray]]) -> int:
    """Full-embedding count of an aggregated leaf: product over label groups."""
    c = 1
    for _lbl, sets in white_sets_by_label.items():
        c *= injective_count(sets)
        if c == 0:
            return 0
    return c


def iter_injective(sets: list[np.ndarray], prefix: tuple[int, ...] = ()):
    """Yield injective tuples (materialization path)."""
    if not sets:
        yield prefix
        return
    head, rest = sets[0], sets[1:]
    for v in head.tolist():
        if v in prefix:
            continue
        yield from iter_injective(rest, prefix + (v,))
