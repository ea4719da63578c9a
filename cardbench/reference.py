"""The plain reference: how many embeddings a query has, in NumPy alone.

An embedding of a labeled query graph q in a labeled data graph G maps each
query vertex to a data vertex of the same label, distinct query vertices to
distinct data vertices, and each query edge to a data edge (a
monomorphism; extra data edges are allowed). `count` returns the number of
embeddings, or `limit` where there are at least that many, which is what
`Matcher.count(query, limit=limit)` promises.

It shares nothing with the program under test: candidates by label and
degree, refined until every candidate of u has a candidate neighbour for
each query edge (u, w); a greedy connected matching order; then a
depth-first search over blocks of partial embeddings, each block extended
one query vertex at a time with array operations over each vertex's
neighbours grouped by label. `injective=False` drops
the distinct-vertices rule (it counts homomorphisms instead): that is the
control, which has to come out as not correct; `clamp=False` is a second
one, which breaks the answer's cap at the limit instead.
"""
from __future__ import annotations

import numpy as np

from .datasets import CSR

__all__ = ["DataIndex", "count"]

_BLOCK = 4096          # partial embeddings extended together
_GATHER = 1 << 22      # neighbour entries gathered at most at once
_ROUNDS = 4            # candidate refinement rounds (pruning only)


class DataIndex:
    """What the search reads of the data graph: each vertex's neighbours
    grouped by label (`nbr`, `ptr[v * L + l]` to `ptr[v * L + l + 1]`),
    and the sorted keys src * n + dst of every directed edge for edge
    lookups."""

    def __init__(self, g: CSR):
        self.g = g
        n, L = g.n, g.n_labels
        self.deg = np.diff(g.indptr)
        src = np.repeat(np.arange(n, dtype=np.int64), self.deg)
        self.keys = src * n + g.indices     # sorted: rows and rows' entries
        group = src * L + g.labels[g.indices]
        self.nbr = g.indices[np.argsort(group * n + g.indices)]
        self.ptr = np.zeros(n * L + 1, dtype=np.int64)
        np.cumsum(np.bincount(group, minlength=n * L), out=self.ptr[1:])

    def has_edge(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        k = x.astype(np.int64) * self.g.n + y
        pos = np.searchsorted(self.keys, k)
        pos[pos == self.keys.shape[0]] = 0
        return self.keys[pos] == k

    def n_with(self, parents: np.ndarray, label: int) -> np.ndarray:
        """How many neighbours of each parent have `label`."""
        at = parents.astype(np.int64) * self.g.n_labels + label
        return self.ptr[at + 1] - self.ptr[at]

    def gather(self, parents: np.ndarray,
               label: int) -> tuple[np.ndarray, np.ndarray]:
        """Every neighbour with `label` of each parent, and the parent's
        position."""
        starts = self.ptr[parents.astype(np.int64) * self.g.n_labels + label]
        lens = self.n_with(parents, label)
        owner = np.repeat(np.arange(parents.shape[0]), lens)
        first = np.cumsum(lens) - lens
        offs = np.arange(owner.shape[0]) - first[owner]
        return self.nbr[starts[owner] + offs], owner


def _candidates(d: DataIndex, q: CSR) -> list[np.ndarray]:
    """Boolean candidate masks over the data vertices, one per query
    vertex: the label, a degree at least the query vertex's, and (after
    up to `_ROUNDS` rounds of refinement) a candidate neighbour for every
    query edge."""
    qdeg = q.degree
    masks = [(d.g.labels == q.labels[u]) & (d.deg >= qdeg[u])
             for u in range(q.n)]
    for _ in range(_ROUNDS):
        changed = False
        for u in range(q.n):
            cand = np.flatnonzero(masks[u])
            ok = np.ones(cand.shape[0], dtype=bool)
            for w in q.neighbors(u).tolist():
                nbr, owner = d.gather(cand, int(q.labels[w]))
                ok &= np.bincount(owner[masks[w][nbr]],
                                  minlength=cand.shape[0]) > 0
            if not ok.all():
                masks[u][cand[~ok]] = False
                changed = True
        if not changed:
            break
    return masks


def _order(q: CSR, sizes: list[int]) -> list[int]:
    """Fewest candidates per query degree first, then always a vertex
    joined to those already placed: most such joins, then fewest
    candidates."""
    qdeg = q.degree
    order = [min(range(q.n), key=lambda u: (sizes[u] / max(qdeg[u], 1), u))]
    placed = set(order)
    while len(order) < q.n:
        best = None
        for u in range(q.n):
            if u in placed:
                continue
            joins = sum(1 for w in q.neighbors(u).tolist() if w in placed)
            if joins == 0:
                continue
            key = (-joins, sizes[u], u)
            if best is None or key < best[0]:
                best = (key, u)
        order.append(best[1])
        placed.add(best[1])
    return order


def _extend(d: DataIndex, block: np.ndarray, back: list[int],
            same_label: list[int], label: int, mask: np.ndarray,
            injective: bool, leaf: bool) -> np.ndarray | int:
    """Every extension of each partial embedding (a row of `block`) by one
    vertex joined to the columns `back`; columns `same_label` hold data
    vertices that the new one must differ from. At the last query vertex
    (`leaf`) only their number."""
    # walk from the joined column whose vertices have the fewest neighbours
    b0 = min(back, key=lambda b: int(d.n_with(block[:, b], label).sum()))
    out, n_leaf = [], 0
    lens = d.n_with(block[:, b0], label)
    start = 0
    while start < block.shape[0]:
        stop = start + max(1, int(np.searchsorted(
            np.cumsum(lens[start:]), _GATHER, side="right")))
        rows = block[start:stop]
        cand, owner = d.gather(rows[:, b0], label)
        keep = mask[cand]
        cand, owner = cand[keep], owner[keep]
        for b in back:
            if b != b0 and cand.shape[0]:
                keep = d.has_edge(rows[owner, b], cand)
                cand, owner = cand[keep], owner[keep]
        if injective:
            for b in same_label:
                keep = rows[owner, b] != cand
                cand, owner = cand[keep], owner[keep]
        if leaf:
            n_leaf += cand.shape[0]
        else:
            out.append(np.concatenate([rows[owner], cand[:, None]], axis=1))
        start = stop
    if leaf:
        return n_leaf
    return np.concatenate(out) if len(out) > 1 else out[0]


def count(d: DataIndex, q: CSR, limit: int, *, injective: bool = True,
          clamp: bool = True) -> int:
    """min(number of embeddings of q in the data graph, limit).
    `clamp=False` (a control) returns instead the count reached when the
    block that crossed the limit was done."""
    masks = _candidates(d, q)
    sizes = [int(m.sum()) for m in masks]
    if min(sizes) == 0:
        return 0
    order = _order(q, sizes)
    pos = {u: i for i, u in enumerate(order)}
    back = [[pos[w] for w in q.neighbors(u).tolist() if pos[w] < i]
            for i, u in enumerate(order)]
    same = [[j for j in range(i) if q.labels[order[j]] == q.labels[u]]
            for i, u in enumerate(order)]
    root = np.flatnonzero(masks[order[0]]).astype(np.int64)[:, None]
    if q.n == 1:
        return min(root.shape[0], limit)
    total = 0
    stack = [root[i:i + _BLOCK] for i in range(0, root.shape[0], _BLOCK)]
    stack.reverse()
    while stack:
        block = stack.pop()
        i = block.shape[1]
        u = order[i]
        ext = _extend(d, block, back[i], same[i], int(q.labels[u]),
                      masks[u], injective, leaf=i + 1 == q.n)
        if i + 1 == q.n:
            total += ext
            if total >= limit:
                return limit if clamp else total
            continue
        for j in range(((ext.shape[0] - 1) // _BLOCK) * _BLOCK, -1,
                       -_BLOCK):
            if j < ext.shape[0]:
                stack.append(ext[j:j + _BLOCK])
    return min(total, limit)
