"""Delta enumeration: embeddings created/destroyed by one graph delta.

The identity behind `Matcher.count_delta` (docs/streaming.md): an embedding
exists after a delta but not before iff it uses ≥1 inserted edge, and
existed before but not after iff it uses ≥1 removed edge (removed = explicit
edge deletes plus every edge incident to a deleted vertex). So

    count_new = count_old + |created| - |destroyed|

where `created` is counted on the post-delta graph over the inserted edges
and `destroyed` on the pre-delta graph over the removed edges. Both sides
are computed by `embeddings_touching`: a pinned DFS per (delta edge × query
edge × orientation) that enumerates complete embeddings through that pin,
deduplicating across pins (an embedding using two delta edges is reached
twice) with a set of embedding tuples. Work scales with the delta's
neighborhood, not the graph — the win delta mode exists for — but a dense
delta can still blow up, so the set is capped by `MatchOptions.delta_limit`
(`DeltaOverflow`), which callers turn into a full-recount fallback.

Matching semantics replicate `core.filtering` exactly: non-induced injective
embeddings; undirected edge labels are compared on the canonical
(min(u,w) → max(u,w)) CSR entry, mirroring `_edge_pairs`' use of the sorted
unordered-pair list (labels can be stored asymmetrically; the engines only
ever constrain the canonical direction).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.filtering import DataGraphIndex
from ..core.graph import Graph

__all__ = ["DeltaOutcome", "DeltaOverflow", "embeddings_touching"]


class DeltaOverflow(Exception):
    """Raised when a delta-enumeration pass exceeds its embedding cap
    (`MatchOptions.delta_limit`); callers fall back to a full recount."""


@dataclasses.dataclass(frozen=True)
class DeltaOutcome:
    """Result of counting one query across one delta.

    count        : embedding count on the post-delta graph
    created      : embeddings using ≥1 inserted edge (None on fallback)
    destroyed    : embeddings using ≥1 removed edge (None on fallback)
    graph_version: dataset version the count is valid for
    fallback     : True when delta enumeration overflowed (or the base
                   count was unavailable) and `count` came from a full
                   recount instead of the delta identity
    inexact      : True when the fallback recount itself timed out or hit
                   `MatchOptions.limit`, so `count` may undercount; always
                   False on the identity path (exact by construction) and
                   unusable as a future delta base
    elapsed_s    : wall time spent on this query's delta pass
    """

    count: int
    created: int | None
    destroyed: int | None
    graph_version: int
    fallback: bool = False
    inexact: bool = False
    elapsed_s: float = 0.0


def _pin_targets(query: Graph) -> list[tuple[int, int]]:
    """Query edges a delta edge can map to, as ordered (u, w) pins.

    Undirected: both orientations of each unordered pair. Directed: each
    directed edge in its own direction only (a delta edge a→b is used by an
    embedding iff some query edge u→w maps exactly onto it)."""
    pins: list[tuple[int, int]] = []
    if query.directed:
        for u in range(query.n):
            for w_ in query.neighbors(u):
                pins.append((u, int(w_)))
        return pins
    for u in range(query.n):
        for w_ in query.neighbors(u):
            w = int(w_)
            pins.append((u, w))         # both orientations: (w, u) comes up
    return pins                         # at w's own row


def _edges_ok(query: Graph, graph: Graph, qx: int, qy: int,
              vx: int, vy: int) -> bool:
    """Do (qx→vx, qy→vy) satisfy every query edge between qx and qy?
    Callers guarantee qx, qy are adjacent in the query."""
    if not query.directed:
        if not graph.has_edge(vx, vy):
            return False
        if query.edge_labels is None:
            return True
        if qx > qy:                     # canonical direction (see module doc)
            qx, qy, vx, vy = qy, qx, vy, vx
        return (query.edge_label_of(qx, qy)
                == graph.edge_label_of(vx, vy))
    for (a, b, va, vb) in ((qx, qy, vx, vy), (qy, qx, vy, vx)):
        if query.has_edge(a, b):
            if not graph.has_edge(va, vb):
                return False
            if (query.edge_labels is not None
                    and query.edge_label_of(a, b)
                    != graph.edge_label_of(va, vb)):
                return False
    return True


def _bfs_order(query: Graph, u: int, w: int) -> list[tuple[int, int]]:
    """Remaining query vertices in BFS order from the pinned pair, each with
    one already-visited neighbor to generate candidates from."""
    seen = {u, w}
    frontier = [u, w]
    order: list[tuple[int, int]] = []
    while frontier:
        nxt: list[int] = []
        for p in frontier:
            for x_ in query.all_neighbors(p):
                x = int(x_)
                if x not in seen:
                    seen.add(x)
                    order.append((x, p))
                    nxt.append(x)
        frontier = nxt
    return order


def _candidates(query: Graph, graph: Graph, index: DataGraphIndex,
                x: int, p: int, vp: int) -> np.ndarray:
    """Data vertices that could extend the mapping p→vp to query vertex x:
    neighbors of vp (in the direction of one x–p query edge) with x's
    label. Soundness only needs one existing direction; the full
    `_edges_ok` check runs afterwards."""
    lbl = int(query.labels[x])
    if lbl >= index.width:
        return np.empty(0, dtype=np.int32)
    incoming = query.directed and not query.has_edge(p, x)
    ptr, idx, _ = index.label_csr(incoming)
    base = vp * index.width + lbl
    return idx[ptr[base]:ptr[base + 1]]


def embeddings_touching(query: Graph, graph: Graph, index: DataGraphIndex,
                        pairs: np.ndarray, *, limit: int) -> int:
    """Count embeddings of `query` in `graph` that map ≥1 query edge onto
    ≥1 of the data edges in `pairs` ((k, 2); canonical (min, max) rows for
    undirected graphs, directed rows otherwise).

    Pinned DFS per (delta edge × query-edge orientation), deduplicated via
    a set of embedding tuples. Raises DeltaOverflow once the set would
    exceed `limit` — the caller's cue to recount from scratch instead.

    A single-vertex query has no edges, so no embedding of it can touch a
    delta edge and this always returns 0. Its counts still change when a
    delta *inserts vertices* with the query's label — `Matcher.count_delta`
    accounts for those directly (vertex deletes retire in place, label
    kept, so they never change a single-vertex count).
    """
    if pairs.shape[0] == 0 or query.n < 2:
        return 0
    pins = _pin_targets(query)
    qlab = query.labels
    found: set[tuple] = set()
    mapping = np.full(query.n, -1, dtype=np.int64)

    def extend(order: list[tuple[int, int]], depth: int, used: set[int]):
        if depth == len(order):
            # dedup before the cap check: re-deriving an already-counted
            # embedding (via a second delta edge or pin) at len == limit
            # must not spuriously overflow — the distinct count is capped,
            # not the number of derivations
            t = tuple(mapping.tolist())
            if t not in found:
                if len(found) >= limit:
                    raise DeltaOverflow(
                        f"delta enumeration exceeded {limit}")
                found.add(t)
            return
        x, p = order[depth]
        for v_ in _candidates(query, graph, index, x, p, int(mapping[p])):
            v = int(v_)
            if v in used:
                continue
            ok = True
            for y_ in query.all_neighbors(x):
                y = int(y_)
                if mapping[y] >= 0 and not _edges_ok(query, graph, x, y,
                                                     v, int(mapping[y])):
                    ok = False
                    break
            if ok:
                mapping[x] = v
                used.add(v)
                extend(order, depth + 1, used)
                used.discard(v)
                mapping[x] = -1

    for a_, b_ in pairs:
        va, vb = int(a_), int(b_)
        # undirected pins already include both ordered versions of each
        # query edge, so each delta edge is tried in one orientation only
        for (u, w) in pins:
            if (qlab[u] != graph.labels[va]
                    or qlab[w] != graph.labels[vb]):
                continue
            if not _edges_ok(query, graph, u, w, va, vb):
                continue
            mapping[u], mapping[w] = va, vb
            extend(_bfs_order(query, u, w), 0, {va, vb})
            mapping[u] = mapping[w] = -1
    return len(found)
