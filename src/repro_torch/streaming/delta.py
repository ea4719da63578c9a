"""GraphDelta: a validated batch of streaming edits to a data graph.

A delta is the unit of streaming maintenance (docs/streaming.md): a set of
edge inserts/deletes plus vertex inserts/retirements, validated against the
graph it will be applied to. Semantics are chosen so that the incremental
patch path (`streaming.maintain`) and the rebuild-from-scratch oracle
(`apply_delta_reference`, the differential baseline) are *bit-identical*:

  * vertex inserts append new ids `n .. n+k-1` with the given labels; edge
    inserts in the same delta may reference them;
  * vertex deletes retire a vertex *in place*: every incident edge is
    removed but the id (and its label) remains as an isolated vertex, so no
    renumbering ever happens and candidate/bitmap indices stay stable;
  * edge deletes must name existing edges, edge inserts must name absent
    ones, and no edge may appear twice in one delta — strictness keeps
    apply-vs-rebuild parity exact instead of "best effort";
  * undirected edges are canonicalized to (min, max); directed edges are
    directional, so `(a, b)` and `(b, a)` are distinct edits;
  * edge-labeled graphs require `edge_insert_labels` (one label per
    inserted edge, applied symmetrically for undirected graphs).

`random_delta` generates valid deltas for tests and benchmarks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.graph import Graph, build_graph

__all__ = ["GraphDelta", "apply_delta_reference", "random_delta"]


def _as_edge_array(edges) -> np.ndarray:
    if edges is None:
        return np.empty((0, 2), dtype=np.int64)
    arr = np.asarray(list(edges) if not isinstance(edges, np.ndarray)
                     else edges, dtype=np.int64)
    return arr.reshape(-1, 2)


def _as_1d(vals, dtype) -> np.ndarray:
    if vals is None:
        return np.empty(0, dtype=dtype)
    return np.asarray(list(vals) if not isinstance(vals, np.ndarray)
                      else vals, dtype=dtype).reshape(-1)


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One batch of graph edits, normalized to numpy arrays on construction.

    edge_inserts       : (k, 2) vertex-id pairs to add. May reference the
                         ids of vertices inserted by this same delta.
    edge_deletes       : (k, 2) pairs to remove (must exist).
    edge_insert_labels : (k,) labels aligned with `edge_inserts`; required
                         iff the target graph is edge-labeled.
    vertex_inserts     : (k,) vertex labels; new ids are assigned
                         `n .. n+k-1` in order.
    vertex_deletes     : (k,) existing vertex ids to retire (all incident
                         edges removed; the id stays, isolated).
    """

    edge_inserts: np.ndarray = None
    edge_deletes: np.ndarray = None
    edge_insert_labels: np.ndarray | None = None
    vertex_inserts: np.ndarray = None
    vertex_deletes: np.ndarray = None

    def __post_init__(self):
        object.__setattr__(self, "edge_inserts",
                           _as_edge_array(self.edge_inserts))
        object.__setattr__(self, "edge_deletes",
                           _as_edge_array(self.edge_deletes))
        if self.edge_insert_labels is not None:
            object.__setattr__(self, "edge_insert_labels",
                               _as_1d(self.edge_insert_labels, np.int32))
        object.__setattr__(self, "vertex_inserts",
                           _as_1d(self.vertex_inserts, np.int32))
        object.__setattr__(self, "vertex_deletes",
                           _as_1d(self.vertex_deletes, np.int64))

    @property
    def size(self) -> int:
        """Number of elementary edits in the batch."""
        return (self.edge_inserts.shape[0] + self.edge_deletes.shape[0]
                + self.vertex_inserts.shape[0]
                + self.vertex_deletes.shape[0])

    @property
    def is_empty(self) -> bool:
        """True when the delta contains no edits at all."""
        return self.size == 0

    def __repr__(self) -> str:
        return (f"GraphDelta(+e={self.edge_inserts.shape[0]} "
                f"-e={self.edge_deletes.shape[0]} "
                f"+v={self.vertex_inserts.shape[0]} "
                f"-v={self.vertex_deletes.shape[0]})")


@dataclasses.dataclass
class _CanonDelta:
    """A GraphDelta validated against one graph and lowered to per-direction
    CSR entry edits (internal to this package).

    out_ins / out_del hold *directed CSR entries*: for an undirected graph
    each logical edge appears in both orientations; for a directed graph
    they are the out-CSR entries (the in-CSR edits are the swapped pairs).
    """

    n_old: int
    n_new: int
    out_ins_src: np.ndarray
    out_ins_dst: np.ndarray
    out_ins_el: np.ndarray | None
    out_del_src: np.ndarray
    out_del_dst: np.ndarray
    touched: np.ndarray                 # unique touched vertex ids
    ins_pairs: np.ndarray               # (k, 2) logical inserted edges
    del_pairs: np.ndarray               # (k, 2) logical removed edges
                                        # (incl. vertex-delete incidents)
    new_labels: np.ndarray              # (n_new,) full label vector


def _err(msg: str):
    raise ValueError(f"GraphDelta: {msg}")


def canonicalize_delta(graph: Graph, delta: GraphDelta) -> _CanonDelta:
    """Validate `delta` against `graph` and lower it to per-direction CSR
    entry edits. Raises ValueError with a specific message on any invalid
    edit (see the GraphDelta docstring for the rules)."""
    n = graph.n
    v_ins = delta.vertex_inserts
    v_del = delta.vertex_deletes
    e_ins = delta.edge_inserts.copy()
    e_del = delta.edge_deletes.copy()
    elab = delta.edge_insert_labels
    n_new = n + v_ins.shape[0]

    if graph.edge_labels is not None:
        if elab is None:
            _err("graph is edge-labeled; edge_insert_labels is required")
        if elab.shape[0] != e_ins.shape[0]:
            _err(f"edge_insert_labels has {elab.shape[0]} entries for "
                 f"{e_ins.shape[0]} edge inserts")
        if elab.shape[0] and int(elab.min()) < 0:
            _err("edge labels must be non-negative")
    elif elab is not None and elab.shape[0]:
        _err("graph has no edge labels; edge_insert_labels must be None")

    if v_ins.shape[0] and (int(v_ins.min()) < 0
                           or int(v_ins.max()) >= graph.n_labels):
        _err(f"vertex_inserts labels must lie in [0, {graph.n_labels})")
    if v_del.shape[0]:
        if int(v_del.min()) < 0 or int(v_del.max()) >= n:
            _err(f"vertex_deletes ids must lie in [0, {n})")
        if np.unique(v_del).shape[0] != v_del.shape[0]:
            _err("duplicate ids in vertex_deletes")
    dead = set(v_del.tolist())

    for name, arr, hi in (("edge_deletes", e_del, n),
                          ("edge_inserts", e_ins, n_new)):
        if arr.shape[0] == 0:
            continue
        if int(arr.min()) < 0 or int(arr.max()) >= hi:
            _err(f"{name} endpoints must lie in [0, {hi})")
        if np.any(arr[:, 0] == arr[:, 1]):
            _err(f"{name} contains a self loop")
        if dead and np.any(np.isin(arr, v_del)):
            _err(f"{name} touches a vertex deleted by this delta")

    if not graph.directed:              # canonical (min, max) orientation
        e_ins = np.sort(e_ins, axis=1)
        e_del = np.sort(e_del, axis=1)
    stride = max(n_new, 1)
    ins_key = e_ins[:, 0] * stride + e_ins[:, 1]
    del_key = e_del[:, 0] * stride + e_del[:, 1]
    if np.unique(ins_key).shape[0] != ins_key.shape[0]:
        _err("duplicate edge in edge_inserts")
    if np.unique(del_key).shape[0] != del_key.shape[0]:
        _err("duplicate edge in edge_deletes")
    if np.intersect1d(ins_key, del_key).shape[0]:
        _err("an edge appears in both edge_inserts and edge_deletes")

    for a, b in e_del.tolist():
        if not graph.has_edge(int(a), int(b)):
            _err(f"edge_deletes names absent edge ({a}, {b})")
    for i, (a, b) in enumerate(e_ins.tolist()):
        if a < n and b < n and graph.has_edge(int(a), int(b)):
            _err(f"edge_inserts names existing edge ({a}, {b})")

    # vertex deletions remove every incident edge (logical del_pairs)
    extra_pairs = []
    for v in v_del.tolist():
        for w_ in graph.neighbors(v):
            w = int(w_)
            if not graph.directed:
                if w not in dead or v < w:      # dedup shared dead edges
                    extra_pairs.append((min(v, w), max(v, w)))
            else:
                extra_pairs.append((v, w))
        if graph.directed:
            for s_ in graph.in_neighbors(v):
                s = int(s_)
                if s in dead:                   # dedup: handled at s's turn
                    continue
                extra_pairs.append((s, v))
    if extra_pairs:
        extra = np.unique(np.asarray(extra_pairs, dtype=np.int64), axis=0)
        # an explicitly deleted edge can't be incident to a dead vertex
        # (validated above), so extra and e_del are disjoint
        del_pairs = np.concatenate([e_del, extra], axis=0)
    else:
        del_pairs = e_del

    # lower logical edges to per-direction CSR entries
    if graph.directed:
        out_ins_src, out_ins_dst = e_ins[:, 0], e_ins[:, 1]
        out_ins_el = elab
        out_del_src, out_del_dst = del_pairs[:, 0], del_pairs[:, 1]
    else:
        out_ins_src = np.concatenate([e_ins[:, 0], e_ins[:, 1]])
        out_ins_dst = np.concatenate([e_ins[:, 1], e_ins[:, 0]])
        out_ins_el = (np.concatenate([elab, elab])
                      if elab is not None else None)
        out_del_src = np.concatenate([del_pairs[:, 0], del_pairs[:, 1]])
        out_del_dst = np.concatenate([del_pairs[:, 1], del_pairs[:, 0]])

    touched = np.unique(np.concatenate([
        out_ins_src, out_ins_dst, out_del_src, out_del_dst,
        np.arange(n, n_new, dtype=np.int64), v_del]))
    new_labels = np.concatenate([graph.labels, v_ins.astype(np.int32)])
    return _CanonDelta(n_old=n, n_new=n_new,
                       out_ins_src=out_ins_src, out_ins_dst=out_ins_dst,
                       out_ins_el=out_ins_el,
                       out_del_src=out_del_src, out_del_dst=out_del_dst,
                       touched=touched, ins_pairs=e_ins, del_pairs=del_pairs,
                       new_labels=new_labels)


def _edge_list(graph: Graph):
    """Canonical logical edge list (src, dst, elab) of a graph: one row per
    undirected edge (src < dst) or per directed edge."""
    n = graph.n
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(graph.indptr))
    dst = graph.indices.astype(np.int64)
    el = graph.edge_labels
    if not graph.directed:
        keep = src < dst
        src, dst = src[keep], dst[keep]
        el = el[keep] if el is not None else None
    return src, dst, el


def apply_delta_reference(graph: Graph, delta: GraphDelta,
                          canon: _CanonDelta | None = None) -> Graph:
    """Rebuild-from-scratch oracle: apply `delta` by re-deriving the edge
    list and running it back through `build_graph`. The incremental patch
    path must be bit-identical to this; differential tests compare the two
    on every array.

    The surviving edges are fed back as the *full per-direction entry list*
    (not one canonical direction): `build_graph`'s stable dedup then keeps
    each direction's own edge label, so undirected graphs whose labels came
    out asymmetric from duplicate input pairs round-trip exactly. Inserted
    edges are appended once and symmetrized by `build_graph`, matching the
    patch path's symmetric insert."""
    c = canon if canon is not None else canonicalize_delta(graph, delta)
    n = graph.n
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(graph.indptr))
    dst = graph.indices.astype(np.int64)
    el = graph.edge_labels
    stride = max(c.n_new, 1)
    key = src * stride + dst
    dkey = c.out_del_src * stride + c.out_del_dst
    keep = ~np.isin(key, dkey)
    src, dst = src[keep], dst[keep]
    if el is not None:
        el = el[keep]
    src = np.concatenate([src, c.ins_pairs[:, 0]])
    dst = np.concatenate([dst, c.ins_pairs[:, 1]])
    if graph.edge_labels is not None:
        el = np.concatenate([el, delta.edge_insert_labels])
    return build_graph(c.n_new, np.stack([src, dst], axis=1), c.new_labels,
                       directed=graph.directed, edge_labels=el,
                       n_labels=graph.n_labels)


def random_delta(graph: Graph, seed: int, *, n_edge_inserts: int = 4,
                 n_edge_deletes: int = 4, n_vertex_inserts: int = 0,
                 n_vertex_deletes: int = 0,
                 n_edge_labels: int | None = None) -> GraphDelta:
    """Seeded random valid delta for `graph` (tests and benchmarks).

    Edge deletes sample existing edges, inserts sample absent pairs
    (occasionally touching freshly inserted vertices), and vertex ops are
    chosen so the strict validation in `canonicalize_delta` always passes.
    Requested op counts are caps — fewer are produced when the graph runs
    out of legal edits. `n_edge_labels` bounds inserted edge labels for
    edge-labeled graphs (defaults to max existing label + 1).
    """
    rng = np.random.default_rng(seed)
    n = graph.n
    n_new = n + n_vertex_inserts

    v_del = np.empty(0, dtype=np.int64)
    if n_vertex_deletes > 0 and n > 2:
        v_del = rng.choice(n, size=min(n_vertex_deletes, n // 4 + 1),
                           replace=False).astype(np.int64)
    dead = set(v_del.tolist())

    src, dst, _ = _edge_list(graph)
    alive = ~(np.isin(src, v_del) | np.isin(dst, v_del))
    src, dst = src[alive], dst[alive]
    deletes = np.empty((0, 2), dtype=np.int64)
    if n_edge_deletes > 0 and src.shape[0]:
        take = rng.choice(src.shape[0],
                          size=min(n_edge_deletes, src.shape[0]),
                          replace=False)
        deletes = np.stack([src[take], dst[take]], axis=1)

    existing = set((int(a), int(b)) for a, b in zip(src, dst))
    if not graph.directed:
        existing |= set((b, a) for a, b in existing)
    chosen: list[tuple[int, int]] = []
    seen = set()
    attempts = 0
    while len(chosen) < n_edge_inserts and attempts < 50 * n_edge_inserts:
        attempts += 1
        a = int(rng.integers(0, n_new))
        b = int(rng.integers(0, n_new))
        if not graph.directed and a > b:
            a, b = b, a
        if a == b or a in dead or b in dead:
            continue
        if (a, b) in existing or (a, b) in seen:
            continue
        seen.add((a, b))
        chosen.append((a, b))
    inserts = np.asarray(chosen, dtype=np.int64).reshape(-1, 2)

    elab = None
    if graph.edge_labels is not None:
        hi = (n_edge_labels if n_edge_labels is not None
              else int(graph.edge_labels.max(initial=0)) + 1)
        elab = rng.integers(0, max(hi, 1), size=inserts.shape[0])
    v_ins = (rng.integers(0, graph.n_labels, size=n_vertex_inserts)
             if n_vertex_inserts > 0 else None)
    return GraphDelta(edge_inserts=inserts, edge_deletes=deletes,
                      edge_insert_labels=elab, vertex_inserts=v_ins,
                      vertex_deletes=v_del)
