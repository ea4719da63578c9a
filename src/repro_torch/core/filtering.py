"""Preprocessing phase: candidate filtering + auxiliary structure (paper §2.2.1).

Implements:
  * LDF (label-degree filter) and NLF (neighbor-label filter) [Zhu et al.]
  * iterative edge-consistency refinement (CFL/CECI-style): every candidate of
    u must have ≥1 candidate neighbor in C(u') for every query edge (u,u')
  * the auxiliary structure  A^{u}_{u'}(v) = N(v) ∩ C(u')  as CSR arrays
    (`adj_indptr`/`adj_indices` per ordered query pair) — the reference DFS
    engine consumes rows as zero-copy slices, the vectorized engine packs
    them into uint32 bitmaps with one scatter per query edge (plan.py).

The whole compile path is flat array programs — no per-candidate Python.
The workhorse is `_edge_pairs`: for one query pair {u,w} it produces every
candidate-edge (c, j) in four vectorized steps against the data graph's
label-sorted CSR (DataGraphIndex): gather the per-candidate neighbor ranges
of label ℓ_w, expand the ragged ranges, optionally mask by edge label, and
translate data ids to candidate positions through an O(1) scratch map.
Refinement derives both endpoints' keep-masks from the same pair list (the
compatibility relation is symmetric), so each unordered query pair is
scanned once per round; the converged round's pair lists *are* the final
auxiliary structure, so the common case pays no extra pass.

Directed + edge-labeled graphs (paper §6.4): candidate edges respect direction
and edge label — if the query has u→w, data must have v→v'; if both u→w and
w→u exist, both data directions are required, each with its matching label.

`filtering_ref.build_candidate_space_reference` retains the per-candidate
implementation (the PR-2-era cost profile) behind the same round-scheduling
driver; differential tests require bit-identical output from both.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .graph import Graph

__all__ = ["CandidateSpace", "DataGraphIndex", "build_data_index",
           "build_candidate_space", "pack_bitmap_adjacency"]

_EMPTY_PAIRS = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))


@dataclasses.dataclass
class DataGraphIndex:
    """Query-independent preprocessing of one data graph, built once and
    shared across every query matched against it (`api.Dataset` owns
    one; thousands of queries amortize it — paper §7.1.2 protocol).

    by_label         : label → sorted int32 vertex ids
    deg_out/deg_in   : (n,) degrees (deg_in is None for undirected graphs)
    nbr_label_counts : (n, width) int32 — nbr_label_counts[v, ℓ] = number of
                       distinct neighbors of v (union of in/out) with label ℓ;
                       the NLF filter becomes one vectorized comparison.
    lab_indptr/lab_indices : label-sorted CSR — out-neighbors of v with label
                       ℓ are lab_indices[lab_indptr[v*width+ℓ] :
                       lab_indptr[v*width+ℓ+1]]; compatible-neighbor
                       selection becomes a pure gather.
    lab_edge_labels  : edge labels aligned with lab_indices (or None)
    in_lab_*         : the same for in-neighbors (directed graphs only)
    """

    data: Graph
    by_label: dict[int, np.ndarray]
    deg_out: np.ndarray
    deg_in: np.ndarray | None
    nbr_label_counts: np.ndarray
    width: int
    lab_indptr: np.ndarray
    lab_indices: np.ndarray
    lab_edge_labels: np.ndarray | None
    in_lab_indptr: np.ndarray | None = None
    in_lab_indices: np.ndarray | None = None
    in_lab_edge_labels: np.ndarray | None = None

    _scratch: np.ndarray | None = dataclasses.field(default=None, repr=False)

    def verts_with_label(self, lbl: int) -> np.ndarray:
        return self.by_label.get(int(lbl), np.empty(0, dtype=np.int32))

    def scratch_map(self) -> np.ndarray:
        """(n,) int64 position map shared by compiles against this index,
        kept at -1 between uses (every writer restores the entries it set).
        Lazy and Dataset-lifetime so per-query compiles skip the O(n)
        allocation+memset. Not safe for concurrent compiles."""
        if self._scratch is None:
            self._scratch = np.full(self.data.n, -1, dtype=np.int64)
        return self._scratch

    def label_csr(self, incoming: bool):
        if incoming and self.data.directed:
            return (self.in_lab_indptr, self.in_lab_indices,
                    self.in_lab_edge_labels)
        return self.lab_indptr, self.lab_indices, self.lab_edge_labels

    def out_label_counts(self) -> np.ndarray:
        """(n, width) per-(vertex, label) out-neighbor counts, recovered as
        `np.diff` of the label-sorted CSR row pointers. For undirected
        graphs these ARE the NLF histograms (`nbr_label_counts`) — the
        invariant the reference's streaming patch path (`streaming.maintain`)
        exploits to refresh NLF for free after splicing the label CSR, and
        that the streaming differential tests assert."""
        return np.diff(self.lab_indptr).reshape(self.data.n, self.width)


def _label_sorted_csr(width: int, lab: np.ndarray, indptr: np.ndarray,
                      indices: np.ndarray, edge_labels: np.ndarray | None):
    """Reorder each CSR row by (neighbor label, neighbor id) and return
    (flat (n*width+1,) indptr, reordered indices, reordered edge labels,
    (n, width) per-(vertex,label) counts)."""
    n = indptr.shape[0] - 1
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dst = indices.astype(np.int64)
    order = np.lexsort((dst, lab[dst], src))
    counts = np.bincount(src * width + lab[dst],
                         minlength=n * width).reshape(n, width)
    ptr = np.zeros(n * width + 1, dtype=np.int64)
    np.cumsum(counts.ravel(), out=ptr[1:])
    return (ptr, indices[order],
            edge_labels[order] if edge_labels is not None else None,
            counts)


def build_data_index(data: Graph) -> DataGraphIndex:
    lab = data.labels
    n = data.n
    by_label = {int(l): np.nonzero(lab == l)[0].astype(np.int32)
                for l in np.unique(lab)}
    deg_out = np.diff(data.indptr)
    deg_in = np.diff(data.in_indptr) if data.directed else None

    width = max(int(data.n_labels), int(lab.max(initial=0)) + 1)
    lab_ptr, lab_idx, lab_el, out_counts = _label_sorted_csr(
        width, lab, data.indptr, data.indices, data.edge_labels)
    in_lab_ptr = in_lab_idx = in_lab_el = None
    if data.directed:
        in_lab_ptr, in_lab_idx, in_lab_el, _ = _label_sorted_csr(
            width, lab, data.in_indptr, data.in_indices, data.in_edge_labels)
        # NLF counts the union of in/out neighbors, each distinct nbr once
        src = np.concatenate([
            np.repeat(np.arange(n, dtype=np.int64), deg_out),
            np.repeat(np.arange(n, dtype=np.int64), deg_in)])
        dst = np.concatenate([data.indices.astype(np.int64),
                              data.in_indices.astype(np.int64)])
        key = np.unique(src * n + dst)
        src, dst = key // n, key % n
        counts = np.bincount(src * width + lab[dst],
                             minlength=n * width).reshape(n, width)
    else:
        counts = out_counts
    return DataGraphIndex(data=data, by_label=by_label, deg_out=deg_out,
                          deg_in=deg_in,
                          nbr_label_counts=counts.astype(np.int32),
                          width=width, lab_indptr=lab_ptr,
                          lab_indices=lab_idx, lab_edge_labels=lab_el,
                          in_lab_indptr=in_lab_ptr, in_lab_indices=in_lab_idx,
                          in_lab_edge_labels=in_lab_el)


@dataclasses.dataclass
class CandidateSpace:
    """Filtered candidates + candidate-edge adjacency for a (Q, G) pair.

    cand[u]          : (k_u,) int32 data-vertex ids, ascending
    adj_indptr[(u,w)]: (k_u+1,) int64 CSR row pointers
    adj_indices[(u,w)]: (nnz,) int32 candidate *indices* into cand[w],
                       sorted ascending per row — row c holds
                       A^{u}_{w}(cand[u][c]), for every adjacent query pair
                       (u,w), both orders.
    """

    query: Graph
    data: Graph
    cand: list[np.ndarray]
    adj_indptr: dict[tuple[int, int], np.ndarray]
    adj_indices: dict[tuple[int, int], np.ndarray]

    def sizes(self) -> np.ndarray:
        return np.array([c.shape[0] for c in self.cand], dtype=np.int64)

    def adj_row(self, u: int, w: int, c: int) -> np.ndarray:
        """A^{u}_{w}(cand[u][c]) as a zero-copy slice of the CSR arrays."""
        ptr = self.adj_indptr[(u, w)]
        return self.adj_indices[(u, w)][ptr[c]:ptr[c + 1]]

    def index_of(self, u: int, data_vertex: int) -> int:
        c = self.cand[u]
        j = int(np.searchsorted(c, data_vertex))
        if j < c.shape[0] and c[j] == data_vertex:
            return j
        return -1


def _query_unordered_pairs(query: Graph) -> list[tuple[int, int]]:
    """All adjacent {u,w} pairs, one per unordered pair, using undirected
    adjacency."""
    pairs: set[tuple[int, int]] = set()
    for u in range(query.n):
        for w_ in query.all_neighbors(u):
            w = int(w_)
            pairs.add((u, w) if u < w else (w, u))
    return sorted(pairs)


def _expand_ranges(starts: np.ndarray, ends: np.ndarray):
    """Ragged gather: (seg, pos) with seg[i] = source row, pos[i] walking
    starts[seg[i]] .. ends[seg[i]]-1 — the flattened concatenation of all
    [starts, ends) ranges."""
    lens = ends - starts
    seg = np.repeat(np.arange(lens.shape[0], dtype=np.int64), lens)
    total = int(lens.sum())
    if total == 0:
        return seg, np.empty(0, dtype=np.int64)
    cum = np.cumsum(lens) - lens
    pos = (np.arange(total, dtype=np.int64)
           - np.repeat(cum, lens) + np.repeat(starts, lens))
    return seg, pos


def _half_pairs(index: DataGraphIndex, cu: np.ndarray, cw: np.ndarray,
                lbl_w: int, elab: int | None, incoming: bool,
                scratch: np.ndarray):
    """Candidate-edge pairs for one data-edge direction: (c, j) such that
    cand_w[j] is an (in-)neighbor of cand_u[c] with label lbl_w (and edge
    label `elab`, if given). `scratch` is an n-sized int64 map kept at -1
    between calls."""
    if cu.shape[0] == 0 or cw.shape[0] == 0 or lbl_w >= index.width:
        return _EMPTY_PAIRS
    ptr, idx, elabs = index.label_csr(incoming)
    base = cu.astype(np.int64) * index.width + lbl_w
    seg, pos = _expand_ranges(ptr[base], ptr[base + 1])
    if pos.shape[0] == 0:
        return _EMPTY_PAIRS
    dst = idx[pos].astype(np.int64)
    if elab is not None:
        m = elabs[pos] == elab
        seg, dst = seg[m], dst[m]
    scratch[cw] = np.arange(cw.shape[0], dtype=np.int64)
    j = scratch[dst]
    scratch[cw] = -1
    m = j >= 0
    return seg[m], j[m]


def _edge_pairs(query: Graph, index: DataGraphIndex, cu: np.ndarray,
                cw: np.ndarray, u: int, w: int, scratch: np.ndarray):
    """All candidate-edge pairs (c, j): mapping (u→cu[c], w→cw[j]) satisfies
    every query edge between u and w (direction + edge label). Pairs are
    unique; order is unspecified."""
    lbl_w = int(query.labels[w])
    has_el = query.edge_labels is not None
    if not query.directed:
        el = query.edge_label_of(u, w) if has_el else None
        return _half_pairs(index, cu, cw, lbl_w, el, False, scratch)
    out = None
    if query.has_edge(u, w):        # u→w requires data v→v'
        el = query.edge_label_of(u, w) if has_el else None
        out = _half_pairs(index, cu, cw, lbl_w, el, False, scratch)
    if query.has_edge(w, u):        # w→u requires data v'→v
        el = query.edge_label_of(w, u) if has_el else None
        oth = _half_pairs(index, cu, cw, lbl_w, el, True, scratch)
        if out is None:
            out = oth
        else:
            stride = max(int(cw.shape[0]), 1)
            inter = np.intersect1d(out[0] * stride + out[1],
                                   oth[0] * stride + oth[1],
                                   assume_unique=True)
            out = inter // stride, inter % stride
    assert out is not None, f"query vertices {u},{w} are not adjacent"
    return out


PairFn = Callable[[np.ndarray, np.ndarray, int, int],
                  tuple[np.ndarray, np.ndarray]]


def _refine_and_collect(cand: list[np.ndarray],
                        upairs: list[tuple[int, int]], pair_fn: PairFn,
                        refine_rounds: int
                        ) -> dict[tuple[int, int],
                                  tuple[np.ndarray, np.ndarray]]:
    """Edge-consistency refinement, pair-at-a-time Gauss-Seidel: each round
    computes every unordered pair's candidate-edge list once and keeps only
    candidates covered by ≥1 pair, on both endpoints, immediately. Mutates
    `cand`; returns final pair lists consistent with the final cand arrays.

    A converged (no-change) round leaves every cached pair list valid for
    the surviving candidates, so it doubles as the auxiliary-structure
    build; only a non-converged exit pays one extra clean pass. The driver
    is shared with filtering_ref so both compilers filter identically.
    """
    pairs: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    clean = False
    for _ in range(refine_rounds):
        changed = False
        for (u, w) in upairs:
            rc, cc = pair_fn(cand[u], cand[w], u, w)
            pairs[(u, w)] = (rc, cc)
            keep_u = np.zeros(cand[u].shape[0], dtype=bool)
            keep_u[rc] = True
            keep_w = np.zeros(cand[w].shape[0], dtype=bool)
            keep_w[cc] = True
            if u == w:                 # query self-loop: one shared cand set
                keep_u &= keep_w
                keep_w = keep_u
            if not keep_u.all():
                cand[u] = cand[u][keep_u]
                changed = True
            if u != w and not keep_w.all():
                cand[w] = cand[w][keep_w]
                changed = True
        if not changed:
            clean = True
            break
    if not clean:
        for (u, w) in upairs:
            pairs[(u, w)] = pair_fn(cand[u], cand[w], u, w)
    return pairs


def _csr_adjacency(cand: list[np.ndarray],
                   pairs: dict[tuple[int, int],
                               tuple[np.ndarray, np.ndarray]]):
    """Assemble the ordered-pair CSR adjacency (both orders per unordered
    pair) from candidate-edge lists."""
    adj_indptr: dict[tuple[int, int], np.ndarray] = {}
    adj_indices: dict[tuple[int, int], np.ndarray] = {}
    for (u, w), (rc, cc) in pairs.items():
        for (a, b, rows, cols) in ((u, w, rc, cc), (w, u, cc, rc)):
            k_a = cand[a].shape[0]
            order = np.lexsort((cols, rows))
            ptr = np.zeros(k_a + 1, dtype=np.int64)
            np.cumsum(np.bincount(rows, minlength=k_a), out=ptr[1:])
            adj_indptr[(a, b)] = ptr
            adj_indices[(a, b)] = cols[order].astype(np.int32)
    return adj_indptr, adj_indices


def _ldf_nlf(query: Graph, data: Graph,
             index: DataGraphIndex) -> list[np.ndarray]:
    """Label-degree + neighbor-label filters → initial candidate sets.
    Vectorized against the shared DataGraphIndex (one histogram comparison
    per query vertex instead of a python loop over candidates)."""
    counts = index.nbr_label_counts
    cand: list[np.ndarray] = []
    for u in range(query.n):
        base = index.verts_with_label(int(query.labels[u]))
        if data.directed:
            q_out = query.neighbors(u).shape[0]
            q_in = query.in_neighbors(u).shape[0]
            base = base[(index.deg_out[base] >= q_out)
                        & (index.deg_in[base] >= q_in)]
        else:
            base = base[index.deg_out[base] >= query.degree(u)]
        # NLF on undirected neighbor label multiset
        q_nbr_labels, q_counts = np.unique(
            query.labels[query.all_neighbors(u)], return_counts=True)
        if base.shape[0] and q_nbr_labels.shape[0]:
            if int(q_nbr_labels.max()) >= counts.shape[1]:
                base = base[:0]    # label absent from the data graph
            else:
                hist = counts[base][:, q_nbr_labels]
                base = base[np.all(hist >= q_counts[None, :], axis=1)]
        cand.append(base.astype(np.int32))
    return cand


def build_candidate_space(query: Graph, data: Graph, *,
                          refine_rounds: int = 3,
                          index: DataGraphIndex | None = None
                          ) -> CandidateSpace:
    if index is None:
        index = build_data_index(data)
    cand = _ldf_nlf(query, data, index)
    upairs = _query_unordered_pairs(query)
    scratch = index.scratch_map()

    def pair_fn(cu, cw, u, w):
        return _edge_pairs(query, index, cu, cw, u, w, scratch)

    pairs = _refine_and_collect(cand, upairs, pair_fn, refine_rounds)
    adj_indptr, adj_indices = _csr_adjacency(cand, pairs)
    return CandidateSpace(query=query, data=data, cand=cand,
                          adj_indptr=adj_indptr, adj_indices=adj_indices)


def pack_bitmap_adjacency(cs: CandidateSpace) -> dict[tuple[int, int], np.ndarray]:
    """Pack A^{u}_{w} into uint32 bitmaps: out[(u,w)] has shape
    (|C(u)|, ceil(|C(w)|/32)); bit (32*j + b) of row c is set iff
    cand[w][32*j + b] ∈ A^{u}_{w}(cand[u][c]). One vectorized scatter per
    query edge, straight from the CSR arrays."""
    out: dict[tuple[int, int], np.ndarray] = {}
    for (u, w), ptr in cs.adj_indptr.items():
        k_u = cs.cand[u].shape[0]
        k_w = cs.cand[w].shape[0]
        words = max(1, (k_w + 31) // 32)
        bm = np.zeros((k_u, words), dtype=np.uint32)
        cols = cs.adj_indices[(u, w)].astype(np.int64)
        if cols.shape[0]:
            rows = np.repeat(np.arange(k_u, dtype=np.int64), np.diff(ptr))
            np.bitwise_or.at(
                bm, (rows, cols >> 5),
                np.uint32(1) << (cols & 31).astype(np.uint32))
        out[(u, w)] = bm
    return out
