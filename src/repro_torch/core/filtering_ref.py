"""Retained slow reference of the candidate-space compiler (differential
baseline).

Copy of `repro.core.filtering_ref` (numpy only).
`build_candidate_space_reference` computes exactly what
`filtering.build_candidate_space` computes — same LDF/NLF, same
pair-at-a-time refinement scheduling (the shared `_refine_and_collect`
driver), same CSR assembly — but derives each candidate's compatible
neighbors with the per-candidate Python loop of the pre-vectorization
compiler (one `_compatible_neighbors` call per candidate per query edge per
round): a differential oracle for the vectorized pipeline and the
streaming index maintenance, since the loop reads every index field
through the public accessors.
"""
from __future__ import annotations

import numpy as np

from .filtering import (CandidateSpace, DataGraphIndex, _csr_adjacency,
                        _ldf_nlf, _query_unordered_pairs, _refine_and_collect,
                        build_data_index)
from .graph import Graph

__all__ = ["build_candidate_space_reference"]


def _compatible_neighbors(query: Graph, data: Graph, u: int, w: int,
                          v: int) -> np.ndarray:
    """Data vertices v' such that mapping (u→v, w→v') satisfies every query
    edge between u and w (direction + edge label)."""
    if not query.directed:
        nb = data.neighbors(v)
        if query.edge_labels is not None:
            lbl = query.edge_label_of(u, w)
            row = data.edge_labels[data.indptr[v]:data.indptr[v + 1]]
            nb = nb[row == lbl]
        return nb
    res: np.ndarray | None = None
    if query.has_edge(u, w):  # u→w requires v→v'
        nb = data.neighbors(v)
        if query.edge_labels is not None:
            lbl = query.edge_label_of(u, w)
            row = data.edge_labels[data.indptr[v]:data.indptr[v + 1]]
            nb = nb[row == lbl]
        res = nb
    if query.has_edge(w, u):  # w→u requires v'→v
        nb = data.in_neighbors(v)
        if query.edge_labels is not None:
            lbl = query.edge_label_of(w, u)
            row = data.in_edge_labels[data.in_indptr[v]:data.in_indptr[v + 1]]
            nb = nb[row == lbl]
        res = nb if res is None else np.intersect1d(res, nb)
    assert res is not None, f"query vertices {u},{w} are not adjacent"
    return res


def _pairs_slow(query: Graph, data: Graph, cu: np.ndarray, cw: np.ndarray,
                u: int, w: int):
    """Per-candidate candidate-edge pairs: (c, j) with cand_w[j] a
    compatible neighbor of cand_u[c]. Label filtering is implicit (every
    member of cand_w carries label ℓ_w)."""
    rows: list[int] = []
    cols: list[int] = []
    if cw.shape[0]:
        for c, v in enumerate(cu.tolist()):
            nb = _compatible_neighbors(query, data, u, w, int(v))
            if nb.shape[0] == 0:
                continue
            pos = np.searchsorted(cw, nb)
            pos = np.clip(pos, 0, cw.shape[0] - 1)
            for j in np.unique(pos[cw[pos] == nb]).tolist():
                rows.append(c)
                cols.append(int(j))
    return (np.asarray(rows, dtype=np.int64),
            np.asarray(cols, dtype=np.int64))


def build_candidate_space_reference(query: Graph, data: Graph, *,
                                    refine_rounds: int = 3,
                                    index: DataGraphIndex | None = None
                                    ) -> CandidateSpace:
    if index is None:
        index = build_data_index(data)
    cand = _ldf_nlf(query, data, index)
    upairs = _query_unordered_pairs(query)

    def pair_fn(cu, cw, u, w):
        return _pairs_slow(query, data, cu, cw, u, w)

    pairs = _refine_and_collect(cand, upairs, pair_fn, refine_rounds)
    adj_indptr, adj_indices = _csr_adjacency(cand, pairs)
    return CandidateSpace(query=query, data=data, cand=cand,
                          adj_indptr=adj_indptr, adj_indices=adj_indices)
