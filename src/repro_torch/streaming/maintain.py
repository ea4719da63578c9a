"""Incremental maintenance of Graph CSRs and the DataGraphIndex under deltas.

The patch path treats every CSR in the system — the graph's out/in CSRs and
the index's label-sorted CSRs — as one flat sorted key sequence
(`row * stride + dst`) and applies a delta with a single splice per CSR:
mask out deleted entries, merge inserted entries at their `searchsorted`
positions, rebuild the row pointers with one bincount. That is O(E) memcpy
but avoids the global lexsort + bincount-histogram cascade of
`build_data_index`, and (crucially) is *bit-identical* to rebuilding from
scratch — `apply_delta` with `force="patch"` and `force="rebuild"` must
produce equal arrays, which the differential suite asserts.

Derived structures ride along almost for free:

  * degrees are `np.diff` of the patched row pointers;
  * undirected NLF histograms are exactly `np.diff(lab_indptr)` reshaped,
    so the patched label CSR *is* the patched NLF;
  * directed NLF rows (union of in/out neighbor labels) are recomputed only
    for the touched vertices;
  * label buckets only ever grow (vertex deletes retire ids in place).

Above a dirtiness threshold (`rebuild_fraction` of vertices touched) the
splice loses to the from-scratch build and `apply_delta` falls back to it —
the summary records which path ran.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.filtering import DataGraphIndex, _expand_ranges
from ..core.graph import Graph

from .delta import (GraphDelta, _CanonDelta, apply_delta_reference,
                    canonicalize_delta)

__all__ = ["DeltaSummary", "apply_delta"]

_FORCE_MODES = (None, "patch", "rebuild")


@dataclasses.dataclass
class DeltaSummary:
    """What one `apply_delta` did: edit/touch sizes, which maintenance path
    ran, and the touched-vertex label set (the cache-invalidation signal —
    a compiled plan whose query labels are disjoint from `touched_labels`
    is provably unaffected by the delta; see docs/streaming.md)."""

    size: int
    n_touched: int
    dirtiness: float
    rebuilt: bool
    touched_labels: frozenset[int]
    graph_version: int = -1             # stamped by Dataset.apply_delta


def _splice_csr(indptr: np.ndarray, indices: np.ndarray, extras: list,
                del_row: np.ndarray, del_dst: np.ndarray,
                ins_row: np.ndarray, ins_dst: np.ndarray, ins_extras: list,
                n_rows_new: int, stride: int):
    """Apply entry deletes/inserts to one CSR whose rows are sorted by dst.

    The CSR is viewed as the ascending key sequence `row * stride + dst`
    (requires stride > every dst). Deleted keys are masked out, inserted
    keys merged in at their sorted positions (`searchsorted + arange`), and
    the row pointers rebuilt over `n_rows_new` rows (new rows append empty).
    `extras` are arrays aligned with `indices` (e.g. edge labels), spliced
    identically. Returns (new_indptr, new_indices, new_extras).
    """
    n_old = indptr.shape[0] - 1
    row_of = np.repeat(np.arange(n_old, dtype=np.int64), np.diff(indptr))
    key = row_of * stride + indices.astype(np.int64)
    if del_row.shape[0]:
        keep = ~np.isin(key, del_row * stride + del_dst)
        key, row_of, indices = key[keep], row_of[keep], indices[keep]
        extras = [e[keep] for e in extras]
    k = ins_row.shape[0]
    if k:
        ikey = ins_row * stride + ins_dst
        order = np.argsort(ikey)
        ikey, ins_row, ins_dst = ikey[order], ins_row[order], ins_dst[order]
        ins_extras = [e[order] for e in ins_extras]
        total = key.shape[0] + k
        pos = np.searchsorted(key, ikey) + np.arange(k)
        old_pos = np.ones(total, dtype=bool)
        old_pos[pos] = False
        new_idx = np.empty(total, dtype=indices.dtype)
        new_idx[pos] = ins_dst.astype(indices.dtype)
        new_idx[old_pos] = indices
        new_row = np.empty(total, dtype=np.int64)
        new_row[pos] = ins_row
        new_row[old_pos] = row_of
        merged = []
        for e_old, e_ins in zip(extras, ins_extras):
            buf = np.empty(total, dtype=e_old.dtype)
            buf[pos] = e_ins.astype(e_old.dtype)
            buf[old_pos] = e_old
            merged.append(buf)
        indices, row_of, extras = new_idx, new_row, merged
    new_ptr = np.zeros(n_rows_new + 1, dtype=np.int64)
    np.cumsum(np.bincount(row_of, minlength=n_rows_new), out=new_ptr[1:])
    return new_ptr, indices, extras


def _patch(graph: Graph, index: DataGraphIndex, c: _CanonDelta):
    """Incremental path: splice every CSR, refresh the derived structures.
    Bit-identical to `apply_delta_reference` + `build_data_index`."""
    n_new, width = c.n_new, index.width
    lab = c.new_labels
    stride = max(n_new, 1)
    labeled = graph.edge_labels is not None
    ins_el = [c.out_ins_el] if labeled else []

    out_ptr, out_idx, out_ex = _splice_csr(
        graph.indptr, graph.indices,
        [graph.edge_labels] if labeled else [],
        c.out_del_src, c.out_del_dst, c.out_ins_src, c.out_ins_dst,
        ins_el, n_new, stride)
    in_ptr = in_idx = None
    in_ex: list = []
    if graph.directed:
        in_ptr, in_idx, in_ex = _splice_csr(
            graph.in_indptr, graph.in_indices,
            [graph.in_edge_labels] if labeled else [],
            c.out_del_dst, c.out_del_src, c.out_ins_dst, c.out_ins_src,
            ins_el, n_new, stride)
    g2 = Graph(labels=lab, indptr=out_ptr, indices=out_idx,
               n_labels=graph.n_labels, directed=graph.directed,
               edge_labels=out_ex[0] if labeled else None,
               in_indptr=in_ptr, in_indices=in_idx,
               in_edge_labels=in_ex[0] if labeled and graph.directed
               else None)

    # label-sorted CSRs: same splice over flat rows v*width + label(dst)
    lab_ptr, lab_idx, lab_ex = _splice_csr(
        index.lab_indptr, index.lab_indices,
        [index.lab_edge_labels] if labeled else [],
        c.out_del_src * width + lab[c.out_del_dst], c.out_del_dst,
        c.out_ins_src * width + lab[c.out_ins_dst], c.out_ins_dst,
        ins_el, n_new * width, stride)
    in_lab_ptr = in_lab_idx = None
    in_lab_ex: list = []
    if graph.directed:
        in_lab_ptr, in_lab_idx, in_lab_ex = _splice_csr(
            index.in_lab_indptr, index.in_lab_indices,
            [index.in_lab_edge_labels] if labeled else [],
            c.out_del_dst * width + lab[c.out_del_src], c.out_del_src,
            c.out_ins_dst * width + lab[c.out_ins_src], c.out_ins_src,
            ins_el, n_new * width, stride)

    deg_out = np.diff(out_ptr)
    deg_in = np.diff(in_ptr) if graph.directed else None
    if graph.directed:
        # union-of-in/out NLF: recompute only the touched rows
        counts = np.zeros((n_new, width), dtype=np.int32)
        counts[:c.n_old] = index.nbr_label_counts
        t = c.touched
        if t.shape[0]:
            seg_o, pos_o = _expand_ranges(out_ptr[t], out_ptr[t + 1])
            seg_i, pos_i = _expand_ranges(in_ptr[t], in_ptr[t + 1])
            src = np.concatenate([t[seg_o], t[seg_i]])
            dst = np.concatenate([out_idx[pos_o], in_idx[pos_i]]
                                 ).astype(np.int64)
            key = np.unique(src * n_new + dst)
            src, dst = key // n_new, key % n_new
            hist = np.bincount(src * width + lab[dst],
                               minlength=n_new * width).reshape(n_new, width)
            counts[t] = hist[t].astype(np.int32)
    else:
        counts = np.diff(lab_ptr).reshape(n_new, width).astype(np.int32)

    by_label = dict(index.by_label)
    new_ids = np.arange(c.n_old, n_new, dtype=np.int64)
    for l in np.unique(lab[c.n_old:]):
        bucket = by_label.get(int(l), np.empty(0, dtype=np.int32))
        by_label[int(l)] = np.concatenate(
            [bucket, new_ids[lab[c.n_old:] == l].astype(np.int32)])

    idx2 = DataGraphIndex(
        data=g2, by_label=by_label, deg_out=deg_out, deg_in=deg_in,
        nbr_label_counts=counts, width=width,
        lab_indptr=lab_ptr, lab_indices=lab_idx,
        lab_edge_labels=lab_ex[0] if labeled else None,
        in_lab_indptr=in_lab_ptr, in_lab_indices=in_lab_idx,
        in_lab_edge_labels=in_lab_ex[0] if labeled and graph.directed
        else None)
    return g2, idx2


def apply_delta(graph: Graph, index: DataGraphIndex, delta: GraphDelta, *,
                rebuild_fraction: float = 0.25, force: str | None = None
                ) -> tuple[Graph, DataGraphIndex, DeltaSummary]:
    """Apply one validated delta to (graph, index); returns the new pair
    plus a DeltaSummary.

    Picks the incremental splice path when the delta touches at most
    `rebuild_fraction` of the (post-delta) vertices, else falls back to the
    from-scratch rebuild (`apply_delta_reference` + `build_data_index`) —
    both paths produce bit-identical results, so the threshold is purely a
    cost choice. `force` pins the path: "patch", "rebuild", or None (auto).
    Raises ValueError if the delta fails validation against `graph`.
    """
    if force not in _FORCE_MODES:
        raise ValueError(f"force must be one of {_FORCE_MODES}, "
                         f"got {force!r}")
    from ..core.filtering import build_data_index
    c = canonicalize_delta(graph, delta)
    dirtiness = c.touched.shape[0] / max(c.n_new, 1)
    rebuilt = (force == "rebuild"
               or (force is None and dirtiness > rebuild_fraction))
    if rebuilt:
        g2 = apply_delta_reference(graph, delta, c)
        idx2 = build_data_index(g2)
    else:
        g2, idx2 = _patch(graph, index, c)
    touched_labels = frozenset(
        int(l) for l in np.unique(c.new_labels[c.touched]))
    return g2, idx2, DeltaSummary(
        size=delta.size, n_touched=int(c.touched.shape[0]),
        dirtiness=float(dirtiness), rebuilt=rebuilt,
        touched_labels=touched_labels)
