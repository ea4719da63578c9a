"""Graph data structures for the CEMR matching engine.

Host-side (numpy) CSR graphs: the data graph and query graphs live on the host;
the enumeration engine converts candidate spaces to device bitmaps.

Supports undirected vertex-labeled graphs (the paper's main model, §2.1) and
the directed / edge-labeled extension (§6.4) used by the LSQB-analog benchmark.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "Graph",
    "build_graph",
    "synthetic_labeled_graph",
    "random_walk_query",
    "DATASET_STATS",
    "synthetic_dataset",
]


@dataclasses.dataclass(frozen=True)
class Graph:
    """CSR graph. For undirected graphs both edge directions are stored.

    labels:      (n,) int32 vertex labels in [0, n_labels)
    indptr:      (n+1,) int64
    indices:     (nnz,) int32 neighbor ids, sorted per row
    directed:    if True, `indices` holds out-neighbors and `in_indptr/in_indices`
                 hold in-neighbors.
    edge_labels: optional (nnz,) int32 aligned with `indices`.
    """

    labels: np.ndarray
    indptr: np.ndarray
    indices: np.ndarray
    n_labels: int
    directed: bool = False
    edge_labels: np.ndarray | None = None
    in_indptr: np.ndarray | None = None
    in_indices: np.ndarray | None = None
    in_edge_labels: np.ndarray | None = None

    @property
    def n(self) -> int:
        return int(self.labels.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def n_edges(self) -> int:
        return self.nnz if self.directed else self.nnz // 2

    def degree(self, v: int | None = None):
        deg = np.diff(self.indptr)
        return deg if v is None else int(deg[v])

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def in_neighbors(self, v: int) -> np.ndarray:
        if not self.directed:
            return self.neighbors(v)
        assert self.in_indptr is not None and self.in_indices is not None
        return self.in_indices[self.in_indptr[v] : self.in_indptr[v + 1]]

    def all_neighbors(self, v: int) -> np.ndarray:
        """Union of in- and out-neighbors (== neighbors for undirected)."""
        if not self.directed:
            return self.neighbors(v)
        return np.union1d(self.neighbors(v), self.in_neighbors(v))

    def edge_label_of(self, v: int, w: int) -> int:
        """Label of edge v->w (searches the sorted row)."""
        row = self.neighbors(v)
        j = np.searchsorted(row, w)
        if j >= row.shape[0] or row[j] != w:
            raise KeyError(f"edge ({v},{w}) not present")
        assert self.edge_labels is not None
        return int(self.edge_labels[self.indptr[v] + j])

    def has_edge(self, v: int, w: int) -> bool:
        row = self.neighbors(v)
        j = np.searchsorted(row, w)
        return bool(j < row.shape[0] and row[j] == w)

    def adjacency_sets(self) -> list[set[int]]:
        return [set(self.neighbors(v).tolist()) for v in range(self.n)]


def _csr_from_pairs(n: int, src: np.ndarray, dst: np.ndarray,
                    elab: np.ndarray | None):
    """Sorted CSR from (src, dst) pairs; dedups parallel edges."""
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if elab is not None:
        elab = elab[order]
    if src.shape[0]:
        keep = np.ones(src.shape[0], dtype=bool)
        keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        src, dst = src[keep], dst[keep]
        if elab is not None:
            elab = elab[keep]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst.astype(np.int32), elab


def build_graph(
    n: int,
    edges: Iterable[tuple[int, int]] | np.ndarray,
    labels: Sequence[int] | np.ndarray,
    *,
    directed: bool = False,
    edge_labels: Sequence[int] | np.ndarray | None = None,
    n_labels: int | None = None,
) -> Graph:
    e = np.asarray(list(edges) if not isinstance(edges, np.ndarray) else edges,
                   dtype=np.int64).reshape(-1, 2)
    lab = np.asarray(labels, dtype=np.int32)
    assert lab.shape[0] == n
    elab = None if edge_labels is None else np.asarray(edge_labels, dtype=np.int32)
    # drop self loops
    if e.shape[0]:
        keep = e[:, 0] != e[:, 1]
        e = e[keep]
        if elab is not None:
            elab = elab[keep]
    src, dst = e[:, 0], e[:, 1]
    if directed:
        indptr, indices, out_el = _csr_from_pairs(n, src, dst, elab)
        in_indptr, in_indices, in_el = _csr_from_pairs(n, dst, src, elab)
        return Graph(labels=lab, indptr=indptr, indices=indices,
                     n_labels=n_labels or int(lab.max(initial=0)) + 1,
                     directed=True, edge_labels=out_el,
                     in_indptr=in_indptr, in_indices=in_indices,
                     in_edge_labels=in_el)
    src2 = np.concatenate([src, dst])
    dst2 = np.concatenate([dst, src])
    elab2 = None if elab is None else np.concatenate([elab, elab])
    indptr, indices, el = _csr_from_pairs(n, src2, dst2, elab2)
    return Graph(labels=lab, indptr=indptr, indices=indices,
                 n_labels=n_labels or int(lab.max(initial=0)) + 1,
                 directed=False, edge_labels=el)


def synthetic_labeled_graph(
    n: int,
    avg_degree: float,
    n_labels: int,
    seed: int,
    *,
    power_law: bool = True,
    directed: bool = False,
    n_edge_labels: int | None = None,
) -> Graph:
    """Synthetic labeled graph with roughly the requested |V|, avg degree, |Σ|.

    Power-law degree profile (configuration-model style with rejection of
    self-loops) mirrors the heavy-tailed degree distributions of the paper's
    datasets (Table 2).
    """
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / (1 if directed else 2))
    if power_law:
        w = (np.arange(1, n + 1, dtype=np.float64)) ** (-0.75)
        w /= w.sum()
        perm = rng.permutation(n)
        src = perm[rng.choice(n, size=m, p=w)]
        dst = perm[rng.choice(n, size=m, p=w)]
    else:
        src = rng.integers(0, n, size=m)
        dst = rng.integers(0, n, size=m)
    labels = rng.integers(0, n_labels, size=n)
    elab = (rng.integers(0, n_edge_labels, size=m)
            if n_edge_labels is not None else None)
    return build_graph(n, np.stack([src, dst], 1), labels, directed=directed,
                       edge_labels=elab, n_labels=n_labels)


def random_walk_query(
    data: Graph, size: int, seed: int, *, dense: bool | None = None
) -> Graph:
    """Paper §7.1.2: random-walk over the data graph, extract the induced
    subgraph on the visited vertices.  Guarantees ≥1 embedding.

    `dense=True` keeps all induced edges; `dense=False` keeps a spanning
    walk-tree plus few extra edges (sparse query, avg degree < 3).
    """
    rng = np.random.default_rng(seed)
    for _attempt in range(64):
        start = int(rng.integers(0, data.n))
        if data.degree(start) == 0:
            continue
        visited: list[int] = [start]
        vset = {start}
        cur = start
        steps = 0
        while len(visited) < size and steps < size * 30:
            steps += 1
            nbrs = data.neighbors(cur)
            if nbrs.shape[0] == 0:
                cur = visited[int(rng.integers(0, len(visited)))]
                continue
            cur = int(nbrs[int(rng.integers(0, nbrs.shape[0]))])
            if cur not in vset:
                vset.add(cur)
                visited.append(cur)
        if len(visited) == size:
            break
    else:
        raise RuntimeError("could not sample a connected query")
    vid = {v: i for i, v in enumerate(visited)}
    edges, elabs = [], []
    for v in visited:
        for w in data.neighbors(v):
            w = int(w)
            if w in vset and vid[v] < vid[w]:
                edges.append((vid[v], vid[w]))
                if data.edge_labels is not None:
                    elabs.append(data.edge_label_of(v, int(w)))
    edges_a = np.asarray(edges, dtype=np.int64)
    if dense is False and edges_a.shape[0] > size:  # sparsify: keep a connected core
        keep = _sparsify_connected(size, edges_a, rng, target_m=size + size // 4)
        edges_a = edges_a[keep]
        if elabs:
            elabs = list(np.asarray(elabs)[keep])
    labels = data.labels[np.asarray(visited)]
    return build_graph(size, edges_a, labels, directed=data.directed,
                       edge_labels=(elabs if data.edge_labels is not None else None),
                       n_labels=data.n_labels)


def _sparsify_connected(n, edges, rng, target_m):
    """Mask keeping a spanning set + random extras (connected result)."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    order = rng.permutation(edges.shape[0])
    keep = np.zeros(edges.shape[0], dtype=bool)
    kept = 0
    for idx in order:  # spanning forest first
        a, b = find(int(edges[idx, 0])), find(int(edges[idx, 1]))
        if a != b:
            parent[a] = b
            keep[idx] = True
            kept += 1
    for idx in order:
        if kept >= target_m:
            break
        if not keep[idx]:
            keep[idx] = True
            kept += 1
    return keep


# Paper Table 2 statistics — synthetic stand-ins are generated to match
# (|V|, |E|, |Σ|, avg degree).  Scaled variants available for CI-speed runs.
DATASET_STATS: dict[str, tuple[int, int, int]] = {
    # name: (|V|, |Σ|, avg_degree)
    "yeast": (3_112, 71, 8),
    "human": (4_674, 44, 37),
    "hprd": (9_460, 307, 7),
    "wordnet": (76_853, 5, 3),
    "dblp": (317_080, 15, 7),
    "eu2005": (862_664, 40, 37),
    "youtube": (1_134_890, 25, 5),
    "patents": (3_774_768, 20, 9),
}


def synthetic_dataset(name: str, *, scale: float = 1.0, seed: int = 0) -> Graph:
    n, n_labels, avg_deg = DATASET_STATS[name]
    n = max(64, int(n * scale))
    # stable per-name offset: builtin hash() is salted per process, which
    # made benchmark workloads (and perf-gate margins) vary across runs
    name_seed = zlib.crc32(name.encode()) % 9973
    return synthetic_labeled_graph(n, avg_deg, n_labels, seed=seed + name_seed)
