"""The benchmark's own inputs: data graphs and query pools, in NumPy.

These are copies of the port's generators (`synthetic_labeled_graph`,
`synthetic_dataset` and the default induced `random_walk_query` of
`repro_torch.core.graph`), kept here so that the yardstick does not move
with the program: for the same seeds they give the same arrays, bit for bit
(the harness's tests hold them to it). A configuration that states its
edge count (`edges`) gets exactly that many edges, which the port's
generator does not promise; that one path is the harness's own. The CSR is sorted and deduplicated
through one sort of a combined int64 key instead of a lexsort of pairs,
which gives the same arrays in a fraction of the time.

A configuration's data graph is fixed by the configuration's own seed and
cached as an `.npz` file under `cardbench/.cache/` (a fixed directory inside
the checkout, listed in `.gitignore`), so that only the first run of a
configuration in a checkout generates it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zlib
from pathlib import Path

import numpy as np

__all__ = ["CSR", "DATASET_STATS", "synthetic_graph", "random_walk_query",
           "load_graph", "query_pool", "pool_sizes", "replay_order",
           "CACHE_DIR"]

CACHE_DIR = Path(__file__).resolve().parent / ".cache"

# CEMR's Table 2: name -> (|V|, |Sigma|, average degree), as the port has it
DATASET_STATS: dict[str, tuple[int, int, int]] = {
    "yeast": (3_112, 71, 8),
    "human": (4_674, 44, 37),
    "hprd": (9_460, 307, 7),
    "wordnet": (76_853, 5, 3),
    "dblp": (317_080, 15, 7),
    "eu2005": (862_664, 40, 37),
    "youtube": (1_134_890, 25, 5),
    "patents": (3_774_768, 20, 9),
}


@dataclasses.dataclass(frozen=True)
class CSR:
    """An undirected vertex-labeled graph: both directions of each edge,
    each row's neighbours sorted, no self loops or parallel edges."""

    labels: np.ndarray        # (n,) int32
    indptr: np.ndarray        # (n + 1,) int64
    indices: np.ndarray       # (nnz,) int32
    n_labels: int

    @property
    def n(self) -> int:
        return int(self.labels.shape[0])

    @property
    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def _csr(n: int, src: np.ndarray, dst: np.ndarray, labels: np.ndarray,
         n_labels: int) -> CSR:
    """Symmetrised, sorted, deduplicated CSR of the edge list (src, dst)."""
    keep = src != dst
    src, dst = src[keep].astype(np.int64), dst[keep].astype(np.int64)
    key = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    rows = key // n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return CSR(labels=np.asarray(labels, dtype=np.int32), indptr=indptr,
               indices=(key % n).astype(np.int32), n_labels=int(n_labels))


def synthetic_graph(name: str, *, scale: float = 1.0, seed: int = 0,
                    edges: int | None = None) -> CSR:
    """The synthetic stand-in for a Table 2 dataset: power-law endpoints
    (weights i^-0.75 over a seeded permutation), uniform labels.

    With `edges` None, n * average degree / 2 endpoint pairs are drawn and
    the graph is the port's `synthetic_dataset`, bit for bit (self loops
    and repeated pairs dropped, so it has somewhat fewer edges). With
    `edges` (the published count, cut by `scale`), pairs are drawn in
    rounds until that many distinct undirected edges have come, and the
    first that many, in the order drawn, are kept: the published edge
    count exactly."""
    n, n_labels, avg_deg = DATASET_STATS[name]
    n_full = n
    n = max(64, int(n * scale))
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 9973)
    w = np.arange(1, n + 1, dtype=np.float64) ** (-0.75)
    w /= w.sum()
    perm = rng.permutation(n)
    if edges is None:
        m = int(n * avg_deg / 2)
        src = perm[rng.choice(n, size=m, p=w)]
        dst = perm[rng.choice(n, size=m, p=w)]
    else:
        want = max(1, round(edges * n / n_full))
        keys = np.empty(0, dtype=np.int64)
        draw = want
        while True:
            s = perm[rng.choice(n, size=draw, p=w)].astype(np.int64)
            d = perm[rng.choice(n, size=draw, p=w)].astype(np.int64)
            keep = s != d
            keys = np.concatenate([keys, np.minimum(s, d)[keep] * n
                                   + np.maximum(s, d)[keep]])
            uniq, first = np.unique(keys, return_index=True)
            if uniq.shape[0] >= want:
                break
            draw = (want - uniq.shape[0]) * 5 // 4 + 64
        kept = keys[np.sort(first)[:want]]
        src, dst = kept // n, kept % n
    labels = rng.integers(0, n_labels, size=n)
    return _csr(n, src, dst, labels, n_labels)


def random_walk_query(data: CSR, size: int, seed: int) -> CSR:
    """CEMR section 7.1.2: a random walk over the data graph, and the
    subgraph induced on the vertices it visits (so it has an embedding)."""
    rng = np.random.default_rng(seed)
    for _attempt in range(64):
        start = int(rng.integers(0, data.n))
        if data.indptr[start + 1] == data.indptr[start]:
            continue
        visited = [start]
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
    src, dst = [], []
    for v in visited:
        for w in data.neighbors(v).tolist():
            if w in vset and vid[v] < vid[w]:
                src.append(vid[v])
                dst.append(vid[w])
    return _csr(size, np.asarray(src, dtype=np.int64),
                np.asarray(dst, dtype=np.int64),
                data.labels[np.asarray(visited)], data.n_labels)


def _cache_path(config: dict) -> Path:
    """One file per configuration and generator parameters."""
    params = {k: config.get(k) for k in ("dataset", "scale", "graph_seed",
                                         "edges")}
    digest = hashlib.sha1(json.dumps(params, sort_keys=True).encode())
    return CACHE_DIR / f"{config['name']}-{digest.hexdigest()[:12]}.npz"


def load_graph(config: dict, *, cache: bool = True) -> tuple[CSR, bool]:
    """The configuration's data graph, and whether it came from the cache.
    A miss generates it and, with `cache`, writes the cache file (under a
    private name first, then renamed, so a reader never sees half a
    file)."""
    path = _cache_path(config)
    if cache and path.exists():
        with np.load(path) as z:
            return CSR(labels=z["labels"], indptr=z["indptr"],
                       indices=z["indices"],
                       n_labels=int(z["n_labels"])), True
    g = synthetic_graph(config["dataset"], scale=config["scale"],
                        seed=config["graph_seed"], edges=config.get("edges"))
    if cache:
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
        np.savez(tmp, labels=g.labels, indptr=g.indptr, indices=g.indices,
                 n_labels=np.int64(g.n_labels))
        os.replace(tmp, path)
    return g, False


def query_pool(data: CSR, pool: dict, config: dict) -> list[CSR]:
    """A traffic mix's fixed pool: `per_size` queries of each size in
    `sizes`, query i of size s drawn with seed pool_seed + 1000 * s + i;
    then, with `exact`, the configuration's `exact` queries of those sizes,
    listed as [size, seed] pairs: queries found (`select_exact.py`) to
    have fewer embeddings than the limit, whose answers are exact counts.
    Every size has to be one of the configuration's `query_sizes`."""
    sizes = list(pool["sizes"])
    allowed = config.get("query_sizes", sizes)
    if not set(sizes) <= set(allowed):
        raise ValueError(f"pool sizes {sizes} outside the configuration's "
                         f"query_sizes {allowed}")
    qs = [random_walk_query(data, s, pool["pool_seed"] + 1000 * s + i)
          for s in sizes for i in range(pool["per_size"])]
    if pool.get("exact"):
        qs += [random_walk_query(data, s, seed)
               for s, seed in config.get("exact", []) if s in sizes]
    return qs


def pool_sizes(pool: list[CSR]) -> np.ndarray:
    return np.asarray([q.n for q in pool], dtype=np.int64)


def replay_order(sizes: np.ndarray, seed: int) -> np.ndarray:
    """The order in which a pass replays the pool: each size's queries in
    an order drawn from `seed`, and the sizes spread evenly through the
    pass (query j of a size's n at (j + 1/2) / n of the way), so that any
    stretch of a pass holds the sizes in the pool's proportions, whatever
    the seed: the seed changes the order, not the work in a window."""
    rng = np.random.default_rng(seed)
    idx, at = [], []
    for s in np.unique(sizes):
        members = np.flatnonzero(sizes == s)
        idx.append(members[rng.permutation(members.shape[0])])
        at.append((np.arange(members.shape[0]) + 0.5) / members.shape[0]
                  + s * 1e-9)
    idx, at = np.concatenate(idx), np.concatenate(at)
    return idx[np.argsort(at, kind="stable")]
