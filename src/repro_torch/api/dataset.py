"""Dataset: a data graph preprocessed once, matched against many times.

Everything that is query-independent — CSR adjacency, the label index,
degree vectors, the NLF neighbor-label histogram, and the label-sorted CSR
that turns compatible-neighbor selection into pure gathers (docs/compile.md)
— is built here exactly once and shared by every Matcher/query.
Per-(query, data) artifacts are cached downstream in Matcher's plan cache.

Datasets are not frozen at preprocess time: `apply_delta` applies a
validated `streaming.GraphDelta` in place, incrementally maintaining the
graph and index, and bumps the monotonic `graph_version`. Downstream caches
key on (signature, graph_version); the bounded delta log (`deltas_since`)
lets `Matcher` carry provably-unaffected compiled plans across versions
instead of recompiling (docs/streaming.md). A copy of `repro.api.Dataset`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from ..core.filtering import DataGraphIndex, build_data_index
from ..core.graph import (Graph, build_graph, random_walk_query,
                          synthetic_dataset, synthetic_labeled_graph)
from ..streaming import GraphDelta, apply_delta as _apply_delta
from ..streaming.maintain import DeltaSummary

from .signature import graph_signature

__all__ = ["Dataset"]

# retained (version, touched_labels) delta summaries per Dataset; enough to
# carry plans across a realistic update stream, small enough to be free
_DELTA_LOG_MAX = 64


@dataclasses.dataclass
class Dataset:
    """A preprocessed data graph. Construct via `from_graph` / `from_edges` /
    `synthetic`, not the raw constructor. Mutable only through
    `apply_delta`, which keeps `graph_version` monotonic."""

    graph: Graph
    index: DataGraphIndex
    name: str | None = None
    graph_version: int = 0
    _signature: str | None = dataclasses.field(default=None, repr=False)
    _delta_log: list = dataclasses.field(default_factory=list, repr=False)

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_graph(cls, graph: Graph, *, name: str | None = None) -> "Dataset":
        """Preprocess an existing Graph into a Dataset (builds the shared
        DataGraphIndex once; `name` is cosmetic, used in reprs/logs)."""
        return cls(graph=graph, index=build_data_index(graph), name=name)

    @classmethod
    def from_edges(cls, n: int, edges: Iterable[tuple[int, int]] | np.ndarray,
                   labels: Sequence[int] | np.ndarray, *,
                   directed: bool = False,
                   edge_labels: Sequence[int] | np.ndarray | None = None,
                   n_labels: int | None = None,
                   name: str | None = None) -> "Dataset":
        """Build a canonical Graph from an edge list (deduped, sorted CSR;
        optionally directed / edge-labeled) and preprocess it. Raises
        whatever `build_graph` raises on malformed input."""
        g = build_graph(n, edges, labels, directed=directed,
                        edge_labels=edge_labels, n_labels=n_labels)
        return cls.from_graph(g, name=name)

    @classmethod
    def synthetic(cls, name: str, *, scale: float = 1.0,
                  seed: int = 0) -> "Dataset":
        """Synthetic stand-in for a paper dataset (Table 2 statistics)."""
        return cls.from_graph(synthetic_dataset(name, scale=scale, seed=seed),
                              name=name)

    @classmethod
    def random(cls, n: int, avg_degree: float, n_labels: int, *,
               seed: int = 0, **kw) -> "Dataset":
        """Seeded random labeled data graph (`synthetic_labeled_graph`
        kwargs pass through: power_law, directed, n_edge_labels, ...)."""
        return cls.from_graph(
            synthetic_labeled_graph(n, avg_degree, n_labels, seed, **kw))

    # ------------------------------------------------------------- properties
    @property
    def n(self) -> int:
        """Number of data vertices."""
        return self.graph.n

    @property
    def n_edges(self) -> int:
        """Number of data edges (undirected edges counted once)."""
        return self.graph.n_edges

    @property
    def n_labels(self) -> int:
        """Size of the vertex label alphabet."""
        return self.graph.n_labels

    @property
    def signature(self) -> str:
        """Canonical content hash of the data graph (memoized); part of
        external cache keys alongside query signatures."""
        if self._signature is None:
            self._signature = graph_signature(self.graph)
        return self._signature

    # --------------------------------------------------------------- streaming
    def apply_delta(self, delta: GraphDelta, *,
                    rebuild_fraction: float = 0.25,
                    force: str | None = None) -> DeltaSummary:
        """Apply one validated edit batch in place and bump `graph_version`.

        Maintains the graph CSRs and the DataGraphIndex incrementally
        (bit-identical to a from-scratch rebuild; `force`/`rebuild_fraction`
        pass through to `streaming.apply_delta`), invalidates the memoized
        signature, and records the delta's touched-label set in the bounded
        delta log that backs `deltas_since`. Returns the DeltaSummary,
        stamped with the new version. Raises ValueError if the delta fails
        validation; the Dataset is unchanged in that case.
        """
        g2, idx2, summary = _apply_delta(
            self.graph, self.index, delta,
            rebuild_fraction=rebuild_fraction, force=force)
        self.graph = g2
        self.index = idx2
        self.graph_version += 1
        self._signature = None
        summary.graph_version = self.graph_version
        self._delta_log.append((self.graph_version, summary.touched_labels))
        del self._delta_log[:-_DELTA_LOG_MAX]
        return summary

    def deltas_since(self, version: int) -> list[frozenset] | None:
        """Touched-label sets of every delta applied after `version`, oldest
        first — the cache carry-forward signal (a compiled plan survives all
        of them iff its query's labels are disjoint from every set). Returns
        None when `version` predates the bounded log (caller must assume
        anything changed); [] when `version` is current."""
        if version == self.graph_version:
            return []
        if version > self.graph_version:
            return None
        if not self._delta_log or self._delta_log[0][0] > version + 1:
            return None
        return [labels for (v, labels) in self._delta_log if v > version]

    # ------------------------------------------------------------ conveniences
    def random_query(self, size: int, seed: int, *,
                     dense: bool | None = None) -> Graph:
        """Sample a random-walk query guaranteed to have ≥1 embedding."""
        return random_walk_query(self.graph, size, seed, dense=dense)

    def __repr__(self) -> str:  # keep huge arrays out of reprs/logs
        nm = f"{self.name!r}, " if self.name else ""
        ver = f", v{self.graph_version}" if self.graph_version else ""
        return (f"Dataset({nm}|V|={self.n}, |E|={self.n_edges}, "
                f"|Σ|={self.n_labels}{ver})")
