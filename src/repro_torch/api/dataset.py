"""Dataset: a data graph preprocessed once, matched against many times.

Everything that is query-independent — CSR adjacency, the label index,
degree vectors, the NLF neighbor-label histogram, and the label-sorted CSR
that turns compatible-neighbor selection into pure gathers (docs/compile.md)
— is built here exactly once and shared by every Matcher/query.
Per-(query, data) artifacts are cached downstream in Matcher's plan cache.

Copy of `repro.api.Dataset` without the streaming half (`apply_delta`,
`deltas_since`): `graph_version` stays 0 in this package.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from ..core.filtering import DataGraphIndex, build_data_index
from ..core.graph import (Graph, build_graph, random_walk_query,
                          synthetic_dataset, synthetic_labeled_graph)

from .signature import graph_signature

__all__ = ["Dataset"]


@dataclasses.dataclass
class Dataset:
    """A preprocessed data graph. Construct via `from_graph` / `from_edges` /
    `synthetic`, not the raw constructor."""

    graph: Graph
    index: DataGraphIndex
    name: str | None = None
    graph_version: int = 0
    _signature: str | None = dataclasses.field(default=None, repr=False)

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
