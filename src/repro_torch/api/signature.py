"""Canonical query/graph signatures for plan-cache keys.

A Graph built by `build_graph` is already in canonical CSR form (rows sorted,
parallel edges deduped, self-loops dropped), so hashing the CSR arrays gives
a stable identity: two Graph objects with identical vertex numbering,
labels, and edges share a signature. The signature is *not* isomorphism-
invariant — a relabeled query compiles its own plan, which is correct since
plans are expressed in query-vertex ids.
"""
from __future__ import annotations

import hashlib

import numpy as np

from ..core.graph import Graph

__all__ = ["graph_signature"]


def graph_signature(g: Graph) -> str:
    """Stable 128-bit hex content hash of a canonical-CSR Graph
    (directedness, labels, adjacency, edge labels). Equal for structurally
    identical Graph objects; not isomorphism-invariant."""
    h = hashlib.blake2b(digest_size=16)
    h.update(b"d" if g.directed else b"u")
    for arr in (g.labels, g.indptr, g.indices):
        h.update(np.ascontiguousarray(arr).tobytes())
        h.update(b"|")
    if g.edge_labels is not None:
        h.update(np.ascontiguousarray(g.edge_labels).tobytes())
    return h.hexdigest()
