"""Independent oracle for subgraph-matching counts, used only by tests.

Copy of `repro.core.oracle`. Def. 2.1 is *non-induced* subgraph
isomorphism (monomorphism): every query edge must map to a data edge;
extra data edges are allowed. networkx's GraphMatcher provides
`subgraph_monomorphisms_iter` with exactly these semantics when run on
(G, Q). networkx is imported inside the functions, so importing this
module (or `repro_torch.core`) never needs it.
"""
from __future__ import annotations

from .graph import Graph

__all__ = ["nx_count", "nx_embeddings"]


def _to_nx(g: Graph):
    import networkx as nx
    out = nx.DiGraph() if g.directed else nx.Graph()
    for v in range(g.n):
        out.add_node(v, label=int(g.labels[v]))
    for v in range(g.n):
        row = g.indices[g.indptr[v]:g.indptr[v + 1]]
        for j, w in enumerate(row.tolist()):
            attrs = {}
            if g.edge_labels is not None:
                attrs["elabel"] = int(g.edge_labels[g.indptr[v] + j])
            out.add_edge(v, int(w), **attrs)
    return out


def nx_embeddings(query: Graph, data: Graph) -> list[dict[int, int]]:
    """All monomorphism embeddings as {query_vertex: data_vertex}."""
    import networkx as nx
    gq, gd = _to_nx(query), _to_nx(data)
    nm = nx.algorithms.isomorphism.categorical_node_match("label", -1)
    em = (nx.algorithms.isomorphism.categorical_edge_match("elabel", -1)
          if query.edge_labels is not None else None)
    cls = (nx.algorithms.isomorphism.DiGraphMatcher if query.directed
           else nx.algorithms.isomorphism.GraphMatcher)
    gm = cls(gd, gq, node_match=nm, edge_match=em)
    out = []
    for m in gm.subgraph_monomorphisms_iter():
        out.append({qv: dv for dv, qv in m.items()})
    return out


def nx_count(query: Graph, data: Graph) -> int:
    return len(nx_embeddings(query, data))
