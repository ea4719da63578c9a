"""GNN data substrate: padded GraphBatch, synthetic generators per assigned
shape, and the triplet index builder for DimeNet-family models (numpy; a
copy of the JAX package's module, whose arrays it reproduces exactly).

All four GNN architectures consume the same GraphBatch:
  * gatedgcn uses node_feat/edge features;
  * geometric models (nequip, equiformer_v2, dimenet) use positions+species —
    for non-geometric shapes (full_graph_sm / ogb_products) positions are a
    synthetic 3D layout and node features are projected in (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["GraphBatch", "synth_full_graph", "molecule_batch",
           "build_triplets", "graph_batch_specs", "batch_to_arrays"]


@dataclasses.dataclass
class GraphBatch:
    node_feat: np.ndarray | None      # (N, F) float32 (None for molecules)
    positions: np.ndarray             # (N, 3) float32
    species: np.ndarray               # (N,) int32
    edge_src: np.ndarray              # (E,) int32
    edge_dst: np.ndarray              # (E,) int32
    node_mask: np.ndarray             # (N,) bool
    edge_mask: np.ndarray             # (E,) bool
    graph_ids: np.ndarray             # (N,) int32 graph membership
    n_graphs: int
    node_labels: np.ndarray | None = None   # (N,) int32 classification target
    energies: np.ndarray | None = None      # (n_graphs,) float32 target
    triplets: tuple | None = None     # (t_kj, t_ji, t_mask) edge-index pairs

    @property
    def n(self) -> int:
        return int(self.node_mask.shape[0])

    @property
    def e(self) -> int:
        return int(self.edge_mask.shape[0])


def synth_full_graph(n_nodes: int, n_edges: int, d_feat: int, *,
                     n_classes: int = 16, n_species: int = 16, seed: int = 0,
                     with_triplets: bool = False,
                     triplet_cap_per_edge: int = 8) -> GraphBatch:
    """Random power-law-ish graph with features, labels, 3D layout."""
    rng = np.random.default_rng(seed)
    w = np.arange(1, n_nodes + 1, dtype=np.float64) ** (-0.6)
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # symmetrize (message passing is directed over both orders)
    src2 = np.concatenate([src, dst])
    dst2 = np.concatenate([dst, src])
    gb = GraphBatch(
        node_feat=rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
        positions=rng.standard_normal((n_nodes, 3)).astype(np.float32) * 3,
        species=rng.integers(0, n_species, n_nodes).astype(np.int32),
        edge_src=src2, edge_dst=dst2,
        node_mask=np.ones(n_nodes, bool),
        edge_mask=np.ones(src2.shape[0], bool),
        graph_ids=np.zeros(n_nodes, np.int32), n_graphs=1,
        node_labels=rng.integers(0, n_classes, n_nodes).astype(np.int32),
        energies=rng.standard_normal(1).astype(np.float32))
    if with_triplets:
        gb.triplets = build_triplets(gb, cap_per_edge=triplet_cap_per_edge)
    return gb


def molecule_batch(batch: int, nodes_per: int, edges_per: int, *,
                   n_species: int = 10, seed: int = 0,
                   with_triplets: bool = False) -> GraphBatch:
    """`batch` small molecules padded into one disjoint graph."""
    rng = np.random.default_rng(seed)
    n = batch * nodes_per
    pos = rng.standard_normal((n, 3)).astype(np.float32) * 1.5
    species = rng.integers(0, n_species, n).astype(np.int32)
    srcs, dsts = [], []
    for g in range(batch):
        off = g * nodes_per
        # radius-ish graph: connect nearest neighbors until edges_per
        p = pos[off:off + nodes_per]
        d2 = ((p[:, None] - p[None, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        order = np.argsort(d2, axis=None)
        pairs = np.stack(np.unravel_index(order[:edges_per], d2.shape), 1)
        srcs.append(pairs[:, 0] + off)
        dsts.append(pairs[:, 1] + off)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    gb = GraphBatch(
        node_feat=None, positions=pos, species=species,
        edge_src=src, edge_dst=dst,
        node_mask=np.ones(n, bool), edge_mask=np.ones(src.shape[0], bool),
        graph_ids=np.repeat(np.arange(batch, dtype=np.int32), nodes_per),
        n_graphs=batch, node_labels=species.copy(),
        energies=rng.standard_normal(batch).astype(np.float32))
    if with_triplets:
        gb.triplets = build_triplets(gb, cap_per_edge=edges_per)
    return gb


def build_triplets(gb: GraphBatch, *, cap_per_edge: int = 8):
    """DimeNet triplet index arrays: for each edge e=(j→i), triplet partners
    are edges k→j with k ≠ i. Returns (t_kj, t_ji, t_mask): indices into the
    edge list, padded to e·cap_per_edge.

    The cap bounds the O(Σ deg²) blow-up on large graphs (DESIGN.md §4);
    molecule-scale graphs use a cap ≥ max degree (exact).
    """
    e = gb.edge_src.shape[0]
    in_edges: dict[int, list[int]] = {}
    for idx in range(e):
        if gb.edge_mask[idx]:
            in_edges.setdefault(int(gb.edge_dst[idx]), []).append(idx)
    t_kj = np.zeros((e, cap_per_edge), np.int32)
    t_mask = np.zeros((e, cap_per_edge), bool)
    for idx in range(e):
        if not gb.edge_mask[idx]:
            continue
        j, i = int(gb.edge_src[idx]), int(gb.edge_dst[idx])
        cnt = 0
        for kj in in_edges.get(j, ()):
            if cnt >= cap_per_edge:
                break
            if int(gb.edge_src[kj]) == i:
                continue
            t_kj[idx, cnt] = kj
            t_mask[idx, cnt] = True
            cnt += 1
    t_ji = np.broadcast_to(np.arange(e, dtype=np.int32)[:, None],
                           (e, cap_per_edge)).copy()
    return t_kj.reshape(-1), t_ji.reshape(-1), t_mask.reshape(-1)


def graph_batch_specs(n_nodes: int, n_edges: int, d_feat: int | None,
                      *, n_graphs: int = 1, with_triplets: bool = False,
                      triplet_cap: int = 8):
    """{name: (shape, torch dtype)} mirroring GraphBatch (the shapes of a
    step's inputs), like the other bundles' `input_specs`."""
    spec = {
        "positions": ((n_nodes, 3), torch.float32),
        "species": ((n_nodes,), torch.int32),
        "edge_src": ((n_edges,), torch.int32),
        "edge_dst": ((n_edges,), torch.int32),
        "node_mask": ((n_nodes,), torch.bool),
        "edge_mask": ((n_edges,), torch.bool),
        "graph_ids": ((n_nodes,), torch.int32),
        "node_labels": ((n_nodes,), torch.int32),
        "energies": ((n_graphs,), torch.float32),
    }
    if d_feat:
        spec["node_feat"] = ((n_nodes, d_feat), torch.float32)
    if with_triplets:
        t = n_edges * triplet_cap
        spec["t_kj"] = ((t,), torch.int32)
        spec["t_ji"] = ((t,), torch.int32)
        spec["t_mask"] = ((t,), torch.bool)
    return spec


def batch_to_arrays(gb: GraphBatch) -> dict:
    out = {
        "positions": gb.positions, "species": gb.species,
        "edge_src": gb.edge_src, "edge_dst": gb.edge_dst,
        "node_mask": gb.node_mask, "edge_mask": gb.edge_mask,
        "graph_ids": gb.graph_ids,
    }
    if gb.node_labels is not None:
        out["node_labels"] = gb.node_labels
    if gb.energies is not None:
        out["energies"] = gb.energies
    if gb.node_feat is not None:
        out["node_feat"] = gb.node_feat
    if gb.triplets is not None:
        out["t_kj"], out["t_ji"], out["t_mask"] = gb.triplets
    return out
