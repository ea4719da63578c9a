"""Neighbor sampler for minibatch GNN training (GraphSAGE-style fanout).

Real sampling over a CSR graph: for each layer, sample `fanout[l]` neighbors
per frontier node (with replacement when degree < fanout, the standard
GraphSAGE convention) and emit a layered, padded GraphBatch whose shapes are
static functions of (batch_nodes, fanout) — required for jit/pjit.
"""
from __future__ import annotations

import numpy as np

from .graph_data import GraphBatch

__all__ = ["NeighborSampler", "sampled_shape"]


def sampled_shape(batch_nodes: int, fanout: tuple[int, ...]) -> tuple[int, int]:
    """(n_nodes, n_edges) of the padded layered subgraph."""
    n = batch_nodes
    e = 0
    frontier = batch_nodes
    for f in fanout:
        e += frontier * f
        frontier *= f
        n += frontier
    return n, e


class NeighborSampler:
    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 node_feat: np.ndarray | None = None,
                 labels: np.ndarray | None = None, *, d_feat: int = 128,
                 n_classes: int = 64, seed: int = 0):
        self.indptr, self.indices = indptr, indices
        self.n = indptr.shape[0] - 1
        self.rng = np.random.default_rng(seed)
        self.node_feat = node_feat
        self.labels = labels
        self.d_feat = node_feat.shape[1] if node_feat is not None else d_feat
        self.n_classes = n_classes
        self._feat_seed = seed

    def _features(self, nodes: np.ndarray) -> np.ndarray:
        if self.node_feat is not None:
            return self.node_feat[nodes]
        # deterministic per-node synthetic features (hash-seeded)
        out = np.empty((nodes.shape[0], self.d_feat), np.float32)
        for i, v in enumerate(nodes.tolist()):
            out[i] = np.random.default_rng(self._feat_seed ^ (v * 2654435761
                                                              & 0x7FFFFFFF)
                                           ).standard_normal(self.d_feat)
        return out

    def sample(self, seeds: np.ndarray, fanout: tuple[int, ...]) -> GraphBatch:
        """Layered fanout sample. Nodes are laid out [seeds, hop1, hop2, …];
        edges point from sampled neighbor → its parent (message direction)."""
        seeds = np.asarray(seeds, np.int64)
        layers = [seeds]
        srcs, dsts = [], []
        offset = 0
        next_offset = seeds.shape[0]
        frontier = seeds
        for f in fanout:
            deg = self.indptr[frontier + 1] - self.indptr[frontier]
            # sample with replacement; isolated nodes self-loop
            r = self.rng.integers(0, np.maximum(deg, 1)[:, None],
                                  size=(frontier.shape[0], f))
            flat = self.indptr[frontier][:, None] + r
            nbrs = np.where(deg[:, None] > 0, self.indices[flat],
                            frontier[:, None])
            child_ids = next_offset + np.arange(frontier.shape[0] * f)
            parent_ids = offset + np.repeat(np.arange(frontier.shape[0]), f)
            srcs.append(child_ids)
            dsts.append(parent_ids)
            layers.append(nbrs.reshape(-1))
            offset = next_offset
            next_offset += frontier.shape[0] * f
            frontier = nbrs.reshape(-1)
        nodes = np.concatenate(layers)
        src = np.concatenate(srcs).astype(np.int32)
        dst = np.concatenate(dsts).astype(np.int32)
        n = nodes.shape[0]
        labels = (self.labels[nodes] if self.labels is not None else
                  (nodes % self.n_classes)).astype(np.int32)
        pos_rng = np.random.default_rng(int(seeds[0]) + 17)
        return GraphBatch(
            node_feat=self._features(nodes),
            positions=pos_rng.standard_normal((n, 3)).astype(np.float32),
            species=(nodes % 16).astype(np.int32),
            edge_src=src, edge_dst=dst,
            node_mask=np.ones(n, bool), edge_mask=np.ones(src.shape[0], bool),
            graph_ids=np.zeros(n, np.int32), n_graphs=1,
            node_labels=labels,
            energies=np.zeros(1, np.float32))
