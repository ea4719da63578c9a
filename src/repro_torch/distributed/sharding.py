"""Shard-partition helper of the port's sharded enumeration.

Copy of `partition_bitmap` from `repro.distributed.sharding` (numpy only):
the sharded schedulers (`repro_torch.core.shard`) split the root candidate
bitmap across their lanes with it, weighting each candidate by its
estimated subtree cost (`repro_torch.core.plan.root_extension_weights`).
"""
from __future__ import annotations

import numpy as np

__all__ = ["partition_bitmap"]


def partition_bitmap(mask: np.ndarray, weights: np.ndarray | None,
                     n_shards: int):
    """Greedy weight-balanced disjoint partition of a bitmap's set bits.

    Args:
        mask: (W,) uint32 packed bitmap whose set bits are the work items.
        weights: per-bit-position cost estimates, length >= 32*W (e.g.
            `plan.root_extension_weights`); None = uniform.
        n_shards: number of partitions.

    Returns:
        (parts, counts): parts is (n_shards, W) uint32 with
        OR(parts) == mask and pairwise-disjoint shards; counts is
        (n_shards,) int64 set bits per shard. Bits are assigned
        heaviest-first to the currently lightest shard, so the result is
        deterministic; when there are fewer set bits than shards the tail
        shards come back empty (counts == 0).
    """
    mask = np.ascontiguousarray(mask, dtype=np.uint32)
    parts = np.zeros((n_shards, mask.shape[0]), np.uint32)
    counts = np.zeros(n_shards, np.int64)
    bits = np.nonzero(np.unpackbits(mask.view(np.uint8),
                                    bitorder="little"))[0]
    if bits.size == 0:
        return parts, counts
    wb = (np.ones(bits.shape[0], np.float64) if weights is None
          else np.asarray(weights, np.float64)[bits])
    loads = np.zeros(n_shards, np.float64)
    for i in np.argsort(-wb, kind="stable"):
        b = int(bits[i])
        s = int(np.argmin(loads))
        loads[s] += wb[i]
        parts[s, b >> 5] |= np.uint32(1) << np.uint32(b & 31)
        counts[s] += 1
    return parts, counts
