"""Explicit sequence-sharded decode attention over the lanes of a mesh.

Torch counterpart of `repro.distributed.context_parallel`. The cache's S
positions are cut into one block per lane; each lane runs the decode
kernel over its own block (`flash_decode_partials`: the split kernels and
the combine's partials mode, the reference's `_local_partials`), and the
lanes' partial (acc, m, l) rows merge by the log-sum-exp identity

    o = sum_i exp(m_i - m*) acc_i / sum_i exp(m_i - m*) l_i

in `flash_decode_merge`, the same combine kernel (the reference's
`pmax` / `psum` pair). What moves between devices is q, the lengths and
one (B, H, D + 2) fp32 row a lane, independent of S; no cache byte moves.
On CPU tensors the wrappers run their plain versions.

    mesh = EnumMesh((torch.device("cuda", 0),) * 4)    # 4 lanes, one card
    out = sharded_decode_attention(q, k, v, lengths, mesh)
"""
from __future__ import annotations

from collections.abc import Sequence

import torch

from repro_torch.kernels.flash_decode import (flash_decode_merge,
                                              flash_decode_partials)
from repro_torch.launch.mesh import EnumMesh

__all__ = ["lane_blocks", "sharded_decode_attention"]


def lane_blocks(s: int, lanes: int) -> list[tuple[int, int]]:
    """The (offset, length) of each lane's block of S positions: S split
    into `lanes` blocks as even as can be (the reference's S / lanes each
    when it divides)."""
    if not 1 <= lanes <= s:
        raise ValueError(f"cannot cut {s} positions into {lanes} blocks")
    edges = [i * s // lanes for i in range(lanes + 1)]
    return [(a, b - a) for a, b in zip(edges, edges[1:])]


def _blocks(k, v, mesh: EnumMesh) -> list[tuple]:
    """(k block, v block, offset) a lane, each block on its lane's
    device."""
    if isinstance(k, torch.Tensor):
        if not isinstance(v, torch.Tensor) or k.shape != v.shape:
            raise ValueError("k and v must both be tensors of one shape")
        if any(dev != k.device for dev in mesh.devices):
            raise ValueError(f"a cache on {k.device} serves only lanes on "
                             f"{k.device}; give one block a lane for lanes "
                             f"on {sorted({str(d) for d in mesh.devices})}")
        return [(k[:, off:off + n], v[:, off:off + n], off)
                for off, n in lane_blocks(k.shape[1], mesh.size)]
    k, v = list(k), list(v)
    if len(k) != mesh.size or len(v) != mesh.size:
        raise ValueError(f"{len(k)} k and {len(v)} v blocks for "
                         f"{mesh.size} lanes")
    out, off = [], 0
    for kb, vb, dev in zip(k, v, mesh.devices):
        if kb.shape != vb.shape or kb.device != dev or vb.device != dev:
            raise ValueError(f"block {tuple(kb.shape)} on {kb.device}, "
                             f"{tuple(vb.shape)} on {vb.device} for a lane "
                             f"on {dev}")
        out.append((kb, vb, off))
        off += kb.shape[1]
    return out


def sharded_decode_attention(q: torch.Tensor, k, v,
                             lengths: torch.Tensor | None,
                             mesh: EnumMesh) -> torch.Tensor:
    """q (B, H, D); the cache either as k, v (B, S, Hkv, D) on the device
    of every lane (each lane takes a view of its block, `lane_blocks`) or
    as sequences of per-lane blocks (B, S_i, Hkv, D), block i on lane i's
    device and holding positions sum_{j<i} S_j onwards; lengths (B,) int32
    over the whole cache (None: every position). Returns (B, H, D) in q's
    dtype on q's device, equal to decode attention over the whole cache.
    The lanes run one after another on the host, each on its own device;
    the merge runs on q's device."""
    parts = []
    for kb, vb, off in _blocks(k, v, mesh):
        dev = kb.device
        lens = None if lengths is None else lengths.to(dev)
        parts.append(flash_decode_partials(q.to(dev), kb, vb, lens, off)
                     .to(q.device))
    return flash_decode_merge(torch.stack(parts, dim=2), q.dtype)
