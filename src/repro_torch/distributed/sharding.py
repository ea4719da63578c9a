"""Logical-axis sharding context plus shard-partition helpers.

Models call `constrain(x, "logical_name")` at strategic points; the launcher
installs a rule table mapping logical names to partition specs (`P`) for
the active mesh with `sharding_ctx`. `constrain` redistributes a DTensor
to the rule's placements. It is a no-op outside a context (unit tests, one
device), on a plain tensor, for a name without a rule, and where a named
dim does not divide by its axes' size (the reference's fallback to what
the tensor has), so model code is mesh-agnostic.

`P` is the counterpart of jax's `PartitionSpec`: one entry a tensor dim,
each None (replicated), a mesh axis name, or a tuple of names (the dim
split over those axes, the first outermost). `to_placements` turns it into
one `Shard(d)` / `Replicate()` a mesh dim of a torch `DeviceMesh`.

`partition_bitmap` is the work-partitioning half: the sharded enumeration
schedulers (`repro_torch.core.shard`) split the root candidate bitmap
across their lanes with it, weighting each candidate by its estimated
subtree cost (`repro_torch.core.plan.root_extension_weights`).
"""
from __future__ import annotations

import contextlib
import math
import threading

import numpy as np

__all__ = ["P", "to_placements", "sharding_ctx", "current_rules",
           "constrain", "divides", "full", "all_gather",
           "reduce_to_placements", "partition_bitmap"]

_tls = threading.local()


class P(tuple):
    """A partition spec: `P("data", None)` shards dim 0 over `data` and
    replicates dim 1; `P(("data", "model"))` splits dim 0 over both axes;
    `P()` replicates every dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes_of(self, dim: int) -> tuple:
        """The mesh axes that split tensor dim `dim`, outermost first."""
        if dim >= len(self) or self[dim] is None:
            return ()
        e = self[dim]
        return (e,) if isinstance(e, str) else tuple(a for a in e
                                                     if a is not None)


def _names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def to_placements(spec: P, mesh) -> tuple:
    """One placement a mesh dim of `mesh` (a `DeviceMesh`): `Shard(d)` for
    the dim d that names it, else `Replicate()`. A tuple entry must name
    its axes in the mesh's order (DTensor splits a dim over several mesh
    dims outermost first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = _names(mesh)
    owner = {}
    for d in range(len(spec)):
        axes = spec.axes_of(d)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"{spec}: axes {unknown} not in the mesh "
                             f"{names}")
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"{spec}: dim {d} names {axes} out of the "
                             f"mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"{spec}: axis {a!r} shards two dims")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


@contextlib.contextmanager
def sharding_ctx(mesh, rules: dict):
    """rules: logical name → P (or None: leave the tensor as it is), for
    `mesh`, a torch `DeviceMesh`. Thread-local; nested contexts restore the
    outer one on exit.

    The outermost context also lets DTensor ops take plain tensors as
    replicated (`implicit_replication`): the masks, positions and rotary
    angles that model code makes with `torch.arange` meet DTensor
    activations on a mesh, as a jax array meets a sharded one under
    GSPMD."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (mesh, rules)
    try:
        if prev is None:
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _tls.ctx = prev


def full(x):
    """x as a plain tensor: a DTensor's whole value (`full_tensor`, a
    collective over its mesh), any other tensor itself."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def all_gather(x, dim: int, group):
    """x of every rank of `group` (a process group, or a `(DeviceMesh,
    mesh dim)` pair) concatenated along `dim`, in rank order (a functional
    collective; `all_gather_single`, named `all_gather_tensor` before torch
    2.12)."""
    from torch.distributed import _functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    return funcol.wait_tensor(gather(x.contiguous(), dim, group))


def reduce_to_placements(grads, params):
    """Each gradient redistributed to its parameter's placements. Autograd
    leaves the gradient of a parameter replicated over `data` as a partial
    sum over `data` (each rank's share of the batch): this is the
    data-parallel all-reduce (or reduce-scatter, for a parameter sharded
    over `data`), which GSPMD inserts on its own. Plain tensors pass."""
    from torch.distributed.tensor import DTensor
    out = []
    for g, p in zip(grads, params):
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(
                p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        out.append(g)
    return out


def current_rules():
    """(mesh, rules) of the innermost context of this thread, or None."""
    return getattr(_tls, "ctx", None)


def divides(shape, spec: P, mesh) -> bool:
    """Whether every dim of `shape` that `spec` names splits evenly over
    its axes of `mesh` (and `spec` is no longer than `shape`)."""
    if len(spec) > len(shape):
        return False
    sizes = dict(zip(_names(mesh), mesh.shape))
    return all(shape[d] % math.prod(sizes[a] for a in spec.axes_of(d)) == 0
               for d in range(len(spec)))


def constrain(x, name: str):
    """x redistributed to the placements of rule `name` of the current
    context; x itself outside a context, for a plain tensor, for a name
    without a rule, and where a named dim does not divide by its axes'
    size."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = rules.get(name)
    if spec is None or not divides(x.shape, spec, mesh):
        return x
    return x.redistribute(mesh, to_placements(spec, mesh))


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
