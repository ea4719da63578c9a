"""Roofline terms of a step on NVIDIA H100 cards.

Torch counterpart of `repro.launch.roofline`, with the card's constants in
place of the reference's TPU v5e ones:

  compute    = FLOPs / (chips x 989 TFLOP/s)   [bf16 tensor cores]
  memory     = HBM bytes / (chips x 3.35 TB/s)
  collective = collective bytes / 450 GB/s      [NVLink, each way]

The reference reads FLOPs, bytes and collectives from XLA's analysis of a
compiled step. Here the caller gives FLOPs (`count_flops`: PyTorch's
`FlopCounterMode` over a call; a hand-written kernel it cannot see is
added by the caller) and bytes (`hbm_model.hbm_floor_bytes`), both per
device, as the reference's post-SPMD figures are. A step traced under
`StepTrace` (a `TorchDispatchMode` below DTensor, so it sees each rank's
local ops) gives the rest: its per-device FLOPs, the collectives it
issued (`collective_bytes`: output bytes by the reference's kind names,
from the `_c10d_functional` and `c10d` ops instead of HLO text) and its
peak live bytes (`parse_memory_analysis`, under the reference's keys).

    with StepTrace() as trace:
        out = step(...)
    coll = collective_bytes(trace)
    terms = roofline_terms(trace.flops, hbm_floor_bytes(bundle, shape,
                           mesh), chips, coll_bytes=coll)
    terms.bound_s, terms.dominant, terms.coll_breakdown
"""
from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

__all__ = ["HW", "RooflineTerms", "roofline_terms", "count_flops",
           "StepTrace", "collective_bytes", "parse_memory_analysis"]

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the card's
# full 700 W power limit
HW = {"flops_bf16": 989e12,      # bf16 / fp16 tensor cores
      "flops_tf32": 495e12,      # TF32 tensor cores
      "flops_f32": 67e12,        # float32 outside the tensor cores
      "hbm_bw": 3.35e12,         # HBM3, bytes/s
      "nvlink_bw": 450e9}        # NVLink to the host's other cards, each way


@dataclasses.dataclass
class RooflineTerms:
    flops: float                  # total flops (all devices)
    hbm_bytes: float              # total bytes accessed
    coll_bytes: float             # per-device collective bytes
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    coll_breakdown: dict
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.flops,
            "useful_frac": round(self.useful_fraction, 4),
        }


def roofline_terms(flops: float, hbm_bytes: float, chips: int,
                   coll_bytes: float | dict = 0.0,
                   model_flops: float = 0.0) -> RooflineTerms:
    """The terms of a step whose every device does `flops` operations and
    moves `hbm_bytes` bytes of HBM (per device, as the reference's cost
    analysis reports them) and `coll_bytes` bytes of collectives over
    NVLink: a number, or `collective_bytes`' {kind: bytes}, which becomes
    `coll_breakdown`."""
    flops = float(flops) * chips
    hbm = float(hbm_bytes) * chips
    breakdown = dict(coll_bytes) if isinstance(coll_bytes, dict) else {}
    coll = (float(sum(breakdown.values())) if isinstance(coll_bytes, dict)
            else float(coll_bytes))
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm, coll_bytes=coll, chips=chips,
        compute_s=flops / (chips * HW["flops_bf16"]),
        memory_s=hbm / (chips * HW["hbm_bw"]),
        collective_s=coll / HW["nvlink_bw"],
        coll_breakdown=breakdown, model_flops=model_flops)


def count_flops(fn, *args, **kwargs) -> tuple:
    """(fn(*args, **kwargs), the FLOPs of its PyTorch operators): matrix
    products, convolutions and attention as `FlopCounterMode` counts them
    (2 per multiply-add). Work done inside a kernel of this repository,
    launched through ctypes, is not seen."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, counter.get_total_flops()


def _kinds() -> dict:
    """The collective ops of `torch.distributed`, by the reference's kind
    names (an HLO collective's)."""
    f, c = torch.ops._c10d_functional, torch.ops.c10d
    table = {
        "all-gather": [f.all_gather_into_tensor,
                       f.all_gather_into_tensor_coalesced, c._allgather_base_,
                       c.allgather_, c.allgather_coalesced_,
                       c.allgather_into_tensor_coalesced_],
        "all-reduce": [f.all_reduce, f.all_reduce_coalesced, c.allreduce_,
                       c.allreduce_coalesced_],
        "reduce-scatter": [f.reduce_scatter_tensor,
                           f.reduce_scatter_tensor_coalesced,
                           c._reduce_scatter_base_, c.reduce_scatter_,
                           c.reduce_scatter_tensor_coalesced_],
        "all-to-all": [f.all_to_all_single, c.alltoall_, c.alltoall_base_],
        "collective-permute": [c.send, c.recv_],
    }
    return {op: kind for kind, ops in table.items() for op in ops}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class StepTrace(TorchDispatchMode):
    """What a step's ops do on this rank, seen below DTensor (a DTensor op
    is passed on, and the local ops and collectives it turns into come
    back here): `flops` (PyTorch's FLOP formulas, as `FlopCounterMode`
    counts them, on the local shapes), `collectives` ((kind, output bytes)
    a call, in order) and `peak_bytes` (the most bytes of storage made by
    the step's ops alive at once, a storage counted while the tensor that
    made it lives; a view or an in-place op's output, an argument's
    storage, makes none). Works on real tensors and under
    `FakeTensorMode`."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives: list[tuple[str, int]] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._kinds = _kinds()
        self._seen: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        kind = self._kinds.get(packet)
        if kind is not None:
            self.collectives.append((kind, _nbytes(out)))
        # a view or an in-place op's output is an argument's storage: no
        # new bytes (a decode step's cache write, a weight's transpose)
        given = {_storage_key(t) for t in tree_leaves((args, kwargs))
                 if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and _storage_key(t) not in given:
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._seen:
            return
        n = t.untyped_storage().nbytes()
        self._seen.add(key)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self._seen.discard(key)
        self.live_bytes -= n


def _storage_key(t: torch.Tensor) -> int:
    return StorageWeakRef(t.untyped_storage()).cdata


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagator is running the current op on
    fake inputs to learn its output's shape (once an op signature): not
    work of the step."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def collective_bytes(trace: StepTrace) -> dict[str, int]:
    """Sum of the *output* bytes of each collective a traced step issued,
    per kind ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute"): the bytes one device receives, as the
    reference sums the output shapes of its post-SPMD HLO."""
    out: dict[str, int] = {}
    for kind, b in trace.collectives:
        out[kind] = out.get(kind, 0) + b
    return out


def _local_bytes(tree) -> int:
    """Bytes one rank holds of a tree of tensors (a DTensor's local shard;
    a storage shared by several leaves once)."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if not isinstance(t, torch.Tensor):
            continue
        key = StorageWeakRef(t.untyped_storage()).cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def parse_memory_analysis(trace: StepTrace, arguments, outputs=None) -> dict:
    """A traced step's memory on one device, under the reference's keys
    (bytes): its arguments' local shards (parameters, optimizer state,
    inputs, caches), its outputs' and, as temp, the peak live bytes of
    what its ops made. No generated code: None."""
    return {"argument_size_in_bytes": _local_bytes(arguments),
            "output_size_in_bytes": (None if outputs is None
                                     else _local_bytes(outputs)),
            "temp_size_in_bytes": trace.peak_bytes,
            "generated_code_size_in_bytes": None}
