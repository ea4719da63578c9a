"""Roofline terms of a step on NVIDIA H100 cards.

Torch counterpart of `repro.launch.roofline`, with the card's constants in
place of the reference's TPU v5e ones:

  compute    = FLOPs / (chips x 989 TFLOP/s)   [bf16 tensor cores]
  memory     = HBM bytes / (chips x 3.35 TB/s)
  collective = collective bytes / 450 GB/s      [NVLink, each way]

The reference reads FLOPs and bytes from XLA's cost analysis of a compiled
step. Here the caller gives them: FLOPs from `count_flops` (PyTorch's
`FlopCounterMode` over a call; a hand-written kernel it cannot see is
added by the caller) and bytes from `hbm_model.hbm_floor_bytes`, both per
device, as the reference's post-SPMD figures are. The collective term
waits for the multi-card dry run (ROADMAP.md Queue 1): it is 0 unless
given, and `coll_breakdown` (the reference's bytes per collective kind)
stays empty until then.

    terms = roofline_terms(flops, hbm_floor_bytes(bundle, shape, mesh), 1)
    terms.bound_s, terms.dominant
"""
from __future__ import annotations

import dataclasses

from torch.utils.flop_counter import FlopCounterMode

__all__ = ["HW", "RooflineTerms", "roofline_terms", "count_flops"]

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
                   coll_bytes: float = 0.0,
                   model_flops: float = 0.0) -> RooflineTerms:
    """The terms of a step whose every device does `flops` operations and
    moves `hbm_bytes` bytes of HBM (per device, as the reference's cost
    analysis reports them) and `coll_bytes` bytes of collectives over
    NVLink."""
    flops = float(flops) * chips
    hbm = float(hbm_bytes) * chips
    coll = float(coll_bytes)
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm, coll_bytes=coll, chips=chips,
        compute_s=flops / (chips * HW["flops_bf16"]),
        memory_s=hbm / (chips * HW["hbm_bw"]),
        collective_s=coll / HW["nvlink_bw"],
        coll_breakdown={}, model_flops=model_flops)


def count_flops(fn, *args, **kwargs) -> tuple:
    """(fn(*args, **kwargs), the FLOPs of its PyTorch operators): matrix
    products, convolutions and attention as `FlopCounterMode` counts them
    (2 per multiply-add). Work done inside a kernel of this repository,
    launched through ctypes, is not seen."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, counter.get_total_flops()
