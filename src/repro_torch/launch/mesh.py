"""Enumeration meshes: the lane devices of sharded subgraph enumeration.

Torch counterpart of `repro.launch.mesh.make_enum_mesh`. A mesh is a tuple
of lane devices (`EnumMesh`); the sharded schedulers (`core.shard`) run one
lane of every sharded superstep on each. The Matcher resolves `mesh=k`
through `make_enum_mesh`, which clamps `k` to the devices `lane_devices`
lists for its device (every visible card on CUDA, one lane on the CPU) and
returns None at size 1, so the single-device scheduler runs. A mesh that
repeats one device (`EnumMesh((cuda0,) * 4)`) is built only by constructing
the schedulers directly, as the tests and `chip_smoke.py` do.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["EnumMesh", "lane_devices", "make_enum_mesh"]


def _indexed(device) -> torch.device:
    """`device` with its index: a bare "cuda" is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class EnumMesh:
    """The lane devices of a sharded run, in lane order; a device may
    repeat (several lanes on one card)."""

    devices: tuple

    def __post_init__(self):
        devs = tuple(_indexed(d) for d in self.devices)
        if not devs:
            raise ValueError("an EnumMesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        """The lane count."""
        return len(self.devices)


def lane_devices(device) -> list[torch.device]:
    """The devices a Matcher on `device` may shard across: every visible
    card for a CUDA device, the one CPU otherwise."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_enum_mesh(n_devices: int | None, device) -> EnumMesh | None:
    """The mesh of the first `n_devices` lane devices of `device` (None =
    all of them), clamped to how many there are; None when that leaves one
    lane — callers run the single-device scheduler, which keeps the
    one-device fallback bit-identical to the unsharded path."""
    devs = lane_devices(device)
    n = len(devs) if n_devices is None else max(1, min(int(n_devices),
                                                       len(devs)))
    if n <= 1:
        return None
    return EnumMesh(tuple(devs[:n]))
