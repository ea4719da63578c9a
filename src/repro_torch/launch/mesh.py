"""Enumeration meshes: the lane devices of sharded subgraph enumeration.

Torch counterpart of `repro.launch.mesh.make_enum_mesh`. A mesh is a tuple
of lane devices (`EnumMesh`); the sharded schedulers (`core.shard`) run one
lane of every sharded superstep on each. The Matcher resolves `mesh=k`
through `make_enum_mesh`, which clamps `k` to the devices `lane_devices`
lists for its device (every visible card on CUDA, one lane on the CPU) and
returns None at size 1, so the single-device scheduler runs. A mesh that
repeats one device (`EnumMesh((cuda0,) * 4)`) is built only by constructing
the schedulers directly, as the tests and `chip_smoke.py` do.

`MeshShape` is a mesh's axis names and sizes without devices: what
`hbm_model.hbm_floor_bytes` reads of a mesh (`.size`, `.shape`), the
counterpart of the shape of the reference's jax Mesh.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["EnumMesh", "MeshShape", "lane_devices", "make_enum_mesh"]


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


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a device mesh, no devices:
    `MeshShape(("data", "model"), (4, 2))` is 8 devices, 2-way tensor
    parallel."""

    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        names, sizes = tuple(self.axis_names), tuple(self.axis_sizes)
        if len(names) != len(sizes) or len(set(names)) != len(names) \
                or any(int(n) < 1 for n in sizes):
            raise ValueError(f"axes {names} of sizes {sizes}")
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", tuple(int(n) for n in sizes))

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The device count."""
        return math.prod(self.axis_sizes)


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
