"""Device meshes of the port: the (data, model) meshes of training,
serving and the dry run, and the enumeration meshes of sharded subgraph
enumeration.

`make_local_mesh(data, model)` and `make_production_mesh(multi_pod)` are
the reference's `repro.launch.mesh` functions on
`torch.distributed.device_mesh.init_device_mesh`, over the default process
group's world: every rank of the group (NCCL on the cards, gloo or the
fake group of the dry run on the CPU). In one process with no group,
`make_local_mesh()` starts a group of one on its own, so the single-card
path runs under a (1, 1) mesh.

Enumeration meshes: a tuple of lane devices (`EnumMesh`), the counterpart
of `repro.launch.mesh.make_enum_mesh`. The sharded schedulers
(`core.shard`) run one lane of every sharded superstep on each. The
Matcher resolves `mesh=k` through `make_enum_mesh`, which clamps `k` to
the devices `lane_devices` lists for its device (every visible card on
CUDA, one lane on the CPU) and returns None at size 1, so the
single-device scheduler runs. A mesh that repeats one device
(`EnumMesh((cuda0,) * 4)`) is built only by constructing the schedulers
directly, as the tests and `chip_smoke.py` do.

`MeshShape` is a mesh's axis names and sizes without devices: what the
policy (`distributed.policy`) and `hbm_model.hbm_floor_bytes` read of a
mesh (`.axis_names`, `.shape`, `.size`), the counterpart of the shape of
the reference's jax Mesh; `mesh_shape` reads it off a `DeviceMesh`.
"""
from __future__ import annotations

import dataclasses
import math
import socket

import torch

__all__ = ["EnumMesh", "MeshShape", "lane_devices", "make_enum_mesh",
           "make_local_mesh", "make_production_mesh", "mesh_shape"]


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


def mesh_shape(mesh) -> MeshShape:
    """The axis names and sizes of `mesh`: a `MeshShape` as it is, or a
    torch `DeviceMesh` (its `mesh_dim_names` and shape)."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"{type(mesh).__name__} is neither a MeshShape nor "
                        "a DeviceMesh with axis names")
    return MeshShape(tuple(names), tuple(mesh.shape))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _world(device) -> int:
    """The default group's size, after starting a group of one (NCCL on a
    card, gloo on the CPU) when this process has none."""
    import torch.distributed as dist
    if not dist.is_initialized():
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)
    return dist.get_world_size()


def _device_type(device) -> str:
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_local_mesh(data: int | None = None, model: int = 1, *,
                    device=None):
    """A (data, model) `DeviceMesh` over every rank of the default group
    (`data=None`: the world size divided by `model`, as the reference
    takes every device). `device` picks the mesh's device type ("cuda" or
    "cpu"; None: the card when there is one)."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = _device_type(device)
    n = _world(dev)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the group has {n}")
    return init_device_mesh(dev, (data, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: (16, 16) (data, model) = 256 ranks. Multi-pod:
    (2, 16, 16) (pod, data, model) = 512 ranks. The default group must
    have that many (the dry run's fake group does)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = _device_type(device)
    n = _world(dev)
    if n != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the group has {n}")
    return init_device_mesh(dev, shape, mesh_dim_names=axes)
