"""The port's logical-axis sharding context (`repro_torch.distributed.
sharding`): `P` and `to_placements`, `constrain`'s no-op cases and its
redistribution, nested contexts and thread-locality, `make_local_mesh`
in a process with no group, and `make_production_mesh` over a fake group.

DeviceMeshes here sit on a fake process group of 8 ranks in this process
(`torch.testing._internal.distributed.fake_pg`: collectives move no data,
so only placements and shapes are checked), torn down after the module."""
import threading

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate, Shard,  # noqa: E402
                                      distribute_tensor)

from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import (P, constrain,  # noqa: E402
                                              current_rules, sharding_ctx,
                                              to_placements)


class Names:
    """What `to_placements` reads of a mesh: its axis names."""

    def __init__(self, *names):
        self.mesh_dim_names = names


@pytest.fixture(scope="module")
def mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (4, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_p_is_a_tuple_of_entries():
    assert P() == ()
    assert P("data", None) == ("data", None)
    assert P(("pod", "data"), "model").axes_of(0) == ("pod", "data")
    assert P(("data",), None).axes_of(0) == ("data",)
    assert P((None,), None).axes_of(0) == ()
    assert P("model").axes_of(3) == ()
    assert repr(P("data", None)) == "P('data', None)"


def test_to_placements_names_one_placement_a_mesh_dim():
    m2 = Names("data", "model")
    assert to_placements(P(), m2) == (Replicate(), Replicate())
    assert to_placements(P("data", None), m2) == (Shard(0), Replicate())
    assert to_placements(P(None, "model"), m2) == (Replicate(), Shard(1))
    assert to_placements(P("model", "data"), m2) == (Shard(1), Shard(0))
    m3 = Names("pod", "data", "model")
    assert to_placements(P(("pod", "data"), None, "model"), m3) == (
        Shard(0), Shard(0), Shard(2))
    # long_500k's cache: S over data x model
    assert to_placements(P(None, ("data", "model"), None, None), m3) == (
        Replicate(), Shard(1), Shard(1))
    assert to_placements(P(("data",), None), m3) == (
        Replicate(), Shard(0), Replicate())


def test_to_placements_refuses_what_dtensor_cannot_say():
    m2 = Names("data", "model")
    with pytest.raises(ValueError, match="order"):
        to_placements(P(("model", "data")), m2)
    with pytest.raises(ValueError, match="two dims"):
        to_placements(P("data", "data"), m2)
    with pytest.raises(ValueError, match="not in the mesh"):
        to_placements(P("pod"), m2)


def test_constrain_outside_a_context_is_a_no_op(mesh):
    x = distribute_tensor(torch.zeros(8, 4), mesh, [Shard(0), Replicate()])
    assert current_rules() is None
    assert constrain(x, "act_btd") is x
    y = torch.zeros(8, 4)
    assert constrain(y, "act_btd") is y


def test_constrain_redistributes_a_dtensor(mesh):
    x = distribute_tensor(torch.zeros(8, 6, 4), mesh,
                          [Replicate(), Replicate()])
    with sharding_ctx(mesh, {"act_btd": P("data", None, "model"),
                             "none": None}):
        y = constrain(x, "act_btd")
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert y.to_local().shape == (2, 6, 2)
        assert constrain(x, "none") is x        # a rule of None
        assert constrain(x, "missing") is x     # no rule


def test_constrain_is_a_no_op_on_plain_tensors_and_odd_dims(mesh):
    plain = torch.zeros(8, 6, 4)
    odd = distribute_tensor(torch.zeros(6, 6, 3), mesh,
                            [Replicate(), Replicate()])
    with sharding_ctx(mesh, {"act_btd": P("data", None, "model"),
                             "long": P(None, None, None, "model")}):
        assert constrain(plain, "act_btd") is plain
        # 6 rows over 4 data ranks, 3 columns over 2 model ranks
        assert constrain(odd, "act_btd") is odd
        # a spec longer than the tensor
        assert constrain(odd, "long") is odd


def test_nested_contexts_restore_the_outer_one(mesh):
    outer, inner = {"a": P("data")}, {"a": P("model")}
    with sharding_ctx(mesh, outer):
        assert current_rules() == (mesh, outer)
        with sharding_ctx(mesh, inner):
            assert current_rules() == (mesh, inner)
        assert current_rules() == (mesh, outer)
    assert current_rules() is None


def test_a_context_is_thread_local(mesh):
    seen = {}
    entered, release = threading.Event(), threading.Event()

    def other():
        entered.wait(10)
        seen["other"] = current_rules()
        with sharding_ctx(mesh, {"b": P()}):
            seen["other_inside"] = current_rules()[1]
        release.set()

    t = threading.Thread(target=other)
    t.start()
    with sharding_ctx(mesh, {"a": P("data")}):
        entered.set()
        release.wait(10)
        seen["main"] = current_rules()[1]
    t.join(10)
    assert seen == {"other": None, "other_inside": {"b": P()},
                    "main": {"a": P("data")}}


def test_the_context_lets_plain_tensors_meet_dtensors(mesh):
    x = distribute_tensor(torch.ones(8, 4), mesh, [Shard(0), Replicate()])
    with sharding_ctx(mesh, {}):
        y = x * torch.arange(4.0)          # a plain operand, replicated
    assert isinstance(y, DTensor)
    assert tuple(y.placements) == (Shard(0), Replicate())
    with pytest.raises(RuntimeError, match="mixed"):
        x * torch.arange(4.0)


def test_reduce_to_placements_and_full(mesh):
    from torch.distributed.tensor import Partial
    p = distribute_tensor(torch.zeros(8, 4), mesh, [Replicate(), Shard(0)])
    g = DTensor.from_local(torch.zeros(4, 4), mesh, [Partial(), Shard(0)])
    plain = torch.ones(3)
    out = sharding.reduce_to_placements([g, plain], [p, plain])
    assert tuple(out[0].placements) == (Replicate(), Shard(0))
    assert out[1] is plain
    assert sharding.full(plain) is plain
    assert sharding.full(p).shape == (8, 4)
    assert not isinstance(sharding.full(p), DTensor)


def test_production_meshes_over_a_fake_group():
    """(16, 16) on 256 ranks and (2, 16, 16) on 512, and a size check."""
    import subprocess
    import sys
    code = (
        "import torch.distributed as dist\n"
        "from repro_torch.launch import dryrun, mesh\n"
        "with dryrun.fake_world(256):\n"
        "    m = mesh.make_production_mesh(device='cpu')\n"
        "    print(tuple(m.mesh_dim_names), tuple(m.shape))\n"
        "    print(mesh.mesh_shape(m).size)\n"
        "    try:\n"
        "        mesh.make_production_mesh(multi_pod=True, device='cpu')\n"
        "    except ValueError as e:\n"
        "        print('refused', 'needs 512' in str(e))\n"
        "with dryrun.fake_world(512):\n"
        "    m = mesh.make_production_mesh(multi_pod=True, device='cpu')\n"
        "    print(tuple(m.mesh_dim_names), tuple(m.shape))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:4] == [
        "('data', 'model') (16, 16)", "256", "refused True",
        "('pod', 'data', 'model') (2, 16, 16)"]


def test_make_local_mesh_in_one_process_is_one_by_one():
    """With no group, a group of one starts (gloo on the CPU): a (1, 1)
    mesh; data=None takes every rank over the model axis."""
    import subprocess
    import sys
    code = (
        "import torch.distributed as dist\n"
        "from repro_torch.launch.mesh import make_local_mesh\n"
        "m = make_local_mesh(device='cpu')\n"
        "print(tuple(m.mesh_dim_names), tuple(m.shape), "
        "dist.get_backend(), dist.get_world_size())\n"
        "try:\n"
        "    make_local_mesh(2, 1, device='cpu')\n"
        "except ValueError as e:\n"
        "    print('refused', '2 ranks' in str(e))\n"
        "dist.destroy_process_group()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:2] == [
        "('data', 'model') (1, 1) gloo 1", "refused True"]
