"""The port's sharding policy (`repro_torch.distributed.policy`) against
the reference's (`repro.distributed.policy`) at full width, on four mesh
shapes and all ten registry ids, with no device: the reference reads a
mesh through `.axis_names` and `.shape` only, so both packages read the
same `MeshShape`; the port's models are built under `FakeTensorMode` and
the reference's trees with `jax.eval_shape`.

Every parameter's spec must equal the reference's, a block leaf's with
the reference's leading layer entry dropped (the port has one module a
layer); `batch_pspecs`, `activation_rules` (every kind, with a batch that
divides the data-parallel extent, one that does not, none, and
long_500k's batch 1) and `dp_axes` must be equal; a block alone must be
placed as it is inside its model (`init_fn(mesh=)` places each block as
it is drawn), and `input_axes` must be the reference's `_flat_axes` for a
GNN batch and `dp_axes` otherwise. Specs are compared
entry by entry, an entry as the tuple of mesh axes that split its dim
(None = (), "data" = ("data",)): that is what a spec means to both."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import registry as jregistry  # noqa: E402
from repro.distributed import policy as jpolicy  # noqa: E402
from repro.models.api import build_bundle as jax_build_bundle  # noqa: E402
from repro_torch.distributed import policy  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models.api import build_bundle  # noqa: E402

ARCHS = jregistry.arch_ids()
MESHES = {"1x1": MeshShape(("data", "model"), (1, 1)),
          "4x2": MeshShape(("data", "model"), (4, 2)),
          "16x16": MeshShape(("data", "model"), (16, 16)),
          "2x16x16": MeshShape(("pod", "data", "model"), (2, 16, 16))}
KINDS = {"lm": ("train", "prefill", "decode"), "gnn": ("full", "sampled",
                                                      "batched"),
         "recsys": ("train", "serve", "retrieval")}


def _entry(e) -> tuple:
    if e is None:
        return ()
    if isinstance(e, str):
        return (e,)
    return tuple(a for a in e if a is not None)


def norm(spec, rank: int | None = None) -> tuple:
    """A spec as one tuple of axes a dim, padded to `rank` with ()."""
    out = [_entry(e) for e in spec]
    if rank is not None:
        out += [()] * (rank - len(out))
    return tuple(out)


def _path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def reference_specs(arch: str, mesh) -> dict:
    """{reference path: (spec, shape)} of the reference's full-width
    parameter tree (for a GNN, the molecule shape's)."""
    bundle = jax_build_bundle(arch)
    init = (bundle.init_fn_for("molecule") if bundle.family == "gnn"
            else bundle.init_fn)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    specs = jpolicy.param_pspecs(shapes, bundle.cfg, mesh)
    flat_specs = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    flat_shapes = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {_path(p): (s, tuple(x.shape))
            for (p, s), (_, x) in zip(flat_specs, flat_shapes)}


@pytest.fixture(scope="module")
def port_models():
    """Each arch's full-width model as fake tensors (no memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    out = {}
    with FakeTensorMode():
        for arch in ARCHS:
            bundle = build_bundle(arch, device="cpu")
            init = (bundle.init_fn_for("molecule") if bundle.family == "gnn"
                    else bundle.init_fn)
            out[arch] = (bundle, init(0))
    return out


def _ref_key(name: str, family: str) -> str:
    parts = name.split(".")
    if family == "lm" or family == "recsys":
        if parts[0] == "blocks":
            parts = parts[:1] + parts[2:]
    return "/".join(parts)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_the_reference(arch, mesh_id, port_models):
    mesh = MESHES[mesh_id]
    bundle, model = port_models[arch]
    mine = policy.param_pspecs(model, bundle.cfg, mesh)
    theirs = reference_specs(arch, mesh)
    stacked = bundle.family in ("lm", "recsys")
    seen = set()
    for name, p in model.named_parameters():
        key = _ref_key(name, bundle.family)
        spec, shape = theirs[key]
        seen.add(key)
        if stacked and name.startswith("blocks."):
            # the reference's leading entry is its layer axis (None)
            full = norm(spec, len(shape))
            assert full[0] == (), (name, spec)
            want = full[1:]
            assert tuple(p.shape) == shape[1:], name
        else:
            want = norm(spec, len(shape))
            assert tuple(p.shape) == shape, name
        assert norm(mine[name], p.dim()) == want, (name, mine[name], spec)
    assert seen == set(theirs)


LM_ARCHS = [a for a in ARCHS if jregistry.get_config(a).family == "lm"]


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_a_block_alone_is_placed_as_inside_the_model(arch, mesh_id,
                                                     port_models):
    """`init_fn(mesh=)` places each block as soon as it is drawn, by the
    specs of the block alone: they must be its specs inside the model."""
    mesh = MESHES[mesh_id]
    bundle, model = port_models[arch]
    whole = policy.param_pspecs(model, bundle.cfg, mesh)
    for i, blk in enumerate(model.blocks):
        for name, spec in policy.param_pspecs(blk, bundle.cfg, mesh).items():
            assert whole[f"blocks.{i}.{name}"] == spec, (name, spec)


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_input_axes_split_a_gnn_batch_over_every_axis(mesh_id):
    """`distribute_inputs` splits a GNN batch over the reference's
    `_flat_axes` (every axis), any other family's over `dp_axes`."""
    mesh = MESHES[mesh_id]
    assert policy.input_axes("gnn", mesh) == jpolicy._flat_axes(mesh)
    for family in ("lm", "recsys"):
        assert policy.input_axes(family, mesh) == jpolicy.dp_axes(mesh)


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_dp_axes_equal_the_reference(mesh_id):
    mesh = MESHES[mesh_id]
    assert policy.dp_axes(mesh) == jpolicy.dp_axes(mesh)
    assert policy._flat_axes(mesh) == jpolicy._flat_axes(mesh)
    for axes in (None, "model", ("data",), ("pod", "data"), (None,)):
        if axes is not None and "pod" in _entry(axes) \
                and "pod" not in mesh.axis_names:
            continue
        assert policy._size(mesh, axes) == jpolicy._size(mesh, axes)


def _batches(mesh) -> tuple:
    """0 (no batch), one that divides the data-parallel extent, one that
    does not, and long_500k's 1."""
    n = jpolicy._size(mesh, jpolicy.dp_axes(mesh))
    return (0, 4 * n, 4 * n + 1, 1)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("family", list(KINDS))
def test_batch_pspecs_equal_the_reference(family, mesh_id):
    mesh = MESHES[mesh_id]
    for kind in KINDS[family]:
        for batch in _batches(mesh):
            mine = policy.batch_pspecs(family, kind, mesh, batch=batch)
            theirs = jpolicy.batch_pspecs(family, kind, mesh, batch=batch)
            assert set(mine) == set(theirs)
            for k in theirs:
                assert norm(mine[k]) == norm(theirs[k]), (kind, batch, k)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_rules_equal_the_reference(arch, mesh_id, port_models):
    mesh = MESHES[mesh_id]
    cfg = port_models[arch][0].cfg
    jcfg = jregistry.get_config(arch)
    kinds = KINDS[cfg.family] + (("decode",) if cfg.family != "lm" else ())
    for kind in kinds:
        for batch in _batches(mesh):
            mine = policy.activation_rules(cfg, mesh, kind, batch=batch)
            theirs = jpolicy.activation_rules(jcfg, mesh, kind, batch=batch)
            assert set(mine) == set(theirs), (kind, batch)
            for k, spec in theirs.items():
                if spec is None:
                    assert mine[k] is None, (kind, batch, k)
                else:
                    assert norm(mine[k]) == norm(spec), (kind, batch, k)
