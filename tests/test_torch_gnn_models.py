"""The port's four GNN architectures and their bundles on the CPU against
the reference: gatedgcn, nequip, equiformer-v2 and dimenet, reduced, on all
four reduced GNN shapes (molecule, full_graph_sm, minibatch_lg,
ogb_products), from the reference's weights with seeded noise on the
biases and gains (moved across by `gnn_params_from_jax`, strict): the
batch (the same numpy draws, bit for bit), the forward output, the loss,
its gradients and one `steps["train"]`. The reference runs jitted, once a
cell. Plus the configs (full and reduced) and `model_flops` and
`input_specs` of every (arch × shape) at full size, equal to the
reference's.

Tolerances (float32 on both sides; sums and products in another order,
through two layers):
- forward outputs and the loss: 1e-5 relative to the reference's largest
  magnitude (DimeNet's molecule energies reach ~40);
- gradients: within 1e-4 of each leaf's largest |g|, or GRAD_FLOOR
  (1e-7) where that is larger: a leaf whose true gradient is zero carries
  rounding noise alone (EquiformerV2's alpha MLP's last bias shifts every
  score of a per-destination softmax alike: ~1e-9 on both sides);
- the train step's gnorm 1e-5 relative; its parameters within 1e-5 where
  the reference's gradient |g| >= 1e-6, and within 2·lr elsewhere: Adam's
  first step moves an entry by lr·g/(|g| + 1e-8) (+ the decay), which
  normalises float32 rounding noise where |g| is near the epsilon.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import registry as jregistry  # noqa: E402
from repro.models.api import build_bundle as jax_build_bundle  # noqa: E402
from repro.models.gnn_models import GNN_MODELS as JAX_GNN_MODELS  # noqa
from repro_torch.config import GNN_SHAPES  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.api import build_bundle  # noqa: E402
from repro_torch.models.convert import gnn_params_from_jax  # noqa: E402
from torch_lm_common import flat_np, perturb_tree, to_np  # noqa: E402

ARCHS = ["gatedgcn", "nequip", "equiformer-v2", "dimenet"]
SHAPES = ["molecule", "full_graph_sm", "minibatch_lg", "ogb_products"]
CELLS = [(a, s) for a in ARCHS for s in SHAPES]
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-7
GNORM_RTOL = 1e-5
PARAM_ATOL = 1e-5
ADAM_G_FLOOR = 1e-6


@functools.lru_cache(maxsize=None)
def _cell(arch, shape):
    """The reference's results on a cell (jitted once) and the port's
    bundle, model (the same weights) and batch."""
    jb = jax_build_bundle(arch, reduced=True)
    cfg = jb.cfg
    tree = perturb_tree(jb.init_fn_for(shape)(jax.random.PRNGKey(0)))
    jbatch = jb.make_inputs(shape)
    model_cls = JAX_GNN_MODELS[cfg.model]

    def run(params, batch):
        out = model_cls.forward(params, batch, cfg)
        (loss, _), grads = jax.value_and_grad(
            lambda p: model_cls.loss(p, batch, cfg), has_aux=True)(params)
        new, _, gnorm = jb.optimizer.update(
            grads, jb.optimizer.init(params), params)
        return out, loss, grads, new, gnorm

    out, loss, grads, new, gnorm = jax.jit(run)(tree, jbatch)
    ref = {"out": np.asarray(out), "loss": float(loss),
           "grads": flat_np(grads), "new": flat_np(new),
           "gnorm": float(gnorm), "batch": jbatch}
    bundle = build_bundle(arch, reduced=True, device="cpu")
    model = bundle.init_fn_for(shape)(0)
    model.load_state_dict(gnn_params_from_jax(tree, bundle.cfg), strict=True)
    return ref, bundle, model, bundle.make_inputs(shape)


def _fresh_model(arch, shape):
    ref, bundle, model, batch = _cell(arch, shape)
    fresh = bundle.init_fn_for(shape)(1)
    fresh.load_state_dict(model.state_dict())
    return ref, bundle, fresh, batch


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch, reduced):
    mine = registry.get_config(arch, reduced=reduced)
    theirs = jregistry.get_config(arch, reduced=reduced)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert registry.shapes_for(arch) == jregistry.shapes_for(arch) \
        == GNN_SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_flops_and_specs_are_the_reference_ones(arch):
    """model_flops and input_specs of every GNN shape at full size (the
    padding to multiples of 4,096 included), and the default init's
    node-feature width (molecule's)."""
    bundle = build_bundle(arch, device="cpu")
    jbundle = jax_build_bundle(arch)
    assert bundle.family == jbundle.family == "gnn"
    for shape in SHAPES:
        assert bundle.model_flops(shape) == jbundle.model_flops(shape)
        mine = bundle.input_specs(shape)
        theirs = jbundle.input_specs(shape)
        assert sorted(mine) == sorted(theirs)
        for name, (shp, dtype) in mine.items():
            assert shp == theirs[name].shape
            assert str(dtype).split(".")[-1] == theirs[name].dtype.name \
                or (dtype, theirs[name].dtype) == (torch.bool, jnp.bool_)
    default = bundle.init_fn_for("molecule")
    names = [n for n, _ in bundle.init_fn(0).named_parameters()]
    assert names == [n for n, _ in default(0).named_parameters()]


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cut_follows_the_specs(arch):
    """make_inputs(batch=k) cuts a sampled shape's seeds and a batched
    shape's molecules, as input_specs(batch=k) and model_flops(batch=k)
    count them (the shape's own batch gives the uncut numbers); a full
    graph has no batch to cut."""
    bundle = build_bundle(arch, reduced=True, device="cpu")
    full = build_bundle(arch, device="cpu")
    for shape, k in (("minibatch_lg", 5), ("molecule", 2)):
        batch = bundle.make_inputs(shape, batch=k)
        specs = bundle.input_specs(shape, batch=k)
        for name in ("node_mask", "edge_mask"):
            assert tuple(batch[name].shape) == specs[name][0]
        own = GNN_SHAPES[shape].get("batch_nodes",
                                    GNN_SHAPES[shape].get("batch"))
        assert full.model_flops(shape, batch=own) == full.model_flops(shape)
        assert full.model_flops(shape, batch=own // 2) \
            < full.model_flops(shape)
    with pytest.raises(ValueError, match="no batch"):
        bundle.make_inputs("full_graph_sm", batch=2)


def test_bundles_run_on_the_card_unless_asked():
    """build_bundle without a device needs CUDA (and raises without one);
    device="cpu" builds every GNN bundle."""
    for arch in ARCHS:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                build_bundle(arch)
        assert build_bundle(arch, device="cpu").device.type == "cpu"


def test_train_launcher_refuses_a_gnn():
    """launch/train.py trains the LM ids only (its token stream is an
    LM's); a GNN or bert4rec id is refused before any work."""
    for arch in ARCHS + ["bert4rec"]:
        with pytest.raises(SystemExit, match="trains the LM ids"):
            launch_train.main(["--arch", arch, "--device", "cpu"])


# ------------------------------------------------------------- the slice
@pytest.mark.parametrize("arch,shape", CELLS)
def test_inputs_are_the_reference_inputs(arch, shape):
    """Every array bit for bit, in its spec's dtype. (Shapes follow the
    reference's batch: its molecule triplets are capped at the 64 edges of
    a molecule, where input_specs and model_flops take TRIPLET_CAPS' 16.)"""
    ref, bundle, _, batch = _cell(arch, shape)
    assert sorted(batch) == sorted(ref["batch"])
    specs = bundle.input_specs(shape)
    for name, t in batch.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref["batch"][name]))
        assert t.dtype == specs[name][1]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_forward_matches_the_reference(arch, shape):
    ref, _, model, batch = _cell(arch, shape)
    with torch.no_grad():
        out = to_np(model(batch))
    scale = max(float(np.abs(ref["out"]).max()), 1.0)
    assert out.shape == ref["out"].shape
    np.testing.assert_allclose(out, ref["out"], rtol=0,
                               atol=OUT_RTOL * scale)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_loss_and_gradients_match_the_reference(arch, shape):
    ref, _, model, batch = _cell(arch, shape)
    params = dict(model.named_parameters())
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    assert abs(float(loss.detach()) - ref["loss"]) <= OUT_RTOL * max(abs(ref["loss"]),
                                                            1.0)
    assert sorted(params) == sorted(ref["grads"])
    for name, g in zip(params, grads):
        want = ref["grads"][name]
        atol = max(GRAD_RTOL * float(np.abs(want).max()), GRAD_FLOOR)
        np.testing.assert_allclose(to_np(g), want, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_train_step_matches_the_reference(arch, shape):
    ref, bundle, model, batch = _fresh_model(arch, shape)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt_state = bundle.optimizer.init(dict(model.named_parameters()))
    _, opt_state, metrics = bundle.steps[GNN_SHAPES[shape]["kind"]](
        model, opt_state, batch)
    assert abs(float(metrics["loss"]) - ref["loss"]) \
        <= OUT_RTOL * max(abs(ref["loss"]), 1.0)
    assert abs(float(metrics["gnorm"]) - ref["gnorm"]) \
        <= GNORM_RTOL * ref["gnorm"]
    assert int(opt_state["step"]) == 1
    lr = bundle.optimizer.lr
    changed = 0
    for name, p in model.named_parameters():
        got, want = to_np(p), ref["new"][name]
        firm = np.abs(ref["grads"][name]) >= ADAM_G_FLOOR
        np.testing.assert_allclose(got[firm], want[firm], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        np.testing.assert_allclose(got[~firm], want[~firm], rtol=0,
                                   atol=2 * lr, err_msg=name)
        changed += int(not torch.equal(p.detach(), before[name]))
    assert changed > 0
