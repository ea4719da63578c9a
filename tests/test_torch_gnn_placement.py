"""The four reduced GNNs placed by the policy on four gloo CPU ranks over a
(data, model) = (2, 2) mesh: nodes, edges and triplets split over both
mesh dims (the reference's `_flat_axes`), the mesh flattened to one dim of
four (`policy.placement_mesh`), parameters whole.

`tests/torch_dist_cases.py gnn` runs the ranks once for the module, in a
subprocess with a time limit, from weights this module writes: the JAX
package's reduced init with seeded noise on its biases and gains
(`perturb_tree`), moved across by `gnn_params_from_jax`. Each cell of
`GNN_CELLS` (gatedgcn on full_graph_sm and molecule; nequip, equiformer-v2
and dimenet on molecule) trains one float32 step there. Held:

- the placed loss against the JAX package's loss on the same weights and
  batch, 1e-5 relative to max(|loss|, 1) (float32 on both sides, sums in
  another order: `test_torch_gnn_models`' OUT_RTOL);
- the placed step against the port's undistributed step on the same
  weights: loss and gnorm 1e-5 relative (the same products, each rank's
  rows summed apart, then across ranks), the updated parameters within
  1e-5 where the undistributed gradient |g| >= 1e-6 and within 2·lr
  elsewhere (Adam's first step normalises float32 rounding noise where
  |g| is near its epsilon: `test_torch_gnn_models`' rule);
- the guard: every op DTensor dispatched in the step (forward and
  backward) was recorded, and no index, gather, scatter or embedding op
  met a DTensor: the card's torch 2.11 cannot place one on a dim split
  over two mesh dims (`aten.index.Tensor` on S(0)S(0)), so the port runs
  each on the ranks' own rows;
- the batch's node, edge and triplet tensors are split over the flattened
  mesh of all four ranks, so the step ran on shards;
- an LM placed block by block as it is drawn (`init_fn(mesh=)`, how a
  card holds a model larger than itself) equals the same model placed
  whole: names, placements and values.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models.api import build_bundle as jax_build_bundle  # noqa: E402
from repro.models.gnn_models import GNN_MODELS as JAX_GNN_MODELS  # noqa
from repro_torch.config import GNN_SHAPES  # noqa: E402
from repro_torch.models.api import build_bundle  # noqa: E402
from repro_torch.models.convert import gnn_params_from_jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_cases as cases  # noqa: E402
from torch_lm_common import perturb_tree  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
CELLS = list(cases.GNN_CELLS)
IDS = [f"{a}-{s}" for a, s in CELLS]
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-5
PARAM_ATOL = 1e-5
ADAM_G_FLOOR = 1e-6
SPLIT = ["S(0)"]
FLAT = {"data_model": 4}


@functools.lru_cache(maxsize=None)
def _weights(arch, shape):
    """The reference's perturbed init (numpy tree) and the port's state
    dict of the same weights."""
    jb = jax_build_bundle(arch, reduced=True)
    tree = perturb_tree(jb.init_fn_for(shape)(jax.random.PRNGKey(0)))
    bundle = build_bundle(arch, reduced=True, device="cpu")
    return jb, tree, gnn_params_from_jax(tree, bundle.cfg)


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    out = tmp_path_factory.mktemp("gnn")
    for arch, shape in CELLS:
        state = _weights(arch, shape)[2]
        np.savez(out / f"{arch}-{shape}.npz",
                 **{k: v.numpy() for k, v in state.items()})
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dist_cases.py"), "gnn",
         str(out)], env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    import json
    with open(out / "gnn.json") as f:
        res = json.load(f)
    res["arrays"] = dict(np.load(out / "gnn.npz"))
    return res


@functools.lru_cache(maxsize=None)
def _undistributed(arch, shape):
    """The port's undistributed step on the same weights and batch: loss,
    gnorm, the gradients and the updated parameters."""
    bundle = build_bundle(arch, reduced=True, device="cpu")
    model = bundle.init_fn_for(shape)(0)
    model.load_state_dict(_weights(arch, shape)[2], strict=True)
    batch = bundle.make_inputs(shape)
    params = dict(model.named_parameters())
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    state = bundle.optimizer.init(params)
    _, state, m = bundle.steps[GNN_SHAPES[shape]["kind"]](model, state, batch)
    return {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
            "grads": {k: g.numpy() for k, g in zip(params, grads)},
            "params": {k: v.detach().numpy()
                       for k, v in model.named_parameters()},
            "lr": bundle.optimizer.lr}


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_placed_loss_matches_the_reference(placed, arch, shape):
    jb, tree, _ = _weights(arch, shape)
    cfg = jb.cfg
    model_cls = JAX_GNN_MODELS[cfg.model]
    want = float(jax.jit(lambda p, b: model_cls.loss(p, b, cfg)[0])(
        tree, jb.make_inputs(shape)))
    got = placed[f"{arch}-{shape}"]["loss"]
    assert abs(got - want) <= LOSS_RTOL * max(abs(want), 1.0), (got, want)


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_placed_step_matches_the_undistributed_step(placed, arch, shape):
    got = placed[f"{arch}-{shape}"]
    want = _undistributed(arch, shape)
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert abs(got["gnorm"] - want["gnorm"]) <= GNORM_RTOL * want["gnorm"]
    for name, p in want["params"].items():
        new = placed["arrays"][f"{arch}-{shape}/{name}"]
        firm = np.abs(want["grads"][name]) >= ADAM_G_FLOOR
        np.testing.assert_allclose(new[firm], p[firm], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        np.testing.assert_allclose(new[~firm], p[~firm], rtol=0,
                                   atol=2 * want["lr"], err_msg=name)


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_no_index_gather_or_scatter_meets_a_dtensor(placed, arch, shape):
    got = placed[f"{arch}-{shape}"]
    # the guard saw the step, its backward included
    assert got["backward_dtensor_ops"] > 0
    assert got["dtensor_ops"] > got["backward_dtensor_ops"]
    assert got["flagged"] == [], got["flagged"][:5]


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_the_batch_is_split_over_all_four_ranks(placed, arch, shape):
    assert placed[f"{arch}-{shape}"]["mesh"] == FLAT
    pl = placed[f"{arch}-{shape}"]["placements"]
    for name in ("positions", "species", "edge_src", "edge_dst",
                 "node_mask", "edge_mask", "graph_ids"):
        assert pl[name] == SPLIT, (name, pl[name])
    if arch == "dimenet":
        assert pl["t_kj"] == pl["t_ji"] == pl["t_mask"] == SPLIT


def test_block_by_block_placement_equals_placing_the_whole_model(placed):
    got = placed["placed_init"]
    assert got["names_equal"] and got["placements_equal"] \
        and got["values_equal"], got
    # the experts over model (expert parallel) and over data (FSDP)
    assert got["experts"] == ["S(1)", "S(0)"]
