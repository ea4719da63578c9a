"""The port's GNN substrate on the CPU against the reference: the data
generators and the neighbor sampler (`data/graph_data.py`,
`data/sampler.py`), the segment ops and the GatedGCN layer (`nn/gnn.py`),
the equivariant primitives (`nn/equivariant.py`) and the new `nn/core.py`
primitives (LayerNorm, the tanh GELU, the MLP, uniform_init).

Tolerances:
- generator and sampler arrays, triplets, Gaunt tensors, the X±
  rotation matrices and numpy spherical harmonics: equal bit for bit (the
  same numpy code);
- float32 spherical harmonics on random vectors, on ±z and on the x–y
  plane: 1e-5 absolute (values of order 1; the poles floor sinθ at 1e-6
  on both sides);
- segment ops, the GatedGCN layer, the rotations, SO2Conv, the radial and
  angular bases and the core primitives: 1e-5 absolute at values of order
  1 (float32 sums in another order); rotating forth and back returns the
  input within 1e-5;
- `segment_sum` inside `shard_rows` on four gloo ranks
  (`torch_dist_cases.py segments`): within 1e-5 of `jax.ops.segment_sum`;
  against the unsharded `segment_sum`, equal bit for bit where the range
  does not split over the ranks (summed whole, in one device's order) and
  within 1e-6 where it does (partials added across ranks); the values'
  gradients exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.graph import synthetic_labeled_graph as jax_graph  # noqa
from repro.data import graph_data as jgd  # noqa: E402
from repro.data import sampler as jsampler  # noqa: E402
from repro.nn import core as jcore  # noqa: E402
from repro.nn import equivariant as jeq  # noqa: E402
from repro.nn import gnn as jgnn  # noqa: E402
from repro_torch.core.graph import synthetic_labeled_graph  # noqa: E402
from repro_torch.data import graph_data as gd  # noqa: E402
from repro_torch.data import sampler  # noqa: E402
from repro_torch.models.convert import gnn_params_from_jax  # noqa: E402
from repro_torch.nn import core  # noqa: E402
from repro_torch.nn import equivariant as eq  # noqa: E402
from repro_torch.nn import gnn  # noqa: E402
from torch_lm_common import flat_np, perturb_tree, to_np  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_dist_cases as cases  # noqa: E402

ATOL = 1e-5
SH_ATOL = 1e-5


def _assert_batches_equal(mine, theirs):
    a, b = gd.batch_to_arrays(mine), jgd.batch_to_arrays(theirs)
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert mine.n_graphs == theirs.n_graphs


# ------------------------------------------------------------- data
@pytest.mark.parametrize("with_triplets", [False, True])
def test_synth_full_graph_is_the_reference_one(with_triplets):
    kw = dict(seed=3, with_triplets=with_triplets, triplet_cap_per_edge=4)
    _assert_batches_equal(gd.synth_full_graph(80, 300, 12, **kw),
                          jgd.synth_full_graph(80, 300, 12, **kw))


@pytest.mark.parametrize("with_triplets", [False, True])
def test_molecule_batch_is_the_reference_one(with_triplets):
    kw = dict(seed=5, with_triplets=with_triplets)
    _assert_batches_equal(gd.molecule_batch(3, 12, 20, **kw),
                          jgd.molecule_batch(3, 12, 20, **kw))


@pytest.mark.parametrize("cap", [1, 3, 16])
def test_build_triplets_is_the_reference_one(cap):
    """Over a graph with masked (padded) edges too."""
    gb = gd.synth_full_graph(40, 150, 4, seed=1)
    gb.edge_mask = gb.edge_mask.copy()
    gb.edge_mask[::7] = False
    ours = gd.build_triplets(gb, cap_per_edge=cap)
    theirs = jgd.build_triplets(gb, cap_per_edge=cap)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert ours[2].any() and not ours[2].all()


@pytest.mark.parametrize("fanout", [(3, 2), (5,), (4, 3, 2)])
def test_neighbor_sampler_is_the_reference_one(fanout):
    """The sampler over the port's own synthetic graph (equal to the
    reference's CSR), laid out [seeds, hop 1, ...], with sampled_shape's
    counts."""
    g, jg = synthetic_labeled_graph(300, 6.0, 4, seed=2), \
        jax_graph(300, 6.0, 4, seed=2)
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)
    seeds = np.random.default_rng(0).integers(0, g.n, 10)
    mine = sampler.NeighborSampler(g.indptr, g.indices, d_feat=8, seed=4)
    theirs = jsampler.NeighborSampler(jg.indptr, jg.indices, d_feat=8,
                                      seed=4)
    a, b = mine.sample(seeds, fanout), theirs.sample(seeds, fanout)
    _assert_batches_equal(a, b)
    assert (a.n, a.e) == sampler.sampled_shape(10, fanout) \
        == jsampler.sampled_shape(10, fanout)


def test_graph_batch_specs_are_the_reference_ones():
    for kw in ({}, {"with_triplets": True, "triplet_cap": 4},
               {"n_graphs": 3}):
        for d_feat in (None, 7):
            mine = gd.graph_batch_specs(50, 120, d_feat, **kw)
            theirs = jgd.graph_batch_specs(50, 120, d_feat, **kw)
            assert sorted(mine) == sorted(theirs)
            for name, (shape, dtype) in mine.items():
                assert shape == theirs[name].shape
                assert torch.empty(0, dtype=dtype).numpy().dtype \
                    == theirs[name].dtype


# ------------------------------------------------------------- segment ops
def _edges(seed, n=9, e=40, h=None):
    """Edges into n nodes with node n - 1 receiving none, a mask with False
    entries (padded edges point at node 0), and values of width h."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n - 1, e).astype(np.int32)
    mask = rng.random(e) > 0.25
    dst[~mask] = 0
    shape = (e,) if h is None else (e, h)
    vals = rng.standard_normal(shape).astype(np.float32)
    return vals, dst, mask


@pytest.mark.parametrize("masked", [False, True])
def test_scatter_sum_and_mean_match_the_reference(masked):
    vals, dst, mask = _edges(0, h=5)
    m = mask if masked else None
    tm = torch.from_numpy(mask) if masked else None
    for mine, theirs in ((gnn.scatter_sum, jgnn.scatter_sum),
                         (gnn.scatter_mean, jgnn.scatter_mean)):
        got = mine(torch.from_numpy(vals), torch.from_numpy(dst), 9, tm)
        want = theirs(jnp.asarray(vals), jnp.asarray(dst), 9,
                      None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                                   atol=ATOL)
        assert not got[-1].any()             # the node with no edge


@pytest.mark.parametrize("h", [None, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches_the_reference(h, masked):
    """(E,) and (E, H) scores; values and gradients; node 0 also receives
    the padded edges, the last node none."""
    vals, dst, mask = _edges(1, h=h)
    vals = vals * 4
    tm = torch.from_numpy(mask) if masked else None
    jm = jnp.asarray(mask) if masked else None
    x = torch.from_numpy(vals).requires_grad_()
    got = gnn.segment_softmax(x, torch.from_numpy(dst), 9, tm)
    w = np.random.default_rng(2).standard_normal(vals.shape) \
        .astype(np.float32)
    (g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), x)
    fn = lambda v: jgnn.segment_softmax(v, jnp.asarray(dst), 9, jm)  # noqa
    want = fn(jnp.asarray(vals))
    jg = jax.grad(lambda v: (fn(v) * w).sum())(jnp.asarray(vals))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(to_np(g), np.asarray(jg), rtol=0, atol=ATOL)
    if masked:
        assert not got[torch.from_numpy(~mask)].any()


def test_segment_max_of_an_empty_segment_is_minus_inf():
    vals, dst, _ = _edges(3, h=2)
    got = core.segment_max(torch.from_numpy(vals), torch.from_numpy(dst), 9)
    want = jax.ops.segment_max(jnp.asarray(vals), jnp.asarray(dst),
                               num_segments=9)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert torch.isneginf(got[-1]).all()


@pytest.fixture(scope="module")
def sharded_segments(tmp_path_factory):
    """`tests/torch_dist_cases.py segments`: `segment_sum` inside
    `shard_rows` on four gloo ranks, in a subprocess of its own."""
    out = tmp_path_factory.mktemp("segments")
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    proc = subprocess.run([sys.executable, str(HERE / "torch_dist_cases.py"),
                           "segments", str(out)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out / "segments.json") as f:
        return dict(np.load(out / "segments.npz")), json.load(f)


@pytest.mark.parametrize("n,rows,empty", cases.SEGMENT_CASES)
def test_sharded_segment_sum_matches_the_reference(sharded_segments, n,
                                                   rows, empty):
    """Each rank's rows of the values: a range of segments that does not
    split over the four ranks is summed whole, in one device's row order,
    so it equals the unsharded `segment_sum` (index_add) bit for bit; a
    range that splits is reduce-scattered, within 1e-6 of it (the ranks'
    partials added across ranks). Both within ATOL of
    `jax.ops.segment_sum` on the same numpy inputs, empty segments exactly
    0; the values' gradient of a weighted sum of the result is exactly the
    weights of their segments on every rank."""
    arrays, res = sharded_segments
    values, ids, w = cases.segment_inputs(n, rows, empty)
    key = f"{n}-{rows}-{int(empty)}"
    got = arrays[f"{key}/out"]
    want = jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(ids),
                               num_segments=n)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    one = to_np(core.segment_sum(torch.from_numpy(values),
                                 torch.from_numpy(ids), n))
    whole = n % cases.WORLD != 0
    if whole:
        np.testing.assert_array_equal(got, one)
        assert res[key]["rows_back"] == [n, 3]
        assert res[key]["equal_on_every_rank"]
    else:
        np.testing.assert_allclose(got, one, rtol=0, atol=1e-6)
        assert res[key]["rows_back"] == [n // cases.WORLD, 3]
    if empty:
        assert not got[1::2].any()
    np.testing.assert_array_equal(arrays[f"{key}/grad"], w[ids])


def test_gatedgcn_layer_matches_the_reference():
    """The layer's h and e outputs and its weights' gradients, from the
    reference's weights with noisy biases and gains."""
    d, n = 6, 9
    tree = perturb_tree(jgnn.gatedgcn_init(jax.random.PRNGKey(0), d))
    layer = gnn.GatedGCNLayer(d, gen=torch.Generator().manual_seed(0),
                              device="cpu")
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in flat_np(tree).items()}, strict=True)
    _, dst, mask = _edges(4, n=n)
    rng = np.random.default_rng(5)
    src = rng.integers(0, n, dst.shape[0]).astype(np.int32)
    h = rng.standard_normal((n, d)).astype(np.float32)
    e = rng.standard_normal((dst.shape[0], d)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (h, e, src, dst, mask)]
    ho, eo = gnn.gatedgcn_layer(layer, *args, n)
    grads = torch.autograd.grad((ho ** 2).sum() + eo.sum(),
                                list(layer.parameters()))

    def ref(p):
        return jgnn.gatedgcn_layer(p, *map(jnp.asarray, (h, e, src, dst,
                                                         mask)), n)
    jho, jeo = ref(tree)
    jgrads = flat_np(jax.grad(
        lambda p: (ref(p)[0] ** 2).sum() + ref(p)[1].sum())(tree))
    np.testing.assert_allclose(to_np(ho), np.asarray(jho), rtol=0, atol=ATOL)
    np.testing.assert_allclose(to_np(eo), np.asarray(jeo), rtol=0, atol=ATOL)
    for (name, _), g in zip(layer.named_parameters(), grads):
        np.testing.assert_allclose(to_np(g), jgrads[name], rtol=1e-5,
                                   atol=1e-4, err_msg=name)


# ------------------------------------------------------------- core
def test_layernorm_gelu_and_mlp_match_the_reference():
    """LayerNorm (noisy gain and bias), the tanh-approximate GELU (not
    torch's default erf form) and a 3-layer MLP with and without the final
    activation."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 7)).astype(np.float32) * 3
    ln = core.LayerNorm(7, device="cpu")
    g = rng.standard_normal(7).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    ln.load_state_dict({"g": torch.from_numpy(g), "b": torch.from_numpy(b)})
    np.testing.assert_allclose(
        to_np(core.layernorm(ln, torch.from_numpy(x))),
        np.asarray(jcore.layernorm({"g": g, "b": b}, jnp.asarray(x))),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(to_np(core.gelu(torch.from_numpy(x))),
                               np.asarray(jcore.gelu(jnp.asarray(x))),
                               rtol=0, atol=ATOL)
    assert float((core.gelu(torch.from_numpy(x)) - torch.nn.functional.gelu(
        torch.from_numpy(x))).abs().max()) > 1e-4
    tree = perturb_tree(jcore.mlp_init(jax.random.PRNGKey(1), (7, 9, 4, 3)))
    m = core.MLP((7, 9, 4, 3), gen=torch.Generator().manual_seed(0),
                 device="cpu")
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in flat_np(tree).items()}, strict=True)
    for final_act in (False, True):
        np.testing.assert_allclose(
            to_np(core.mlp(m, torch.from_numpy(x), final_act=final_act)),
            np.asarray(jcore.mlp(tree, jnp.asarray(x), final_act=final_act)),
            rtol=0, atol=ATOL)


def test_uniform_init_follows_the_reference_bounds():
    gen = torch.Generator().manual_seed(0)
    for shape in ((400, 30), (1000,)):
        x = core.uniform_init(gen, shape, device="cpu")
        bound = 1.0 / np.sqrt(shape[0] if len(shape) > 1 else 1)
        ref = np.asarray(jcore.uniform_init(jax.random.PRNGKey(0), shape))
        assert x.shape == ref.shape and x.dtype == torch.float32
        assert float(x.abs().max()) <= bound and np.abs(ref).max() <= bound
        assert float(x.abs().max()) > 0.9 * bound
        assert abs(float(x.mean())) < 0.1 * bound


# ------------------------------------------------------------- equivariant
def _vectors():
    """Random vectors, ±z (the poles, with and without a scale), and the
    x–y plane."""
    rng = np.random.default_rng(8)
    rand = rng.standard_normal((64, 3))
    poles = np.array([[0, 0, 1], [0, 0, -1], [0, 0, 2.5], [0, 0, -0.3]],
                     np.float64)
    ang = rng.uniform(0, 2 * np.pi, 16)
    plane = np.stack([np.cos(ang), np.sin(ang), np.zeros(16)], 1) * 1.7
    return {"random": rand, "poles": poles, "plane": plane}


@pytest.mark.parametrize("where", ["random", "poles", "plane"])
def test_real_sph_harm_matches_the_reference(where):
    v = _vectors()[where]
    for l_max in (2, 6):
        ours = eq.real_sph_harm(v, l_max, xp=np)
        theirs = jeq.real_sph_harm(v, l_max, xp=np)
        got = eq.real_sph_harm(torch.tensor(v, dtype=torch.float32), l_max)
        want = jeq.real_sph_harm(jnp.asarray(v, jnp.float32), l_max)
        for l in range(l_max + 1):
            np.testing.assert_array_equal(ours[l], theirs[l])
            np.testing.assert_allclose(to_np(got[l]), np.asarray(want[l]),
                                       rtol=0, atol=SH_ATOL)


def test_fixed_tables_are_the_reference_ones():
    """gaunt_tensor for every (l1, l2, l3) up to 3, and x_rot_matrices up
    to l_max 6, bit for bit."""
    for l1 in range(4):
        for l2 in range(4):
            for l3 in range(4):
                np.testing.assert_array_equal(eq.gaunt_tensor(l1, l2, l3),
                                              jeq.gaunt_tensor(l1, l2, l3))
    for l_max in (1, 2, 6):
        for ours, theirs in zip(eq.x_rot_matrices(l_max),
                                jeq.x_rot_matrices(l_max)):
            assert len(ours) == len(theirs) == l_max + 1
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)


def test_align_angles_and_dz_apply_match_the_reference():
    v = np.concatenate(list(_vectors().values())).astype(np.float32)
    a, b = eq.align_to_z_angles(torch.from_numpy(v))
    ja, jb = jeq.align_to_z_angles(jnp.asarray(v))
    np.testing.assert_array_equal(to_np(a), np.asarray(ja))
    np.testing.assert_allclose(to_np(b), np.asarray(jb), rtol=0, atol=ATOL)
    assert np.isfinite(to_np(b)).all()
    f = np.random.default_rng(9).standard_normal((v.shape[0], 3, 7)) \
        .astype(np.float32)
    for sign in (1.0, -1.0):
        np.testing.assert_allclose(
            to_np(eq.dz_apply(torch.from_numpy(f), a[:, None], 3, sign)),
            np.asarray(jeq.dz_apply(jnp.asarray(f), ja[:, None], 3, sign)),
            rtol=0, atol=ATOL)


def _edge_feats(n_edges, c, l_max, seed):
    rng = np.random.default_rng(seed)
    return {l: rng.standard_normal((n_edges, c, 2 * l + 1))
            .astype(np.float32) for l in range(l_max + 1)}


@pytest.mark.parametrize("l_max", [2, 6])
def test_rotate_to_edge_frame_forth_and_back(l_max):
    """Forth and back against the reference's, and back ∘ forth = the
    input; a rotated edge direction lands on +z."""
    v = np.concatenate(list(_vectors().values())).astype(np.float32)
    a, b = eq.align_to_z_angles(torch.from_numpy(v))
    ja, jb = jeq.align_to_z_angles(jnp.asarray(v))
    feats = _edge_feats(v.shape[0], 3, l_max, 10)
    tf = {l: torch.from_numpy(f) for l, f in feats.items()}
    fwd = eq.rotate_to_edge_frame(tf, a, b, l_max)
    back = eq.rotate_to_edge_frame(fwd, a, b, l_max, inverse=True)
    jfwd = jeq.rotate_to_edge_frame({l: jnp.asarray(f) for l, f in
                                     feats.items()}, ja, jb, l_max)
    jback = jeq.rotate_to_edge_frame(jfwd, ja, jb, l_max, inverse=True)
    for l in feats:
        np.testing.assert_allclose(to_np(fwd[l]), np.asarray(jfwd[l]),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(to_np(back[l]), np.asarray(jback[l]),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(to_np(back[l]), feats[l], rtol=0,
                                   atol=ATOL)
    # Y(v) rotated into the edge frame is Y(ẑ)
    sh = eq.real_sph_harm(torch.from_numpy(v), l_max)
    z = eq.real_sph_harm(torch.tensor([[0.0, 0.0, 1.0]]), l_max)
    rot = eq.rotate_to_edge_frame({l: s[:, None, :] for l, s in sh.items()},
                                  a, b, l_max)
    for l in rot:
        np.testing.assert_allclose(to_np(rot[l][:, 0]),
                                   to_np(z[l]).repeat(v.shape[0], 0),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("l_max,c_in,c_out", [(2, 3, 4), (6, 2, 2)])
def test_so2_conv_matches_the_reference(l_max, c_in, c_out):
    tree = jeq.SO2Conv.init(jax.random.PRNGKey(2), l_max, c_in, c_out)
    conv = eq.SO2Conv(l_max, c_in, c_out,
                      gen=torch.Generator().manual_seed(0), device="cpu")
    conv.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in tree.items()}, strict=True)
    feats = _edge_feats(11, c_in, l_max, 12)
    got = eq.so2_conv(conv, {l: torch.from_numpy(f)
                             for l, f in feats.items()}, l_max, c_out)
    want = jeq.SO2Conv.apply(tree, {l: jnp.asarray(f)
                                    for l, f in feats.items()}, l_max, c_out)
    for l in range(l_max + 1):
        assert tuple(got[l].shape) == (11, c_out, 2 * l + 1)
        np.testing.assert_allclose(to_np(got[l]), np.asarray(want[l]),
                                   rtol=0, atol=ATOL)


def test_radial_and_angular_bases_match_the_reference():
    """bessel_basis below, at and beyond the cutoff and at r → 0;
    legendre_poly over [-1, 1]."""
    r = np.array([0.0, 1e-7, 0.3, 1.0, 2.5, 4.99, 5.0, 7.0], np.float32)
    for n_rbf in (4, 8):
        np.testing.assert_allclose(
            to_np(eq.bessel_basis(torch.from_numpy(r), n_rbf, 5.0)),
            np.asarray(jeq.bessel_basis(jnp.asarray(r), n_rbf, 5.0)),
            rtol=1e-6, atol=ATOL)
    z = np.linspace(-1, 1, 21).astype(np.float32)
    for l_max in (0, 1, 6):
        np.testing.assert_allclose(
            to_np(eq.legendre_poly(torch.from_numpy(z), l_max)),
            np.asarray(jeq.legendre_poly(jnp.asarray(z), l_max)),
            rtol=0, atol=ATOL)


def test_gnn_params_from_jax_flattens_dicts_and_lists():
    tree = {"embed": {"table": np.zeros((2, 3))},
            "layers": [{"radial": {"0_1_1": {"layers": [
                {"w": np.ones((1, 2)), "b": np.zeros(2)}]}},
                "self": {"0": {"w": np.eye(2)}}}] * 2}
    cfg = type("C", (), {"model": "nequip", "n_layers": 2})()
    sd = gnn_params_from_jax(tree, cfg)
    assert sorted(sd) == sorted(
        ["embed.table"] + [f"layers.{i}.{p}" for i in range(2) for p in
                           ("radial.0_1_1.layers.0.w",
                            "radial.0_1_1.layers.0.b", "self.0.w")])
    cfg.n_layers = 3
    with pytest.raises(ValueError, match="3"):
        gnn_params_from_jax(tree, cfg)
