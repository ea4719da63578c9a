"""The port's recsys stack (bert4rec) on the CPU against the reference: the
config and the registry's ten ids, the bidirectional `encoder_forward`,
`cloze_loss` and its gradients, the top-k functions on built ties,
`score_next`, `score_candidates`, the bundle's inputs, specs and FLOPs,
its three steps on every reduced RECSYS_SHAPES entry from the reference's
weights with seeded noise on the gains (moved across by
`bert4rec_params_from_jax`, strict), `embedding_bag`, and the serving
launcher's `--arch bert4rec`.

Tolerances (float32 on both sides; sums in another order, two blocks
deep):
- hidden states, scores, top-k values and the loss: 1e-5 relative to the
  reference's largest magnitude;
- gradients: within 1e-4 of each leaf's largest |g|;
- the train step's gnorm 1e-5 relative; its parameters within 1e-5 where
  the reference's |g| >= 1e-6, within 2·lr elsewhere (Adam's first step
  normalises rounding noise where |g| is near its epsilon);
- top-k indices: equal, ties included (a tie goes to the lower index, as
  `jax.lax.top_k` has it);
- embedding_bag: 1e-6 absolute.
"""
import dataclasses
import functools
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import RECSYS_SHAPES as JAX_RECSYS_SHAPES  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.models import bert4rec as jb4  # noqa: E402
from repro.models.api import build_bundle as jax_build_bundle  # noqa: E402
from repro.nn import core as jcore  # noqa: E402
from repro.nn import transformer as jT  # noqa: E402
from repro_torch.config import RECSYS_SHAPES  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import bert4rec as b4  # noqa: E402
from repro_torch.models.api import build_bundle  # noqa: E402
from repro_torch.models.convert import bert4rec_params_from_jax  # noqa
from repro_torch.nn import core  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from torch_lm_common import perturb_tree, to_np  # noqa: E402

ARCH = "bert4rec"
RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5
ADAM_G_FLOOR = 1e-6
BAG_ATOL = 1e-6


@functools.lru_cache(maxsize=None)
def _weights():
    """(the reference's reduced bundle, its tree with noisy gains, the
    port's bundle, the port's model on the same weights)."""
    jb = jax_build_bundle(ARCH, reduced=True)
    tree = perturb_tree(jb.init_fn(jax.random.PRNGKey(0)))
    bundle = build_bundle(ARCH, reduced=True, device="cpu")
    return jb, tree, bundle, _port_model(bundle, tree)


def _port_model(bundle, tree):
    model = bundle.init_fn(1)
    model.load_state_dict(bert4rec_params_from_jax(tree, bundle.cfg),
                          strict=True)
    return model


def _close(got, want, rtol=RTOL, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=rtol * scale,
                               err_msg=what)


# ------------------------------------------------------------- registry
@pytest.mark.parametrize("reduced", [False, True])
def test_config_is_the_reference_config(reduced):
    mine = registry.get_config(ARCH, reduced=reduced)
    theirs = jregistry.get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(b4.bert4rec_encoder_cfg(mine)).items() <= \
        dataclasses.asdict(jb4.bert4rec_encoder_cfg(theirs)).items()


def test_registry_covers_the_reference_ids():
    """The ten ids in the reference's order; each id's family shapes; an
    unknown id raises the reference's KeyError text."""
    assert registry.arch_ids() == jregistry.arch_ids()
    assert len(registry.arch_ids()) == 10
    for arch in registry.arch_ids():
        assert registry.shapes_for(arch) == jregistry.shapes_for(arch)
        for reduced in (False, True):
            assert registry.get_config(arch, reduced=reduced).family \
                == jregistry.get_config(arch, reduced=reduced).family
    assert RECSYS_SHAPES == JAX_RECSYS_SHAPES
    with pytest.raises(KeyError) as mine:
        registry.get_config("gpt-9")
    with pytest.raises(KeyError) as theirs:
        jregistry.get_config("gpt-9")
    assert str(mine.value) == str(theirs.value)


def test_bundle_inputs_specs_and_flops_are_the_reference_ones():
    """Every reduced shape's inputs (the same draws) and specs; model_flops
    of every shape at full size; the card by default."""
    jb, _, bundle, _ = _weights()
    for shape in RECSYS_SHAPES:
        mine, theirs = bundle.make_inputs(shape, seed=3), \
            jb.make_inputs(shape, seed=3)
        assert sorted(mine) == sorted(theirs)
        specs, jspecs = bundle.input_specs(shape), jb.input_specs(shape)
        for name, t in mine.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(theirs[name]))
            assert specs[name][0] == tuple(t.shape) == jspecs[name].shape
            assert specs[name][1] == t.dtype
    full, jfull = build_bundle(ARCH, device="cpu"), jax_build_bundle(ARCH)
    assert full.family == jfull.family == "recsys"
    for shape in RECSYS_SHAPES:
        assert full.model_flops(shape) == jfull.model_flops(shape)
        assert {n: s for n, (s, _) in full.input_specs(shape).items()} \
            == {n: s.shape for n, s in jfull.input_specs(shape).items()}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_bundle(ARCH)


# ------------------------------------------------------------- encoder, loss
def test_encoder_forward_matches_the_reference():
    jb, tree, bundle, model = _weights()
    ids = bundle.make_inputs("serve_p99", seed=1)["ids"]
    with torch.no_grad():
        got = T.encoder_forward(model, ids)
    want = jT.encoder_forward(tree, jnp.asarray(ids.numpy()),
                              jb4.bert4rec_encoder_cfg(jb.cfg))
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("batch_chunk", [None, 3])
def test_cloze_loss_and_gradients_match_the_reference(batch_chunk):
    """One chunk of the whole batch, and chunks of 3 rows over 8 (the last
    one short: the reference pads it with invalid rows)."""
    jb, tree, bundle, model = _weights()
    batch = bundle.make_inputs("train_batch", seed=2)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    params = dict(model.named_parameters())
    loss, met = b4.cloze_loss(model, batch, bundle.cfg,
                              batch_chunk=batch_chunk)
    grads = torch.autograd.grad(loss, list(params.values()))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jb4.cloze_loss(p, jbatch, jb.cfg, batch_chunk=batch_chunk),
        has_aux=True)(tree)
    _close(loss, jloss)
    assert float(met["nll"].detach()) == float(loss.detach())
    jg = bert4rec_params_from_jax(jgrads, bundle.cfg)
    for name, g in zip(params, grads):
        want = jg[name].numpy()
        np.testing.assert_allclose(
            to_np(g), want, rtol=0,
            atol=GRAD_RTOL * max(float(np.abs(want).max()), 1e-30),
            err_msg=name)


# ------------------------------------------------------------- top-k
def _tied_scores(rows, cols, seed):
    """Integer-valued scores with many exact ties (values in 0..5)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 6, (rows, cols)).astype(np.float32)


@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_top_k_on_built_ties_is_the_references(n_parts):
    """iterative_top_k and two_stage_top_k at 1, 2 and 4 parts: values and
    indices equal to the reference's functions and to jax.lax.top_k, a tie
    going to the lower index; the input is left as it was."""
    x = _tied_scores(5, 64, n_parts)
    t = torch.from_numpy(x)
    for k in (1, 10, 17):
        lv, li = jax.lax.top_k(jnp.asarray(x), k)
        iv, ii = b4.iterative_top_k(t, k)
        jv, ji = jb4.iterative_top_k(jnp.asarray(x), k)
        sv, si = b4.two_stage_top_k(t, k, n_parts)
        jsv, jsi = jb4.two_stage_top_k(jnp.asarray(x), k, n_parts)
        for v, i, wv, wi in ((iv, ii, jv, ji), (iv, ii, lv, li),
                             (sv, si, jsv, jsi), (sv, si, lv, li)):
            np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
            np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        assert ii.dtype == si.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), x)


@pytest.mark.parametrize("top_k", [10, 40])
def test_score_next_on_built_ties_is_the_references(top_k):
    """The item table zeroed but for the rows of the histories' items, so
    every other item scores exactly 0: the top-k fills with zeros in index
    order, as the reference's (jax.lax.top_k) does."""
    jb, tree, bundle, _ = _weights()
    ids = bundle.make_inputs("serve_p99", seed=4)["ids"]
    table = np.array(tree["embed"]["table"])
    keep = np.zeros(table.shape[0], bool)
    keep[np.unique(ids.numpy())] = True
    table[~keep] = 0.0
    tied = {**tree, "embed": {"table": table}}
    model = _port_model(bundle, tied)
    vals, idx = b4.score_next(model, ids, bundle.cfg, top_k=top_k)
    jvals, jidx = jb4.score_next(tied, jnp.asarray(ids.numpy()), jb.cfg,
                                 top_k=top_k)
    _close(vals, jvals)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if top_k == 40:
        assert (vals == 0).any()             # the ties are in the top-k


def test_score_candidates_matches_the_reference():
    jb, tree, bundle, model = _weights()
    batch = bundle.make_inputs("retrieval_cand", seed=5,
                               batch=3)
    got = b4.score_candidates(model, batch["ids"], batch["candidate_ids"],
                              bundle.cfg)
    want = jb4.score_candidates(tree, jnp.asarray(batch["ids"].numpy()),
                                jnp.asarray(batch["candidate_ids"].numpy()),
                                jb.cfg)
    assert tuple(got.shape) == want.shape == (3, 512)
    _close(got, want)


# ------------------------------------------------------------- the slice
@pytest.mark.parametrize("shape", list(RECSYS_SHAPES))
def test_steps_on_every_reduced_shape_match_the_reference(shape):
    """Each shape through its kind's step: train (loss, gnorm, the updated
    parameters), serve (top-10 values and indices) or retrieval
    (scores)."""
    jb, tree, bundle, _ = _weights()
    model = _port_model(bundle, tree)
    batch = bundle.make_inputs(shape)
    jbatch = jb.make_inputs(shape)
    kind = RECSYS_SHAPES[shape]["kind"]
    if kind == "train":
        opt_state = bundle.optimizer.init(dict(model.named_parameters()))
        _, opt_state, met = bundle.steps["train"](model, opt_state, batch)
        jgrads = jax.grad(lambda p: jb4.cloze_loss(p, jbatch, jb.cfg)[0])(
            tree)
        new, _, jmet = jax.jit(jb.steps["train"])(
            tree, jb.optimizer.init(tree), jbatch)
        _close(met["loss"], jmet["loss"])
        assert abs(float(met["gnorm"]) - float(jmet["gnorm"])) \
            <= RTOL * float(jmet["gnorm"])
        g = bert4rec_params_from_jax(jgrads, bundle.cfg)
        want = bert4rec_params_from_jax(new, bundle.cfg)
        lr = bundle.optimizer.lr
        for name, p in model.named_parameters():
            firm = (g[name].abs() >= ADAM_G_FLOOR).numpy()
            got, ref = to_np(p), want[name].numpy()
            np.testing.assert_allclose(got[firm], ref[firm], rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
            np.testing.assert_allclose(got, ref, rtol=0, atol=2 * lr,
                                       err_msg=name)
    elif kind == "serve":
        vals, idx = bundle.steps["serve"](model, batch)
        jvals, jidx = jb.steps["serve"](tree, jbatch)
        _close(vals, jvals)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    else:
        got = bundle.steps["retrieval"](model, batch)
        _close(got, jb.steps["retrieval"](tree, jbatch))


def test_serve_launcher_scores_bert4rec():
    """`--arch bert4rec` scores a serve_p99 batch (or `--shape`'s) of the
    reduced config and prints the reference launcher's line; a GNN id is
    refused."""
    for argv, want in ((["--arch", ARCH, "--device", "cpu"],
                        "scored batch (8, 24) → top10 (8, 10) on cpu"),
                       (["--arch", ARCH, "--device", "cpu", "--shape",
                         "serve_bulk"], "scored batch (8, 24)")):
        out = io.StringIO()
        with redirect_stdout(out):
            assert serve.main(argv) == 0
        assert out.getvalue().startswith(want)
    with pytest.raises(SystemExit, match="only trains"):
        serve.main(["--arch", "gatedgcn", "--device", "cpu"])


# ------------------------------------------------------------- embedding bag
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_the_reference(mode, weighted):
    """Bags of 0 to 4 ids over 6 segments, the last bag empty (0 for sum
    and mean, -inf for max, as the reference's segment ops give)."""
    rng = np.random.default_rng(11)
    table = rng.standard_normal((20, 5)).astype(np.float32)
    seg = np.sort(rng.integers(0, 5, 14)).astype(np.int32)
    ids = rng.integers(0, 20, 14).astype(np.int32)
    w = rng.random(14).astype(np.float32) if weighted else None
    emb = core.Embedding(20, 5, gen=torch.Generator().manual_seed(0),
                         device="cpu")
    emb.load_state_dict({"table": torch.from_numpy(table)})
    got = core.embedding_bag(emb, torch.from_numpy(ids), torch.from_numpy(seg),
                             6, mode=mode, weights=None if w is None
                             else torch.from_numpy(w))
    want = jcore.embedding_bag({"table": jnp.asarray(table)},
                               jnp.asarray(ids), jnp.asarray(seg), 6,
                               mode=mode, weights=None if w is None
                               else jnp.asarray(w))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=BAG_ATOL)
