"""The port's training stack on the CPU against the reference: AdamW and
its schedule, one `steps["train"]` of the reduced qwen2-1.5b from the same
weights, int8 gradient compression, checkpoints (round trips, keep-k,
across both packages, async snapshots), the Supervisor's fault replay and
straggler flag, the token stream, and `launch/train.py`.

Tolerances:
- AdamW: gnorm 1e-6 relative; float32 leaves and the moments 1e-5
  relative (the same float32 formulas with the products and the norm's
  sum in another order, through three steps); a bfloat16 leaf within one
  bfloat16 step (the float32 results may round to neighbours);
- the float32 train step: loss and gnorm 1e-5 relative, parameters and
  moments 1e-5 absolute;
- the bfloat16 train step: loss 1e-3 and gnorm 1e-2 relative (each side
  rounds its activations to bfloat16 at other places, so gradient entries
  differ by a few percent; the loss and the norm average over many of
  them); parameters within 2·lr + 1e-6 of each other: on the first step
  Adam moves every entry by lr·(g/|g| + wd·p) with |g/|g|| ≤ 1 on both
  sides whatever the gradients, so 2·lr bounds the difference; the first
  moments within 10 % of the leaf's largest magnitude;
- the int8 codes and scales equal, dequantized values and residuals 1e-7;
- the Supervisor's replay against a fault-free run: 1e-4 (the
  reference's test).
"""
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models.api import build_bundle as jax_build_bundle  # noqa: E402
from repro.nn import transformer as jT  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.trainer import lm_token_stream as jax_token_stream  # noqa
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.api import build_bundle  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402
from repro_torch.runtime import ft  # noqa: E402
from repro_torch.runtime.ft import FaultInjector  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import TrainLoop, lm_token_stream  # noqa
from torch_lm_common import (ARCH, JNP_DTYPE, TORCH_DTYPE,  # noqa: E402
                             perturbed_params, port_model, to_np)

LR = 3e-4                  # the bundles' AdamW
TRAIN_CASES = [("float32", 1), ("float32", 4), ("bfloat16", 1),
               ("bfloat16", 4)]


# ------------------------------------------------------------- optimizer
def _adamw_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (3.0 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("schedule", ["cosine_clipped", "constant"])
def test_adamw_matches_the_reference(schedule):
    """Three steps from the same parameters and gradients: a cosine
    schedule with warmup and clipping active (gradient norms ~10 against
    clip_norm 1), or a constant lr without clipping; one float32 leaf of
    each case is held in bfloat16 instead."""
    if schedule == "cosine_clipped":
        kw = dict(lr=opt.cosine_schedule(1e-2, 2, 5), clip_norm=1.0)
        jkw = dict(lr=jopt.cosine_schedule(1e-2, 2, 5), clip_norm=1.0)
    else:
        kw = jkw = dict(lr=1e-3, clip_norm=None, weight_decay=0.1)
    params, grads = _adamw_inputs(7)
    mine = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    mine["c"] = mine["c"].bfloat16()
    theirs = {k: jnp.asarray(v) for k, v in params.items()}
    theirs["c"] = theirs["c"].astype(jnp.bfloat16)
    o, jo = opt.AdamW(**kw), jopt.AdamW(**jkw)
    state, jstate = o.init(mine), jo.init(theirs)
    assert state["m"]["c"].dtype == torch.float32
    for g in grads:
        mine, state, gnorm = o.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, state, mine)
        theirs, jstate, jgnorm = jo.update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, theirs)
        np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=1e-6)
        assert int(state["step"]) == int(jstate["step"])
        for k in params:
            for a, b in ((state["m"][k], jstate["m"][k]),
                         (state["v"][k], jstate["v"][k])):
                np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-5,
                                           atol=1e-9)
            tol = 2.0 ** -7 if k == "c" else 1e-5
            np.testing.assert_allclose(to_np(mine[k]), to_np(theirs[k]),
                                       rtol=tol, atol=1e-9)
        assert mine["c"].dtype == torch.bfloat16
    if schedule == "cosine_clipped":
        assert float(gnorm) > 1.0          # clipping was active


def test_schedule_and_norms_are_the_reference_ones():
    mine = opt.cosine_schedule(3e-4, 10, 100)
    theirs = jopt.cosine_schedule(3e-4, 10, 100)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(float(mine(step)), float(theirs(step)),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(mine(torch.tensor(step))),
                                   float(theirs(step)), rtol=1e-6)
    _, grads = _adamw_inputs(3)
    tree = {k: torch.from_numpy(v) for k, v in grads[0].items()}
    clipped, n = opt.clip_by_global_norm(tree, 2.0)
    jclipped, jn = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in grads[0].items()}, 2.0)
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(opt.global_norm(clipped)), 2.0,
                               rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(to_np(clipped[k]), to_np(jclipped[k]),
                                   rtol=1e-6)


# ------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def reference_train_steps():
    """The reference bundle's jitted train step, once per (activation
    dtype, grad_accum) case, on the same weights and a (4, 24) batch. The
    reference's step calls `lm_loss` with its default bfloat16
    activations; its float32 cases run with `lm_loss`'s default dtype
    patched to float32 while they trace."""
    tree = perturbed_params()
    tokens = np.random.default_rng(5).integers(0, 256, (4, 24)) \
        .astype(np.int32)
    out = {}
    orig = jT.lm_loss
    for dtype, accum in TRAIN_CASES:
        jbundle = jax_build_bundle(ARCH, reduced=True,
                                   override={"grad_accum": accum})
        params = jax.tree.map(jnp.asarray, tree)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jT, "lm_loss",
                       functools.partial(orig, dtype=JNP_DTYPE[dtype]))
            new, state, metrics = jax.jit(jbundle.steps["train"])(
                params, jbundle.optimizer.init(params),
                {"tokens": jnp.asarray(tokens)})
        out[dtype, accum] = (jax.tree.map(np.asarray, new),
                             jax.tree.map(np.asarray, state),
                             {k: float(v) for k, v in metrics.items()})
    return tree, tokens, out


@pytest.mark.parametrize("dtype,accum", TRAIN_CASES)
def test_train_step_matches_the_reference(reference_train_steps, dtype,
                                          accum):
    tree, tokens, ref = reference_train_steps
    jparams, jstate, jmetrics = ref[dtype, accum]
    bundle = build_bundle(ARCH, reduced=True, override={"grad_accum": accum},
                          device="cpu")
    model = port_model(tree, bundle.cfg)
    params = dict(model.named_parameters())
    state = bundle.optimizer.init(params)
    out, state, metrics = bundle.steps["train"](
        model, state, {"tokens": torch.from_numpy(tokens)},
        dtype=TORCH_DTYPE[dtype])
    assert out is model and int(state["step"]) == int(jstate["step"]) == 1
    want_p = lm_params_from_jax(jparams, bundle.cfg)
    want_m = lm_params_from_jax(jstate["m"], bundle.cfg)
    if dtype == "float32":
        rtol = {"loss": 1e-5, "gnorm": 1e-5}
        p_atol, m_atol = 1e-5, lambda m: 1e-5
    else:
        rtol = {"loss": 1e-3, "gnorm": 1e-2}
        p_atol, m_atol = 2 * LR + 1e-6, lambda m: 0.1 * float(m.abs().max())
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(float(metrics[k]), jmetrics[k],
                                   rtol=rtol[k])
    assert sorted(params) == sorted(want_p)
    for k, p in params.items():
        np.testing.assert_allclose(to_np(p), to_np(want_p[k]), atol=p_atol,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(to_np(state["m"][k]), to_np(want_m[k]),
                                   atol=m_atol(want_m[k]), rtol=0, err_msg=k)


def test_train_step_moves_the_model_and_lowers_the_loss():
    """Three steps on one batch (float32): the model's own parameters
    change in place and the loss falls."""
    bundle = build_bundle(ARCH, reduced=True, device="cpu")
    model = bundle.init_fn(0)
    before = model.blocks[0].attn.wq.w.detach().clone()
    state = bundle.optimizer.init(dict(model.named_parameters()))
    batch = bundle.make_inputs("train_4k", seed=1)
    losses = []
    for _ in range(3):
        _, state, metrics = bundle.steps["train"](model, state, batch,
                                                  dtype=torch.float32)
        losses.append(float(metrics["loss"]))
    assert not torch.equal(model.blocks[0].attn.wq.w, before)
    assert losses[2] < losses[0]


# ------------------------------------------------------------- compression
@pytest.mark.parametrize("shape", [(64,), (8, 33)])
def test_int8_compression_matches_the_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    res = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    q, scale = comp.quantize_int8(torch.from_numpy(x))
    jq, jscale = jcomp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_allclose(
        to_np(comp.dequantize_int8(q, scale)),
        to_np(jcomp.dequantize_int8(jq, jscale)), atol=1e-7)
    deq, new_res = comp.ef_compress_update(torch.from_numpy(x),
                                           torch.from_numpy(res))
    jdeq, jres = jcomp.ef_compress_update(jnp.asarray(x), jnp.asarray(res))
    np.testing.assert_allclose(to_np(deq), to_np(jdeq), atol=1e-7)
    np.testing.assert_allclose(to_np(new_res), to_np(jres), atol=1e-7)


# ------------------------------------------------------------- checkpoints
def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "h": torch.linspace(-3, 3, 7).bfloat16()},
            "l": [torch.full((2,), 7.5), torch.tensor(3, dtype=torch.int32)]}


def _assert_same_tree(got, want):
    assert ckpt._flatten(got).keys() == ckpt._flatten(want).keys()
    for k, w in ckpt._flatten(want).items():
        g = ckpt._flatten(got)[k]
        assert g.dtype == w.dtype and torch.equal(g, w), k


def test_checkpoint_roundtrip(tmp_path):
    """Nested dicts and lists, int32 and bfloat16 leaves: bit for bit,
    bfloat16 stored widened with its dtype in the manifest."""
    d = str(tmp_path / "ck")
    tree = _tree()
    path = ckpt.save_checkpoint(d, 7, tree, extra={"next_step": 7})
    assert path.endswith("step_0000000007")
    restored, manifest = ckpt.load_checkpoint(d, _tree(), device="cpu")
    assert manifest["step"] == 7 and manifest["extra"] == {"next_step": 7}
    assert manifest["dtypes"]["b/h"] == "bfloat16"
    assert manifest["keys"] == ["a", "b/c", "b/h", "l/0", "l/1"]
    assert isinstance(restored["l"], list)
    _assert_same_tree(restored, tree)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_checkpoint(d, {"a": torch.zeros(4, 3)})
    with pytest.raises(KeyError, match="missing"):
        ckpt.load_checkpoint(d, {"z": torch.zeros(1)})


def test_checkpoint_keep_k_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(d, {"x": torch.zeros(2)})
    for s in [1, 2, 3, 4, 5]:
        ckpt.save_checkpoint(d, s, {"x": torch.full((2,), float(s))},
                             keep=2)
    assert ckpt.latest_step(d) == 5
    assert sorted(p.name for p in tmp_path.joinpath("ck").iterdir()) == [
        "step_0000000004", "step_0000000005"]
    x, _ = ckpt.load_checkpoint(d, {"x": torch.zeros(2)}, step=4)
    assert torch.equal(x["x"], torch.full((2,), 4.0))


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoint_loads_across_packages(tmp_path, direction):
    """A plain tree (float32 and int32 leaves, a dict and a list) written
    by one package loads in the other, bit for bit, with its manifest."""
    d = str(tmp_path / "ck")
    rng = np.random.default_rng(0)
    plain = {"w": rng.standard_normal((4, 3)).astype(np.float32),
             "opt": {"step": np.array(3, np.int32),
                     "m": [rng.standard_normal(5).astype(np.float32)]}}
    if direction == "port_to_reference":
        ckpt.save_checkpoint(d, 2, jax.tree.map(torch.from_numpy, plain),
                             extra={"next_step": 2})
        got, manifest = jckpt.load_checkpoint(
            d, jax.eval_shape(lambda: jax.tree.map(jnp.asarray, plain)))
        got = jax.tree.map(np.asarray, got)
    else:
        jckpt.save_checkpoint(d, 2, jax.tree.map(jnp.asarray, plain),
                              extra={"next_step": 2})
        got, manifest = ckpt.load_checkpoint(d, jax.tree.map(
            lambda a: torch.zeros_like(torch.from_numpy(a)), plain))
        got = jax.tree.map(lambda t: t.numpy(), got)
    assert manifest["step"] == 2 and manifest["extra"]["next_step"] == 2
    assert jax.tree.structure(got) == jax.tree.structure(plain)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(plain)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_checkpoint_snapshot_is_not_changed_by_later_updates(tmp_path,
                                                             monkeypatch):
    """maybe_save copies the tree before its thread writes: an in-place
    update of a CPU tensor right after the call (the next AdamW step)
    does not reach the checkpoint. The writer is held until the update
    is done."""
    release = threading.Event()
    save = ckpt.save_checkpoint

    def held_save(*args, **kwargs):
        assert release.wait(30)
        return save(*args, **kwargs)

    monkeypatch.setattr(ckpt, "save_checkpoint", held_save)
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), interval_steps=2)
    w = torch.arange(6.0)
    assert not mgr.maybe_save(1, {"w": w})
    assert mgr.maybe_save(2, {"w": w})
    with torch.no_grad():
        w.add_(100.0)
    release.set()
    restored, manifest = mgr.restore_or_none({"w": torch.zeros(6)})
    assert manifest["step"] == 2
    assert torch.equal(restored["w"], torch.arange(6.0))


# ------------------------------------------------------------- supervisor
def _loop(tmp_path, name, **kw):
    return TrainLoop(arch=ARCH, reduced=True, batch=2, seq=32,
                     ckpt_dir=str(tmp_path / name), device="cpu", **kw)


def test_supervisor_replays_after_faults(tmp_path):
    """Faults at steps 5 and 9 with checkpoints every 3 steps: two
    restores into the live model and optimizer (5 replays from step 3; 9
    finds the checkpoint of step 9) end where a fault-free run ends
    (within 1e-4).
    A restore that missed the model's tensors would replay steps on
    weights already trained past them."""
    res = _loop(tmp_path, "sup", n_steps=12, ckpt_every=3).run(
        injector=FaultInjector(fail_at={5, 9}))
    assert res.restarts == 2
    assert [h["step"] for h in res.history] == (
        [0, 1, 2, 3, 4] + [3, 4, 5, 6, 7, 8] + [9, 10, 11])
    losses = [h["loss"] for h in res.history]
    assert all(np.isfinite(losses))
    clean = _loop(tmp_path, "sup2", n_steps=12, ckpt_every=3).run()
    assert clean.restarts == 0 and clean.steps_run == 12
    assert abs(res.history[-1]["loss"] - clean.history[-1]["loss"]) < 1e-4
    for k, p in res.state["params"].items():
        assert torch.allclose(p, clean.state["params"][k], atol=1e-4), k
    # the forced final save resumes a finished run without stepping
    again = _loop(tmp_path, "sup2", n_steps=12, ckpt_every=3).run()
    assert again.steps_run == 0 and ckpt.latest_step(
        str(tmp_path / "sup2")) == 12


class _FakeTime:
    """The supervisor's clock: each reading advances 50 ms and a sleep
    advances it by its seconds, so step times do not depend on the
    host's load."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 0.05
        return self.now

    def sleep(self, seconds):
        self.now += seconds


def test_supervisor_flags_stragglers(tmp_path, monkeypatch):
    """A step more than 4x the trailing mean is flagged; the mean skips
    the first step, so a slow first step (a compile) hides nothing."""
    monkeypatch.setattr(ft, "time", _FakeTime())
    res = _loop(tmp_path, "lag", n_steps=8, ckpt_every=100).run(
        injector=FaultInjector(straggle_at={0: 5.0, 6: 0.8}))
    assert res.stragglers == [6]


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    state = {"w": torch.zeros(2)}

    def step_fn(state, batch):
        raise RuntimeError("always fails")

    sup = ft.Supervisor(str(tmp_path / "dead"), max_restarts=2)
    with pytest.raises(RuntimeError, match="always fails"):
        sup.run(state, step_fn, lambda step: None, 3)


# ------------------------------------------------------------- data, launcher
def test_lm_token_stream_is_the_reference_stream():
    mine = lm_token_stream(256, 3, 10, seed=2, cycle=4, device="cpu")
    theirs = jax_token_stream(256, 3, 10, seed=2, cycle=4)
    for step in (0, 1, 3, 4, 9):
        got = mine(step)["tokens"]
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(theirs(step)["tokens"]))


def test_train_loop_and_stream_run_on_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        lm_token_stream(256, 1, 4)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        TrainLoop(arch=ARCH, n_steps=1).run()


def test_train_main_on_the_cpu(tmp_path, capsys):
    args = ["--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "2", "--device", "cpu"]
    assert launch_train.main(args) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device=cpu steps=3 restarts=0"
    assert out[1].startswith("loss ") and " -> " in out[1]
    assert ckpt.latest_step(str(tmp_path / "ck")) == 3
    # one process is one rank: a larger mesh needs torch.distributed.run
    # (tests/test_torch_distributed.py runs the launcher under it)
    for axes in (["--data-axis", "2"], ["--model-axis", "4"]):
        with pytest.raises(SystemExit, match="torch.distributed.run"):
            launch_train.main(args + axes)
