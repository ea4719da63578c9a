"""The port's qwen2-1.5b decode path on the CPU against the reference:
configs, NN primitives, one GQA decode step and four LM decode steps on
the same weights (moved across by `lm_params_from_jax`), the bundle's
inputs and FLOPs for every shape, and the serving launcher (prefill and
training: tests/test_torch_prefill.py, tests/test_torch_train.py).

Tolerances: float32 1e-4 absolute (sums in another order, through a few
layers); bfloat16 logits 5e-2 absolute (each side rounds its activations
to bfloat16 after every op, at other places; the logits here are of order
0.1-1, where one bfloat16 step is 2^-8 to 2^-4 of that)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import LM_SHAPES as JAX_LM_SHAPES  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.models.api import build_bundle as jax_build_bundle  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import core as jcore  # noqa: E402
from repro.nn import transformer as jT  # noqa: E402
from repro_torch.config import LM_SHAPES  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.api import build_bundle  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn import core  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from torch_lm_common import perturbed_params as _perturbed_params  # noqa: E402
from torch_lm_common import to_np as _np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-1.5b"
F32_ATOL = 1e-4
BF16_LOGITS_ATOL = 5e-2
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JNP_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(scope="module")
def weights():
    cfg = registry.get_config(ARCH, reduced=True)
    tree = _perturbed_params()
    model = T.lm_init(cfg, seed=0, device="cpu")
    model.load_state_dict(lm_params_from_jax(tree, cfg), strict=True)
    return cfg, tree, model


def _random_caches(cfg, batch, max_len, dtype, seed):
    """The same random cache contents for both packages (a filled context
    makes every attended position count)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    vals = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    port = {n: torch.from_numpy(a).to(TORCH_DTYPE[dtype])
            for n, a in vals.items()}
    ref = {n: jnp.asarray(a).astype(JNP_DTYPE[dtype])
           for n, a in vals.items()}
    return port, ref


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("reduced", [False, True])
def test_config_is_the_reference_config(reduced):
    mine = registry.get_config(ARCH, reduced=reduced)
    theirs = jregistry.get_config(ARCH, reduced=reduced)
    # the port keeps the fields that its LM paths and n_params read
    ours = dataclasses.asdict(mine)
    assert ours == {n: v for n, v in dataclasses.asdict(theirs).items()
                    if n in ours}
    assert mine.n_params() == theirs.n_params()
    assert mine.n_active_params() == theirs.n_active_params()
    assert LM_SHAPES == JAX_LM_SHAPES


def test_unported_arch_and_blocks_name_the_roadmap():
    """The registry holds the reference's ten ids (its five LM ids among
    them), with its order and shapes; an unknown id raises the reference's
    KeyError; context-parallel attention (cp_degree > 0), once the port's
    last unported block, now builds, its GQA layers routed to
    `cp_attention` (tests/test_torch_cp_attention.py holds it against the
    reference)."""
    lm_ids = [a for a in jregistry.arch_ids()
              if jregistry.get_config(a).family == "lm"]
    assert list(registry.ARCHS) == registry.arch_ids() \
        == jregistry.arch_ids()
    assert len(lm_ids) == 5
    for arch in lm_ids:
        assert registry.shapes_for(arch) == jregistry.shapes_for(arch)
        for reduced in (False, True):
            assert registry.get_config(arch, reduced=reduced).name \
                == jregistry.get_config(arch, reduced=reduced).name
    for call in (registry.get_config, registry.shapes_for):
        with pytest.raises(KeyError, match="unknown arch 'llama-9'"):
            call("llama-9")
    cfg = registry.get_config(ARCH, reduced=True)
    model = T.lm_init(dataclasses.replace(cfg, cp_degree=2), device="cpu")
    assert model.cfg.cp_degree == 2
    assert len(model.blocks) == cfg.n_layers


# ------------------------------------------------------------- primitives
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_primitives_match_the_reference(dtype):
    """rmsnorm (normalise in float32, cast, then scale), interleaved rotary,
    dense with its bias, SwiGLU and the embedding gather."""
    rng = np.random.default_rng(7)
    gen = torch.Generator().manual_seed(0)
    tol = F32_ATOL if dtype == "float32" else 2e-2
    td, jd = TORCH_DTYPE[dtype], JNP_DTYPE[dtype]
    x = rng.standard_normal((3, 2, 4, 16)).astype(np.float32)
    xt, xj = torch.from_numpy(x).to(td), jnp.asarray(x).astype(jd)

    norm = core.RMSNorm(16, device="cpu")
    with torch.no_grad():             # the parameters are trainable
        norm.g.copy_(torch.from_numpy(rng.standard_normal(16)
                                      .astype(np.float32)))
    np.testing.assert_allclose(
        _np(core.rmsnorm(norm, xt)),
        _np(jcore.rmsnorm({"g": jnp.asarray(_np(norm.g))}, xj)),
        atol=tol, rtol=tol)

    pos = rng.integers(0, 300, (3, 2))
    cos, sin, rot = core.rope_angles(16, torch.from_numpy(pos))
    jcos, jsin, jrot = jcore.rope_angles(16, jnp.asarray(pos))
    assert rot == jrot == 16
    np.testing.assert_allclose(_np(cos), _np(jcos), atol=F32_ATOL)
    np.testing.assert_allclose(
        _np(core.apply_rope(xt, cos, sin, rot)),
        _np(jcore.apply_rope(xj, jcos, jsin, jrot)), atol=tol, rtol=tol)

    ffn = core.SwiGLU(16, 24, gen=gen, device="cpu")
    with torch.no_grad():
        ffn.wi.w.add_(0.1)            # break the symmetry between wi and wg
    jffn = {n: {"w": jnp.asarray(_np(getattr(ffn, n).w))}
            for n in ("wi", "wg", "wo")}
    np.testing.assert_allclose(_np(core.swiglu(ffn, xt)),
                               _np(jcore.swiglu(jffn, xj)), atol=tol,
                               rtol=tol)
    lin = core.Dense(16, 8, bias=True, gen=gen, device="cpu")
    with torch.no_grad():
        lin.b.copy_(torch.arange(8, dtype=torch.float32) / 8)
    np.testing.assert_allclose(
        _np(core.dense(lin, xt)),
        _np(jcore.dense({"w": jnp.asarray(_np(lin.w)),
                         "b": jnp.asarray(_np(lin.b))}, xj)),
        atol=tol, rtol=tol)

    emb = core.Embedding(11, 16, gen=gen, device="cpu")
    ids = rng.integers(0, 11, (3, 1)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(core.embed(emb, torch.from_numpy(ids), dtype=td)),
        _np(jcore.embed({"table": jnp.asarray(_np(emb.table))},
                        jnp.asarray(ids), dtype=jd)))


# ------------------------------------------------------------- attention
def test_gqa_decode_matches_the_reference(weights):
    """One layer's decode step, float32, against the reference with its
    Pallas kernel (interpreted): the output and the whole new cache."""
    cfg, tree, model = weights
    layer = 1
    jp = jax.tree.map(lambda a: jnp.asarray(a[layer]), tree["blocks"]["attn"])
    rng = np.random.default_rng(3)
    b, s = 3, 24
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    lengths = np.array([0, 11, s - 1], np.int32)
    caches, jcaches = _random_caches(cfg, b, s, "float32", seed=4)
    k, v = caches["k"][layer], caches["v"][layer]
    y = model.blocks[layer].attn.decode(torch.from_numpy(x), k, v,
                                        torch.from_numpy(lengths))
    jy, jcache = jattn.gqa_decode(
        jp, jnp.asarray(x), {"k": jcaches["k"][layer],
                             "v": jcaches["v"][layer]},
        jnp.asarray(lengths), n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, use_pallas=True)
    np.testing.assert_allclose(_np(y), _np(jy), atol=F32_ATOL)
    np.testing.assert_allclose(_np(k), _np(jcache["k"]), atol=F32_ATOL)
    np.testing.assert_allclose(_np(v), _np(jcache["v"]), atol=F32_ATOL)


def test_init_kv_cache_is_the_reference_cache():
    port = attn.init_kv_cache(2, 5, 2, 16, device="cpu")
    ref = jattn.init_kv_cache(2, 5, 2, 16)
    for n in ("k", "v"):
        assert port[n].dtype == torch.bfloat16
        assert tuple(port[n].shape) == ref[n].shape and not port[n].any()


# ------------------------------------------------------------- LM step
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_decode_steps_match_the_reference(weights, dtype):
    """Four greedy decode steps of the reduced qwen2-1.5b on the same
    weights and caches, with ragged lengths, against the reference with its
    Pallas kernel. float32: logits and caches within 1e-4 and the same
    greedy tokens; bfloat16: logits within 5e-2 with the same tokens fed to
    both (near-ties may pick other tokens)."""
    cfg, tree, model = weights
    b, s = 3, 16
    jparams = jax.tree.map(jnp.asarray, tree)
    jcfg = jregistry.get_config(ARCH, reduced=True)
    step = jax.jit(lambda p, t, c, n: jT.lm_decode_step(
        p, t, c, n, jcfg, dtype=JNP_DTYPE[dtype], use_pallas=True))
    caches, jcaches = _random_caches(cfg, b, s, dtype, seed=9)
    lengths = np.array([0, 5, 9], np.int32)
    token = np.array([3, 200, 77], np.int32)
    for _ in range(4):
        logits, caches = T.lm_decode_step(
            model, torch.from_numpy(token), caches,
            torch.from_numpy(lengths), dtype=TORCH_DTYPE[dtype])
        jlogits, jcaches = step(jparams, jnp.asarray(token), jcaches,
                                jnp.asarray(lengths))
        assert logits.dtype == TORCH_DTYPE[dtype]
        assert logits.shape == (b, cfg.vocab)
        if dtype == "float32":
            np.testing.assert_allclose(_np(logits), _np(jlogits),
                                       atol=F32_ATOL)
            for n in ("k", "v"):
                np.testing.assert_allclose(_np(caches[n]), _np(jcaches[n]),
                                           atol=F32_ATOL)
            mine = torch.argmax(logits, -1).numpy()
            np.testing.assert_array_equal(mine,
                                          np.asarray(jnp.argmax(jlogits, -1)))
        else:
            np.testing.assert_allclose(_np(logits), _np(jlogits),
                                       atol=BF16_LOGITS_ATOL)
        token = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
        lengths = lengths + 1


def test_converter_rejects_a_wrong_layer_count(weights):
    cfg, tree, _ = weights
    with pytest.raises(ValueError, match="stacked layers"):
        lm_params_from_jax(tree, dataclasses.replace(cfg, n_layers=3))


def test_caches_are_stacked_as_the_reference_stacks_them():
    cfg = registry.get_config(ARCH, reduced=True)
    port = T.lm_init_caches(cfg, 2, 7, dtype=torch.float32, device="cpu")
    ref = jT.lm_init_caches(jregistry.get_config(ARCH, reduced=True), 2, 7,
                            dtype=jnp.float32)
    for n in ("k", "v"):
        assert tuple(port[n].shape) == ref[n].shape
        assert port[n].is_contiguous() and port[n][1].is_contiguous()


# ------------------------------------------------------------- bundle
def _same_inputs_and_flops(bundle, jbundle, shape_id):
    mine = bundle.make_inputs(shape_id, seed=3)
    theirs = jbundle.make_inputs(shape_id, seed=3)
    specs = bundle.input_specs(shape_id)
    assert sorted(specs) == sorted(mine) == sorted(theirs) \
        == sorted(jbundle.input_specs(shape_id))
    for n, (shape, dtype) in specs.items():
        np.testing.assert_array_equal(mine[n].numpy(), np.asarray(theirs[n]))
        assert (shape, dtype) == (theirs[n].shape, torch.int32)
        assert shape == jbundle.input_specs(shape_id)[n].shape
    assert bundle.model_flops(shape_id) == jbundle.model_flops(shape_id)


def test_bundle_inputs_and_flops_are_the_reference_ones():
    bundle = build_bundle(ARCH, reduced=True, device="cpu")
    jbundle = jax_build_bundle(ARCH, reduced=True)
    for shape_id in LM_SHAPES:
        _same_inputs_and_flops(bundle, jbundle, shape_id)
    cut = bundle.make_inputs("decode_32k", batch=5)
    assert cut["lengths"].shape == (5,)
    assert bundle.make_inputs("train_4k", batch=3)["tokens"].shape == (3, 128)


@pytest.mark.parametrize("shape_id", ["train_4k", "prefill_32k"])
def test_train_and_prefill_shapes_are_the_reference_ones(shape_id):
    """At full width: the shape's (B, S) tokens, the same draws, and the
    reference's model FLOPs (6·N·B·S for train, 2·N·B·S for prefill)."""
    bundle = build_bundle(ARCH, device="cpu")
    jbundle = jax_build_bundle(ARCH)
    _same_inputs_and_flops(bundle, jbundle, shape_id)
    spec = LM_SHAPES[shape_id]
    assert bundle.input_specs(shape_id) == {"tokens": (
        (spec["global_batch"], spec["seq_len"]), torch.int32)}


def test_bundle_runs_on_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        build_bundle(ARCH, reduced=True)
    assert build_bundle(ARCH, reduced=True, device="cpu").device.type == "cpu"


# ------------------------------------------------------------- serving
def test_decode_loop_on_the_cpu():
    bundle = build_bundle(ARCH, reduced=True, device="cpu")
    model = bundle.init_fn(0, dtype=torch.bfloat16)
    launches = fd.flash_decode.launches
    res = serve.decode_loop(bundle, model, batch=2, tokens=3)
    assert fd.flash_decode.launches == launches   # no kernel on the CPU
    assert res["tokens"].shape == (3, 2)
    assert ((res["tokens"] >= 0) & (res["tokens"] < bundle.cfg.vocab)).all()
    assert res["tokens_per_s"] > 0


def test_serve_main_runs_on_the_cpu(capsys):
    assert serve.main(["--tokens", "2", "--batch", "2",
                       "--device", "cpu"]) == 0
    assert "decoded 2 tokens × batch 2 on cpu" in capsys.readouterr().out
    # --arch match serves through the same launcher (tests/
    # test_torch_launch_match.py holds its counts)
    assert serve.main(["--arch", "match", "--device", "cpu",
                       "--n-queries", "2", "--scale", "0.03"]) == 0
    assert "served 2 queries" in capsys.readouterr().out


def test_lm_path_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, tempfile\n"
        "from repro_torch.launch import serve, train\n"
        "from repro_torch.train import trainer\n"
        "from repro_torch.runtime import ft\n"
        "assert serve.main(['--tokens', '1', '--batch', '1', "
        "'--device', 'cpu']) == 0\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    assert train.main(['--steps', '2', '--batch', '2', '--seq', "
        "'16', '--ckpt-dir', d, '--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_cuda_decode_step_matches_the_plain_attention():
    """The reduced model on the card: the kernel's step against the same
    step with the plain attention, float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100 via chip_smoke.py)")
    bundle = build_bundle(ARCH, reduced=True, device="cuda")
    model = bundle.init_fn(0)
    inputs = bundle.make_inputs("decode_32k", seed=0)
    b = inputs["token"].shape[0]
    caches = bundle.init_caches(b, 128, dtype=torch.float32)
    fd.reset_launches()
    got, _ = bundle.steps["decode"](model, caches, inputs,
                                    dtype=torch.float32)
    assert fd.flash_decode.launches == bundle.cfg.n_layers
    want, _ = bundle.steps["decode"](model, caches, inputs,
                                     dtype=torch.float32, use_kernel=False)
    torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=F32_ATOL)
