"""The port's LM prefill path on the CPU against the reference:
`flash_attention` forward and gradients, one layer's `GQA.forward`,
`lm_forward` / `lm_prefill_logits` / the bundle's prefill step, and
`lm_loss` with its parameter gradients, on the reduced qwen2-1.5b with
the same weights (moved across by `lm_params_from_jax`) and
numpy-seeded inputs; plus prefill logits against the decode path's.

Tolerances:
- float32 attention outputs and gradients: 1e-5 absolute (values of
  order 1; the two sides sum the blocks' products in another order);
- float32 hidden states and logits: 1e-4 absolute, as the decode tests
  (two layers deep);
- bfloat16 logits: 5e-2 absolute, as the decode tests; bfloat16 hidden
  states: 0.1 absolute (values up to ~5, where one bfloat16 step is
  1/32, and each side rounds after every op at other places);
- float32 loss 1e-5 relative; each gradient leaf within 1e-5 of the
  leaf's largest magnitude.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import registry as jregistry  # noqa: E402
from repro.models.api import build_bundle as jax_build_bundle  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import transformer as jT  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models.api import build_bundle  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from torch_lm_common import (ARCH, JNP_DTYPE, TORCH_DTYPE,  # noqa: E402
                             perturbed_params, port_grads, port_model, to_np)

ATTN_ATOL = 1e-5
F32_ATOL = 1e-4
BF16_HIDDEN_ATOL = 0.1
BF16_LOGITS_ATOL = 5e-2
F32_RTOL = 1e-5
Q_CHUNK, K_CHUNK = 16, 32          # the reduced config's chunks


@pytest.fixture(scope="module")
def weights():
    cfg = registry.get_config(ARCH, reduced=True)
    tree = perturbed_params()
    return cfg, tree, port_model(tree, cfg), jax.tree.map(jnp.asarray, tree)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("causal,group,seq,chunks", [
    (True, 1, 37, (Q_CHUNK, K_CHUNK)), (True, 2, 37, (Q_CHUNK, K_CHUNK)),
    (True, 4, 37, (Q_CHUNK, K_CHUNK)), (False, 1, 37, (Q_CHUNK, K_CHUNK)),
    (False, 2, 37, (Q_CHUNK, K_CHUNK)), (False, 4, 37, (Q_CHUNK, K_CHUNK)),
    (True, 2, 64, (Q_CHUNK, K_CHUNK)), (True, 2, 37, (K_CHUNK, Q_CHUNK))])
def test_flash_attention_matches_the_reference(causal, group, seq, chunks):
    """Output and the gradients of sum(out · w) with respect to q, k and
    v, against the reference with jax.grad; S = 37 is a multiple of
    neither chunk (padded keys and queries), S = 64 of both; query blocks
    longer than key blocks put key blocks inside a query block's rows,
    where the causal sweep must stop at the block past its last row."""
    rng = np.random.default_rng(group * 100 + seq)
    b, n, d = 2, 2, 16
    q = rng.standard_normal((b, seq, n * group, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, seq, n, d)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, q_chunk=chunks[0], k_chunk=chunks[1])

    def jloss(q, k, v):
        return (jattn.flash_attention(q, k, v, **kw) * w).sum()

    jargs = tuple(jnp.asarray(a) for a in (q, k, v))
    want = jattn.flash_attention(*jargs, **kw)
    want_grads = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    targs = tuple(torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = attn.flash_attention(*targs, **kw)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(want), atol=ATTN_ATOL)
    for t, g in zip(targs, want_grads):
        np.testing.assert_allclose(to_np(t.grad), to_np(g), atol=ATTN_ATOL)


def test_flash_attention_keeps_the_input_dtype():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 20, 4, 16))
                         .astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((1, 20, 2, 16))
                         .astype(np.float32)).bfloat16()
    out = attn.flash_attention(q, k, k, q_chunk=8, k_chunk=8)
    want = jattn.flash_attention(*(jnp.asarray(to_np(t)).astype(jnp.bfloat16)
                                   for t in (q, k, k)), q_chunk=8, k_chunk=8)
    assert out.dtype == torch.bfloat16
    # both round one float32 result to bfloat16
    np.testing.assert_allclose(to_np(out), to_np(want), atol=1e-2)


def test_masked_key_blocks_change_nothing():
    """The causal sweep skips key blocks wholly above the diagonal. Such a
    block, after key block 0 has given every row a finite running max,
    leaves the running max, sum and accumulator bit for bit as they
    were."""
    gen = torch.Generator().manual_seed(0)
    q, k0, k1, v0, v1 = (torch.randn(shape, generator=gen) for shape in (
        (1, 2, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16),
        (1, 2, 8, 16)))
    m = torch.full((1, 2, 2, 8), attn._NEG)
    state = attn._flash_block(q, k0, v0, m, torch.zeros_like(m),
                              torch.zeros(1, 2, 2, 8, 16), None)
    after = attn._flash_block(q, k1, v1, *state,
                              torch.zeros(8, 8, dtype=torch.bool))
    for a, b in zip(state, after):
        assert torch.equal(a, b)


def test_gqa_forward_matches_the_reference_gqa_attention(weights):
    """One layer's projections, rotary at positions 0..S-1, causal flash
    attention and the output projection, float32."""
    cfg, tree, model, _ = weights
    layer = 1
    jp = jax.tree.map(lambda a: jnp.asarray(a[layer]), tree["blocks"]["attn"])
    x = np.random.default_rng(2).standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        got = model.blocks[layer].attn(torch.from_numpy(x), q_chunk=Q_CHUNK,
                                       k_chunk=K_CHUNK)
    want = jattn.gqa_attention(jp, jnp.asarray(x), n_heads=cfg.n_heads,
                               n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                               q_chunk=Q_CHUNK, k_chunk=K_CHUNK)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=F32_ATOL)


# ------------------------------------------------------------- LM
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_and_prefill_match_the_reference(weights, dtype):
    """Hidden states of every position, the aux term, and the last
    position's logits through `lm_prefill_logits` and the bundle's
    prefill step (B 3, S 45: three query blocks, two key blocks)."""
    cfg, _, model, jparams = weights
    jcfg = jregistry.get_config(ARCH, reduced=True)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab, (3, 45)).astype(np.int32)
    td, jd = TORCH_DTYPE[dtype], JNP_DTYPE[dtype]
    with torch.no_grad():
        h, aux = T.lm_forward(model, torch.from_numpy(tokens), dtype=td)
    jh, jaux = jT.lm_forward(jparams, jnp.asarray(tokens), jcfg, dtype=jd)
    assert h.dtype == td and h.shape == (3, 45, cfg.d_model)
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
    h_tol = F32_ATOL if dtype == "float32" else BF16_HIDDEN_ATOL
    np.testing.assert_allclose(to_np(h), to_np(jh), atol=h_tol)

    bundle = build_bundle(ARCH, reduced=True, device="cpu")
    want = jT.lm_prefill_logits(jparams, jnp.asarray(tokens), jcfg, dtype=jd)
    tol = F32_ATOL if dtype == "float32" else BF16_LOGITS_ATOL
    for got in (T.lm_prefill_logits(model, torch.from_numpy(tokens),
                                    dtype=td),
                bundle.steps["prefill"](
                    model, {"tokens": torch.from_numpy(tokens)}, dtype=td)):
        assert got.shape == (3, 1, cfg.vocab) and got.dtype == td
        assert not got.requires_grad
        np.testing.assert_allclose(to_np(got), to_np(want), atol=tol)


def test_bundle_prefill_step_is_the_reference_step(weights):
    """The reduced prefill_32k shape through both bundles' steps, with
    their default bfloat16 activations."""
    _, _, model, jparams = weights
    bundle = build_bundle(ARCH, reduced=True, device="cpu")
    jbundle = jax_build_bundle(ARCH, reduced=True)
    got = bundle.steps["prefill"](model, bundle.make_inputs("prefill_32k"))
    want = jax.jit(jbundle.steps["prefill"])(
        jparams, jbundle.make_inputs("prefill_32k"))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(to_np(got), to_np(want),
                               atol=BF16_LOGITS_ATOL)


def test_lm_loss_and_gradients_match_the_reference(weights):
    """float32, loss_chunk 8 against 29 target positions (four chunks,
    the last one short): the loss, nll, aux and every parameter's
    gradient."""
    cfg, tree, _, jparams = weights
    cfg8 = dataclasses.replace(cfg, loss_chunk=8)
    jcfg8 = dataclasses.replace(jregistry.get_config(ARCH, reduced=True),
                                loss_chunk=8)
    model = port_model(tree, cfg8)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 30)).astype(np.int32)
    loss, metrics = T.lm_loss(model, torch.from_numpy(tokens),
                              dtype=torch.float32)
    loss.backward()
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jT.lm_loss(p, jnp.asarray(tokens), jcfg8,
                             dtype=jnp.float32), has_aux=True)(jparams)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=F32_RTOL)
    np.testing.assert_allclose(float(metrics["nll"]), float(jmetrics["nll"]),
                               rtol=F32_RTOL)
    assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0
    want = port_grads(jgrads, cfg8)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(to_np(g), want[k],
                                   atol=F32_RTOL * scale, err_msg=k)


def test_prefill_logits_equal_the_decode_logits(weights):
    """Prefill over a prefix and the same tokens fed one by one through
    `lm_decode_step` with a float32 cache give the same last logits
    (float32, 1e-4)."""
    cfg, _, model, _ = weights
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 21)).astype(np.int32))
    prefill = T.lm_prefill_logits(model, tokens, dtype=torch.float32)
    caches = T.lm_init_caches(cfg, 2, 24, dtype=torch.float32, device="cpu")
    lengths = torch.zeros(2, dtype=torch.int32)
    for t in range(tokens.shape[1]):
        logits, caches = T.lm_decode_step(model, tokens[:, t], caches,
                                          lengths, dtype=torch.float32)
        lengths = lengths + 1
    np.testing.assert_allclose(to_np(prefill[:, 0]), to_np(logits),
                               atol=F32_ATOL)
