"""The port's context-parallel prefill attention on the CPU against the
reference: `cp_attention` alone, causal and bidirectional, over 1, 2 and 4
query blocks; the reduced qwen2-1.5b with `cp_degree` 2 through
`lm_forward` against the reference's, with the same weights; and a
sequence that `cp_degree` does not divide, which both sides send to
`flash_attention`.

Tolerances: attention outputs 2e-5 absolute (float32 scores, one
softmax, sums in another order); hidden states and logits 1e-4 absolute,
as tests/test_torch_prefill.py (two layers deep)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import registry as jregistry  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import transformer as jT  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from torch_lm_common import (ARCH, perturbed_params, port_model,  # noqa: E402
                             to_np)

ATTN_ATOL = 2e-5
F32_ATOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    return perturbed_params()


def _qkv(seed, b=2, s=24, n=2, g=3, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, n * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, n, d)).astype(np.float32)
    v = rng.standard_normal((b, s, n, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("mp", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cp_attention_matches_the_reference(causal, mp):
    q, k, v = _qkv(mp + 10 * causal)
    got = attn.cp_attention(*(torch.from_numpy(a) for a in (q, k, v)), mp,
                            causal=causal)
    want = jattn.cp_attention(*(jnp.asarray(a) for a in (q, k, v)), mp,
                              causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(want), atol=ATTN_ATOL)
    # and equal to the flash formulation of the same attention
    flash = attn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal, q_chunk=8, k_chunk=8)
    np.testing.assert_allclose(to_np(got), to_np(flash), atol=ATTN_ATOL)


def test_cp_attention_keeps_the_input_dtype_and_gradients():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(3))
    out = attn.cp_attention(q, k, v, 4)
    out.sum().backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (q, k, v))
    assert attn.cp_attention(q.detach().bfloat16(), k.detach().bfloat16(),
                             v.detach().bfloat16(), 2).dtype \
        == torch.bfloat16


def _forward(model, jparams, cfg, jcfg, tokens, monkeypatch):
    """Both sides' lm_forward on float32, counting the port's and the
    reference's cp_attention calls."""
    calls = {"port": 0, "reference": 0}

    def counted(side, fn):
        def wrapped(*a, **kw):
            calls[side] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(attn, "cp_attention",
                        counted("port", attn.cp_attention))
    monkeypatch.setattr(jattn, "cp_attention",
                        counted("reference", jattn.cp_attention))
    with torch.no_grad():
        h, _ = T.lm_forward(model, torch.from_numpy(tokens),
                            dtype=torch.float32)
    jh, _ = jT.lm_forward(jparams, jnp.asarray(tokens), jcfg,
                          dtype=jnp.float32)
    return h, jh, calls


@pytest.mark.parametrize("cp,seq,routed", [(2, 40, True), (3, 40, False)],
                         ids=["cp2-divides", "cp3-does-not"])
def test_reduced_lm_with_cp_degree_matches_the_reference(weights, cp, seq,
                                                         routed, monkeypatch):
    """The reduced qwen2 with cp_degree replaced on both sides: hidden
    states and last logits against the reference's; cp_attention runs in
    every layer of both when cp divides S, else neither runs it
    (flash_attention) and the port's hidden states equal its cp_degree=0
    run bit for bit."""
    cfg = dataclasses.replace(registry.get_config(ARCH, reduced=True),
                              cp_degree=cp)
    jcfg = dataclasses.replace(jregistry.get_config(ARCH, reduced=True),
                               cp_degree=cp)
    model = port_model(weights, cfg)
    jparams = jax.tree.map(jnp.asarray, weights)
    tokens = np.random.default_rng(cp).integers(
        0, cfg.vocab, (2, seq)).astype(np.int32)
    h, jh, calls = _forward(model, jparams, cfg, jcfg, tokens, monkeypatch)
    # the reference scans its layers, so it traces cp_attention once
    assert calls == {"port": cfg.n_layers if routed else 0,
                     "reference": int(routed)}
    np.testing.assert_allclose(to_np(h), to_np(jh), atol=F32_ATOL)
    with torch.no_grad():
        logits = T.lm_prefill_logits(model, torch.from_numpy(tokens),
                                     dtype=torch.float32)
    jlogits = jT.lm_prefill_logits(jparams, jnp.asarray(tokens), jcfg,
                                   dtype=jnp.float32)
    np.testing.assert_allclose(to_np(logits), to_np(jlogits), atol=F32_ATOL)
    if not routed:
        plain = port_model(weights, dataclasses.replace(cfg, cp_degree=0))
        with torch.no_grad():
            h0, _ = T.lm_forward(plain, torch.from_numpy(tokens),
                                 dtype=torch.float32)
        assert torch.equal(h, h0)
