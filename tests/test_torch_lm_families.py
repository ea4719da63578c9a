"""The port's other four LM architectures on the CPU against the reference:
chatglm3-6b (partial rotary, QKV bias), minicpm3-4b (MLA), qwen3-moe-30b-a3b
and granite-moe-3b-a800m (MoE; untied and tied heads). Each reduced model
runs the reference's weights with seeded noise on the biases and gains
(moved across by `lm_params_from_jax`, strict) through `lm_forward`,
`lm_loss`, `lm_prefill_logits`, 8 `lm_decode_step`s and one
`steps["train"]`; plus unit cases of the partial rotary, `moe_ffn` (groups
that divide S, that do not, decode, padded experts), a built top-k tie,
MLA's absorbed decode against its expanded path, the registry, the
bundle's inputs and FLOPs, and the serving launcher for every LM id.

Tolerances:
- float32 hidden states, logits, aux losses and caches: 1e-4 absolute
  (sums in another order, through two layers);
- float32 loss and gnorm 1e-5 relative; gradients and the parameters
  after a train step 1e-4 absolute;
- bfloat16 logits of the dense architectures: 5e-2 absolute at logits of
  order 1, as tests/test_torch_lm.py holds qwen2-1.5b's (each side rounds
  its activations to bfloat16 at other places), scaled by the largest
  reference logit where it exceeds 1: the untied heads' N(0, 1/d) weights
  give logits up to ~4.5, and a rounding of the hidden state reaches every
  logit in proportion to the head's scale (the 8 decode steps differ by
  up to 0.058 at a largest logit of 3.0 and 4.5: 1-2 % of it);
- bfloat16 MoE: a near-tie of the router may flip between the packages,
  so the expert choices are compared, at least 90 % of the tokens must
  choose the same experts, and the outputs of the tokens whose group
  routed alike up to them are held at 5e-2 (values of order 1).
"""
import ast
import dataclasses
import functools

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
from repro.nn import moe as jmoe  # noqa: E402
from repro.nn import transformer as jT  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.api import build_bundle  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn import core  # noqa: E402
from repro_torch.nn import moe  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from torch_lm_common import (JNP_DTYPE, TORCH_DTYPE,  # noqa: E402
                             perturbed_params, port_grads, port_model, to_np)

FAMILIES = ["chatglm3-6b", "minicpm3-4b", "qwen3-moe-30b-a3b",
            "granite-moe-3b-a800m"]
DENSE = ["chatglm3-6b", "minicpm3-4b"]
MOE = ["qwen3-moe-30b-a3b", "granite-moe-3b-a800m"]
F32_ATOL = 1e-4
F32_RTOL = 1e-5
BF16_LOGITS_ATOL = 5e-2
BF16_MOE_ATOL = 5e-2
MOE_AGREE_MIN = 0.9


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """(cfg, the reference's tree, the reference's config, the port's model
    on the same weights), once per architecture."""
    cfg = registry.get_config(arch, reduced=True)
    tree = perturbed_params(arch=arch)
    return cfg, tree, jregistry.get_config(arch, reduced=True), \
        port_model(tree, cfg)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _caches(cfg, batch, max_len, dtype, seed):
    """The same random cache contents for both packages (a filled context
    makes every attended position count), in the architecture's layout."""
    rng = np.random.default_rng(seed)
    shapes = {n: tuple(t.shape) for n, t in T.lm_init_caches(
        cfg, batch, max_len, dtype=torch.float32, device="meta").items()}
    vals = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    return ({n: torch.from_numpy(a).to(TORCH_DTYPE[dtype])
             for n, a in vals.items()},
            {n: jnp.asarray(a).astype(JNP_DTYPE[dtype])
             for n, a in vals.items()})


# ------------------------------------------------------------- registry
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_config_is_the_reference_config(arch, reduced):
    mine = registry.get_config(arch, reduced=reduced)
    theirs = jregistry.get_config(arch, reduced=reduced)
    ours = dataclasses.asdict(mine)
    assert ours == {n: v for n, v in dataclasses.asdict(theirs).items()
                    if n in ours}
    assert mine.n_params() == theirs.n_params()
    assert mine.n_active_params() == theirs.n_active_params()
    assert registry.shapes_for(arch) == jregistry.shapes_for(arch) \
        == JAX_LM_SHAPES


@pytest.mark.parametrize("arch", FAMILIES)
def test_bundle_inputs_caches_and_flops_are_the_reference_ones(arch):
    """Every shape's inputs (same draws) and model FLOPs at full width
    (MoE counts the top-k experts only), and the decode caches' layout."""
    bundle = build_bundle(arch, device="cpu")
    jbundle = jax_build_bundle(arch)
    for shape_id in JAX_LM_SHAPES:
        mine = bundle.make_inputs(shape_id, seed=3)
        theirs = jbundle.make_inputs(shape_id, seed=3)
        assert sorted(mine) == sorted(theirs)
        for n in mine:
            np.testing.assert_array_equal(mine[n].numpy(),
                                          np.asarray(theirs[n]))
        assert bundle.model_flops(shape_id) == jbundle.model_flops(shape_id)
    cfg = registry.get_config(arch, reduced=True)
    port = T.lm_init_caches(cfg, 2, 7, dtype=torch.float32, device="cpu")
    ref = jT.lm_init_caches(jregistry.get_config(arch, reduced=True), 2, 7,
                            dtype=jnp.float32)
    assert sorted(port) == sorted(ref)
    for n in port:
        assert tuple(port[n].shape) == ref[n].shape and not port[n].any()
        assert port[n][1].is_contiguous()


# ------------------------------------------------------------- rotary
@pytest.mark.parametrize("frac", [1.0, 0.5, 0.3])
def test_partial_rotary_matches_the_reference(frac):
    """rope_angles' rot (int(D·frac) rounded down to even) and its angles
    over rot, and apply_rope rotating [0, rot) and passing the rest."""
    rng = np.random.default_rng(int(frac * 10))
    d = 20
    pos = rng.integers(0, 500, (3, 5))
    x = rng.standard_normal((3, 5, 2, d)).astype(np.float32)
    cos, sin, rot = core.rope_angles(d, torch.from_numpy(pos), frac=frac)
    jcos, jsin, jrot = jcore.rope_angles(d, jnp.asarray(pos), frac=frac)
    assert rot == jrot == {1.0: 20, 0.5: 10, 0.3: 6}[frac]
    np.testing.assert_allclose(to_np(cos), to_np(jcos), atol=F32_ATOL)
    np.testing.assert_allclose(to_np(sin), to_np(jsin), atol=F32_ATOL)
    got = core.apply_rope(torch.from_numpy(x), cos, sin, rot)
    np.testing.assert_allclose(
        to_np(got), to_np(jcore.apply_rope(jnp.asarray(x), jcos, jsin, jrot)),
        atol=F32_ATOL)
    np.testing.assert_array_equal(to_np(got)[..., rot:], x[..., rot:])


# ------------------------------------------------------------- MoE units
def _moe_pair(d, f, e, pad_to, seed):
    gen = torch.Generator().manual_seed(seed)
    m = moe.MoE(d, f, e, pad_to=pad_to, gen=gen, device="cpu")
    jp = {"router": {"w": jnp.asarray(to_np(m.router.w))},
          **{n: jnp.asarray(to_np(getattr(m, n))) for n in ("wi", "wg", "wo")}}
    return m, jp


@pytest.mark.parametrize("case", ["divides", "does_not_divide", "decode",
                                  "padded_decode"])
def test_moe_ffn_matches_the_reference(case):
    """Groups of 16 over S = 48 (three groups), S = 40 (one group of the
    whole sequence), a decode step (S = 1: the batch of 24 rows grouped),
    and a decode step with 12 expert slots for 8 experts (dead slots
    never routed to); float32, output and aux loss."""
    e, k = 8, 2
    pad_to = 12 if case == "padded_decode" else 0
    m, jp = _moe_pair(32, 24, e, pad_to, seed=5)
    assert tuple(m.wi.shape) == (max(pad_to, e), 32, 24)
    shape = {"divides": (2, 48, 32), "does_not_divide": (2, 40, 32)}.get(
        case, (24, 1, 32))
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    y, aux = moe.moe_ffn(m, torch.from_numpy(x), n_experts=e, top_k=k,
                         group_size=16)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), n_experts=e, top_k=k,
                            group_size=16)
    np.testing.assert_allclose(to_np(y), to_np(jy), atol=F32_ATOL)
    np.testing.assert_allclose(float(to_np(aux)), float(jaux), rtol=F32_RTOL)
    assert float(np.abs(to_np(y)).max()) > 0.1


def test_moe_top_k_tie_goes_to_the_lower_expert():
    """A built tie: positive inputs and a router whose column e is c_e
    times all-ones, c = (1, 3, 3, 2, 3, 1, 0.5, 2), so experts 1, 2 and 4
    tie bit for bit at the top for every token, and top-2 must keep 1 and
    2 and drop 4 (jax.lax.top_k's lower index first). The stable top-k
    picks as the reference does, and the MoE's output (the experts' weights
    differ) and aux equal the reference's."""
    e, k, d = 8, 2, 16
    m, _ = _moe_pair(d, 8, e, 0, seed=9)
    c = torch.tensor([1, 3, 3, 2, 3, 1, 0.5, 2], dtype=torch.float32)
    with torch.no_grad():
        m.router.w.copy_(0.1 * c[None, :].expand(d, e))
    jp = {"router": {"w": jnp.asarray(to_np(m.router.w))},
          **{n: jnp.asarray(to_np(getattr(m, n))) for n in ("wi", "wg", "wo")}}
    x = np.abs(np.random.default_rng(10).standard_normal((1, 32, d))) \
        .astype(np.float32)
    probs = torch.softmax(core.dense(m.router, torch.from_numpy(x)), -1)
    assert torch.equal(probs[..., 1], probs[..., 4])
    assert torch.equal(probs[..., 2], probs[..., 4])
    for kk in (1, 2, 3):
        _, idx = moe.stable_top_k(probs, kk)
        _, jidx = jax.lax.top_k(jnp.asarray(to_np(probs)), kk)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert (idx.numpy() == [1, 2, 4][:kk]).all()
    for shape in ((1, 32, d), (32, 1, d)):            # prefill and decode
        xs = x.reshape(shape)
        y, aux = moe.moe_ffn(m, torch.from_numpy(xs), n_experts=e, top_k=k)
        jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(xs), n_experts=e, top_k=k)
        np.testing.assert_allclose(to_np(y), to_np(jy), atol=F32_ATOL)
        np.testing.assert_allclose(float(to_np(aux)), float(jaux), rtol=F32_RTOL)


def _choices(router_w, x, top_k, jax_side):
    """Each token's expert choices as the MoE takes them in x's dtype."""
    if jax_side:
        probs = jax.nn.softmax(jcore.dense({"w": router_w}, x)
                               .astype(jnp.float32), -1)
        return np.asarray(jax.lax.top_k(probs, top_k)[1])
    probs = torch.softmax(core.dense(router_w, x).float(), -1)
    return moe.stable_top_k(probs, top_k)[1].numpy()


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("grouping", ["prefill", "decode"])
def test_moe_bf16_choices_and_outputs(arch, grouping):
    """bfloat16 MoE of layer 0 of the reduced model on seeded inputs: the
    share of tokens choosing the same experts in both packages (at least
    MOE_AGREE_MIN), and the outputs of the tokens whose whole group routed
    alike up to and including them (their capacity ranks are then equal)."""
    cfg, tree, _, model = _weights(arch)
    blk = model.blocks[0].ffn
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"]["ffn"])
    shape = (2, 64, cfg.d_model) if grouping == "prefill" \
        else (32, 1, cfg.d_model)
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    kw = dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k)
    y, _ = moe.moe_ffn(blk, xt, **kw, group_size=cfg.moe_group)
    jy, _ = jax.jit(lambda p, x: jmoe.moe_ffn(
        p, x, **kw, group_size=cfg.moe_group))(jp, xj)
    assert y.dtype == torch.bfloat16 and y.shape == xt.shape
    # (groups, tokens in dispatch order): a row of 64 positions is one
    # group (64 < moe_group); a decode step's 32 rows are one group
    same = (np.sort(_choices(blk.router, xt, cfg.moe_top_k, False), -1)
            == np.sort(_choices(jp["router"]["w"], xj, cfg.moe_top_k, True),
                       -1)).all(-1)
    got, want = to_np(y), to_np(jy)
    if grouping == "decode":
        same, got, want = same.T, got.transpose(1, 0, 2), \
            want.transpose(1, 0, 2)
    share = float(same.mean())
    alike = np.cumprod(same, axis=-1).astype(bool)   # a prefix routed alike
    print(f"{arch} {grouping}: {share:.4f} of the tokens choose alike, "
          f"{alike.mean():.4f} in a prefix routed alike")
    assert share >= MOE_AGREE_MIN
    assert alike.any()
    np.testing.assert_allclose(got[alike], want[alike], atol=BF16_MOE_ATOL)


# ------------------------------------------------------------- MLA units
def test_mla_absorbed_decode_matches_the_expanded_path():
    """The reference's own check, on the port: decode the tokens one by
    one through the absorbed path (latent-space scores, the cache written
    in place) and hold the last output against `MLA.forward` over the
    whole prefix."""
    cfg = registry.get_config("minicpm3-4b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    m = attn.MLA(cfg, gen=gen, device="cpu")
    b, s_ctx = 2, 9
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, s_ctx + 1, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want = m(x, q_chunk=16, k_chunk=16)[:, -1:]
    cache = attn.init_mla_cache(b, s_ctx + 1, cfg.kv_lora_rank,
                                cfg.qk_rope_head_dim, dtype=torch.float32,
                                device="cpu")
    for t in range(s_ctx + 1):
        y = m.decode(x[:, t:t + 1], cache["c_kv"], cache["k_rope"],
                     torch.full((b,), t, dtype=torch.int32))
    np.testing.assert_allclose(to_np(y), to_np(want), atol=2e-4)
    assert cache["c_kv"].abs().min(-1).values.gt(0).all()   # every row set


def test_mla_decode_matches_the_reference():
    """One layer's absorbed decode step, float32, ragged lengths: the
    output and both cache leaves against the reference's new cache."""
    arch = "minicpm3-4b"
    cfg, tree, jcfg, model = _weights(arch)
    layer = 1
    jp = jax.tree.map(lambda a: jnp.asarray(a[layer]), tree["blocks"]["attn"])
    b, s = 3, 24
    x = np.random.default_rng(3).standard_normal((b, 1, cfg.d_model)) \
        .astype(np.float32)
    lengths = np.array([0, 11, s - 1], np.int32)
    caches, jcaches = _caches(cfg, b, s, "float32", seed=4)
    c, kr = caches["c_kv"][layer], caches["k_rope"][layer]
    y = model.blocks[layer].attn.decode(torch.from_numpy(x), c, kr,
                                        torch.from_numpy(lengths))
    jy, jcache = jax.jit(lambda p, x, c, n: jattn.mla_decode(
        p, x, c, n, jcfg))(jp, jnp.asarray(x),
                           {n: jcaches[n][layer] for n in jcaches},
                           jnp.asarray(lengths))
    np.testing.assert_allclose(to_np(y), to_np(jy), atol=F32_ATOL)
    np.testing.assert_allclose(to_np(c), to_np(jcache["c_kv"]), atol=F32_ATOL)
    np.testing.assert_allclose(to_np(kr), to_np(jcache["k_rope"]),
                               atol=F32_ATOL)


# ------------------------------------------------------------- the LMs
def _bf16_logits_agree(logits, jlogits):
    want = to_np(jlogits)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(to_np(logits), want,
                               atol=BF16_LOGITS_ATOL * scale)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_loss_and_prefill_match_the_reference(arch):
    """float32: lm_forward's hidden states and aux (the MoE blocks' summed
    Switch losses), lm_loss with 0.01 · aux, and the prefill logits (an
    untied head on qwen3-moe and chatglm3, minicpm3)."""
    cfg, tree, jcfg, model = _weights(arch)
    params = jax.tree.map(jnp.asarray, tree)
    tok = _tokens(1, (2, 40))
    tt, tj = torch.from_numpy(tok), jnp.asarray(tok)
    f32 = dict(dtype=torch.float32)
    with torch.no_grad():
        h, aux = T.lm_forward(model, tt, **f32)
        loss, metrics = T.lm_loss(model, tt, **f32)
    jh, jaux = jT.lm_forward(params, tj, jcfg, dtype=jnp.float32)
    jloss, jmetrics = jT.lm_loss(params, tj, jcfg, dtype=jnp.float32)
    np.testing.assert_allclose(to_np(h), to_np(jh), atol=F32_ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=F32_ATOL)
    assert (float(aux) > 0) == bool(cfg.moe_experts)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=F32_RTOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=F32_RTOL, atol=1e-7)
    logits = T.lm_prefill_logits(model, tt, **f32)
    jlogits = jT.lm_prefill_logits(params, tj, jcfg, dtype=jnp.float32)
    assert logits.shape == (2, 1, cfg.vocab)
    np.testing.assert_allclose(to_np(logits), to_np(jlogits), atol=F32_ATOL)
    assert (model.head is None) == cfg.tie_embeddings


@pytest.mark.parametrize("arch,dtype",
                         [(a, "float32") for a in FAMILIES]
                         + [(a, "bfloat16") for a in DENSE])
def test_decode_steps_match_the_reference(arch, dtype):
    """8 greedy decode steps of the reduced model on the same weights and
    random caches, ragged lengths, against the reference (its flash_decode
    Pallas kernel interpreted on the GQA models; MLA decode is plain on
    both sides). float32: logits and every cache leaf within 1e-4, the same
    greedy tokens. bfloat16, dense models: logits within 5e-2 with the
    reference's tokens fed to both; MoE models in bfloat16 are held by
    test_moe_bf16_choices_and_outputs."""
    cfg, tree, jcfg, model = _weights(arch)
    b, s = 3, 16
    params = jax.tree.map(jnp.asarray, tree)
    step = jax.jit(lambda p, t, c, n: jT.lm_decode_step(
        p, t, c, n, jcfg, dtype=JNP_DTYPE[dtype], use_pallas=True))
    caches, jcaches = _caches(cfg, b, s, dtype, seed=9)
    lengths = np.array([0, 5, 7], np.int32)
    token = np.array([3, 200, 77], np.int32)
    for _ in range(8):
        logits, caches = T.lm_decode_step(
            model, torch.from_numpy(token), caches,
            torch.from_numpy(lengths), dtype=TORCH_DTYPE[dtype])
        jlogits, jcaches = step(params, jnp.asarray(token), jcaches,
                                jnp.asarray(lengths))
        assert logits.dtype == TORCH_DTYPE[dtype]
        assert logits.shape == (b, cfg.vocab)
        if dtype == "float32":
            np.testing.assert_allclose(to_np(logits), to_np(jlogits),
                                       atol=F32_ATOL)
            for n in jcaches:
                np.testing.assert_allclose(to_np(caches[n]),
                                           to_np(jcaches[n]), atol=F32_ATOL)
            np.testing.assert_array_equal(
                torch.argmax(logits, -1).numpy(),
                np.asarray(jnp.argmax(jlogits, -1)))
        else:
            _bf16_logits_agree(logits, jlogits)
        token = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
        lengths = lengths + 1


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_prefill_logits_match_the_reference(arch):
    cfg, tree, jcfg, model = _weights(arch)
    tok = _tokens(2, (2, 40))
    logits = T.lm_prefill_logits(model, torch.from_numpy(tok))
    jlogits = jT.lm_prefill_logits(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(tok), jcfg)
    assert logits.dtype == torch.bfloat16
    _bf16_logits_agree(logits, jlogits)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_the_reference(arch):
    """float32: the gradients of lm_loss (with 0.01 · aux) and one
    `steps["train"]` from the same weights and a (4, 24) batch: loss and
    gnorm 1e-5 relative, every gradient and parameter leaf within 1e-4."""
    cfg, tree, jcfg, _ = _weights(arch)
    tokens = _tokens(5, (4, 24))
    params = jax.tree.map(jnp.asarray, tree)
    jgrads = jax.jit(jax.grad(lambda p: jT.lm_loss(
        p, jnp.asarray(tokens), jcfg, dtype=jnp.float32)[0]))(params)
    jbundle = jax_build_bundle(arch, reduced=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jT, "lm_loss", functools.partial(jT.lm_loss,
                                                    dtype=jnp.float32))
        jnew, _, jmetrics = jax.jit(jbundle.steps["train"])(
            params, jbundle.optimizer.init(params),
            {"tokens": jnp.asarray(tokens)})
    model = port_model(tree, cfg)
    loss, _ = T.lm_loss(model, torch.from_numpy(tokens), dtype=torch.float32)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    want = port_grads(jgrads, cfg)
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        np.testing.assert_allclose(to_np(g), want[n], atol=F32_ATOL,
                                   err_msg=n)
    bundle = build_bundle(arch, reduced=True, device="cpu")
    p = dict(model.named_parameters())
    _, state, metrics = bundle.steps["train"](
        model, bundle.optimizer.init(p), {"tokens": torch.from_numpy(tokens)},
        dtype=torch.float32)
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=F32_RTOL)
    want_p = lm_params_from_jax(jax.tree.map(np.asarray, jnew), cfg)
    for n, t in p.items():
        np.testing.assert_allclose(to_np(t), to_np(want_p[n]), atol=F32_ATOL,
                                   err_msg=n)


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ["qwen2-1.5b"] + FAMILIES)
def test_serve_main_decodes_every_lm_arch_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--tokens", "3", "--batch", "2",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "decoded 3 tokens × batch 2 on cpu" in out
    sample = ast.literal_eval(out.split("sample:")[1].strip())
    assert len(sample) == 3 and all(0 <= t < 256 for t in sample)
