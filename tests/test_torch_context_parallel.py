"""The port's context-parallel decode on the CPU against the reference:
the plain partials of a cache block (`flash_decode_partials` on CPU
tensors) against the reference's `_local_partials` shard by shard, and
`sharded_decode_attention` over 1-8 CPU lanes against the reference's
`flash_decode_ref` and its own `sharded_decode_attention` on a one-device
mesh. The CUDA entries (the partials and merge kernels) run only on the
card (the `cuda` marker).

Tolerance: 2e-5 absolute in float32, the reference's own
(tests/test_context_parallel.py): both sides sum in float32, in another
order. bfloat16 outputs: one bfloat16 step, a relative 2**-7 (both sides
round the same float32 sum once, and may land either side of a rounding
midpoint).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.distributed import context_parallel as jcp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.distributed.context_parallel import (  # noqa: E402
    lane_blocks, sharded_decode_attention)
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import EnumMesh  # noqa: E402

ATOL = 2e-5
# one bfloat16 step (8 significant bits) of the larger value: both sides
# sum in float32 and round once to bfloat16
BF16_RTOL = 2.0 ** -7
CPU = torch.device("cpu")
# the reference test's shapes: (B, H, D), (B, S, Hkv, D), lengths
SHAPES = {"b2s32": ((2, 4, 16), (2, 32, 2, 16), [7, 30]),
          "b3s64": ((3, 6, 8), (3, 64, 2, 8), [5, 33, 64])}


def _inputs(name, seed=0):
    """numpy q, k, v, lengths of a named shape."""
    q_shape, kv_shape, lens = SHAPES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(q_shape).astype(np.float32)
    k = rng.standard_normal(kv_shape).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _lanes(n):
    return EnumMesh((CPU,) * n)


# ------------------------------------------------------------ partials
@pytest.mark.parametrize("offset", [0, 4, 7, 8, 16, 24])
def test_plain_partials_equal_the_reference_local_partials(offset):
    """One 8-position block at `offset` of the (2, 32) cache, lengths 7 and
    30: a block inside row 0's length (0), across it (4), starting at it
    (7) and past it (8, 16, 24), and row 1's last partial block (24). The
    port's empty partial carries m = -inf where the reference's carries
    -1e30; both have l = 0 and acc = 0."""
    q, k, v, lens = _inputs("b2s32")
    s_loc = 8
    kb, vb = k[:, offset:offset + s_loc], v[:, offset:offset + s_loc]
    qt, kt, vt, lt = _torch(q, k, v, lens)
    for got in (ref.flash_decode_partials_ref(qt, kt[:, offset:offset
                                                     + s_loc],
                                              vt[:, offset:offset + s_loc],
                                              lt, offset),
                fd.flash_decode_partials(qt, kt[:, offset:offset + s_loc],
                                         vt[:, offset:offset + s_loc], lt,
                                         offset)):
        m, l, o = jcp._local_partials(jnp.asarray(q), jnp.asarray(kb),
                                      jnp.asarray(vb), jnp.asarray(lens),
                                      offset, 1.0 / math.sqrt(q.shape[-1]))
        d = q.shape[-1]
        assert got.shape == (2, 4, d + 2) and got.dtype == torch.float32
        got_m = got[..., d].numpy()
        empty = np.asarray(l) == 0
        assert np.array_equal(np.isinf(got_m), empty)
        assert (got_m[empty] < 0).all() and (np.asarray(m)[empty]
                                             == -1e30).all()
        np.testing.assert_allclose(np.where(empty, -1e30, got_m),
                                   np.asarray(m), atol=ATOL)
        np.testing.assert_allclose(got[..., d + 1].numpy(), np.asarray(l),
                                   atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(got[..., :d].numpy(), np.asarray(o),
                                   atol=ATOL, rtol=ATOL)


def test_plain_merge_of_every_block_is_decode_attention():
    """Partials of 4 blocks, merged, equal the oracle; the merge of rows
    all empty gives NaN, as flash_decode does for a row with no
    position."""
    q, k, v, lens = _torch(*_inputs("b3s64", seed=3))
    parts = torch.stack([fd.flash_decode_partials(
        q, k[:, o:o + n], v[:, o:o + n], lens, o)
        for o, n in lane_blocks(64, 4)], dim=2)
    want = jref.flash_decode_ref(*(jnp.asarray(t.numpy())
                                   for t in (q, k, v, lens)))
    np.testing.assert_allclose(fd.flash_decode_merge(parts, torch.float32)
                               .numpy(), np.asarray(want), atol=ATOL)
    past = fd.flash_decode_partials(q, k[:, :8], v[:, :8],
                                    torch.zeros(3, dtype=torch.int32), 0)
    assert torch.isinf(past[..., -2]).all() and (past[..., -1] == 0).all()
    assert (past[..., :-2] == 0).all()
    assert torch.isnan(fd.flash_decode_merge(past[:, :, None],
                                             torch.float32)).all()


@pytest.mark.parametrize("lens", [[1, 5, 64], [64, 64, 64], [0, 0, 0]],
                         ids=["most-empty", "full", "all-empty"])
def test_plain_merge_of_over_1000_blocks_is_decode_attention(lens):
    """The (3, 64) cache cut into 1,030 blocks along a 1,030-position view
    of a longer row (the blocks past S empty by construction: lengths
    count from 0 and cover at most 64 positions), their partials stacked
    and merged: equal to the oracle, and to the reference's
    `sharded_decode_attention` on a one-device mesh where a row holds a
    position. Lengths 1 and 5 leave all blocks but one or two empty;
    length 0 leaves every block empty, so the merge is NaN (the oracle's
    all-masked softmax) and each partial row exactly (0, -inf, 0)."""
    q, k, v, _ = _inputs("b3s64", seed=9)
    lens = np.asarray(lens, np.int32)
    qt, kt, vt, lt = _torch(q, k, v, lens)
    n = 1030
    pad = torch.zeros((3, n - 64, 2, 8))
    kl, vl = torch.cat([kt, pad], 1), torch.cat([vt, pad], 1)
    rows = torch.stack([fd.flash_decode_partials(qt, kl[:, o:o + 1],
                                                 vl[:, o:o + 1], lt, o)
                        for o in range(n)], dim=2)
    assert rows.shape == (3, 6, n, 10)
    assert torch.isinf(rows[:, :, 64:, -2]).all()
    assert (rows[:, :, 64:, -1] == 0).all() and (rows[:, :, 64:, :-2]
                                                 == 0).all()
    got = fd.flash_decode_merge(rows, torch.float32)
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lens))
    want = np.asarray(jref.flash_decode_ref(jq, jk, jv, jl))
    if (lens == 0).all():
        assert torch.isnan(got).all() and np.isnan(want).all()
        return
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    mesh = jax.make_mesh((1,), ("model",))
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jcp.sharded_decode_attention(jq, jk, jv, jl, mesh)),
        atol=ATOL)


# ------------------------------------------------------------ sharded
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(SHAPES))
def test_sharded_decode_over_cpu_lanes_equals_the_reference_oracle(name,
                                                                   lanes):
    q, k, v, lens = _inputs(name, seed=lanes)
    got = sharded_decode_attention(*_torch(q, k, v, lens), _lanes(lanes))
    want = jref.flash_decode_ref(*(jnp.asarray(a) for a in (q, k, v, lens)))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_sharded_decode_equals_the_reference_sharded_decode():
    """The reference's `sharded_decode_attention` on a one-device mesh (the
    reference test's own case) against the port's on 1 and 4 lanes."""
    q, k, v, lens = _inputs("b2s32")
    mesh = jax.make_mesh((1,), ("model",))
    want = jcp.sharded_decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, lens)), mesh)
    for lanes in (1, 4):
        got = sharded_decode_attention(*_torch(q, k, v, lens),
                                       _lanes(lanes))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_per_lane_blocks_equal_the_single_tensor_form():
    """Blocks given as a sequence (uneven, one wholly past every length)
    against the one-tensor form, the reference's `flash_decode_ref` and,
    where lengths are given, the reference's `sharded_decode_attention`
    on a one-device mesh; lengths None too."""
    q, k, v, _ = _inputs("b3s64", seed=5)
    lens = np.asarray([5, 33, 40], np.int32)
    qt, kt, vt, lt = _torch(q, k, v, lens)
    cuts = [0, 3, 30, 41, 64]
    kb = [kt[:, a:b] for a, b in zip(cuts, cuts[1:])]
    vb = [vt[:, a:b] for a, b in zip(cuts, cuts[1:])]
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lens))
    mesh = jax.make_mesh((1,), ("model",))
    for lengths, jlengths in ((lt, jl), (None, None)):
        single = sharded_decode_attention(qt, kt, vt, lengths, _lanes(4))
        blocks = sharded_decode_attention(qt, kb, vb, lengths, _lanes(4))
        wants = [jref.flash_decode_ref(jq, jk, jv, jlengths)]
        if jlengths is not None:
            wants.append(jcp.sharded_decode_attention(jq, jk, jv, jlengths,
                                                      mesh))
        for want in wants:
            np.testing.assert_allclose(blocks.numpy(), np.asarray(want),
                                       atol=ATOL)
            np.testing.assert_allclose(single.numpy(), np.asarray(want),
                                       atol=ATOL)


def test_sharded_decode_in_bfloat16():
    """bfloat16 q and cache, the same bfloat16 values on both sides: the
    output in bfloat16, within one bfloat16 step of the reference's
    `flash_decode_ref` and its `sharded_decode_attention` on a one-device
    mesh."""
    q, k, v, lens = _inputs("b3s64", seed=7)
    qt, kt, vt = (t.bfloat16() for t in _torch(q, k, v))
    got = sharded_decode_attention(qt, kt, vt, torch.from_numpy(lens),
                                   _lanes(4))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    jl = jnp.asarray(lens)
    mesh = jax.make_mesh((1,), ("model",))
    for want in (jref.flash_decode_ref(jq, jk, jv, jl),
                 jcp.sharded_decode_attention(jq, jk, jv, jl, mesh)):
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=BF16_RTOL, atol=ATOL)


def test_lane_blocks_cut_s_evenly():
    assert lane_blocks(32, 4) == [(0, 8), (8, 8), (16, 8), (24, 8)]
    assert lane_blocks(10, 3) == [(0, 3), (3, 3), (6, 4)]
    assert lane_blocks(5, 5) == [(i, 1) for i in range(5)]
    for s, n in ((0, 1), (3, 4), (8, 0)):
        with pytest.raises(ValueError):
            lane_blocks(s, n)


def test_sharded_decode_rejects_what_it_cannot_place():
    q, k, v, lens = _torch(*_inputs("b2s32"))
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="serves only lanes"):
        sharded_decode_attention(q, k, v, lens, EnumMesh((CPU, meta)))
    with pytest.raises(ValueError, match="blocks for"):
        sharded_decode_attention(q, [k], [v], lens, _lanes(2))
    with pytest.raises(ValueError, match="for a lane on"):
        sharded_decode_attention(q, [k[:, :16], k[:, 16:].to(meta)],
                                 [v[:, :16], v[:, 16:]], lens,
                                 EnumMesh((CPU, CPU)))


def test_partials_and_merge_wrappers_check_their_inputs():
    q, k, v, lens = _torch(*_inputs("b2s32"))
    # a view along S is taken; a view along D is not
    fd.flash_decode_partials(q, k[:, 4:9], v[:, 4:9], lens, 4)
    with pytest.raises(ValueError, match="views along S"):
        fd.flash_decode_partials(q[..., :8].contiguous(), k[..., :8],
                                 v[..., :8], lens)
    with pytest.raises(ValueError, match="offset"):
        fd.flash_decode_partials(q, k, v, lens, -1)
    with pytest.raises(ValueError, match="partials"):
        fd.flash_decode_merge(torch.zeros(2, 4, 18), torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fd.flash_decode_merge(torch.zeros(2, 4, 1, 18), torch.float16)
    # the CPU runs the plain versions and launches nothing
    fd.reset_launches()
    fd.flash_decode_merge(torch.zeros(2, 4, 1, 18), torch.float32)
    assert fd.flash_decode_partials.launches == 0
    assert fd.flash_decode_merge.launches == 0


# ------------------------------------------------------------ the card
@pytest.mark.cuda
def test_cuda_partials_merge_and_sharding_match_the_plain_versions():
    """On the card: the partials kernel against its plain version at block
    offsets inside, at and past the lengths, on views of a B > 1 cache,
    in both routes; the merge kernel against its plain version; and
    `sharded_decode_attention` over 1, 2 and 4 lanes of the card against
    `flash_decode`, with no NaN where later lanes are empty."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100 via chip_smoke.py)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, hkv, s, d = 3, 12, 2, 4096, 128
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        lens = torch.tensor([1, 1500, s], dtype=torch.int32, device=dev)
        for off, n in ((0, 1024), (1024, 1024), (1500, 700), (3000, 1096)):
            got = fd.flash_decode_partials(q, k[:, off:off + n],
                                           v[:, off:off + n], lens, off)
            want = ref.flash_decode_partials_ref(q, k[:, off:off + n],
                                                 v[:, off:off + n], lens,
                                                 off)
            torch.cuda.synchronize()
            assert torch.equal(torch.isinf(got[..., -2]),
                               torch.isinf(want[..., -2]))
            fin = torch.isfinite(want[..., -2])
            torch.testing.assert_close(got[fin], want[fin], atol=1e-3,
                                       rtol=1e-4)
            assert (got[~fin][:, -1] == 0).all()
        for lanes in (1, 2, 4):
            for lengths in (lens, torch.full((b,), 700, dtype=torch.int32,
                                             device=dev)):
                got = sharded_decode_attention(q, k, v, lengths,
                                               EnumMesh((dev,) * lanes))
                torch.cuda.synchronize()
                assert bool(torch.isfinite(got).all())
                tol = 1e-5 if dtype == torch.float32 else 2e-2
                torch.testing.assert_close(
                    got.float(), fd.flash_decode(q, k, v, lengths).float(),
                    atol=tol, rtol=tol)
