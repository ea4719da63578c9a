"""The bitmap kernels' word-block width and `autotune_words_per_block`
against the JAX package.

The port compiles one instantiation of each bitmap kernel per width of
`FUSED_TILE_WIDTHS` (32, 64, 128 words a warp reads of a row in one pass);
the reference tiles its Pallas kernels at 8, 16 or 32 words. A width
changes how a row is read, never what is computed. On the CPU each wrapper
takes its plain version, which has no width (AND and popcount are the same
over any blocking of the words); at every port width the wrapper must
equal the reference's jnp oracles and its Pallas kernels in interpret mode
at every reference width. The fused route's counts and `VectorStats`
must equal the reference's `intersect="fused"` run at each forced width
and at the autotuned one. Inputs are numpy arrays from a seed; key
entries are never negative (Pallas in interpret mode clamps a negative
block index to 0, where jnp and the port count it from the end). The
CUDA kernels at each width run only on the card:
`test_torch_autotune_cuda.py`, which imports no JAX.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_reference import port_graph, run_reference, workload  # noqa: E402

from repro.core import bitops as jbitops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bitmap_intersect import (  # noqa: E402
    FUSED_TILE_WIDTHS as JAX_WIDTHS, bitmap_intersect_pallas,
    fused_expand_intersect_pallas)
from repro_torch.api import Dataset, MatchOptions, Matcher  # noqa: E402
from repro_torch.kernels import bitmap_intersect as bi  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

WIDTHS = bi.FUSED_TILE_WIDTHS
WS = (1, 5, 33, 130)
FILLS = ("random", "zeros", "ones")
T, T_IN = 64, 20
MATCHER_WORKLOADS = ("random1", "brother")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _same(got, want):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _tables(rng, k, w, fill):
    """k uint32 tables of 30 + 3 j rows (fixed per (k, W), so the Pallas
    interpreter compiles each shape once for every fill)."""
    out = []
    for j in range(k):
        shape = (30 + 3 * j, w)
        if fill == "random":
            out.append(rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32))
        else:
            out.append(np.full(shape, 0 if fill == "zeros" else 0xFFFFFFFF,
                               np.uint32))
    return out


def _jax_clears(r, pop, cols, clears):
    for c in clears:
        r, was_set = jbitops.clear_bit_rows_count(r, jnp.asarray(cols[:, c]))
        pop = pop - was_set
    return r, pop


def test_widths_are_the_cards_and_the_default_is_the_widest():
    assert WIDTHS == (32, 64, 128)
    assert bi.DEFAULT_WORDS_PER_BLOCK == 128 == max(WIDTHS)
    assert JAX_WIDTHS == (8, 16, 32)
    assert ops.autotune_words_per_block is bi.autotune_words_per_block
    assert "autotune_words_per_block" in ops.__all__


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_bitmap_and_tile_intersect_equal_the_reference_at_every_width(k):
    """bitmap_intersect and tile_intersect (with a same-label clear) at
    every port width against `bitmap_intersect_pallas` at every reference
    width and the jnp oracle."""
    rng = np.random.default_rng(k)
    for w in WS:
        for fill in FILLS:
            tables = _tables(rng, k, w, fill)
            idxs = rng.integers(0, 30, size=(T, k)).astype(np.int32)
            clear_col = rng.integers(-3, 32 * w + 3, size=(T, 1))
            tile_idx = np.concatenate([idxs, clear_col], 1).astype(np.int32)
            jt = tuple(jnp.asarray(t) for t in tables)
            oracle = jref.bitmap_intersect_ref(jt, jnp.asarray(idxs))
            wants = [oracle] + [
                bitmap_intersect_pallas(jt, jnp.asarray(idxs),
                                        words_per_block=jw, interpret=True)
                for jw in JAX_WIDTHS]
            tt = [_t(t) for t in tables]
            plain = ref.bitmap_intersect_ref(tt, torch.from_numpy(idxs))
            for wpb in WIDTHS:
                got = bi.bitmap_intersect(tt, torch.from_numpy(idxs),
                                          words_per_block=wpb)
                tile = bi.tile_intersect(tt, torch.from_numpy(tile_idx),
                                         range(k), [k], words_per_block=wpb)
                for r_want, pop_want in wants:
                    for g in (got, plain):
                        _same(g[0], r_want)
                        _same(g[1], pop_want)
                    r2, pop2 = _jax_clears(r_want, pop_want[:, 0], tile_idx,
                                           [k])
                    _same(tile[0], r2)
                    _same(tile[1], pop2)


@pytest.mark.parametrize("k0", [0, 1, 3])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_fused_and_expand_intersect_equal_the_reference_at_every_width(k,
                                                                       k0):
    """fused_expand_intersect over the reference's selection of a frontier,
    and expand_intersect (the selection in the same call, the bitpos
    column's bit cleared), at every port width against
    `fused_expand_intersect_pallas` at every reference width and the jnp
    oracle. Slot K0 reads bitpos, slots below it parent columns."""
    rng = np.random.default_rng(10 * k + k0)
    slots = tuple([min(j, k0) for j in range(k)][::-1])
    for w in WS:
        for fill in FILLS:
            tables = _tables(rng, k, w, fill)
            idx = rng.integers(0, 30, size=(T_IN, k0)).astype(np.int32)
            frontier = (rng.integers(0, 2 ** 32, size=(T_IN, w),
                                     dtype=np.uint32)
                        & rng.integers(0, 2 ** 32, size=(T_IN, w),
                                       dtype=np.uint32))
            rows, bitpos, _, _ = jbitops.expand_select(
                jnp.asarray(frontier), jnp.int32(0), T)
            child = np.concatenate([idx[np.asarray(rows)],
                                    np.asarray(bitpos)[:, None]], 1)
            jt = tuple(jnp.asarray(t) for t in tables)
            oracle = jref.fused_expand_intersect_ref(
                jt, jnp.asarray(idx), rows, bitpos, slots=slots)
            wants = [oracle] + [
                fused_expand_intersect_pallas(
                    jt, jnp.asarray(idx), rows, bitpos, slots=slots,
                    words_per_block=jw, interpret=True)
                for jw in JAX_WIDTHS]
            tt = [_t(t) for t in tables]
            sel = (torch.from_numpy(np.array(rows)),
                   torch.from_numpy(np.array(bitpos)))
            plain = ref.fused_expand_intersect_ref(
                tt, torch.from_numpy(idx), *sel, slots=slots)
            for wpb in WIDTHS:
                got = bi.fused_expand_intersect(tt, torch.from_numpy(idx),
                                                *sel, slots,
                                                words_per_block=wpb)
                expand = bi.expand_intersect(
                    _t(frontier), 0, T, torch.from_numpy(idx), tt, slots,
                    [k0], words_per_block=wpb)
                _same(expand[4], child)
                for r_want, pop_want in wants:
                    for g in (got, plain):
                        _same(g[0], r_want)
                        _same(g[1], pop_want)
                    r2, pop2 = _jax_clears(r_want, pop_want[:, 0], child,
                                           [k0])
                    _same(expand[5], r2)
                    _same(expand[6], pop2)


@pytest.mark.parametrize("q", [1, 3])
def test_tile_intersect_lane_is_the_same_at_every_width(q):
    """The superbatch's query lane at every width against a numpy gather
    over the stacked tables (query ids and keys on their own axes, both in
    range), with the bitpos-style clear of column 3."""
    rng = np.random.default_rng(q)
    for k, w in ((1, 1), (2, 33), (4, 130)):
        tables = [rng.integers(0, 2 ** 32, size=(q, 25, w), dtype=np.uint32)
                  for _ in range(k)]
        idx = np.stack([rng.integers(0, q, T)]
                       + [rng.integers(0, 25, T) for _ in range(2)]
                       + [rng.integers(-2, 32 * w, T)], 1).astype(np.int32)
        slots = [1 + j % 2 for j in range(k)]
        want = np.bitwise_and.reduce(
            [tbl[idx[:, 0], idx[:, s]] for tbl, s in zip(tables, slots)])
        hit = idx[:, 3] >= 0
        word, bit = idx[hit, 3] >> 5, idx[hit, 3] & 31
        want[np.nonzero(hit)[0], word] &= ~(np.uint32(1) << bit.astype(
            np.uint32))
        pop = np.unpackbits(want.view(np.uint8), axis=1).sum(1)
        for wpb in WIDTHS:
            got = bi.tile_intersect([_t(t) for t in tables],
                                    torch.from_numpy(idx), slots, [3],
                                    qid_slot=0, words_per_block=wpb)
            _same(got[0], want)
            _same(got[1], pop.astype(np.int32))


@pytest.mark.parametrize("bad", [0, 8, 16, 48, 96, 256, -128])
def test_a_width_without_an_instantiation_raises(bad):
    tt = [_t(np.ones((4, 3), np.uint32))]
    idx = torch.zeros((5, 1), dtype=torch.int32)
    rows = torch.zeros((5,), dtype=torch.int32)
    r = _t(np.ones((5, 1), np.uint32))
    calls = (
        lambda: bi.bitmap_intersect(tt, idx, words_per_block=bad),
        lambda: bi.tile_intersect(tt, idx, [0], words_per_block=bad),
        lambda: bi.fused_expand_intersect(tt, idx, rows, rows, [0],
                                          words_per_block=bad),
        lambda: bi.expand_intersect(r, 0, 5, idx, tt, [0],
                                    words_per_block=bad),
        lambda: bi.autotune_words_per_block(1, 3, device="cpu",
                                            widths=(32, bad)),
        lambda: ops.make_fused_expand_intersect_fn(words_per_block=bad)(
            tt, idx, rows, rows, [0]))
    for call in calls:
        with pytest.raises(ValueError, match="words_per_block"):
            call()
    with pytest.raises(TypeError):
        bi.bitmap_intersect(tt, idx, words_per_block=32.0)
    with pytest.raises(ValueError):
        bi.autotune_words_per_block(1, 3, device="cpu", widths=())


def test_autotune_on_the_cpu_returns_a_width_and_caches_it(monkeypatch):
    """The sweep times each width once per (device, k, W); a second call
    for the same key times nothing."""
    monkeypatch.setattr(bi, "_AUTOTUNE_CACHE", {})
    timed = []
    real = bi._sweep_seconds

    def spy(inputs, wpb, dev):
        timed.append(wpb)
        return real(inputs, wpb, dev)

    monkeypatch.setattr(bi, "_sweep_seconds", spy)
    wb = bi.autotune_words_per_block(2, 24, device="cpu")
    assert wb in WIDTHS and timed == list(WIDTHS)
    assert bi.autotune_words_per_block(2, 24, device="cpu") == wb
    assert len(timed) == 3
    for k, w in ((3, 24), (2, 25)):
        assert bi.autotune_words_per_block(k, w, device="cpu") in WIDTHS
    assert len(timed) == 9
    assert set(bi._AUTOTUNE_CACHE) == {("cpu", None, 2, 24, WIDTHS),
                                       ("cpu", None, 3, 24, WIDTHS),
                                       ("cpu", None, 2, 25, WIDTHS)}
    assert not any(bi.expand_intersect.sweep_launches_by_width.values())


def test_sweep_launches_are_counted_where_the_kernel_launches(monkeypatch):
    """With the launch faked (no card here), each launch a sweep makes at
    a width adds one to launches_by_width and to sweep_launches_by_width
    at that width, in the wrapper; a launch outside a sweep only to the
    former."""
    monkeypatch.setattr(bi, "_on_card", lambda dev, what: True)
    monkeypatch.setattr(bi, "_select", lambda *args: args)
    bi.reset_launches()
    try:
        inputs = bi._sweep_inputs(2, 5, torch.device("cpu"))
        bi._sweep_seconds(inputs, 64, torch.device("cpu"))
        r, idx, tabs, slots = inputs
        bi.expand_intersect(r, 0, bi._SWEEP_T, idx, tabs, slots,
                            words_per_block=32)
        fn = bi.expand_intersect
        calls = 1 + bi._SWEEP_CALLS
        assert fn.launches == calls + 1
        assert fn.launches_by_width == {32: 1, 64: calls, 128: 0}
        assert fn.sweep_launches_by_width == {32: 0, 64: calls, 128: 0}
        assert not bi._sweeping
    finally:
        bi.reset_launches()


def test_autotune_sweep_inputs_select_the_references_keys():
    """The frontier's one bit a row makes expand_intersect select the
    reference's synthetic selection: rows[t] = t, bitpos[t] = 7 t % S."""
    r, idx, tabs, slots = bi._sweep_inputs(3, 5, torch.device("cpu"))
    assert slots == (1, 0, 0) and len(tabs) == 3
    assert all(t.shape == (bi._SWEEP_S, 5) for t in tabs)
    assert int(tabs[2][0, 0]) == 0x5A5A5A5A + 2
    rows, bitpos, valid, total, child = bi.expand_select(r, 0, bi._SWEEP_T,
                                                         idx)
    t = np.arange(bi._SWEEP_T)
    _same(rows, t)
    _same(bitpos, (7 * t) % bi._SWEEP_S)
    assert bool(valid.all()) and int(total) == bi._SWEEP_T
    _same(child[:, 0], t % bi._SWEEP_S)


@pytest.mark.parametrize("below_floor", [True, False])
def test_autotune_on_the_card_distrusts_a_time_under_the_hbm_floor(
        monkeypatch, below_floor):
    """On a CUDA device a winner faster than k·T·W·4 B over the card's HBM
    rate returns the largest width; otherwise the fastest wins. The timer
    and the device are patched: no card is needed."""
    from repro_torch.launch.roofline import HW
    k, w = 3, 100
    floor = k * bi._SWEEP_T * w * 4 / HW["hbm_bw"]
    scale = floor * (1e-3 if below_floor else 1e3)
    times = {32: 2 * scale, 64: scale, 128: 3 * scale}
    monkeypatch.setattr(bi, "_AUTOTUNE_CACHE", {})
    monkeypatch.setattr(bi, "resolve_device",
                        lambda d: torch.device("cuda", 1))
    monkeypatch.setattr(bi, "_sweep_inputs", lambda k, w, dev: None)
    monkeypatch.setattr(bi, "_sweep_seconds",
                        lambda inputs, wpb, dev: times[wpb])
    got = bi.autotune_words_per_block(k, w, device="cuda:1")
    assert got == (128 if below_floor else 64)
    assert set(bi._AUTOTUNE_CACHE) == {("cuda", 1, k, w, WIDTHS)}
    # the CPU skips the floor, as the reference skips it in interpret mode
    monkeypatch.setattr(bi, "resolve_device", torch.device)
    assert bi.autotune_words_per_block(k, w, device="cpu") == 64


def test_make_fused_expand_intersect_fn_autotunes_without_a_width(
        monkeypatch):
    asked, used = [], []
    monkeypatch.setattr(bi, "_AUTOTUNE_CACHE", {})
    real_tune, real_fused = bi.autotune_words_per_block, \
        bi.fused_expand_intersect

    def tune(k, w, **kw):
        asked.append((k, w, kw["device"].type))
        return real_tune(k, w, **kw)

    def fused(*args, words_per_block):
        used.append(words_per_block)
        return real_fused(*args, words_per_block=words_per_block)

    monkeypatch.setattr(ops, "autotune_words_per_block", tune)
    monkeypatch.setattr(ops, "fused_expand_intersect", fused)
    rng = np.random.default_rng(0)
    tt = [_t(t) for t in _tables(rng, 2, 40, "random")]
    idx = torch.from_numpy(rng.integers(0, 30, (7, 1)).astype(np.int32))
    rows = torch.from_numpy(rng.integers(0, 7, 16).astype(np.int32))
    bitpos = torch.from_numpy(rng.integers(0, 30, 16).astype(np.int32))
    want = ref.fused_expand_intersect_ref(tt, idx, rows, bitpos,
                                          slots=(1, 0))
    for wpb in (None,) + WIDTHS:
        r, pop = ops.make_fused_expand_intersect_fn(words_per_block=wpb)(
            tt, idx, rows, bitpos, (1, 0))
        assert torch.equal(r, want[0]) and torch.equal(pop, want[1][:, 0])
    assert asked == [(2, 40, "cpu")]
    assert used[0] in WIDTHS and used[1:] == list(WIDTHS)


@pytest.fixture(scope="module")
def reference_fused():
    """The reference Matcher's intersect="fused" counts and VectorStats on
    each workload, in one subprocess."""
    opts = {"engine": "vector", "intersect": "fused", "tile_rows": 8,
            "limit": 10 ** 9}
    cases = [dict(kind="matcher", call="count", workload=w, options=opts)
             for w in MATCHER_WORKLOADS]
    return dict(zip(MATCHER_WORKLOADS,
                    (r[0] for r in run_reference(cases))))


@pytest.mark.parametrize("wpb", [None, *WIDTHS])
@pytest.mark.parametrize("name", MATCHER_WORKLOADS)
def test_fused_route_equals_the_reference_at_every_width(
        name, wpb, reference_fused, monkeypatch):
    """Matcher.count on intersect="fused" with each fused boundary's width
    forced (the engine's autotune patched to return it) or autotuned
    (None): the reference's count and every VectorStats field, and each
    expand_intersect call at the boundary's width."""
    tuned, used = [], []
    real_tune, real_expand = bi.autotune_words_per_block, bi.expand_intersect

    def tune(k, w, *, device):
        assert device.type == "cpu"
        got = real_tune(k, w, device=device) if wpb is None else wpb
        tuned.append(got)
        return got

    def expand(r, start, n_out, *args, words_per_block):
        if n_out != bi._SWEEP_T:          # not the autotune's own sweep
            used.append(words_per_block)
        return real_expand(r, start, n_out, *args,
                           words_per_block=words_per_block)

    monkeypatch.setattr(bi, "autotune_words_per_block", tune)
    monkeypatch.setattr(bi, "expand_intersect", expand)
    query, data = workload(name)
    out = Matcher(Dataset.from_graph(port_graph(data)), device="cpu").count(
        port_graph(query), MatchOptions(engine="vector", intersect="fused",
                                        tile_rows=8, limit=10 ** 9))
    want = reference_fused[name]
    assert out.engine == "vector"
    assert out.count == want["count"]
    assert dataclasses.asdict(out.stats) == want["stats"]
    assert tuned and used and set(used) <= set(tuned) <= set(WIDTHS)
    if wpb is not None:
        assert set(used) == {wpb}
