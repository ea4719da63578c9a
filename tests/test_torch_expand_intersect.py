"""The redesigned bitmap entry points against the JAX package, bit for bit.

On the CPU each wrapper takes its plain version (`repro_torch.kernels.ref`),
which must equal the JAX package's composition of the same steps:

  * expand_intersect: `repro.core.bitops.expand_select`, then
    `fused_expand_intersect_pallas(interpret=True)` over that selection,
    then `repro.core.bitops.clear_bit_rows_count` over the child columns;
  * expand_select: `repro.core.bitops.expand_select` and the child columns
    idx[rows] ++ bitpos;
  * tile_intersect: `bitmap_intersect_pallas(interpret=True)` over the key
    columns, then the same-label clears;
  * tile_intersect with a query lane: the superbatch's jnp gathers
    `tables[qid, key]` over stacked per-query tables, ANDed, then
    `clear_bit_rows` and `row_popcount` (the reference's
    `BatchProgram._make_compute_parts` pair branch).

Inputs are numpy arrays from a seed. Negative index entries sit only in
columns that are cleared, never in key columns: Pallas in interpret mode
clamps a negative block index to 0, where jnp (and the port) count it from
the end. The CUDA kernels themselves run only on the card (`cuda` marker).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import bitops as jbitops  # noqa: E402
from repro.kernels.bitmap_intersect import (  # noqa: E402
    bitmap_intersect_pallas, fused_expand_intersect_pallas)
from repro_torch import api  # noqa: E402
from repro_torch.kernels import bitmap_intersect as bi  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

FILLS = ("empty", "sparse", "dense", "ones")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _same(got, want):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _bits(rng, shape, fill):
    """uint32 words: empty, sparse (about 1 bit in 64, every third row
    empty), dense (random words) or all ones."""
    if fill == "empty":
        return np.zeros(shape, np.uint32)
    if fill == "ones":
        return np.full(shape, 0xFFFFFFFF, np.uint32)
    if fill == "dense":
        return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    bits = (rng.random(shape + (32,)) < 1 / 64).astype(np.uint64)
    bits[::3] = 0
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _tables(rng, k, w):
    return [rng.integers(0, 2 ** 32, size=(int(rng.integers(1, 40)), w),
                         dtype=np.uint32) for _ in range(k)]


def _columns(rng, k, k0):
    """Key slots in [0, K0] (slot K0 is bitpos) and clear slots: always
    the bitpos column, and a parent column that holds negative entries
    and is never a key, where one is free (K0 >= 2, or K0 == 1 with every
    key on bitpos)."""
    neg = k0 - 1 if k0 >= 2 or (k0 == 1 and k % 2) else None
    keys = [s for s in range(k0 + 1) if s != neg]
    slots = [k0] + [int(s) for s in rng.choice(keys, size=k - 1)]
    clears = [k0] + ([neg] if neg is not None else [])
    return slots, clears, neg


def _jax_expand_intersect(r, start, n_out, idx, tables, slots, clears):
    rows, bitpos, valid, total = jbitops.expand_select(
        jnp.asarray(r), jnp.int32(start), n_out)
    child = jnp.concatenate([jnp.asarray(idx)[rows], bitpos[:, None]],
                            axis=1)
    r2, pop = fused_expand_intersect_pallas(
        tuple(jnp.asarray(t) for t in tables), jnp.asarray(idx), rows,
        bitpos, slots=tuple(slots), interpret=True)
    pop = pop[:, 0]
    for c in clears:
        r2, was_set = jbitops.clear_bit_rows_count(r2, child[:, c])
        pop = pop - was_set
    return rows, bitpos, valid, total, child, r2, pop


@pytest.mark.parametrize("w", [1, 33, 82])
@pytest.mark.parametrize("k0", [0, 1, 4])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_expand_intersect_plain_matches_jax_composition(k, k0, w):
    """Every fill, and start at 0, in the middle, at total - 1, at total
    and past it; T_in != T_out both ways, and T_out > total where the
    frontier is empty or sparse."""
    rng = np.random.default_rng(100 * k + 10 * k0 + w)
    t_in, t_out = (9, 16) if k % 2 else (20, 8)
    tables = _tables(rng, k, w)
    slots, clears, neg = _columns(rng, k, k0)
    s_min = min(t.shape[0] for t in tables)
    idx = rng.integers(0, s_min, size=(t_in, k0)).astype(np.int32)
    if neg is not None:
        idx[:, neg] = rng.integers(-5, 70, size=t_in)
        idx[0, neg] = -1
    tt = [_t(t) for t in tables]
    for fill in FILLS:
        r = _bits(rng, (t_in, w), fill)
        total = int(np.unpackbits(r.view(np.uint8)).sum())
        for start in sorted({0, total // 2, max(total - 1, 0), total,
                             total + 3}):
            want = _jax_expand_intersect(r, start, t_out, idx, tables, slots,
                                         clears)
            args = (_t(r), start, t_out, torch.from_numpy(idx))
            for got in (ref.expand_intersect_ref(*args, tt, slots, clears),
                        bi.expand_intersect(*args, tt, slots, clears)):
                assert len(got) == 7
                for g, x in zip(got, want):
                    _same(g, x)
                assert got[3].shape == () and got[6].shape == (t_out,)
            sel = bi.expand_select(*args)
            for g, x in zip(sel, want[:5]):
                _same(g, x)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("t_in,t_out", [(1, 5), (6, 40), (40, 6)])
def test_expand_select_plain_matches_jax_at_every_start(t_in, t_out, fill):
    """The selection alone, walked chunk by chunk through the frontier and
    then at and past its end."""
    rng = np.random.default_rng(t_in * 7 + t_out)
    r = _bits(rng, (t_in, 3), fill)
    idx = rng.integers(0, 50, size=(t_in, 2)).astype(np.int32)
    total = int(np.unpackbits(r.view(np.uint8)).sum())
    for start in list(range(0, total, t_out)) + [total, total + 1]:
        rows, bitpos, valid, tot = jbitops.expand_select(
            jnp.asarray(r), jnp.int32(start), t_out)
        child = np.concatenate([idx[np.asarray(rows)],
                                np.asarray(bitpos)[:, None]], axis=1)
        got = bi.expand_select(_t(r), start, t_out, torch.from_numpy(idx))
        for g, x in zip(got, (rows, bitpos, valid, tot, child)):
            _same(g, x)


@pytest.mark.parametrize("w", [1, 33, 82])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_tile_intersect_plain_matches_pallas_and_clears(k, w):
    """Keys read through slots from K = 1, 2 and 5 index columns, every
    table fill, same-label clears of key columns and of a column with
    negative entries."""
    rng = np.random.default_rng(10 * k + w)
    t_rows = 13
    for n_cols in (1, 2, 5):
        for fill in ("dense", "empty", "ones", "sparse"):
            tables = [_bits(rng, (int(rng.integers(1, 40)), w), fill)
                      for _ in range(k)]
            s_min = min(t.shape[0] for t in tables)
            idx = rng.integers(0, s_min, size=(t_rows, n_cols)).astype(
                np.int32)
            if n_cols > 1:                     # the last column: clears only
                idx[:, -1] = rng.integers(-5, 70, size=t_rows)
                slots = [int(s) for s in rng.integers(0, n_cols - 1, k)]
                clears = [n_cols - 1, slots[0]]
            else:
                slots, clears = [0] * k, [0]
            r, pop = bitmap_intersect_pallas(
                tuple(jnp.asarray(t) for t in tables),
                jnp.asarray(idx[:, slots]), interpret=True)
            pop = pop[:, 0]
            for c in clears:
                r, was_set = jbitops.clear_bit_rows_count(
                    r, jnp.asarray(idx[:, c]))
                pop = pop - was_set
            tt = [_t(t) for t in tables]
            for got in (ref.tile_intersect_ref(tt, torch.from_numpy(idx),
                                               slots, clears),
                        bi.tile_intersect(tt, torch.from_numpy(idx), slots,
                                          clears)):
                _same(got[0], r)
                _same(got[1], pop)
            # no clears: the old bitmap_intersect contract over the keys
            got = bi.bitmap_intersect(tt, torch.from_numpy(
                np.ascontiguousarray(idx[:, slots])))
            plain = bi.tile_intersect(tt, torch.from_numpy(idx), slots)
            assert torch.equal(got[0], plain[0])
            assert torch.equal(got[1][:, 0], plain[1])


def _lane_inputs(rng, k, w, q, t_rows=29, n_cols=4):
    """Stacked (Q, S_j, W) tables and index columns: column 0 the query
    id, columns 1..n_cols-1 keys; query ids and keys both run negative and
    past the end (each is taken on its own axis), and the last column
    also holds clear values."""
    tables = [_bits(rng, (q, int(rng.integers(1, 40)), w),
                    str(rng.choice(["dense", "sparse", "ones"])))
              for _ in range(k)]
    idx = np.stack([rng.integers(-q - 2, q + 3, t_rows)]
                   + [rng.integers(-45, 45, t_rows)
                      for _ in range(n_cols - 1)], 1).astype(np.int32)
    slots = [int(s) for s in rng.integers(1, n_cols, k)]
    return tables, idx, slots, [n_cols - 1, slots[0]]


def _jax_lane(tables, idx, slots, clears):
    r = None
    for tbl, s in zip(tables, slots):
        rows = jnp.asarray(tbl)[jnp.asarray(idx[:, 0]), jnp.asarray(idx[:, s])]
        r = rows if r is None else (r & rows)
    for c in clears:
        r = jbitops.clear_bit_rows(r, jnp.asarray(idx[:, c]))
    return r, jbitops.row_popcount(r)


@pytest.mark.parametrize("q", [1, 2, 5, 8])
@pytest.mark.parametrize("w", [1, 33, 128])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_tile_intersect_lane_plain_matches_jax_gather(k, w, q):
    rng = np.random.default_rng(1000 * k + 10 * w + q)
    for clears_on in (True, False):
        tables, idx, slots, clears = _lane_inputs(rng, k, w, q)
        clears = clears if clears_on else []
        r, pop = _jax_lane(tables, idx, slots, clears)
        tt = [_t(t) for t in tables]
        ti = torch.from_numpy(idx)
        for got in (ref.tile_intersect_ref(tt, ti, slots, clears, qid_slot=0),
                    bi.tile_intersect(tt, ti, slots, clears, qid_slot=0)):
            _same(got[0], r)
            _same(got[1], pop)
        if q == 1:
            # one query: the lane reads that query's table, like no lane
            # over the query's own table with the query column in range
            ti[:, 0] = 0
            plain = bi.tile_intersect([x[0] for x in tt], ti, slots, clears)
            lane = bi.tile_intersect(tt, ti, slots, clears, qid_slot=0)
            assert all(torch.equal(a, b) for a, b in zip(plain, lane))


def test_tile_intersect_lane_rejects_bad_inputs():
    stacked = [torch.zeros((2, 4, 3), dtype=torch.int32)]
    idx = torch.zeros((5, 3), dtype=torch.int32)
    with pytest.raises(TypeError):                  # 2-D tables with a lane
        bi.tile_intersect([stacked[0][0]], idx, [1], qid_slot=0)
    with pytest.raises(TypeError):                  # stacks without a lane
        bi.tile_intersect(stacked, idx, [1])
    with pytest.raises(ValueError):                 # query counts differ
        bi.tile_intersect(stacked + [torch.zeros((3, 4, 3),
                                                 dtype=torch.int32)],
                          idx, [1, 2], qid_slot=0)
    with pytest.raises(ValueError):                 # lane column >= K
        bi.tile_intersect(stacked, idx, [1], qid_slot=3)
    with pytest.raises(ValueError):                 # no query
        bi.tile_intersect([torch.zeros((0, 4, 3), dtype=torch.int32)], idx,
                          [1], qid_slot=0)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(0)
    tt = [_t(t) for t in _tables(rng, 2, 4)]
    r = _t(_bits(rng, (6, 4), "dense"))
    idx = torch.zeros((6, 2), dtype=torch.int32)
    before = {fn.__name__: fn.launches for fn in bi.WRAPPERS}
    bi.expand_select(r, 0, 8, idx)
    bi.expand_intersect(r, 0, 8, idx, tt, [2, 0], [2])
    bi.tile_intersect(tt, idx, [0, 1], [1])
    bi.tile_intersect([t[None] for t in tt], idx, [1, 1], [1], qid_slot=0)
    assert {fn.__name__: fn.launches for fn in bi.WRAPPERS} == before
    assert bi.tile_intersect.lane_launches == 0


def test_new_wrappers_reject_bad_inputs():
    tt = [torch.zeros((4, 2), dtype=torch.int32)]
    idx = torch.zeros((3, 2), dtype=torch.int32)
    r = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError):                       # slot >= K
        bi.tile_intersect(tt, idx, [2])
    with pytest.raises(ValueError):                       # clear >= K
        bi.tile_intersect(tt, idx, [0], [2])
    with pytest.raises(ValueError):
        bi.tile_intersect(tt, idx, [0], [0] * (bi.MAX_CLEARS + 1))
    with pytest.raises(TypeError):
        bi.tile_intersect(tt, idx.to(torch.int64), [0])
    with pytest.raises(ValueError):                       # slot > K0
        bi.expand_intersect(r, 0, 4, idx, tt, [3])
    with pytest.raises(ValueError):                       # negative start
        bi.expand_select(r, -1, 4, idx)
    with pytest.raises(ValueError):                       # past int32 ranks
        bi.expand_select(r, 2 ** 31 - 2, 4, idx)
    with pytest.raises(TypeError):                        # idx rows != T_in
        bi.expand_select(r, 0, 4, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):                       # empty frontier
        bi.expand_select(r[:0], 0, 4, idx[:0])
    with pytest.raises(ValueError):
        bi.expand_select(r.to("meta"), 0, 4, idx.to("meta"))
    with pytest.raises(ValueError):
        bi.tile_intersect([t.to("meta") for t in tt], idx.to("meta"), [0])


@pytest.mark.parametrize("intersect,want", [
    ("auto", {"expand_select", "tile_intersect"}),
    ("fused", {"expand_intersect"}),
    ("jnp", set())])
def test_engine_routes_call_the_new_entry_points(monkeypatch, intersect,
                                                 want):
    """Each kernel route expands every boundary through expand_select or
    expand_intersect and computes pair extends through tile_intersect;
    "jnp" stays on plain torch."""
    calls = {name: 0 for name in ("expand_select", "expand_intersect",
                                  "tile_intersect")}
    for name in calls:
        orig = getattr(bi, name)

        def counted(*args, _orig=orig, _name=name, **kwargs):
            calls[_name] += 1
            return _orig(*args, **kwargs)
        monkeypatch.setattr(bi, name, counted)
    ds = api.Dataset.synthetic("human", scale=0.05)
    m = api.Matcher(ds, device="cpu")
    q = ds.random_query(size=6, seed=7)
    assert m.count(q, engine="vector", intersect=intersect).count \
        == m.count(q, engine="ref").count
    assert {name for name, n in calls.items() if n} >= want
    if not want:
        assert not any(calls.values())
    if intersect == "auto":
        assert calls["expand_intersect"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k0", [0, 4])
def test_cuda_new_kernels_match_plain_versions(k0):
    """The three new entry points against their plain versions on the
    card (chip_smoke.py runs the full grid)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100 via chip_smoke.py)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(k0)
    for k, w in [(1, 1), (2, 33), (4, 82)]:
        tt = [_t(t).to(dev) for t in _tables(rng, k, w)]
        slots, clears, neg = _columns(rng, k, k0)
        idx = torch.from_numpy(rng.integers(-5, 40, size=(300, k0))
                               .astype(np.int32)).to(dev)
        for fill in FILLS:
            r = _t(_bits(rng, (300, w), fill)).to(dev)
            for start in (0, 100, 10 ** 6):
                args = (r, start, 256, idx)
                got = bi.expand_intersect(*args, tt, slots, clears)
                want = ref.expand_intersect_ref(*args, tt, slots, clears)
                assert all(torch.equal(g, x) for g, x in zip(got, want))
                assert all(torch.equal(g, x) for g, x in zip(
                    bi.expand_select(*args), ref.expand_select_ref(*args)))
        if k0:
            got = bi.tile_intersect(tt, idx, [0] * k, [k0 - 1])
            want = ref.tile_intersect_ref(tt, idx, [0] * k, [k0 - 1])
            assert all(torch.equal(g, x) for g, x in zip(got, want))


@pytest.mark.cuda
def test_cuda_tile_intersect_lane_matches_plain_version():
    """The query lane against its plain version on the card
    (chip_smoke.py runs the full grid)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100 via chip_smoke.py)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    for k, w, q in [(1, 1, 1), (2, 33, 5), (4, 128, 8)]:
        tables, idx, slots, clears = _lane_inputs(rng, k, w, q, t_rows=300)
        tt = [_t(t).to(dev) for t in tables]
        ti = torch.from_numpy(idx).to(dev)
        got = bi.tile_intersect(tt, ti, slots, clears, qid_slot=0)
        want = ref.tile_intersect_ref(tt, ti, slots, clears, qid_slot=0)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
