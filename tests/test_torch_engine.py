"""repro_torch.core.{plan,engine,scheduler} against the reference at small
size: plan tables, per-stage extension computes on the same tiles, the leaf
reduction, the ring-buffer key hash. `repro.core.engine` imports in-process;
only `repro.core.scheduler` does not (see torch_reference.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_reference import (port_graph, reference_plan,  # noqa: E402
                             workload)

from repro.core import engine as ref_engine_mod  # noqa: E402
from repro_torch.core import engine, scheduler  # noqa: E402
from repro_torch.core.plan import build_plan, plan_from_arrays  # noqa: E402
from repro_torch.core.ref_engine import preprocess  # noqa: E402

WORKLOADS = ["fig1", "random0", "random1", "random2", "brother", "synthetic"]


def _to_jnp(tile):
    return {"idx": jnp.asarray(tile["idx"].numpy()),
            "bm": {u: jnp.asarray(c.numpy().view(np.uint32))
                   for u, c in tile["bm"].items()},
            "alive": jnp.asarray(tile["alive"].numpy())}


def _same_bits(got, want):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_vector_stats_has_the_reference_fields():
    port = [f.name for f in dataclasses.fields(engine.VectorStats)]
    ref = [f.name for f in dataclasses.fields(ref_engine_mod.VectorStats)]
    assert port == ref


@pytest.mark.parametrize("name", WORKLOADS)
def test_build_plan_is_bit_identical_to_the_reference(name):
    _cs, _an, ref_plan = reference_plan(name)
    query, data = workload(name)
    cs, an = preprocess(port_graph(query), port_graph(data))
    plan = build_plan(cs, an)
    assert plan.tables.keys() == ref_plan.tables.keys()
    for key, tbl in ref_plan.tables.items():
        assert plan.tables[key].dtype == np.uint32
        np.testing.assert_array_equal(plan.tables[key], tbl)
    for u, m in ref_plan.masks.items():
        np.testing.assert_array_equal(plan.masks[u], m)
    assert ([dataclasses.asdict(o) for o in plan.ops]
            == [dataclasses.asdict(o) for o in ref_plan.ops])
    for f in ("words", "label_of", "idx_slots", "leaf_groups",
              "leaf_singles", "root_vertex", "root_words"):
        assert getattr(plan, f) == getattr(ref_plan, f)
    # carried across through plain values, the plan is the same plan
    again = plan_from_arrays(dataclasses.asdict(ref_plan))
    assert ([dataclasses.asdict(o) for o in again.ops]
            == [dataclasses.asdict(o) for o in ref_plan.ops])
    for key, tbl in ref_plan.tables.items():
        np.testing.assert_array_equal(again.tables[key], tbl)
    tables, masks = engine.upload_plan(again, "cpu")
    for (u, w), tbl in ref_plan.tables.items():
        assert tables[f"{u}:{w}"].dtype == torch.int32
        np.testing.assert_array_equal(
            tables[f"{u}:{w}"].numpy().view(np.uint32), tbl)


def _walk(port, ref, *, fused=False):
    """Drive one frontier from the root to the leaf through every stage,
    feeding the same tile to the port's and the reference's computes and
    expansions and comparing each result bit for bit."""
    n_stages = len(port._stages)
    rtables = ref.tables
    rmasks = ref.masks
    tile = {"idx": torch.zeros((1, 0), dtype=torch.int32), "bm": {},
            "alive": torch.ones((1,), dtype=torch.bool)}
    sched = scheduler.TileScheduler(port)
    checked = 0
    pre = None
    for si in range(n_stages):
        compute_r, con = port._make_compute_parts(si)
        ref_compute_r, ref_con = ref._make_compute_parts(si)
        assert con == ref_con
        r, pop = compute_r(tile, port.tables, port.masks)
        r_ref, pop_ref = ref_compute_r(_to_jnp(tile), rtables, rmasks)
        _same_bits(r, r_ref)
        _same_bits(pop, pop_ref)
        if pre is not None:                  # the fused kernel's (R, pop)
            _same_bits(pre[0], r_ref)
            _same_bits(pre[1], pop_ref)
        checked += 1
        r, pop, ok = port.finish_compute(tile, r, pop, con)
        if sched._is_boundary(si):
            if int(pop.sum()) == 0:
                break
            start = 0
            fused_fn = (port._make_expand_fused(si, si + 1)
                        if fused and si + 1 < n_stages else None)
            if fused_fn is not None:
                out, total, pre = fused_fn(tile, r, start, port.tables)
            else:
                out, total = port._make_expand(si)(tile, r, start,
                                                    port.tables)
                pre = None
            out_ref, total_ref = ref._make_expand(si)(
                _to_jnp(tile), jnp.asarray(r.numpy().view(np.uint32)),
                jnp.int32(start), rtables)
            assert int(total) == int(total_ref)
            _same_bits(out["idx"], out_ref["idx"])
            _same_bits(out["alive"], out_ref["alive"])
            assert out["bm"].keys() == out_ref["bm"].keys()
            for u in out["bm"]:
                _same_bits(out["bm"][u], out_ref["bm"][u])
            tile = out
        else:
            pre = None
            tile = {"idx": tile["idx"], "bm": {**tile["bm"],
                                               port._stages[si][1].vertex: r},
                    "alive": ok}
    return checked


@pytest.mark.parametrize("intersect", ["jnp", "auto", "fused"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_stage_computes_match_the_reference_on_the_same_tiles(name,
                                                              intersect):
    cs, an, ref_plan = reference_plan(name)
    ref = ref_engine_mod.VectorEngine(cs, an, plan=ref_plan, tile_rows=32,
                                      intersect="jnp")
    port = engine.VectorEngine(cs, an, device="cpu", tile_rows=32,
                               intersect=intersect,
                               plan=plan_from_arrays(
                                   dataclasses.asdict(ref_plan)))
    assert _walk(port, ref, fused=intersect == "fused") >= 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_union_rows_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    s, w_src, w = 70, 3, 5
    table = rng.integers(0, 2 ** 32, size=(s, w), dtype=np.uint32)
    table[::3] &= rng.integers(0, 2 ** 32, size=(1, w), dtype=np.uint32)
    col = rng.integers(0, 2 ** 32, size=(9, w_src), dtype=np.uint32)
    col[:, -1] &= (1 << (s - 64)) - 1          # bits past S stay clear
    col[0] = 0
    got = engine._union_rows(torch.from_numpy(table.view(np.int32)),
                             torch.from_numpy(col.view(np.int32)))
    want = ref_engine_mod._union_rows(jnp.asarray(table), jnp.asarray(col))
    _same_bits(got, want)


@pytest.mark.parametrize("allow_tf32", [False, True])
def test_union_rows_leaves_matmul_precision_flags_alone(allow_tf32):
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = allow_tf32
    try:
        rng = np.random.default_rng(5)
        table = rng.integers(0, 2 ** 32, size=(40, 2), dtype=np.uint32)
        col = rng.integers(0, 2 ** 8, size=(4, 2), dtype=np.uint32)
        col[:, 1] = 0
        got = engine._union_rows(torch.from_numpy(table.view(np.int32)),
                                 torch.from_numpy(col.view(np.int32)))
        assert flags.allow_tf32 is allow_tf32
        want = ref_engine_mod._union_rows(jnp.asarray(table),
                                          jnp.asarray(col))
        _same_bits(got, want)
    finally:
        flags.allow_tf32 = before


@pytest.mark.parametrize("groups", [([0], []), ([], [[0, 1]]),
                                    ([0], [[1, 2, 3]]), ([0, 1], [[2, 3]])])
def test_leaf_reduce_matches_host_count_and_flags_overflow(groups):
    singles, grps = groups
    n_terms = len(singles) + sum(3 if len(g) == 2 else 7 for g in grps)
    rng = np.random.default_rng(n_terms)
    terms = rng.integers(0, 50, size=(40, n_terms)).astype(np.int32)
    alive = rng.random(40) < 0.7
    reduce = scheduler.make_leaf_reduce(singles, grps)
    cnt, ovf = reduce(torch.from_numpy(terms), torch.from_numpy(alive))
    assert cnt.dtype == torch.int64 and not bool(ovf)
    assert int(cnt) == scheduler.leaf_count_host(singles, grps, terms, alive)
    big = np.full((4, n_terms), 2 ** 31 - 1, np.int32)
    if len(singles) + len(grps) >= 2:
        _, ovf = reduce(torch.from_numpy(big), torch.ones(4, dtype=torch.bool))
        assert bool(ovf)


def test_key_hash_wraps_like_int32():
    rng = np.random.default_rng(0)
    keys = rng.integers(-2 ** 31, 2 ** 31, size=(64, 4)).astype(np.int32)
    h = np.zeros(64, np.int64)
    for j in range(4):
        h = (h * 1000003 + keys[:, j]) & 0xFFFFFFFF
    want = h.astype(np.uint32).view(np.int32)
    got = scheduler._key_hash(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)


def test_ring_insert_dedups_caps_and_wraps():
    buf = scheduler._init_ring(3, 1, "cpu", wit=((), torch.int32))
    keys = torch.tensor([[5], [7], [5], [9], [11], [2]], dtype=torch.int32)
    sel = torch.tensor([True, True, True, False, True, True])
    wit = torch.arange(6, dtype=torch.int32)
    h = scheduler._key_hash(keys)
    new, n_ins = scheduler._ring_insert(buf, keys, h, sel, {"wit": wit})
    # distinct selected keys by hash order: 2, 5, 7, 11 -> the first three
    assert int(n_ins) == 3 and int(new["ptr"]) == 0
    assert sorted(new["keys"][:, 0].tolist()) == [2, 5, 7]
    assert bool(new["valid"].all())
    hit, _ = scheduler._probe(keys, h, new)
    assert hit.tolist() == [True, True, True, False, False, True]
    # nothing selected: the ring comes back unchanged
    same, n0 = scheduler._ring_insert(new, keys, h, torch.zeros(6, dtype=bool),
                                      {"wit": wit})
    assert int(n0) == 0
    assert all(torch.equal(same[k], new[k]) for k in new)
