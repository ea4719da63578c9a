"""The torch port's sharded enumeration (`repro_torch.core.shard`) on the
CPU, against the reference's.

Every case of tests/test_shard_differential.py is ported: the port's
`ShardedTileScheduler` / `ShardedSuperbatchScheduler` run over an
`EnumMesh` of 2, 3 or 4 CPU lanes (one device repeated), and the
reference's sharded schedulers run over a mesh of as many forced host
devices, in one subprocess for the whole file (torch_reference.py). Counts,
every VectorStats field and, for materialized runs, the embeddings in
their order must be equal. The Matcher's wiring is held against the
reference Matcher with the port's lane devices monkeypatched to four CPU
lanes."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_reference import (BATCH_WORKLOADS, port_graph,  # noqa: E402
                             reference_buckets, reference_plan,
                             run_reference, workload)

import repro_torch.core.scheduler as sched  # noqa: E402
import repro_torch.launch.mesh as mesh_mod  # noqa: E402
from repro.core.plan import \
    root_extension_weights as ref_root_weights  # noqa: E402
from repro.core.ref_engine import cemr_match  # noqa: E402
from repro.distributed.sharding import \
    partition_bitmap as ref_partition  # noqa: E402
from repro_torch.api import Dataset, MatchOptions, Matcher  # noqa: E402
from repro_torch.core.engine import VectorEngine  # noqa: E402
from repro_torch.core.plan import (plan_from_arrays,  # noqa: E402
                                   root_extension_weights)
from repro_torch.core.scheduler import TileScheduler  # noqa: E402
from repro_torch.core.shard import (ShardedSuperbatchScheduler,  # noqa: E402
                                    ShardedTileScheduler)
from repro_torch.distributed.sharding import partition_bitmap  # noqa: E402
from repro_torch.launch.mesh import EnumMesh, make_enum_mesh  # noqa: E402

CPU = torch.device("cpu")
STAR = dict(tile_rows=16, encoding="all_black", order=[0, 1, 2])


def _tile(workload, mesh, **kw):
    return dict(kind="sharded", workload=workload, mesh=mesh, **kw)


# (id, reference case) of the single-query sharded scheduler, in
# tests/test_shard_differential.py's order, at 2 and 4 lanes (3 too for
# the contained-vertex case, as there; the workload's distinct queries and
# the random seeds take turns); plus the knobs the port's other parity
# tests cover: overlap off, the fused route, ring wraparound, a second run
# meeting recorded failures, a step budget and the compat loop
TILE_CASES = (
    [(f"fig1-t{tr}-s{s}", _tile("fig1", s, tile_rows=tr))
     for tr in (16, 64) for s in (2, 4)]
    + [(f"random{seed}-s{s}", _tile(f"random{seed}", s))
       for seed, s in ((3, 4), (11, 2), (42, 4), (1234, 2))]
    + [(f"batch1:{i}-{enc}-s{s}", _tile(f"batch1:{i}", s, tile_rows=tr,
                                        encoding=enc))
       for i in (0, 2, 4, 6) for (tr, enc), s in (((32, "cost"), 2 + i % 4),
                                                  ((16, "all_black"),
                                                   4 - i % 4))]
    + [(f"limit-s{s}", _tile("star", s, limit=50, **STAR)) for s in (2, 4)]
    + [(f"stream-s{s}", _tile("fig1", s, materialize=True))
       for s in (2, 4)]
    + [("brother-more-shards", _tile("brother", 4, tile_rows=16))]
    + [(f"clique6-s{s}", _tile("clique6", s, tile_rows=16))
       for s in (4, 2, 3)]
    + [(f"star-s{s}", _tile("star", s, **STAR)) for s in (2, 4)]
    + [("overflow-False-s4", _tile("overflow", 4, tile_rows=64))]
    + [(f"overflow-True-s{s}", _tile("overflow", s, tile_rows=64,
                                     overflow_limit=0.5)) for s in (2, 4)]
    + [("packing-overlap-off-s4", _tile("packing", 4, tile_rows=8,
                                        overlap=False)),
       ("synthetic-fused-wrap-s4", _tile("synthetic", 4, tile_rows=16,
                                         intersect="fused",
                                         cer_buffer_slots=2,
                                         failure_cache_slots=1)),
       ("failing-runs2-s2", _tile("failing", 2, tile_rows=8, runs=2,
                                  failure_cache_slots=2)),
       ("synthetic-budget-s4", _tile("synthetic", 4, tile_rows=8,
                                     max_steps=5)),
       ("synthetic-compat-s4", _tile("synthetic", 4, tile_rows=8,
                                     use_cer_buffer=False))])

# (id, reference case) of the sharded superbatch: the superbatch and the
# contained-vertex pairs of tests/test_shard_differential.py, plus a
# per-query limit, the overflow fallback, overlap off and a second run
SB_CASES = (
    [("shard_batch-s4", _tile("shard_batch", 4, batch=True, tile_rows=32))]
    + [(f"clique6-s{s}", _tile("clique6", s, batch=True, tile_rows=16))
       for s in (4, 2, 3)]
    + [("batch2-limit-s2", _tile("batch2", 2, batch=True, tile_rows=32,
                                 limit=50)),
       ("overflow-s4", _tile("overflow", 4, batch=True, tile_rows=64,
                             overflow_limit=0.5)),
       ("failing-overlap-off-runs2-s2",
        _tile("failing", 2, batch=True, tile_rows=16, runs=2,
              failure_cache_slots=2, overlap=False))])

# the reference Matcher's results the wiring tests hold the port's to
MATCHER_CASES = (
    [dict(kind="matcher", call="count", workload=w,
          options=dict(engine="vector", tile_rows=16, limit=10 ** 9,
                       mesh=4))
     for w in ("fig1", "synthetic", "clique6")]
    + [dict(kind="matcher", call="match_many", workload="shard_batch",
            options=dict(engine="vector", tile_rows=32, limit=10 ** 9,
                         mesh=4))])


@pytest.fixture(scope="module")
def reference():
    """Every reference run of this file, in one subprocess."""
    cases = ([c for _, c in TILE_CASES] + [c for _, c in SB_CASES]
             + MATCHER_CASES)
    out = run_reference(cases, timeout=1200)
    n, m = len(TILE_CASES), len(SB_CASES)
    return {"tile": out[:n], "sb": out[n:n + m], "matcher": out[n + m:]}


def _lanes(s):
    return EnumMesh((CPU,) * s)


def _run_tile(case, monkeypatch):
    """The port's side of a single-query sharded case, on the reference's
    plan."""
    case = dict(case)
    for key in ("kind", "batch"):
        case.pop(key, None)
    s = case.pop("mesh")
    name = case.pop("workload")
    limit = case.pop("limit", 10 ** 9)
    runs = case.pop("runs", 1)
    max_steps = case.pop("max_steps", None)
    materialize = case.pop("materialize", False)
    if "overflow_limit" in case:
        monkeypatch.setattr(sched, "OVERFLOW_LIMIT", case.pop("overflow_limit"))
    cs, an, plan = reference_plan(name, encoding=case.pop("encoding", "cost"),
                                  order=case.pop("order", None))
    eng = VectorEngine(cs, an, device="cpu", mesh=_lanes(s),
                       plan=plan_from_arrays(dataclasses.asdict(plan)),
                       **case)
    for _ in range(runs):
        res = eng.run(limit=limit, max_steps=max_steps,
                      materialize=materialize)
    return eng, res


@pytest.mark.parametrize("i", range(len(TILE_CASES)),
                         ids=[cid for cid, _ in TILE_CASES])
def test_sharded_tile_scheduler_equals_the_reference(i, reference,
                                                     monkeypatch):
    _, case = TILE_CASES[i]
    eng, res = _run_tile(case, monkeypatch)
    want = reference["tile"][i]
    sharded = case.get("use_cer_buffer", True)
    assert isinstance(eng._scheduler, ShardedTileScheduler)
    assert res.count == want["count"]
    assert res.timed_out == want["timed_out"]
    assert dataclasses.asdict(res.stats) == want["stats"]
    if case.get("materialize"):
        assert [sorted(e.items()) for e in res.embeddings] == \
            [[tuple(p) for p in e] for e in want["embeddings"]]
        assert len(res.embeddings) == res.count > 0
    # counts equal the single-device path's and cemr_match's
    query, data = workload(case["workload"])
    if case.get("max_steps") is None:
        want_count = cemr_match(
            query, data, encoding=case.get("encoding", "cost"),
            order=case.get("order"), limit=case.get("limit", 10 ** 9)).count
        assert res.count == want_count
    assert (res.stats.shard_lanes > 0) == sharded


def test_the_tile_cases_exercise_the_shard_machinery(reference):
    """The ported cases reach every mechanism of the sharded loop: lanes,
    rebalances, packing, CER and failure hits, the overflow fallback,
    overlap and the limit."""
    by_id = {cid: r for (cid, _), r in zip(TILE_CASES, reference["tile"])}
    total = {k: sum(r["stats"][k] for r in reference["tile"])
             for k in ("shard_lanes", "shard_rebalances", "packed_tiles",
                       "cer_hits", "fail_hits", "leaf_overflows",
                       "overlapped_supersteps")}
    assert all(v > 0 for v in total.values()), total
    assert by_id["limit-s4"]["count"] == 50
    assert by_id["star-s4"]["stats"]["shard_rebalances"] > 0
    assert by_id["overflow-True-s4"]["stats"]["leaf_overflows"] > 0
    assert by_id["overflow-True-s4"]["count"] == \
        by_id["overflow-False-s4"]["count"]
    assert by_id["packing-overlap-off-s4"]["stats"]["packed_tiles"] > 0


def test_rebalance_beats_the_single_device_supersteps_on_the_skewed_star():
    """The skewed star's work hangs off one root candidate: chunk-splitting
    spreads it over the lanes, in fewer dispatches than one device needs."""
    cs, an, plan = reference_plan("star", encoding="all_black",
                                  order=[0, 1, 2])
    plan = plan_from_arrays(dataclasses.asdict(plan))
    single = VectorEngine(cs, an, device="cpu", tile_rows=16,
                          plan=plan).run(limit=10 ** 9)
    shd = VectorEngine(cs, an, device="cpu", tile_rows=16, plan=plan,
                       mesh=_lanes(4)).run(limit=10 ** 9)
    assert shd.count == single.count
    assert shd.stats.shard_rebalances > 0
    assert shd.stats.supersteps < single.stats.supersteps


@pytest.mark.parametrize("i", range(len(SB_CASES)),
                         ids=[cid for cid, _ in SB_CASES])
def test_sharded_superbatch_equals_the_reference(i, reference, monkeypatch):
    _, case = SB_CASES[i]
    case = dict(case)
    s = case.pop("mesh")
    name = case.pop("workload")
    encoding = case.pop("encoding", "cost")
    limit = case.pop("limit", 10 ** 9)
    runs = case.pop("runs", 1)
    for key in ("kind", "batch"):
        case.pop(key)
    if "overflow_limit" in case:
        monkeypatch.setattr(sched, "OVERFLOW_LIMIT", case.pop("overflow_limit"))
    sched._PROGRAMS.clear()
    want = reference["sb"][i]
    buckets = reference_buckets(name, encoding=encoding,
                                tile_rows=case.get("tile_rows", 256))
    assert len(buckets) == len(want) > 0
    data, queries = BATCH_WORKLOADS[name]()
    for (indices, plans), w in zip(buckets, want):
        sb = ShardedSuperbatchScheduler(
            [plan_from_arrays(dataclasses.asdict(p)) for p in plans],
            mesh=_lanes(s), **case)
        assert sb.device == CPU
        for _ in range(runs):
            counts, st, timed_out = sb.run(limit=limit)
        assert indices == w["indices"]
        assert counts == w["counts"]
        assert timed_out == w["timed_out"]
        assert dataclasses.asdict(st) == w["stats"]
        assert st.shard_lanes > 0 and st.batched_queries == len(indices)
        ref = [min(cemr_match(queries[j], data, encoding=encoding).count,
                   limit) for j in indices]
        assert counts == ref


def test_a_dead_lane_leaves_its_rings_unchanged(monkeypatch):
    """The reference pads a dispatch with all-dead lanes; the port skips
    them. That is sound because a step over an all-dead item (zeros shaped
    like a real one, as the reference's `_dead_item` builds it) leaves
    every ring buffer of its lane as it was and adds nothing to any count —
    checked here on both lanes at every boundary a run dispatched, with
    the rings warm."""
    cs, an, plan = reference_plan("failing")
    eng = VectorEngine(cs, an, device="cpu", tile_rows=8, mesh=_lanes(2),
                       plan=plan_from_arrays(dataclasses.asdict(plan)))
    seen = {}
    dispatch = ShardedTileScheduler._dispatch

    def record(self, b, lanes):
        seen.setdefault(b, lanes[0])
        return dispatch(self, b, lanes)

    monkeypatch.setattr(ShardedTileScheduler, "_dispatch", record)
    eng.run(limit=10 ** 9)
    sch = eng._scheduler
    assert 0 in seen and len(seen) > 1
    for rings in (sch._buffers, sch._fail_buffers):
        assert all(any(bool(buf["valid"].any()) for buf in lane.values())
                   for lane in rings)
    for b, (_b, tile, r, _cursor, _total, part) in seen.items():
        step, _, seg_cer, seg_fail, _, _ = sch._shard_fn(b)
        dead = {"idx": torch.zeros_like(tile["idx"]),
                "bm": {u: torch.zeros_like(c) for u, c in tile["bm"].items()},
                "alive": torch.zeros_like(tile["alive"])}
        dead_part = None if part is None else torch.zeros_like(part)
        for lane in (0, 1):
            bufs = {si: sch._buffers[lane][si] for si in seg_cer}
            fbufs = {si: sch._fail_buffers[lane][si] for si in seg_fail}
            (_, _, cnt, ovf, packed, _, bufs2, fbufs2) = step(
                dead, torch.zeros_like(r), 0, bufs, fbufs, eng.tables,
                eng.masks, part=dead_part)
            assert int(cnt) == 0 and not bool(ovf)
            assert not bool(packed.any()), (b, packed)
            for new, old in ((bufs2, bufs), (fbufs2, fbufs)):
                for si, buf in old.items():
                    for k, v in buf.items():
                        assert torch.equal(new[si][k], v), (b, si, k)


# ---------------------------------------------------------------- helpers

def test_partition_bitmap_is_bit_equal_to_the_reference():
    rng = np.random.default_rng(0)
    for words in (1, 2, 7, 33):
        for shards in (1, 2, 3, 4, 8):
            for fill in (0.0, 0.05, 0.5, 1.0):
                bits = rng.random(32 * words) < fill
                mask = np.packbits(bits, bitorder="little").view(np.uint32)
                for weights in (None, rng.uniform(1, 10, 32 * words),
                                rng.integers(1, 4, 32 * words).astype(
                                    np.float64)):
                    got = partition_bitmap(mask, weights, shards)
                    want = ref_partition(mask, weights, shards)
                    assert got[0].dtype == want[0].dtype == np.uint32
                    assert got[1].dtype == want[1].dtype
                    assert np.array_equal(got[0], want[0])
                    assert np.array_equal(got[1], want[1])
                    acc = np.bitwise_or.reduce(got[0], axis=0)
                    assert np.array_equal(acc, mask)


@pytest.mark.parametrize("encoding", ["cost", "all_black", "all_white",
                                      "case12"])
def test_root_extension_weights_are_bit_equal_to_the_reference(encoding):
    for name in ("fig1", "random0", "random2", "brother", "synthetic",
                 "packing", "star", "clique6", "batch1:3"):
        _cs, _an, plan = reference_plan(name, encoding=encoding)
        want = ref_root_weights(plan)
        got = root_extension_weights(
            plan_from_arrays(dataclasses.asdict(plan)))
        assert got.dtype == want.dtype == np.float64
        assert got.tobytes() == want.tobytes()


def test_enum_mesh_and_make_enum_mesh(monkeypatch):
    assert make_enum_mesh(4, "cpu") is None       # one CPU lane: clamped
    assert make_enum_mesh(None, "cpu") is None
    mesh = EnumMesh(("cpu",) * 3)
    assert mesh.size == 3 and mesh.devices == (CPU,) * 3
    with pytest.raises(ValueError):
        EnumMesh(())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh_mod.lane_devices("cuda") == [torch.device("cuda", i)
                                             for i in range(3)]
    got = make_enum_mesh(8, "cuda")
    assert got.devices == tuple(torch.device("cuda", i) for i in range(3))
    assert make_enum_mesh(2, "cuda").size == 2
    assert make_enum_mesh(1, "cuda") is None
    # a mesh is a value: equal lanes give equal, hashable meshes
    assert make_enum_mesh(2, "cuda") == make_enum_mesh(2, "cuda")
    assert len({make_enum_mesh(2, "cuda"), make_enum_mesh(2, "cuda")}) == 1


# ------------------------------------------------------------ the Matcher

@pytest.fixture
def four_cpu_lanes(monkeypatch):
    """The port's lane devices for a CPU Matcher: four CPU lanes."""
    monkeypatch.setattr(mesh_mod, "lane_devices", lambda device: [CPU] * 4)
    monkeypatch.setattr(os, "cpu_count", lambda: 16)


@pytest.mark.parametrize("i", range(3))
def test_matcher_count_with_mesh_equals_the_reference(i, reference,
                                                      four_cpu_lanes):
    case = MATCHER_CASES[i]
    query, data = workload(case["workload"])
    m = Matcher(Dataset.from_graph(port_graph(data)), device="cpu")
    out = m.count(port_graph(query), **case["options"])
    want = reference["matcher"][i][0]
    assert out.count == want["count"]
    assert dataclasses.asdict(out.stats) == want["stats"]
    assert out.stats.shard_lanes > 0
    eng = next(iter(m.compile(port_graph(query))._engines.values()))
    assert isinstance(eng._scheduler, ShardedTileScheduler)
    assert eng.mesh.size == 4


def test_matcher_match_many_with_mesh_equals_the_reference(reference,
                                                           four_cpu_lanes):
    case = MATCHER_CASES[3]
    data, queries = BATCH_WORKLOADS[case["workload"]]()
    m = Matcher(Dataset.from_graph(port_graph(data)), device="cpu")
    outs = m.match_many([port_graph(q) for q in queries], **case["options"])
    want = reference["matcher"][3]
    assert [o.count for o in outs] == [w["count"] for w in want]
    assert [dataclasses.asdict(o.stats) for o in outs] == \
        [w["stats"] for w in want]
    assert any(isinstance(s, ShardedSuperbatchScheduler)
               for s in m._batch_cache.values())
    assert any(o.stats.batched_queries >= 2 and o.stats.shard_lanes > 0
               for o in outs)


def test_matcher_mesh_auto_over_four_lanes(four_cpu_lanes):
    """mesh="auto" resolves through the reference's cost model over the
    lane devices: four lanes for a large workload, the single-device path
    for a small one — whose count and stats equal mesh=None's."""
    from repro.api.options import auto_mesh_devices as ref_auto
    query, data = workload("synthetic")
    ds = Dataset.from_graph(port_graph(data))
    q = port_graph(query)
    m = Matcher(ds, device="cpu")
    opts = MatchOptions(mesh="auto")
    assert ref_auto(10 ** 6, n_devices=4, cpu_count=16, platform="cpu") == 4
    mesh = m._resolve_mesh(opts, total_rows=10 ** 6)
    assert mesh == EnumMesh((CPU,) * 4)
    assert m._resolve_mesh(opts, total_rows=10 ** 6) is mesh   # memoized
    assert m._resolve_mesh(opts, total_rows=100) is None
    kw = dict(engine="vector", tile_rows=8)
    auto = Matcher(ds, device="cpu").count(q, mesh="auto", **kw)
    single = Matcher(ds, device="cpu").count(q, mesh=None, **kw)
    assert auto.stats.shard_lanes == 0
    assert auto.count == single.count
    assert dataclasses.asdict(auto.stats) == dataclasses.asdict(single.stats)
    four = Matcher(ds, device="cpu").count(q, mesh=4, **kw)
    assert four.count == single.count and four.stats.shard_lanes > 0
    outs = Matcher(ds, device="cpu").match_many([q, q], mesh="auto", **kw)
    assert [o.count for o in outs] == [single.count] * 2


def test_mesh_one_is_the_plain_scheduler():
    """mesh=1 resolves to None and runs the unsharded scheduler —
    bit-for-bit the no-mesh path (same scheduler class, identical stats
    from a cold engine)."""
    query, data = workload("fig1")
    ds = Dataset.from_graph(port_graph(data))
    q = port_graph(query)
    opts = MatchOptions(engine="vector", limit=10 ** 9)
    base = Matcher(ds, device="cpu").count(q, opts)
    m = Matcher(ds, device="cpu")
    one = m.count(q, opts, mesh=1)
    assert one.count == base.count
    assert one.stats.shard_lanes == 0
    assert dataclasses.asdict(base.stats) == dataclasses.asdict(one.stats)
    assert m._resolve_mesh(opts.replace(mesh=1)) is None
    eng = next(iter(m.compile(q)._engines.values()))
    assert type(eng._scheduler) is TileScheduler


def test_mesh_option_validation():
    with pytest.raises(ValueError, match="mesh"):
        MatchOptions(mesh=0)
    with pytest.raises(ValueError, match="mesh"):
        MatchOptions(mesh="all")
    with pytest.raises(ValueError, match="mesh"):
        MatchOptions(mesh=True)
    assert MatchOptions(mesh="auto").mesh == "auto"
    assert MatchOptions(mesh=4).mesh == 4
