"""The torch port's cross-query superbatch (`Matcher.match_many`,
`SuperbatchScheduler`) on the CPU, against the reference.

Counts are held against `batch="off"`, the port's ref engine and the JAX
reference: its numpy `cemr_match` in this process, and its
`SuperbatchScheduler` on the same plans in one subprocess for the whole
file (torch_reference.py), whose per-bucket counts and `VectorStats` the
port's must equal field for field. The workloads are
tests/test_batch_differential.py's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from strategies import batch_workload, fig1_pair  # noqa: E402
from torch_reference import (BATCH_WORKLOADS, port_graph,  # noqa: E402
                             reference_buckets, run_reference)

import repro_torch.core.scheduler as sched  # noqa: E402
from repro.core.plan import \
    plan_shape_signature as ref_plan_shape_signature  # noqa: E402
from repro.core.ref_engine import cemr_match  # noqa: E402
from repro_torch.api import (BATCH_MODES, Dataset, MatchOptions,  # noqa: E402
                             Matcher)
from repro_torch.core.plan import (plan_from_arrays,  # noqa: E402
                                   plan_shape_signature)

# test_batch_differential.py's parity parametrisations:
# (encoding, tile_rows, use_cer_buffer, cer_buffer_slots)
PARITY = [("cost", 32, True, 256),
          ("cost", 16, True, 2),          # ring wraparound
          ("all_black", 16, True, 4),
          ("case12", 32, False, 256)]     # CER buffer off

# (workload, SuperbatchScheduler knobs and run options) held against the
# reference scheduler field for field
SB_CASES = (
    [("batch1", dict(encoding=enc, tile_rows=tr, use_cer_buffer=cer,
                     cer_buffer_slots=slots))
     for enc, tr, cer, slots in PARITY]
    + [("batch1", dict(encoding="cost", tile_rows=32, use_cer_buffer=True,
                       cer_buffer_slots=256, overlap=False)),
       ("batch1", dict(encoding="all_black", tile_rows=16,
                       use_cer_buffer=True, cer_buffer_slots=2,
                       overlap=False)),
       ("batch2", dict(encoding="cost", tile_rows=32, limit=50)),
       ("union", dict(encoding="all_white", tile_rows=32)),
       ("overflow", dict(encoding="cost", tile_rows=64,
                         overflow_limit=0.5)),
       ("failing", dict(encoding="cost", tile_rows=16, runs=2,
                        failure_cache_slots=2)),
       ("failing", dict(encoding="cost", tile_rows=16, max_steps=9))])

STACK_CASES = [("batch1", "cost"), ("batch1", "all_black"),
               ("union", "all_white")]


def _case_id(w, kw):
    return f"{w}-" + "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.fixture(scope="module")
def reference():
    """Every reference run of this file, in one subprocess."""
    cases = ([dict(kind="superbatch", workload=w, **kw) for w, kw in SB_CASES]
             + [dict(kind="stack", workload=w, encoding=enc)
                for w, enc in STACK_CASES])
    out = run_reference(cases, timeout=1200)
    return {"sb": out[:len(SB_CASES)], "stack": out[len(SB_CASES):]}


def _port(graph):
    return port_graph(graph)


def _counts(outs):
    return [o.count for o in outs]


def _batch_and_sequential(data, queries, opts, *, expect_ref=True):
    m = Matcher(Dataset.from_graph(_port(data)), device="cpu")
    qs = [_port(q) for q in queries]
    seq = m.match_many(qs, opts, batch="off")
    bat = m.match_many(qs, opts, batch="auto")
    assert _counts(seq) == _counts(bat)
    if expect_ref:
        ref = [m.count(q, opts, engine="ref").count for q in qs]
        assert ref == _counts(bat)
    return seq, bat


def _port_plans(plans):
    return [plan_from_arrays(dataclasses.asdict(p)) for p in plans]


@pytest.mark.parametrize("encoding,tile_rows,cer,slots", PARITY)
def test_batched_counts_match_sequential_ref_and_reference(
        encoding, tile_rows, cer, slots, reference):
    data, queries = BATCH_WORKLOADS["batch1"]()
    assert len(queries) >= 6
    opts = MatchOptions(engine="vector", tile_rows=tile_rows, limit=10**9,
                        encoding=encoding, use_cer_buffer=cer,
                        cer_buffer_slots=slots)
    seq, bat = _batch_and_sequential(data, queries, opts)
    # duplicate queries bucket together: at least one real superbatch ran
    stats = {id(o.stats): o.stats for o in bat}.values()
    assert any(s.batched_queries >= 2 for s in stats)
    assert all(s.leaf_tiles > 0 for s in stats if s.batched_queries)
    # the JAX reference: its numpy ref engine on every query, and its
    # SuperbatchScheduler on every bucket
    want = [cemr_match(q, data, encoding=encoding).count for q in queries]
    assert _counts(bat) == want
    i = PARITY.index((encoding, tile_rows, cer, slots))
    for bucket in reference["sb"][i]:
        assert [bat[j].count for j in bucket["indices"]] == bucket["counts"]
        assert all(bat[j].stats.batched_queries == len(bucket["indices"])
                   for j in bucket["indices"])


@pytest.mark.parametrize("case", range(len(SB_CASES)),
                         ids=[_case_id(w, kw) for w, kw in SB_CASES])
def test_superbatch_stats_match_the_reference_scheduler(case, reference,
                                                        monkeypatch):
    name, kw = SB_CASES[case]
    kw = dict(kw)
    encoding = kw.pop("encoding")
    limit = kw.pop("limit", 10 ** 9)
    max_steps = kw.pop("max_steps", None)
    runs = kw.pop("runs", 1)
    if "overflow_limit" in kw:
        monkeypatch.setattr(sched, "OVERFLOW_LIMIT", kw.pop("overflow_limit"))
    sched._PROGRAMS.clear()
    buckets = reference_buckets(name, encoding=encoding,
                                tile_rows=kw["tile_rows"])
    want = reference["sb"][case]
    assert len(buckets) == len(want) >= 1
    try:
        for (indices, plans), ref in zip(buckets, want):
            sb = sched.SuperbatchScheduler(_port_plans(plans), device="cpu",
                                           **kw)
            for _ in range(runs):
                counts, st, timed_out = sb.run(limit=limit,
                                               max_steps=max_steps)
            assert indices == ref["indices"]
            assert counts == ref["counts"]
            assert timed_out == ref["timed_out"]
            assert dataclasses.asdict(st) == ref["stats"]
            assert st.readbacks + st.overlapped_supersteps == st.supersteps
    finally:
        sched._PROGRAMS.clear()


def test_the_superbatch_cases_exercise_the_mechanisms(reference):
    stats = [b["stats"] for case in reference["sb"] for b in case]
    total = {k: sum(s[k] for s in stats)
             for k in ("cer_hits", "fail_hits", "packed_tiles",
                       "overlapped_supersteps", "leaf_overflows",
                       "bucket_recompiles")}
    assert all(v > 0 for v in total.values()), total
    assert any(b["timed_out"] for case in reference["sb"] for b in case)
    limited = reference["sb"][[w for w, _ in SB_CASES].index("batch2")]
    assert any(c == 50 for b in limited for c in b["counts"])


@pytest.mark.parametrize("name,encoding", STACK_CASES)
def test_plan_shape_signature_and_stacks_equal_the_reference(name, encoding,
                                                             reference):
    buckets = reference_buckets(name, encoding=encoding)
    want = reference["stack"][STACK_CASES.index((name, encoding))]
    assert len(buckets) == len(want) >= 1
    for (_indices, plans), ref in zip(buckets, want):
        ports = _port_plans(plans)
        sig = plan_shape_signature(ports[0], tile_rows=256)
        for p, pp in zip(plans, ports):
            assert plan_shape_signature(pp, tile_rows=256) == sig \
                == ref_plan_shape_signature(p, tile_rows=256)
        data = sched.stack_batch_inputs(sig, ports,
                                        sched._pow2ceil(len(ports)), "cpu")
        assert sorted(data["tables"]) == sorted(ref["tables"])
        for k, v in data["tables"].items():
            np.testing.assert_array_equal(
                v.numpy().view(np.uint32),
                np.asarray(ref["tables"][k], np.uint32))
        np.testing.assert_array_equal(
            data["mask_root"].numpy().view(np.uint32),
            np.asarray(ref["mask_root"], np.uint32))
        assert {k: v.tolist() for k, v in data["con"].items()} == ref["con"]


@pytest.mark.parametrize("tile_rows", [8, 256])
@pytest.mark.parametrize("name", ["batch1", "batch2", "union"])
def test_plan_shape_signature_equals_the_reference_on_every_plan(name,
                                                                 tile_rows):
    from repro.core.plan import build_plan
    from repro.core.ref_engine import preprocess
    data, queries = BATCH_WORKLOADS[name]()
    for enc in ("cost", "all_white"):
        for q in queries:
            cs, an = preprocess(q, data, encoding=enc)
            if any(c.shape[0] == 0 for c in cs.cand):
                continue
            plan = build_plan(cs, an)
            port = plan_from_arrays(dataclasses.asdict(plan))
            assert (plan_shape_signature(port, tile_rows=tile_rows)
                    == ref_plan_shape_signature(plan, tile_rows=tile_rows))


def test_batched_union_and_decompose_stages():
    data, queries = BATCH_WORKLOADS["union"]()
    opts = MatchOptions(engine="vector", tile_rows=32, limit=10**9,
                        encoding="all_white")
    _, bat = _batch_and_sequential(data, queries, opts)
    assert bat[0].stats.batched_queries == 2


def test_batched_leaf_overflow_falls_back_exact(monkeypatch):
    data, queries = BATCH_WORKLOADS["overflow"]()
    opts = MatchOptions(engine="vector", tile_rows=64, limit=10**9)
    m = Matcher(Dataset.from_graph(_port(data)), device="cpu")
    qs = [_port(q) for q in queries]
    base = _counts(m.match_many(qs, opts, batch="auto"))
    monkeypatch.setattr(sched, "OVERFLOW_LIMIT", 0.5)
    forced = Matcher(Dataset.from_graph(_port(data)),
                     device="cpu").match_many(qs, opts, batch="auto")
    assert _counts(forced) == base == [cemr_match(q, data).count
                                       for q in queries]
    assert forced[0].stats.leaf_overflows > 0


def test_batched_per_query_limit_clamps_identically():
    data, queries = BATCH_WORKLOADS["batch2"]()
    opts = MatchOptions(engine="vector", tile_rows=32, limit=50)
    seq, bat = _batch_and_sequential(data, queries, opts, expect_ref=False)
    assert all(o.count <= 50 for o in bat)
    assert any(o.count == 50 for o in bat)


def test_budget_pools_over_the_bucket():
    data, queries = BATCH_WORKLOADS["batch1"]()
    m = Matcher(Dataset.from_graph(_port(data)), device="cpu")
    qs = [_port(q) for q in queries]
    outs = m.match_many(qs, engine="vector", tile_rows=16, budget=2)
    for o in outs:
        if o.stats.batched_queries:
            assert o.timed_out
            assert o.stats.device_steps <= 2 * o.stats.batched_queries + 1


@pytest.mark.parametrize("directed,n_el", [(True, None), (False, 3),
                                           (True, 3)])
def test_batched_auto_falls_back_for_ref_engine_data(directed, n_el):
    data, queries = batch_workload(seed=7, n=40, deg=4.0, n_queries=3,
                                   dup=1, qsizes=(4,), power_law=False,
                                   directed=directed, n_edge_labels=n_el)
    assert len(queries) >= 2
    opts = MatchOptions(engine="auto", limit=10**9)
    seq, bat = _batch_and_sequential(data, queries, opts, expect_ref=False)
    assert all(o.engine == "ref" for o in bat)
    assert _counts(bat) == [cemr_match(q, data).count for q in queries]


def test_batch_mode_validation_and_sequential_fallbacks():
    data, query = fig1_pair()
    m = Matcher(Dataset.from_graph(_port(data)), device="cpu")
    q = _port(query)
    assert BATCH_MODES == ("auto", "off")
    with pytest.raises(ValueError, match="batch"):
        m.match_many([q, q], batch="always")
    # a forced intersect route, materialize and a single query all run
    # sequentially: no superbatch stats
    for kw in (dict(intersect="jnp"), dict(materialize=True), {}):
        qs = [q] if not kw else [q, q]
        outs = m.match_many(qs, engine="vector", **kw)
        assert all(o.stats.batched_queries == 0 for o in outs)
        assert _counts(outs) == [cemr_match(query, data).count] * len(qs)


def test_warm_scheduler_is_reused_and_cleared():
    data, queries = BATCH_WORKLOADS["batch1"]()
    m = Matcher(Dataset.from_graph(_port(data)), device="cpu")
    qs = [_port(q) for q in queries]
    first = _counts(m.match_many(qs, engine="vector", tile_rows=32))
    n = len(m._batch_cache)
    assert n >= 1
    again = m.match_many(qs, engine="vector", tile_rows=32)
    assert _counts(again) == first and len(m._batch_cache) == n
    # a warm scheduler's programs are built: no fresh supersteps
    assert all(o.stats.bucket_recompiles == 0 for o in again
               if o.stats.batched_queries)
    m.clear_cache()
    assert len(m._batch_cache) == 0


@pytest.mark.parametrize("poison", ["keys", "hash_and_valid"])
def test_poisoned_failure_buffers_never_change_batched_counts(poison):
    """The reference's buffer-poisoning harness on a warm superbatch: the
    failure rings are corrupted before the run and again after every
    superstep's fold-back (`fail_debug_hook`), so no clean entry is ever
    visible to a lookup. The exact-key verify must reject every candidate:
    zero failure hits and the counts of a clean run."""
    data, queries = BATCH_WORKLOADS["failing"]()
    m = Matcher(Dataset.from_graph(_port(data)), device="cpu")
    qs = [_port(q) for q in queries]
    opts = MatchOptions(engine="vector", limit=10**9, tile_rows=16,
                        failure_cache_slots=2)
    clean = m.match_many(qs, opts)
    sb = next(iter(m._batch_cache.values()))
    again = m.match_many(qs, opts)
    assert again[0].stats.fail_hits > 0          # the clean rings do hit

    def mutate(s):
        for si, buf in s._fail_buffers.items():
            if poison == "keys":
                buf = {**buf, "keys": torch.full_like(buf["keys"], -7777)}
            else:
                buf = {**buf, "hash": torch.full_like(buf["hash"], 777),
                       "valid": torch.ones_like(buf["valid"])}
            s._fail_buffers[si] = buf

    calls = {"n": 0}

    def hook(s):
        calls["n"] += 1
        mutate(s)

    mutate(sb)
    sb.fail_debug_hook = hook
    try:
        poisoned = m.match_many(qs, opts)
    finally:
        sb.fail_debug_hook = None
    assert calls["n"] > 0
    assert _counts(poisoned) == _counts(clean) == [
        cemr_match(q, data).count for q in queries]
    assert poisoned[0].stats.fail_hits == 0
