"""repro_torch's streaming half against the JAX package's, on the CPU.

The same seeded graphs and deltas go through `repro.streaming` /
`repro.api` and their copies in `repro_torch`: the deltas, their
canonical lowering, the maintained CSRs and every `DataGraphIndex` array
(incremental and forced-rebuild branches), the pinned delta enumeration,
the Dataset's version log, and `Matcher.count_delta` outcome for outcome
with its plan-cache counters. The reference's vector engine does not
import on this host's JAX, so the port's vector engine is held against
the reference's ref engine on the reference's graph, maintained through
the same deltas by the reference's `apply_delta_reference`."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from strategies import delta_workload  # noqa: E402
from torch_reference import port_graph  # noqa: E402

from repro.api import Dataset as RefDataset  # noqa: E402
from repro.api import GraphDelta as RefGraphDelta  # noqa: E402
from repro.api import Matcher as RefMatcher  # noqa: E402
from repro.api.dataset import _DELTA_LOG_MAX as REF_DELTA_LOG_MAX  # noqa: E402
from repro.core.filtering import build_data_index as ref_build_index  # noqa: E402
from repro.core.graph import build_graph as ref_build_graph  # noqa: E402
from repro.streaming import apply_delta as ref_apply_delta  # noqa: E402
from repro.streaming import \
    apply_delta_reference as ref_apply_reference  # noqa: E402
from repro.streaming import random_delta as ref_random_delta  # noqa: E402
from repro.streaming.delta import \
    canonicalize_delta as ref_canonicalize  # noqa: E402
from repro.streaming.standing import \
    embeddings_touching as ref_touching  # noqa: E402
from repro_torch.api import Dataset, GraphDelta, Matcher  # noqa: E402
from repro_torch.api.dataset import _DELTA_LOG_MAX  # noqa: E402
from repro_torch.core.filtering import build_data_index  # noqa: E402
from repro_torch.core.graph import build_graph  # noqa: E402
from repro_torch.streaming import (DeltaOverflow, apply_delta,  # noqa: E402
                                   apply_delta_reference, random_delta)
from repro_torch.streaming.delta import canonicalize_delta  # noqa: E402
from repro_torch.streaming.standing import embeddings_touching  # noqa: E402

GRAPH_FIELDS = ("labels", "indptr", "indices", "edge_labels",
                "in_indptr", "in_indices", "in_edge_labels")
INDEX_FIELDS = ("deg_out", "deg_in", "nbr_label_counts", "lab_indptr",
                "lab_indices", "lab_edge_labels", "in_lab_indptr",
                "in_lab_indices", "in_lab_edge_labels")
DELTA_FIELDS = ("edge_inserts", "edge_deletes", "edge_insert_labels",
                "vertex_inserts", "vertex_deletes")
CANON_FIELDS = ("out_ins_src", "out_ins_dst", "out_ins_el", "out_del_src",
                "out_del_dst", "touched", "ins_pairs", "del_pairs",
                "new_labels")
OUTCOME_FIELDS = ("count", "created", "destroyed", "graph_version",
                  "fallback", "inexact")


def eq(a, b):
    """Bit-identity for optional arrays: same presence, dtype, shape, data."""
    if a is None or b is None:
        return (a is None) == (b is None)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def assert_same_state(got, want, ctx=""):
    """A port (graph, index) bit-identical to a reference one."""
    g_got, i_got = got
    g_want, i_want = want
    for f in GRAPH_FIELDS:
        assert eq(getattr(g_got, f), getattr(g_want, f)), f"{ctx} graph.{f}"
    assert (g_got.n_labels, g_got.directed) == (g_want.n_labels,
                                                g_want.directed), ctx
    for f in INDEX_FIELDS:
        assert eq(getattr(i_got, f), getattr(i_want, f)), f"{ctx} index.{f}"
    assert i_got.width == i_want.width, ctx
    assert set(i_got.by_label) == set(i_want.by_label), ctx
    for lbl, bucket in i_want.by_label.items():
        assert eq(i_got.by_label[lbl], bucket), f"{ctx} by_label[{lbl}]"


def port_delta(d):
    """A reference GraphDelta as the port's."""
    return GraphDelta(**{f: getattr(d, f) for f in DELTA_FIELDS})


def outcome_fields(out):
    return tuple(getattr(out, f) for f in OUTCOME_FIELDS)


REGIMES = [(False, None), (False, 2), (True, None), (True, 2)]


@pytest.mark.parametrize("directed,n_el", REGIMES)
def test_random_and_canonical_deltas_equal_the_reference(directed, n_el):
    for seed in range(6):
        data, _, _ = delta_workload(seed, directed=directed,
                                    n_edge_labels=n_el, n_deltas=0)
        g = port_graph(data)
        for k in range(3):
            kw = dict(n_edge_inserts=4, n_edge_deletes=4,
                      n_vertex_inserts=k % 2, n_vertex_deletes=k // 2)
            want = ref_random_delta(data, seed * 7 + k, **kw)
            got = random_delta(g, seed * 7 + k, **kw)
            for f in DELTA_FIELDS:
                assert eq(getattr(got, f), getattr(want, f)), (seed, k, f)
            cw, cg = ref_canonicalize(data, want), canonicalize_delta(g, got)
            assert (cg.n_old, cg.n_new) == (cw.n_old, cw.n_new)
            for f in CANON_FIELDS:
                assert eq(getattr(cg, f), getattr(cw, f)), (seed, k, f)


@pytest.mark.parametrize("directed,n_el", REGIMES)
def test_apply_delta_is_bit_identical_to_the_reference(directed, n_el):
    """Both maintenance branches of the port against the reference's patch
    path, delta after delta, and against its rebuild oracle."""
    for seed in range(6):
        data, _, deltas = delta_workload(seed, directed=directed,
                                         n_edge_labels=n_el, n_deltas=3)
        rg, ridx = data, ref_build_index(data)
        g, idx = port_graph(data), build_data_index(port_graph(data))
        for k, d in enumerate(deltas):
            ctx = f"seed={seed} k={k}"
            rg2, ridx2, rsum = ref_apply_delta(rg, ridx, d, force="patch")
            for force in ("patch", "rebuild"):
                g2, idx2, summ = apply_delta(g, idx, port_delta(d),
                                             force=force)
                assert_same_state((g2, idx2), (rg2, ridx2),
                                  f"{ctx} {force}")
                assert summ.touched_labels == rsum.touched_labels
                assert (summ.size, summ.n_touched, summ.dirtiness) == \
                    (rsum.size, rsum.n_touched, rsum.dirtiness)
            oracle = apply_delta_reference(g, port_delta(d))
            assert_same_state((oracle, build_data_index(oracle)),
                              (rg2, ridx2), f"{ctx} oracle")
            g, idx = apply_delta(g, idx, port_delta(d))[:2]
            rg, ridx = rg2, ridx2


def test_apply_delta_path_choice_and_validation_match_the_reference():
    rg = ref_build_graph(4, [(0, 1), (1, 2), (2, 3), (3, 0)], [0, 1, 0, 1])
    g = port_graph(rg)
    d = dict(edge_inserts=[(0, 2)])
    for frac in (0.9, 0.1):
        want = ref_apply_delta(rg, ref_build_index(rg), RefGraphDelta(**d),
                               rebuild_fraction=frac)[2]
        got = apply_delta(g, build_data_index(g), GraphDelta(**d),
                          rebuild_fraction=frac)[2]
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for bad in (dict(edge_inserts=[(0, 0)]), dict(edge_deletes=[(0, 2)]),
                dict(edge_inserts=[(0, 1)]), dict(vertex_deletes=[7]),
                dict(edge_inserts=[(0, 2)], vertex_deletes=[2])):
        with pytest.raises(ValueError) as want:
            ref_canonicalize(rg, RefGraphDelta(**bad))
        with pytest.raises(ValueError) as got:
            canonicalize_delta(g, GraphDelta(**bad))
        assert str(got.value) == str(want.value)


def test_embeddings_touching_equals_the_reference():
    for seed in range(6):
        data, query, deltas = delta_workload(seed, n=50, n_deltas=1,
                                             edge_ops=5, vertex_ops=1)
        if query is None:
            continue
        d = deltas[0]
        c = ref_canonicalize(data, d)
        g2 = apply_delta_reference(port_graph(data), port_delta(d))
        rg2 = ref_apply_delta(data, ref_build_index(data), d)[0]
        q = port_graph(query)
        for pairs, gp, rgp in ((c.del_pairs, port_graph(data), data),
                               (c.ins_pairs, g2, rg2)):
            want = ref_touching(query, rgp, ref_build_index(rgp), pairs,
                                limit=10 ** 6)
            got = embeddings_touching(q, gp, build_data_index(gp), pairs,
                                      limit=10 ** 6)
            assert got == want, seed
            if want > 1:
                with pytest.raises(DeltaOverflow):
                    embeddings_touching(q, gp, build_data_index(gp), pairs,
                                        limit=want - 1)


def test_dataset_versions_and_delta_log_match_the_reference():
    """Version by version past the bounded log: summaries, signatures and
    every `deltas_since` answer equal the reference's."""
    assert _DELTA_LOG_MAX == REF_DELTA_LOG_MAX
    ref = RefDataset.random(40, 3.0, 3, seed=1)
    ds = Dataset.from_graph(port_graph(ref.graph))
    n = _DELTA_LOG_MAX + 6
    for k in range(n):
        d = ref_random_delta(ref.graph, k, n_edge_inserts=1,
                             n_edge_deletes=1, n_vertex_inserts=int(k % 3 == 0))
        want = ref.apply_delta(d)
        got = ds.apply_delta(port_delta(d))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), k
        assert ds.graph_version == ref.graph_version == k + 1
        assert ds.signature == ref.signature
        if k in (0, _DELTA_LOG_MAX - 1, n - 1):
            for v in range(-1, ds.graph_version + 2):
                assert ds.deltas_since(v) == ref.deltas_since(v), (k, v)
    assert_same_state((ds.graph, ds.index), (ref.graph, ref.index))
    assert repr(ds) == repr(ref)
    with pytest.raises(ValueError):
        ds.apply_delta(GraphDelta(edge_inserts=[(0, 0)]))
    assert ds.graph_version == n


# ---------------------------------------------------------- Matcher layer

def _square():
    return ref_build_graph(4, [(0, 1), (1, 2), (2, 3), (3, 0)],
                           [0, 0, 0, 0])


def _script_recount():
    """test_streaming's full-recount workload: one query, three deltas with
    vertex inserts, the base seeded by a count."""
    ds = RefDataset.random(200, 6.0, 3, seed=4)
    q = ds.random_query(4, seed=21)
    steps = [("count", q, {})]
    g = ds.graph
    for k in range(3):
        d = ref_random_delta(g, 500 + k, n_edge_inserts=4, n_edge_deletes=4,
                             n_vertex_inserts=1)
        steps.append(("delta", q, d, {}))
        g = ref_apply_delta(g, ref_build_index(g), d)[0]
    return ds.graph, steps


def _script_list_and_fallback():
    ds = RefDataset.random(150, 5.0, 3, seed=8)
    q1, q2 = ds.random_query(4, seed=1), ds.random_query(5, seed=2)
    d = ref_random_delta(ds.graph, 77, n_edge_inserts=3, n_edge_deletes=3)
    return ds.graph, [("count", q1, {}), ("delta", [q1, q2], d, {})]


def _script_overflow():
    q = ref_build_graph(2, [(0, 1)], [0, 0])
    return _square(), [
        ("count", q, {}),
        ("delta", q, RefGraphDelta(edge_deletes=[(0, 1)]),
         {"delta_limit": 1}),
        ("delta", q, RefGraphDelta(edge_inserts=[(0, 1)]), {})]


def _script_single_vertex():
    g = ref_build_graph(3, [(0, 1), (1, 2)], [0, 0, 1])
    q = ref_build_graph(1, [], [0])
    return g, [("count", q, {}),
               ("delta", q, RefGraphDelta(vertex_inserts=[0, 1, 0]), {}),
               ("delta", q, RefGraphDelta(edge_inserts=[(0, 2)],
                                          vertex_deletes=[1]), {})]


def _script_inexact():
    q = ref_build_graph(2, [(0, 1)], [0, 0])
    return _square(), [
        ("delta", q, RefGraphDelta(edge_inserts=[(0, 2)]), {"limit": 2}),
        ("delta", q, RefGraphDelta(edge_deletes=[(0, 2)]), {})]


def _script_carry_forward():
    labels = [0, 1, 0, 1, 2, 2, 2]
    g = ref_build_graph(7, [(0, 1), (1, 2), (2, 3), (4, 5), (5, 6)], labels)
    q = ref_build_graph(3, [(0, 1), (1, 2)], [0, 1, 0])
    return g, [("count", q, {}),
               ("delta", q, RefGraphDelta(edge_inserts=[(4, 6)]), {}),
               ("count", q, {}),
               ("delta", q, RefGraphDelta(edge_deletes=[(2, 3)]), {}),
               ("count", q, {})]


SCRIPTS = {"recount": _script_recount,
           "list_and_fallback": _script_list_and_fallback,
           "overflow": _script_overflow,
           "single_vertex": _script_single_vertex,
           "inexact": _script_inexact,
           "carry_forward": _script_carry_forward}


def _run_script(matcher, steps, convert_q, convert_d, engine):
    """Each step's observable result plus the plan-cache counters after it."""
    out = []
    for step in steps:
        if step[0] == "count":
            _, q, kw = step
            res = matcher.count(convert_q(q), engine=engine, **kw)
            rec = ("count", res.count, res.graph_version, res.plan_cached)
        else:
            _, qs, d, kw = step
            qs2 = convert_q(qs) if not isinstance(qs, list) \
                else [convert_q(q) for q in qs]
            res = matcher.count_delta(qs2, convert_d(d), engine=engine, **kw)
            recs = res if isinstance(res, list) else [res]
            rec = ("delta", [outcome_fields(r) for r in recs])
        info = matcher.cache_info()
        out.append((rec, dataclasses.asdict(info)))
    return out


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_count_delta_ref_engine_equals_the_reference(script):
    data, steps = SCRIPTS[script]()
    want = _run_script(RefMatcher(RefDataset.from_graph(data)), steps,
                       lambda q: q, lambda d: d, "ref")
    got = _run_script(Matcher(Dataset.from_graph(port_graph(data)),
                              device="cpu"),
                      steps, port_graph, port_delta, "ref")
    assert got == want


def ref_recount(q, rg) -> int:
    """The reference's ref-engine count of reference query `q` on `rg`."""
    return RefMatcher(RefDataset.from_graph(rg)).count(q, engine="ref").count


@pytest.mark.parametrize("script", ["recount", "list_and_fallback",
                                    "carry_forward"])
def test_count_delta_vector_engine_equals_fresh_recounts(script):
    """On the CPU the port's vector engine rolls the same counts forward:
    each outcome equals the reference's ref-engine recount on the
    reference's graph after the same deltas, and the maintained graph and
    index equal the reference's rebuild oracle."""
    data, steps = SCRIPTS[script]()
    ds = Dataset.from_graph(port_graph(data))
    m = Matcher(ds, device="cpu", plan_cache_size=16)
    rg = data
    saw_identity = False
    for step in steps:
        if step[0] == "count":
            got = m.count(port_graph(step[1]), engine="vector",
                          tile_rows=8).count
            assert got == ref_recount(step[1], rg)
            continue
        _, qs, d, kw = step
        qs = qs if isinstance(qs, list) else [qs]
        outs = m.count_delta([port_graph(q) for q in qs], port_delta(d),
                             engine="vector", tile_rows=8, **kw)
        rg = ref_apply_reference(rg, d)
        assert_same_state((ds.graph, ds.index), (rg, ref_build_index(rg)))
        for q, out in zip(qs, outs):
            assert out.count == ref_recount(q, rg)
            assert out.graph_version == ds.graph_version
            saw_identity |= not out.fallback
    assert saw_identity


def test_carried_plan_keeps_its_device_tables_and_a_stale_one_drops_them():
    """A carried plan serves from the same engine (and its tables); a plan a
    delta's labels touched is compiled anew from the new graph, and the old
    entry's engines and warm superbatch schedulers are released. Counts are
    held against the reference's ref engine on the reference's graph."""
    labels = [0, 1, 0, 1, 2, 2, 2, 0, 1]
    edges = [(0, 1), (1, 2), (2, 3), (4, 5), (5, 6), (7, 8), (8, 0)]
    rg = ref_build_graph(9, edges, labels)
    ds = Dataset.from_graph(build_graph(9, edges, labels))
    m = Matcher(ds, device="cpu")
    ref_q = ref_build_graph(3, [(0, 1), (1, 2)], [0, 1, 0])
    q = port_graph(ref_q)
    q2 = build_graph(2, [(0, 1)], [0, 1])
    m.match_many([q, q2, q], engine="vector", tile_rows=8)
    m.count(q, engine="vector", tile_rows=8)
    cq = m.compile(q)
    eng = next(iter(cq._engines.values()))
    d = RefGraphDelta(edge_inserts=[(4, 6)])                    # label 2 only
    ds.apply_delta(port_delta(d))
    rg = ref_apply_reference(rg, d)
    assert m.count(q, engine="vector", tile_rows=8).count == \
        ref_recount(ref_q, rg)
    assert m.cache_info().carried == 1
    assert m.compile(q) is cq and next(iter(cq._engines.values())) is eng
    d = RefGraphDelta(edge_deletes=[(2, 3)])                    # labels 0, 1
    ds.apply_delta(port_delta(d))
    rg = ref_apply_reference(rg, d)
    out = m.count(q, engine="vector", tile_rows=8)
    assert out.count == ref_recount(ref_q, rg)
    new = m.compile(q)
    assert new is not cq and new.cs.data is ds.graph
    assert cq._engines == {}
    assert all(id(cq.plan) not in k[1] for k in m._batch_cache)
    assert m.cache_info().carried == 1


def test_tenant_view_shares_the_dataset_and_device_not_the_cache():
    ds = Dataset.from_graph(port_graph(RefDataset.random(80, 4.0, 2,
                                                         seed=5).graph))
    m = Matcher(ds, device="cpu", plan_cache_size=4)
    v = m.tenant_view("alice", plan_cache_size=2)
    assert (v.tenant, v.dataset, v.device) == ("alice", ds, m.device)
    q = ds.random_query(3, seed=1)
    assert v.count(q).count == m.count(q).count
    assert v.cache_info().misses == 1 and v.cache_info().maxsize == 2
    assert m.cache_info().misses == 1 and m.cache_info().maxsize == 4
