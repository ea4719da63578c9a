"""repro_torch's match runtime (queue, service, worker pool) on the CPU.

With `engine="ref"` the port's `MatchQueueRuntime` and `MatchService` run
the JAX package's own chaos scripts (tests/test_service.py,
tests/test_streaming.py) beside the reference's, on the same seeded graph
and queries: every request's terminal record and every stats dict must be
equal. With `engine="vector"` on the CPU their counts must equal the
sequential `Matcher(device="cpu")` counts, and a real `WorkerPool` of two
spawned CPU workers must drain through one SIGKILL and one hang with
bit-identical counts. The reference's vector engine does not import on
this host's JAX, so the vector runs are held against the reference's
`cemr_match` on the reference's graph, maintained by the reference's own
`apply_delta_reference` where deltas are applied. A kernel fault planted
under a pooled service must fail its requests on the card and may degrade
them to the ref engine only on the CPU."""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from torch_reference import port_graph  # noqa: E402

from repro.core.graph import build_graph as ref_build_graph  # noqa: E402
from repro.core.graph import random_walk_query  # noqa: E402
from repro.core.graph import synthetic_labeled_graph  # noqa: E402
from repro.core.ref_engine import cemr_match  # noqa: E402
from repro.streaming import GraphDelta as RefGraphDelta  # noqa: E402
from repro.streaming import apply_delta_reference  # noqa: E402
from repro.streaming import random_delta as ref_random_delta  # noqa: E402
from repro_torch.api import Dataset, GraphDelta, Matcher  # noqa: E402
from repro_torch.api import MatchOptions  # noqa: E402
from repro_torch.kernels import bitmap_intersect  # noqa: E402
from repro_torch.runtime import (FaultInjector, MatchQueueRuntime,  # noqa: E402
                                 MatchService, ServiceConfig)
from repro_torch.runtime.queue import execute_chunk  # noqa: E402
from repro_torch.runtime.workers import BucketResult  # noqa: E402

DELTA_FIELDS = ("edge_inserts", "edge_deletes", "edge_insert_labels",
                "vertex_inserts", "vertex_deletes")


class ManualClock:
    """Deterministic service clock: scripts advance it explicitly."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _side(port: bool):
    """One package's runtime surface, with its graph/delta converters and
    the keyword arguments that place it (the port on the CPU)."""
    if port:
        from repro_torch.runtime import ft, queue, service
        return types.SimpleNamespace(
            service=service, queue=queue, FaultInjector=ft.FaultInjector,
            MatchOptions=MatchOptions, graph=port_graph,
            delta=lambda d: GraphDelta(**{f: getattr(d, f)
                                          for f in DELTA_FIELDS}),
            kw={"device": "cpu"})
    from repro.api import MatchOptions as RefMatchOptions
    from repro.runtime import ft, queue, service
    return types.SimpleNamespace(
        service=service, queue=queue, FaultInjector=ft.FaultInjector,
        MatchOptions=RefMatchOptions, graph=lambda g: g, delta=lambda d: d,
        kw={})


@pytest.fixture(scope="module")
def data():
    return synthetic_labeled_graph(60, 5.0, 3, seed=0, power_law=False)


@pytest.fixture(scope="module")
def queries(data):
    return [random_walk_query(data, 4, seed=s) for s in range(8)]


@pytest.fixture(scope="module")
def expected(data, queries):
    return [cemr_match(q, data, limit=10 ** 9).count for q in queries]


def _svc_record(svc) -> dict:
    """Everything of a service's terminal state that does not read a clock
    that tests cannot fix."""
    return {"stats": dict(svc.stats),
            "tenant_stats": {t: dict(v) for t, v in svc.tenant_stats.items()},
            "results": {rid: (r.tenant, r.priority, r.count, r.ok, r.shed,
                              r.failed, r.deadline_missed, r.attempts,
                              r.engine)
                        for rid, r in sorted(svc.results.items())}}


def _ticket(t) -> tuple:
    return (type(t).__name__, t.request_id, getattr(t, "reason", None))


def _convert(s, data, qs):
    return s.graph(data), [s.graph(q) for q in qs]


def _workload(qs, **kw):
    return [dict(query=q, limit=10 ** 9, max_steps=None, **kw) for q in qs]


# ----------------------------------------------------------- service scripts
def svc_drain(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    svc = s.service.MatchService(data, options=s.MatchOptions(engine="ref"),
                                 **s.kw)
    tickets = [svc.submit(q, limit=10 ** 9, max_steps=None) for q in qs]
    polled = [svc.result(t.request_id) for t in tickets]
    counts = svc.drain()
    return [_ticket(t) for t in tickets], polled, counts, _svc_record(svc)


def svc_inbox_full(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    svc = s.service.MatchService(
        data, config=s.service.ServiceConfig(inbox_capacity=4),
        options=s.MatchOptions(engine="ref"), **s.kw)
    tickets = [svc.submit(q, limit=10 ** 9) for q in qs]
    hints = [t.retry_after_s for t in tickets if hasattr(t, "retry_after_s")]
    return [_ticket(t) for t in tickets], hints, svc.drain(), \
        _svc_record(svc)


def svc_deadline_budget(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    svc = s.service.MatchService(
        data, config=s.service.ServiceConfig(prior_service_s=1.0),
        options=s.MatchOptions(engine="ref"), **s.kw)
    t0 = svc.submit(qs[0], deadline_s=0.5)
    t1 = svc.submit(qs[1], deadline_s=0.5)
    return _ticket(t0), _ticket(t1), t1.est_wait_s, svc.drain(), \
        _svc_record(svc)


def svc_flush_headroom(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    clock = ManualClock()
    cfg = s.service.ServiceConfig(bucket_size=8, flush_headroom_s=0.05,
                                  prior_service_s=0.01)
    svc = s.service.MatchService(data, config=cfg, clock=clock,
                                 options=s.MatchOptions(engine="ref"),
                                 **s.kw)
    for q in qs[:2]:
        svc.submit(q, priority="interactive", deadline_s=0.2, limit=10 ** 9,
                   max_steps=None)
    first = svc.step()
    clock.advance(0.15)
    second = svc.step()
    return first, second, _svc_record(svc)


def svc_expired(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    clock = ManualClock()
    svc = s.service.MatchService(data, clock=clock,
                                 options=s.MatchOptions(engine="ref"),
                                 **s.kw)
    svc.submit(qs[0], deadline_s=0.1)
    clock.advance(1.0)
    return svc.drain(), _svc_record(svc)


def svc_starvation(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    cfg = s.service.ServiceConfig(bucket_size=1, starvation_limit=2)
    svc = s.service.MatchService(data, config=cfg,
                                 options=s.MatchOptions(engine="ref"),
                                 **s.kw)
    svc.submit(qs[0], priority="batch", limit=10 ** 9, max_steps=None)
    for q in qs[1:7]:
        svc.submit(q, priority="interactive", limit=10 ** 9, max_steps=None)
    for _ in range(3):
        svc.step(force=True)
    mid = _svc_record(svc)
    return mid, svc.drain(), _svc_record(svc)


def svc_executor_death(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    svc = s.service.MatchService(data, options=s.MatchOptions(engine="ref"),
                                 **s.kw)
    for q in qs:
        svc.submit(q, limit=10 ** 9, max_steps=None)
    hits = {"n": 0}

    def fail_hook(req):
        if req.request_id == 1 and hits["n"] < 2:
            hits["n"] += 1
            raise RuntimeError("injected executor death")

    return svc.drain(fail_hook=fail_hook), _svc_record(svc)


def svc_poison(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    svc = s.service.MatchService(
        data, config=s.service.ServiceConfig(max_attempts=2),
        options=s.MatchOptions(engine="ref"), **s.kw)
    for q in qs:
        svc.submit(q, limit=10 ** 9, max_steps=None)

    def fail_hook(req):
        if req.request_id == 3:
            raise RuntimeError("poison query")

    return svc.drain(fail_hook=fail_hook), _svc_record(svc)


def svc_kill_restore(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    cfg = s.service.ServiceConfig(bucket_size=2,
                                  state_path=str(tmp / "svc.json"))
    executions = []
    sup = s.service.ServiceSupervisor(
        lambda: s.service.MatchService(
            data, config=cfg, options=s.MatchOptions(engine="ref"), **s.kw),
        _workload(qs))
    res = sup.run(injector=s.FaultInjector(fail_at={2}),
                  fail_hook=lambda req: executions.append(req.request_id))
    return res.restarts, res.counts, executions, _svc_record(res.service)


def svc_probabilistic_chaos(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    cfg = s.service.ServiceConfig(bucket_size=2,
                                  state_path=str(tmp / "chaos.json"))
    sup = s.service.ServiceSupervisor(
        lambda: s.service.MatchService(
            data, config=cfg, options=s.MatchOptions(engine="ref"), **s.kw),
        _workload(qs), max_restarts=64)
    res = sup.run(injector=s.FaultInjector(fail_rate=0.25, rng_seed=7))
    return res.restarts, res.counts, _svc_record(res.service)


def svc_restart_under_restart(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    cfg = s.service.ServiceConfig(bucket_size=2,
                                  state_path=str(tmp / "svc.json"))
    crash = {"armed": 1}

    class CrashOnRestore(s.service.MatchService):
        def restore(self):
            state = super().restore()
            if state is not None and crash["armed"]:
                crash["armed"] -= 1
                raise RuntimeError("killed mid-restore")
            return state

    executions = []
    sup = s.service.ServiceSupervisor(
        lambda: CrashOnRestore(data, config=cfg,
                               options=s.MatchOptions(engine="ref"), **s.kw),
        _workload(qs))
    res = sup.run(injector=s.FaultInjector(fail_at={1}),
                  fail_hook=lambda req: executions.append(req.request_id))
    return res.restarts, res.counts, sorted(executions), \
        _svc_record(res.service)


def svc_corrupt_checkpoint(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    path = str(tmp / "svc.json")
    cfg = s.service.ServiceConfig(bucket_size=2, state_path=path)
    mk = lambda: s.service.MatchService(  # noqa: E731
        data, config=cfg, options=s.MatchOptions(engine="ref"), **s.kw)
    svc = mk()
    for kw in _workload(qs):
        svc.submit(**kw)
    svc.drain()
    with open(path, "w") as f:
        f.write('{"results": {"0"')
    svc2 = mk()
    for kw in _workload(qs):
        svc2.submit(**kw, force=True)
    svc2.restore()
    return svc2.drain(), _svc_record(svc2)


def svc_shed_backoff(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    cfg = s.service.ServiceConfig(inbox_capacity=1, backoff_seed=7)
    svc = s.service.MatchService(data, config=cfg,
                                 options=s.MatchOptions(engine="ref"),
                                 **s.kw)
    svc.submit(qs[0], limit=10 ** 9, max_steps=None)
    hints = [svc.submit(qs[1], limit=10 ** 9, max_steps=None).retry_after_s
             for _ in range(4)]
    other = svc.submit(qs[1], tenant="other", limit=10 ** 9, max_steps=None)
    streak = svc._shed_streak["default"]
    svc.drain()
    accepted = svc.submit(qs[0], limit=10 ** 9, max_steps=None)
    fresh = svc.submit(qs[1], limit=10 ** 9, max_steps=None)
    return hints, _ticket(other), other.retry_after_s, streak, \
        _ticket(accepted), _ticket(fresh), svc._shed_streak, \
        _svc_record(svc)


def svc_tenants(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    cfg = s.service.ServiceConfig(tenant_plan_cache_size=2)
    svc = s.service.MatchService(data, config=cfg,
                                 options=s.MatchOptions(engine="ref"),
                                 **s.kw)
    svc.submit(qs[0], tenant="alice", limit=10 ** 9, max_steps=None)
    svc.drain()
    for q in qs[1:4]:
        svc.submit(q, tenant="bob", limit=10 ** 9, max_steps=None)
    svc.drain()
    svc.submit(qs[0], tenant="alice", limit=10 ** 9, max_steps=None)
    svc.drain()
    infos = {t: dataclasses.asdict(svc.matcher_for(t).cache_info())
             for t in ("alice", "bob")}
    return infos, _svc_record(svc)


# ------------------------------------------------------------- queue scripts
def _queue_record(rt) -> dict:
    return {"stats": dict(rt.stats),
            "results": {i: (r.count, r.done, r.attempts)
                        for i, r in sorted(rt.results.items())},
            "standing": {sid: (sq.count, sq.graph_version, sq.deltas_seen,
                               sq.fallbacks, sq.inexact)
                         for sid, sq in sorted(rt.standing.items())}}


def queue_straggler(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    rt = s.queue.MatchQueueRuntime(data, engine="ref", deadline_s=0.0,
                                   **s.kw)
    rt.submit(qs[:5], limit=10 ** 9)
    return rt.run(), _queue_record(rt)


def queue_poison_checkpoint_restore(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    path = str(tmp / "queue.json")
    poison = qs[2]
    executed = []

    def hook(item):
        executed.append(item.query_id)
        if item.query is poison:
            raise RuntimeError("poison")

    rt = s.queue.MatchQueueRuntime(data, engine="ref", max_attempts=2,
                                   state_path=path, **s.kw)
    rt.submit(qs[:5], limit=10 ** 9)
    first = rt.run(fail_hook=hook, checkpoint_every=1)
    rec = _queue_record(rt)
    rt2 = s.queue.MatchQueueRuntime(data, engine="ref", max_attempts=2,
                                    state_path=path, **s.kw)
    rt2.submit(qs[:5], limit=10 ** 9)
    state = rt2.restore()
    executed.clear()
    second = rt2.run(fail_hook=hook)
    return first, rec, state, executed, second, _queue_record(rt2)


def queue_corrupt_restore(s, data, qs, tmp):
    data, qs = _convert(s, data, qs)
    path = str(tmp / "queue.json")
    rt = s.queue.MatchQueueRuntime(data, engine="ref", state_path=path,
                                   **s.kw)
    rt.submit(qs[:5], limit=10 ** 9)
    rt.run(checkpoint_every=1)
    with open(path, "w") as f:
        f.write("\x00\x01 not a checkpoint")
    rt2 = s.queue.MatchQueueRuntime(data, engine="ref", state_path=path,
                                    **s.kw)
    rt2.submit(qs[:5], limit=10 ** 9)
    state = rt2.restore()
    return state, rt2.run(), _queue_record(rt2)


def queue_standing(s, data, qs, tmp):
    """A standing query rolled through three deltas, with a checkpoint, a
    refused stale restore and a second standing query registered midway."""
    deltas, g = [], data
    for k in range(3):
        deltas.append(ref_random_delta(g, 300 + k, n_edge_inserts=3,
                                       n_edge_deletes=3,
                                       n_vertex_inserts=k % 2))
        g = apply_delta_reference(g, deltas[-1])
    data, qs = _convert(s, data, qs)
    rt = s.queue.MatchQueueRuntime(data, engine="ref",
                                   state_path=str(tmp / "q.json"), **s.kw)
    rt.register_standing(qs[0])
    outs = []
    for k, d in enumerate(deltas):
        res = rt.apply_delta(s.delta(d))
        outs.append({i: (o.count, o.created, o.destroyed, o.graph_version,
                         o.fallback, o.inexact) for i, o in res.items()})
        if k == 0:
            rt.register_standing(qs[1])
            rt.checkpoint()
    with pytest.raises(ValueError, match="graph_version") as stale:
        rt.restore()
    return outs, str(stale.value), _queue_record(rt)


def queue_inexact(s, data, qs, tmp):
    g = s.graph(ref_build_graph(4, [(0, 1), (1, 2), (2, 3), (3, 0)],
                                [0, 0, 0, 0]))
    rt = s.queue.MatchQueueRuntime(g, engine="ref",
                                   state_path=str(tmp / "q.json"), **s.kw)
    sid = rt.register_standing(s.graph(ref_build_graph(2, [(0, 1)],
                                                       [0, 0])))
    rt.matcher.options = rt.matcher.options.replace(limit=2, delta_limit=1)
    a = rt.apply_delta(s.delta(RefGraphDelta(edge_deletes=[(0, 1)])))[sid]
    rt.checkpoint()
    rt.standing[sid].inexact = False
    rt.restore()
    flag = rt.standing[sid].inexact
    rt.matcher.options = rt.matcher.options.replace(limit=1_000_000)
    b = rt.apply_delta(s.delta(RefGraphDelta(edge_inserts=[(0, 1)])))[sid]
    return [(o.count, o.fallback, o.inexact) for o in (a, b)], flag, \
        _queue_record(rt)


SCRIPTS = {f.__name__: f for f in (
    svc_drain, svc_inbox_full, svc_deadline_budget, svc_flush_headroom,
    svc_expired, svc_starvation, svc_executor_death, svc_poison,
    svc_kill_restore, svc_probabilistic_chaos, svc_restart_under_restart,
    svc_corrupt_checkpoint, svc_shed_backoff, svc_tenants, queue_straggler,
    queue_poison_checkpoint_restore, queue_corrupt_restore, queue_standing,
    queue_inexact)}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_ref_engine_runtime_equals_the_reference(script, data, queries,
                                                 tmp_path):
    fn = SCRIPTS[script]
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = fn(_side(False), data, queries, tmp_path / "ref")
    got = fn(_side(True), data, queries, tmp_path / "port")
    assert got == want


# ------------------------------------------------------------ vector engine
@pytest.fixture(scope="module")
def port_data(data):
    return port_graph(data)


@pytest.fixture(scope="module")
def port_queries(queries):
    return [port_graph(q) for q in queries]


@pytest.fixture(scope="module")
def sequential(port_data, port_queries, expected):
    """The sequential oracle: one Matcher.count per query, vector engine."""
    m = Matcher(Dataset.from_graph(port_data), device="cpu")
    counts = [m.count(q, engine="vector", limit=10 ** 9).count
              for q in port_queries]
    assert counts == expected
    return counts


def test_vector_queue_and_service_equal_sequential_counts(
        port_data, port_queries, sequential, tmp_path):
    rt = MatchQueueRuntime(port_data, engine="vector", tile_rows=8,
                           device="cpu", state_path=str(tmp_path / "q"))
    rt.submit(port_queries, limit=10 ** 9)
    assert list(rt.run(checkpoint_every=3).values()) == sequential
    rt.submit(port_queries, limit=10 ** 9)
    assert list(rt.run(batch="off").values()) == sequential * 2
    assert rt.matcher.device == torch.device("cpu")
    svc = MatchService(port_data, device="cpu",
                       options=MatchOptions(engine="vector", tile_rows=8),
                       config=ServiceConfig(bucket_size=3))
    tickets = [svc.submit(q, limit=10 ** 9, max_steps=None,
                          tenant="t%d" % (i % 2))
               for i, q in enumerate(port_queries)]
    counts = svc.drain()
    assert [counts[t.request_id] for t in tickets] == sequential
    assert svc.stats["failed"] == svc.stats["degraded"] == 0
    assert svc.matcher_for("t1").device == torch.device("cpu")


def test_vector_standing_queries_roll_forward_to_fresh_recounts(data,
                                                               port_data):
    """Each rolled-forward count equals the reference's `cemr_match` on the
    reference's graph after the same deltas (applied by the reference's
    `apply_delta_reference`)."""
    ds = Dataset.from_graph(port_data)
    rt = MatchQueueRuntime(ds, engine="vector", tile_rows=8, device="cpu")
    ref_qs = [random_walk_query(data, 4, seed=s) for s in (11, 12)]
    sids = [rt.register_standing(port_graph(q)) for q in ref_qs]
    rg, fallbacks = data, 0
    for k in range(3):
        d = ref_random_delta(rg, 40 + k, n_edge_inserts=3, n_edge_deletes=3)
        outs = rt.apply_delta(GraphDelta(**{f: getattr(d, f)
                                            for f in DELTA_FIELDS}))
        rg = apply_delta_reference(rg, d)
        for sid, q in zip(sids, ref_qs):
            assert outs[sid].count == rt.standing[sid].count == \
                cemr_match(q, rg, limit=10 ** 9).count
            fallbacks += outs[sid].fallback
    assert fallbacks < 6 and rt.stats["deltas_applied"] == 3


def test_worker_pool_survives_a_kill_and_a_hang_bit_identical(
        port_data, port_queries, sequential):
    """Two spawned CPU workers: one SIGKILLed mid-bucket, one wedged past
    its deadline and killed by the watchdog. Every count equals the
    sequential oracle, nothing is lost or degraded, and the pool is back
    to size; the queue runtime then drains through a pool too."""
    # which bucket each fault meets depends on timing; degrade_after=3
    # keeps a bucket that meets both on the vector engine
    cfg = ServiceConfig(workers=2, bucket_size=4, worker_deadline_s=5.0,
                        retry_backoff_s=0.01, degrade_after=3)
    inj = FaultInjector(kill_worker_at={0}, hang_at={1: 300.0})
    with MatchService(port_data, config=cfg, device="cpu",
                      options=MatchOptions(engine="vector",
                                           tile_rows=8)) as svc:
        tickets = [svc.submit(q, limit=10 ** 9, max_steps=None,
                              deadline_s=600.0) for q in port_queries]
        counts = svc.drain(injector=inj)
        assert [counts[t.request_id] for t in tickets] == sequential
        assert svc.stats["completed"] == len(port_queries)
        assert svc.stats["failed"] == svc.stats["degraded"] == 0
        ps = svc.pool.stats
        assert ps["chaos_kills"] == 1 and ps["watchdog_kills"] == 1
        assert ps["respawned"] >= 2 and svc.pool.size == 2
        assert len(svc.pool.boots) >= 2
        assert all(b["boot_s"] > 0 for b in svc.pool.boots)
        # CPU tensors take the plain versions: no kernel launch counted
        assert set(svc.pool.kernel_launches.values()) <= {0}
    with MatchQueueRuntime(port_data, engine="vector", tile_rows=8,
                           device="cpu", workers=1) as rt:
        rt.submit(port_queries, limit=10 ** 9)
        assert list(rt.run().values()) == sequential
        assert rt.stats["failed"] == 0 and rt.pool.alive_count() == 1


def test_worker_pool_without_a_card_fails_instead_of_using_the_cpu(
        port_data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        MatchService(port_data, config=ServiceConfig(workers=1))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        MatchQueueRuntime(port_data, workers=1)


class _InProcessPool:
    """A one-slot stand-in for `WorkerPool` that runs each bucket in this
    process the way a worker does (`execute_chunk` on a Matcher per
    engine, counts reported as `(count | None, timed_out)`), so a fault
    planted in a kernel wrapper reaches the service as it would from a
    worker on the card."""

    def __init__(self, dataset, options):
        self.dataset, self.options = dataset, options
        self.matchers, self.done = {}, []

    def idle_count(self) -> int:
        return 1

    def waiting_count(self) -> int:
        return len(self.done)

    def dispatch(self, bucket, *, tenant, engine, hang_s=0.0):
        opts = self.options.replace(engine=engine or self.options.engine)
        m = self.matchers.get(opts.engine)
        if m is None:
            m = self.matchers[opts.engine] = Matcher(
                self.dataset, opts, device="cpu", tenant=tenant)
        outs = execute_chunk(m, bucket, batch="auto")
        self.done.append(BucketResult(
            ticket=len(self.done), items=list(bucket), engine=engine,
            counts=[(None if out is None else int(out.count),
                     bool(out is not None and out.timed_out))
                    for _, out, _ in outs]))
        return self.done[-1].ticket

    def poll(self, timeout: float = 0.0) -> list:
        done, self.done = self.done, []
        return done

    def kill_ticket(self, ticket) -> None:
        pass

    def close(self) -> None:
        pass


@pytest.mark.parametrize("card", [True, False], ids=["cuda", "cpu"])
def test_a_kernel_fault_under_a_pool_fails_on_the_card_not_degrades(
        card, port_data, port_queries, expected, monkeypatch):
    """A wrapper that raises on every launch, under a pooled service: on
    the card every request is declared failed after its attempts and none
    is answered by the host's ref engine; on the CPU the reference's
    ladder degrades each to the ref engine, whose counts are exact."""
    svc = MatchService(port_data, device="cpu",
                       options=MatchOptions(engine="vector", tile_rows=8),
                       config=ServiceConfig(bucket_size=4))
    svc.pool = _InProcessPool(svc.dataset, svc.options)
    if card:
        svc.device = torch.device("cuda")   # what a service on the card holds

    def launch_failed(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    for name in ("tile_intersect", "expand_select", "expand_intersect"):
        monkeypatch.setattr(bitmap_intersect, name, launch_failed)
    qs = [q for q, n in zip(port_queries, expected) if n][:4]
    tickets = [svc.submit(q, limit=10 ** 9, max_steps=None,
                          deadline_s=600.0) for q in qs]
    svc.drain()
    res = [svc.results[t.request_id] for t in tickets]
    attempts = svc.config.max_attempts
    assert [r.attempts for r in res] == [attempts] * len(qs)
    if card:
        assert svc.stats["failed"] == len(qs) and svc.stats["degraded"] == 0
        assert all(not r.ok and r.count is None and r.engine is None
                   for r in res)
    else:
        assert svc.stats["failed"] == 0 and svc.stats["degraded"] == len(qs)
        assert [r.count for r in res] == [n for n in expected if n][:4]
        assert all(r.ok and r.engine == "ref" for r in res)
