"""Always-on match service: async admission, deadline-aware scheduling,
and crash-consistent fault tolerance over the CEMR engines.

`launch/serve.py --arch match` is a one-shot batch loop; this module is
the persistent posture. One `MatchService` owns a preprocessed `Dataset`
and serves an open-loop request stream:

  * **Admission with backpressure** — `submit()` returns immediately with
    a typed ticket: `Admitted` (the request is queued, results arrive
    asynchronously via `result()`/`drain()`) or `Overloaded` (the request
    is shed because the bounded inbox is full, or because queue depth ×
    the trailing per-request service time already exceeds the request's
    deadline budget — executing it would only waste capacity on a result
    nobody can use).
  * **Deadline- and priority-aware bucketing** — admitted requests land in
    per-priority-class queues (`PRIORITIES`, highest first) and are drained
    in superbatch-friendly buckets (same tenant, same limit/budget) through
    `runtime.queue.execute_chunk` → `Matcher.match_many`. A bucket is
    dispatched when it is full *or* when the head request's remaining
    deadline headroom no longer covers waiting for more arrivals — a
    low-latency query is never held hostage to a full bucket. Starvation
    protection: a lower class passed over `starvation_limit` times is
    dispatched next regardless of higher-priority arrivals.
  * **Crash recovery** — `checkpoint()` atomically persists results,
    queued/in-flight ids, and per-request retry attempts (the same
    tmp-then-`os.replace` path the queue runtime uses); a checkpoint is
    also written *before* each bucket executes, so a crash mid-bucket is
    recovered by `ServiceSupervisor` (a training supervisor's restore +
    replay + re-issue semantics, adapted to match work items) with zero
    lost and zero double-counted queries.
  * **Tenant isolation** — each tenant gets its own `Matcher.tenant_view`
    (private plan cache + stats over the shared Dataset), so one tenant's
    cold-query storm can never evict another tenant's warm plans.
  * **Process isolation** — with `ServiceConfig(workers > 0)` buckets
    execute on a `runtime.workers.WorkerPool` of out-of-process
    executors instead of inline: a worker that crashes, wedges past
    `worker_deadline_s` (SIGKILLed by the pool watchdog), or is OOM-killed
    loses only its in-flight bucket, which retries under the `attempts`
    budget with exponential backoff + jitter and degrades `vector → ref`
    after `degrade_after` failed attempts before being declared poison.

Semantics, SLO knobs, and the recovery argument: docs/serving.md. The
service, its tenants' Matchers and its workers run on the card unless it is
given `device="cpu"`. A copy of the reference's `repro.runtime.service`,
with one change: the degradation ladder runs on the CPU only. Its "ref"
engine runs on the host, so on the card it would answer a request whose
kernel path failed from the CPU and call it ok; there a request that keeps
failing on the vector engine is declared failed instead.
"""
from __future__ import annotations

import dataclasses
import random
import time
import zlib
from collections import deque

from ..api import Dataset, Matcher, MatchOptions
from ..core.graph import Graph

from .queue import execute_chunk, read_checkpoint, write_checkpoint
from .workers import WorkerPool, as_triples

__all__ = ["PRIORITIES", "ServiceConfig", "MatchRequest", "Admitted",
           "Overloaded", "RequestResult", "MatchService",
           "ServiceSupervisor", "SupervisedServe", "arrival_schedule",
           "open_loop"]

# priority classes, highest first; each maps to a default deadline budget
PRIORITIES = ("interactive", "standard", "batch")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Frozen service knobs (the SLO surface — docs/serving.md#slo-knobs).

    `inbox_capacity` bounds admitted-but-unfinished requests; `bucket_size`
    caps how many same-tenant requests share one superbatch dispatch;
    `flush_headroom_s` is the safety margin under which a partial bucket
    flushes (head request's remaining deadline − estimated execution time);
    `starvation_limit` is how many consecutive dispatches may pass over a
    non-empty lower-priority class before it is forced; `admit_margin`
    scales the deadline budget the admission estimate is checked against;
    `prior_service_s` seeds the trailing service-time estimate before any
    request has completed; `checkpoint_every` (completed requests) gates
    periodic checkpoints — pre-bucket in-flight checkpoints always happen
    when a `state_path` is set.

    Process isolation (docs/serving.md#process-isolation--failure-domains):
    `workers` > 0 executes buckets on that many out-of-process workers;
    `worker_deadline_s` is the per-bucket wall-clock budget after which the
    pool watchdog SIGKILLs the executing worker; `poll_interval_s` bounds
    how long an idle `step()` blocks waiting for pool results. A bucket
    whose worker died retries after `retry_backoff_s · 2^(attempts−1)`
    seconds (seeded-jittered, capped at `retry_backoff_max_s`), degrading
    from `engine="vector"` to `"ref"` once `degrade_after` attempts have
    failed (on the CPU only: on the card it keeps its engine until it is
    declared failed). Shed backoff: repeated `Overloaded` responses to the same
    tenant grow `retry_after_s` geometrically from the admission estimate
    (jitter seeded per tenant from `backoff_seed`, capped at
    `retry_after_max_s`, reset by an accepted submit)."""

    inbox_capacity: int = 256
    bucket_size: int = 8
    flush_headroom_s: float = 0.05
    starvation_limit: int = 4
    max_attempts: int = 3
    checkpoint_every: int = 0
    state_path: str | None = None
    prior_service_s: float = 0.02
    rate_window: int = 64
    admit_margin: float = 1.0
    deadlines_s: tuple[tuple[str, float], ...] = (
        ("interactive", 0.5), ("standard", 5.0), ("batch", 60.0))
    tenant_plan_cache_size: int = 128
    workers: int = 0
    worker_deadline_s: float = 30.0
    poll_interval_s: float = 0.05
    degrade_after: int = 2
    retry_backoff_s: float = 0.05
    retry_backoff_max_s: float = 2.0
    retry_after_base_s: float = 0.05
    retry_after_max_s: float = 5.0
    backoff_seed: int = 0

    def __post_init__(self):
        if self.inbox_capacity < 1:
            raise ValueError("inbox_capacity must be >= 1")
        if self.bucket_size < 1:
            raise ValueError("bucket_size must be >= 1")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.workers < 0:
            raise ValueError("workers must be >= 0 (0 = inline execution)")
        if self.degrade_after < 1:
            raise ValueError("degrade_after must be >= 1")
        if set(dict(self.deadlines_s)) != set(PRIORITIES):
            raise ValueError(f"deadlines_s must cover exactly {PRIORITIES}")

    def deadline_for(self, priority: str) -> float:
        """The default deadline budget (seconds) for a priority class."""
        return dict(self.deadlines_s)[priority]


@dataclasses.dataclass
class MatchRequest:
    """One admitted request: the query plus its scheduling envelope.
    `deadline_at` is absolute (service clock); `attempts` counts dispatch
    attempts and survives checkpoints, so a poison query's retry budget
    never refreshes across restarts."""

    request_id: int
    tenant: str
    priority: str
    query: Graph
    limit: int
    max_steps: int | None
    deadline_s: float
    arrival_s: float
    deadline_at: float
    attempts: int = 0
    # per-request engine override, set by the degradation ladder (None =
    # the service's configured engine); persists across checkpoints so a
    # restart never un-degrades a request back onto the faulting engine
    engine: str | None = None
    # retry-backoff eligibility: not dispatched before this clock time
    # (force-mode drain ignores it — backoff shapes load, not correctness)
    not_before: float = 0.0


@dataclasses.dataclass(frozen=True)
class Admitted:
    """Positive admission ticket: the request is queued; poll `result()`
    (or `drain()`) for completion. `est_wait_s` is the admission-time
    queue-delay estimate the backpressure check used."""

    request_id: int
    est_wait_s: float


@dataclasses.dataclass(frozen=True)
class Overloaded:
    """Typed shed response: the request was NOT admitted. `reason` is
    `"inbox_full"` (bounded inbox at capacity) or `"deadline_budget"`
    (queue depth × trailing service time exceeds the request's deadline
    budget — it would time out before an executor reached it).
    `retry_after_s` is the backoff hint: the admission estimate grown
    geometrically with the tenant's consecutive-shed streak and jittered
    by a per-tenant seeded rng, so a fleet of open-loop clients shed
    together does not retry in lockstep (it resets when a submit from
    the tenant is accepted)."""

    request_id: int
    reason: str
    queue_depth: int
    est_wait_s: float
    retry_after_s: float


@dataclasses.dataclass
class RequestResult:
    """Terminal state of one admitted request. Exactly one of: completed
    (`ok=True`, `count` set), shed in queue (`shed=True` — its deadline
    expired before dispatch), or permanently failed (`failed=True` —
    retry budget burned). `deadline_missed` flags completions that beat
    no one's SLO (first-result-wins: the count is still recorded).
    `engine` is the per-request degradation override the terminal attempt
    ran under (None = the service's configured engine)."""

    request_id: int
    tenant: str
    priority: str
    count: int | None
    ok: bool
    shed: bool = False
    failed: bool = False
    latency_s: float = 0.0
    deadline_missed: bool = False
    attempts: int = 0
    engine: str | None = None


def _tenant_stats() -> dict:
    return {"admitted": 0, "shed": 0, "completed": 0, "failed": 0,
            "deadline_missed": 0, "cache_hits": 0}


class MatchService:
    """A persistent match service over one shared Dataset (module
    docstring for the full contract; docs/serving.md for semantics).

    The service is single-threaded and clock-injected: every public method
    reads `clock()` (default `time.monotonic`), so chaos tests drive it
    with a manual clock while the open-loop driver uses wall time. The
    async surface is `submit()` (immediate ticket) + `pump()`/`step()`
    (dispatch ready buckets) + `result()` (poll a terminal state);
    `drain()` force-flushes to idle for batch-style use."""

    def __init__(self, data: Graph | Dataset, *,
                 config: ServiceConfig | None = None,
                 options: MatchOptions | None = None,
                 clock=time.monotonic, device=None):
        self.dataset = (data if isinstance(data, Dataset)
                        else Dataset.from_graph(data))
        self.config = config if config is not None else ServiceConfig()
        self.options = options if options is not None else MatchOptions()
        self._clock = clock
        self._matchers: dict[str, Matcher] = {
            "default": Matcher(
                self.dataset, self.options, device=device,
                plan_cache_size=self.config.tenant_plan_cache_size,
                tenant="default")}
        self.device = self._matchers["default"].device
        self.pool = (WorkerPool(self.dataset, self.config.workers,
                                self.options, device=self.device,
                                deadline_s=self.config.worker_deadline_s)
                     if self.config.workers else None)
        self._queues: dict[str, deque[MatchRequest]] = {
            p: deque() for p in PRIORITIES}
        self._skipped: dict[str, int] = {p: 0 for p in PRIORITIES}
        self.in_flight: dict[int, MatchRequest] = {}
        self.results: dict[int, RequestResult] = {}
        self._next_id = 0
        self._service_times: deque[float] = deque(
            maxlen=self.config.rate_window)
        self._completed_since_ckpt = 0
        self._retry_rng = random.Random(self.config.backoff_seed)
        self._shed_streak: dict[str, int] = {}
        self._shed_rng: dict[str, random.Random] = {}
        self.stats = {"admitted": 0, "shed_admission": 0, "shed_expired": 0,
                      "completed": 0, "failed": 0, "reissued": 0,
                      "stragglers": 0, "dispatches": 0, "checkpoints": 0,
                      "cache_hits": 0, "deadline_missed": 0, "degraded": 0,
                      "restore_fallbacks": 0}
        self.tenant_stats: dict[str, dict] = {}

    def close(self) -> None:
        """Reap the worker pool (no-op in inline mode). Idempotent — and
        required whenever `workers > 0`, or worker processes outlive the
        service object until interpreter teardown."""
        if self.pool is not None:
            self.pool.close()

    def __enter__(self) -> "MatchService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- utilities
    def matcher_for(self, tenant: str) -> Matcher:
        """The tenant's isolated Matcher (created on first use as a
        `tenant_view` of the default one: shared Dataset, private plan
        cache — one tenant's evictions never touch another's)."""
        m = self._matchers.get(tenant)
        if m is None:
            m = self._matchers["default"].tenant_view(tenant)
            self._matchers[tenant] = m
        return m

    def _tstats(self, tenant: str) -> dict:
        ts = self.tenant_stats.get(tenant)
        if ts is None:
            ts = self.tenant_stats[tenant] = _tenant_stats()
        return ts

    def _service_time_est(self) -> float:
        if not self._service_times:
            return self.config.prior_service_s
        return sum(self._service_times) / len(self._service_times)

    def queue_depth(self) -> int:
        """Admitted-but-unfinished requests (queued + in flight) — the
        quantity the bounded inbox and the admission estimate run on."""
        return sum(len(q) for q in self._queues.values()) \
            + len(self.in_flight)

    def busy(self) -> bool:
        """True while any request is queued or in flight."""
        return self.queue_depth() > 0

    def result(self, request_id: int) -> RequestResult | None:
        """Poll a request's terminal state (None while still queued or in
        flight — the async completion surface)."""
        return self.results.get(request_id)

    # ------------------------------------------------------------- admission
    def submit(self, query: Graph, *, tenant: str = "default",
               priority: str = "standard", deadline_s: float | None = None,
               limit: int = 1_000_000, max_steps: int | None = 50_000,
               force: bool = False) -> Admitted | Overloaded:
        """Admit one request (open-loop: returns immediately, never blocks
        on execution). Backpressure is explicit: the caller gets
        `Overloaded` when the bounded inbox is full or when the admission
        estimate (queue depth × trailing per-request service time) exceeds
        `admit_margin ×` the request's deadline budget. Request ids are
        assigned to *every* submit call, shed or admitted, so a replayed
        workload reproduces identical ids. `force=True` skips the
        backpressure checks — the supervisor's replay path, where the
        workload is durable and was already admitted once."""
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, "
                             f"got {priority!r}")
        now = self._clock()
        budget = (deadline_s if deadline_s is not None
                  else self.config.deadline_for(priority))
        rid = self._next_id
        self._next_id += 1
        depth = self.queue_depth()
        est_wait = depth * self._service_time_est()
        ts = self._tstats(tenant)
        if not force:
            reason = None
            if depth >= self.config.inbox_capacity:
                reason = "inbox_full"
            elif est_wait > self.config.admit_margin * budget:
                reason = "deadline_budget"
            if reason is not None:
                self.stats["shed_admission"] += 1
                ts["shed"] += 1
                self.results[rid] = RequestResult(
                    request_id=rid, tenant=tenant, priority=priority,
                    count=None, ok=False, shed=True)
                return Overloaded(request_id=rid, reason=reason,
                                  queue_depth=depth, est_wait_s=est_wait,
                                  retry_after_s=self._retry_after(
                                      tenant, est_wait))
        self._shed_streak[tenant] = 0     # accepted: reset the shed backoff
        req = MatchRequest(request_id=rid, tenant=tenant, priority=priority,
                           query=query, limit=limit, max_steps=max_steps,
                           deadline_s=budget, arrival_s=now,
                           deadline_at=now + budget)
        self._queues[priority].append(req)
        self.stats["admitted"] += 1
        ts["admitted"] += 1
        return Admitted(request_id=rid, est_wait_s=est_wait)

    def _retry_after(self, tenant: str, est_wait: float) -> float:
        """The `Overloaded.retry_after_s` hint: exponential per-tenant
        backoff with seeded jitter. The base is the admission wait
        estimate (floored at `retry_after_base_s`), doubled per
        consecutive shed for this tenant and jittered into [0.5×, 1.5×]
        by a per-tenant rng seeded from (tenant, `backoff_seed`) — so
        shed clients de-synchronize deterministically, and repeated
        hammering by one tenant is pushed back geometrically (capped at
        `retry_after_max_s`) until one of its submits is accepted."""
        streak = self._shed_streak.get(tenant, 0) + 1
        self._shed_streak[tenant] = streak
        rng = self._shed_rng.get(tenant)
        if rng is None:
            rng = self._shed_rng[tenant] = random.Random(
                zlib.crc32(tenant.encode()) ^ self.config.backoff_seed)
        base = max(est_wait, self.config.retry_after_base_s)
        raw = base * (2.0 ** (streak - 1)) * (0.5 + rng.random())
        return min(raw, self.config.retry_after_max_s)

    # ------------------------------------------------------------ scheduling
    def _shed_expired(self, now: float) -> int:
        """Drop queued requests whose deadline already passed: executing
        them would burn capacity on results nobody is waiting for."""
        shed = 0
        for p in PRIORITIES:
            q = self._queues[p]
            if not q:
                continue
            keep: deque[MatchRequest] = deque()
            for r in q:
                if r.deadline_at < now:
                    self.results[r.request_id] = RequestResult(
                        request_id=r.request_id, tenant=r.tenant,
                        priority=r.priority, count=None, ok=False,
                        shed=True, attempts=r.attempts,
                        latency_s=now - r.arrival_s)
                    self.stats["shed_expired"] += 1
                    self._tstats(r.tenant)["shed"] += 1
                    shed += 1
                else:
                    keep.append(r)
            self._queues[p] = keep
        return shed

    def _select_class(self) -> str | None:
        """Next class to serve: normally the highest-priority non-empty
        one, unless a lower class has been passed over `starvation_limit`
        consecutive dispatches (then the lowest such class goes first)."""
        nonempty = [p for p in PRIORITIES if self._queues[p]]
        if not nonempty:
            return None
        for p in reversed(PRIORITIES):          # lowest priority first
            if (self._queues[p]
                    and self._skipped[p] >= self.config.starvation_limit):
                return p
        return nonempty[0]

    def _take_bucket(self, now: float, force: bool):
        """Select the next dispatch bucket (same class, tenant,
        limit/budget, and degradation engine, up to `bucket_size`
        requests) — or None when the partially-filled head bucket still
        has deadline headroom to wait for more arrivals (never when
        `force`). Requests inside their retry-backoff window
        (`not_before` in the future) are not eligible unless `force` — a
        drain flushes everything, backoff only spaces retries out under
        live load. Selection commits: chosen requests leave their queue
        and the starvation counters advance."""
        cls = self._select_class()
        if cls is None:
            return None
        q = self._queues[cls]
        eligible = [r for r in q if force or r.not_before <= now]
        if not eligible:
            return None
        head = eligible[0]
        key = (head.tenant, head.limit, head.max_steps, head.engine)
        bucket = [r for r in eligible
                  if (r.tenant, r.limit, r.max_steps, r.engine) == key]
        bucket = bucket[:self.config.bucket_size]
        if len(bucket) < self.config.bucket_size and not force:
            # flush on deadline headroom, not just on bucket size: wait
            # for more arrivals only while the head request could still
            # meet its deadline after the estimated bucket execution
            est_exec = self._service_time_est() * max(len(bucket), 1)
            headroom = head.deadline_at - now - est_exec
            if headroom > self.config.flush_headroom_s:
                return None
        taken = {r.request_id for r in bucket}
        self._queues[cls] = deque(r for r in q
                                  if r.request_id not in taken)
        for p in PRIORITIES:
            if self._queues[p]:
                self._skipped[p] += 1
        self._skipped[cls] = 0
        return bucket

    def _fail_or_requeue(self, r: MatchRequest, now: float) -> int:
        """One request's executor (inline hook or real worker process)
        died on it. Under budget: re-queue at the front with an
        exponential-backoff-with-jitter `not_before` (seeded rng, so
        chaos runs are reproducible), degrading `vector → ref` once
        `degrade_after` attempts failed (pool mode on the CPU only —
        inline execution has no per-request engine override, and on the
        card the host engine would hide a failing kernel path). Over
        budget: declare it poison (permanent failure). Returns 1 if
        finalized."""
        if r.attempts < self.config.max_attempts:
            if (self.pool is not None and self.device.type != "cuda"
                    and r.attempts >= self.config.degrade_after
                    and (r.engine or self.options.engine) == "vector"):
                r.engine = "ref"
                self.stats["degraded"] += 1
            delay = min(self.config.retry_backoff_s
                        * (2.0 ** (r.attempts - 1))
                        * (0.5 + self._retry_rng.random()),
                        self.config.retry_backoff_max_s)
            r.not_before = now + delay
            self._queues[r.priority].appendleft(r)
            self.stats["reissued"] += 1
            return 0
        self.results[r.request_id] = RequestResult(
            request_id=r.request_id, tenant=r.tenant,
            priority=r.priority, count=None, ok=False,
            failed=True, attempts=r.attempts,
            latency_s=now - r.arrival_s, engine=r.engine)
        self.stats["failed"] += 1
        self._tstats(r.tenant)["failed"] += 1
        return 1

    def _finalize_outs(self, outs, *, now: float, per_item_s: float) -> int:
        """Absorb one executed bucket's `execute_chunk`-shaped triples
        into terminal results / retry queues; returns requests finalized.
        `per_item_s` feeds the admission service-time estimate — callers
        pass *execution* wall time (worker-measured in pool mode), never
        dispatch round-trip, so IPC/pickling overhead cannot inflate the
        deadline-budget shed decision."""
        finalized = 0
        for r, out, _dt in outs:
            self.in_flight.pop(r.request_id, None)
            if out is None:                       # executor died: re-issue
                finalized += self._fail_or_requeue(r, now)
                continue
            self._service_times.append(per_item_s)
            latency = now - r.arrival_s
            missed = now > r.deadline_at
            self.results[r.request_id] = RequestResult(
                request_id=r.request_id, tenant=r.tenant,
                priority=r.priority, count=out.count, ok=True,
                latency_s=latency, deadline_missed=missed,
                attempts=r.attempts, engine=r.engine)
            self.stats["completed"] += 1
            ts = self._tstats(r.tenant)
            ts["completed"] += 1
            if missed:
                # straggler semantics are first-result-wins: the count is
                # kept, the SLO miss is flagged, nothing is re-executed
                self.stats["deadline_missed"] += 1
                self.stats["stragglers"] += 1
                ts["deadline_missed"] += 1
            finalized += 1
            self._completed_since_ckpt += 1
        return finalized

    def _pool_collect(self, timeout: float = 0.0) -> int:
        """Collect every finished/failed bucket from the worker pool
        (blocking up to `timeout` for the first event — the pool's
        watchdog and respawn logic also run inside this poll). Completed
        buckets finalize exactly like inline execution; died/hung buckets
        re-issue through the retry/backoff/degradation path."""
        finalized = 0
        for res in self.pool.poll(timeout):
            now = self._clock()
            if res.cache_hits:
                self.stats["cache_hits"] += res.cache_hits
                self._tstats(res.items[0].tenant)["cache_hits"] += \
                    res.cache_hits
            per_item_s = res.exec_s / max(len(res.items), 1)
            finalized += self._finalize_outs(as_triples(res), now=now,
                                             per_item_s=per_item_s)
        return finalized

    def step(self, *, force: bool = False, fail_hook=None,
             injector=None) -> int:
        """Dispatch at most one ready bucket; returns the number of
        requests finalized (completed + failed + shed). `force` flushes
        partial buckets regardless of headroom or retry backoff (drain
        mode). `fail_hook` is the in-process executor-death chaos hook
        forwarded to `execute_chunk` — incompatible with a worker pool
        (a closure cannot cross the process boundary; use the injector's
        `kill_worker_at`/`hang_at` for real process chaos instead).
        `injector.check(dispatch_idx)` fires *after* the in-flight
        checkpoint and before execution — an injected raise there is a
        service-process crash with work in flight, the recovery path
        `ServiceSupervisor` exists for; `injector.hang(dispatch_idx)`
        rides the dispatched bucket into the worker (a real sleep the
        watchdog must SIGKILL through), and `injector.kill_worker
        (dispatch_idx)` SIGKILLs the worker right after dispatch (real
        process death mid-bucket).

        In pool mode a step first absorbs finished buckets, then
        dispatches to an idle worker if one exists; with nothing to
        dispatch but work still in flight it blocks up to
        `poll_interval_s` so drain/pump loops make progress instead of
        spinning."""
        now = self._clock()
        finalized = self._shed_expired(now)
        if self.pool is not None:
            if fail_hook is not None:
                raise ValueError(
                    "fail_hook simulates in-process executor death and "
                    "cannot cross the process boundary; with workers > 0 "
                    "use FaultInjector(kill_worker_at=..., hang_at=...) "
                    "for real process-level chaos")
            finalized += self._pool_collect()
        can_dispatch = self.pool is None or self.pool.idle_count() > 0
        bucket = self._take_bucket(now, force) if can_dispatch else None
        if bucket is None:
            if (self.pool is not None and self.busy()
                    and self.pool.waiting_count()):
                # nothing dispatchable, but buckets (or worker startups)
                # are in flight: wait for the pool instead of spinning
                finalized += self._pool_collect(self.config.poll_interval_s)
            return finalized
        for r in bucket:
            r.attempts += 1
            self.in_flight[r.request_id] = r
        self.stats["dispatches"] += 1
        if self.config.state_path:
            # crash-consistency point: the checkpoint on disk now records
            # this bucket as in flight; a crash during execution re-issues
            # exactly these requests and recounts nothing else
            self.checkpoint()
        dispatch_idx = self.stats["dispatches"] - 1
        if injector is not None:
            injector.check(dispatch_idx)
        if self.pool is not None:
            hang_s = (injector.hang(dispatch_idx)
                      if injector is not None else 0.0)
            ticket = self.pool.dispatch(
                bucket, tenant=bucket[0].tenant, engine=bucket[0].engine,
                hang_s=hang_s)
            if ticket is None:
                # the chosen worker died at send time — a real worker
                # loss: route the bucket through the normal death path
                finalized += self._finalize_outs(
                    [(r, None, 0.0) for r in bucket],
                    now=self._clock(), per_item_s=0.0)
            elif injector is not None and injector.kill_worker(dispatch_idx):
                self.pool.kill_ticket(ticket)
        else:
            matcher = self.matcher_for(bucket[0].tenant)
            hits_before = matcher.cache_info().hits
            t0 = time.perf_counter()
            outs = execute_chunk(matcher, bucket, batch="auto",
                                 fail_hook=fail_hook)
            per_item_s = (time.perf_counter() - t0) / len(bucket)
            hit_delta = matcher.cache_info().hits - hits_before
            self.stats["cache_hits"] += hit_delta
            self._tstats(bucket[0].tenant)["cache_hits"] += hit_delta
            finalized += self._finalize_outs(outs, now=self._clock(),
                                             per_item_s=per_item_s)
        if (self.config.checkpoint_every
                and self._completed_since_ckpt
                >= self.config.checkpoint_every):
            self._completed_since_ckpt = 0
            self.checkpoint()
        return finalized

    def pump(self, *, force: bool = False, fail_hook=None,
             injector=None) -> int:
        """Dispatch every currently-ready bucket (the serve-loop inner
        step); returns total requests finalized. Stops when `_take_bucket`
        prefers to wait for arrivals (unless `force`)."""
        total = 0
        while True:
            before = self.stats["dispatches"]
            total += self.step(force=force, fail_hook=fail_hook,
                               injector=injector)
            if self.stats["dispatches"] == before:
                return total

    def drain(self, *, fail_hook=None, injector=None) -> dict[int, int | None]:
        """Force-flush until idle; returns {request_id: count} for every
        request admitted so far (None = shed or permanently failed)."""
        while self.busy():
            self.step(force=True, fail_hook=fail_hook, injector=injector)
        if self.config.state_path:
            self.checkpoint()          # terminal state on disk before idle
        return {rid: r.count for rid, r in sorted(self.results.items())}

    # ------------------------------------------------------------ observability
    def latency_stats(self) -> dict:
        """p50/p99/mean completion latency (seconds) over completed
        requests, plus the shed rate over all terminal requests."""
        lats = sorted(r.latency_s for r in self.results.values() if r.ok)
        n_terminal = len(self.results)
        shed = sum(1 for r in self.results.values() if r.shed)
        if not lats:
            return {"n": 0, "p50_s": 0.0, "p99_s": 0.0, "mean_s": 0.0,
                    "shed_rate": shed / n_terminal if n_terminal else 0.0}
        def q(p):
            return lats[min(len(lats) - 1, int(p * len(lats)))]
        return {"n": len(lats), "p50_s": q(0.50), "p99_s": q(0.99),
                "mean_s": sum(lats) / len(lats),
                "shed_rate": shed / n_terminal}

    def reset_stats(self) -> None:
        """Start a fresh measurement window: drop terminal results, stat
        counters, and the trailing service-rate history while keeping
        every tenant's warm plan cache — the bench/ops idiom for
        separating a warm-up phase from the measured open-loop phase."""
        if self.busy():
            raise RuntimeError("reset_stats() with requests queued or in "
                               "flight would orphan them; drain first")
        self.results.clear()
        self.in_flight.clear()
        self._service_times.clear()
        self._completed_since_ckpt = 0
        self._next_id = 0
        self._retry_rng = random.Random(self.config.backoff_seed)
        self._shed_streak.clear()
        self._shed_rng.clear()
        self.stats = {k: 0 for k in self.stats}
        self.tenant_stats = {t: _tenant_stats() for t in self.tenant_stats}

    # ------------------------------------------------------------- checkpoint
    def checkpoint(self) -> None:
        """Atomically persist terminal results, queued/in-flight request
        ids, per-request attempts, the dispatch counter, and the dataset's
        graph_version (tmp + `os.replace`, the queue runtime's idiom). The
        request *queries* are not serialized — recovery replays the
        deterministic workload (a training loop's `batch_fn` analog) and
        `restore()` reconciles it against this state."""
        if not self.config.state_path:
            return
        queued = {}
        for p in PRIORITIES:
            for r in self._queues[p]:
                queued[str(r.request_id)] = {"attempts": r.attempts,
                                             "engine": r.engine}
        state = {
            "results": {str(rid): {
                "count": r.count, "ok": r.ok, "shed": r.shed,
                "failed": r.failed, "latency_s": r.latency_s,
                "deadline_missed": r.deadline_missed,
                "attempts": r.attempts, "tenant": r.tenant,
                "priority": r.priority, "engine": r.engine}
                for rid, r in self.results.items()},
            "queued": queued,
            "in_flight": {str(rid): {"attempts": r.attempts,
                                     "engine": r.engine}
                          for rid, r in self.in_flight.items()},
            "dispatches": self.stats["dispatches"],
            "next_id": self._next_id,
            "graph_version": self.dataset.graph_version,
        }
        write_checkpoint(self.config.state_path, state)
        self.stats["checkpoints"] += 1

    def restore(self) -> dict | None:
        """Reconcile a re-submitted workload against the last checkpoint:
        requests it records as terminal (completed, shed, or permanently
        failed) are pulled out of the queues and their results seeded —
        never recounted, never resurrected with a fresh retry budget;
        requests it records as queued or in flight stay queued with their
        spent `attempts` restored (in-flight at crash = re-issued here,
        which is exactly the zero-lost/zero-double-count argument: a
        result is either in the checkpoint or its request is re-run, never
        both). Call after `submit(force=True)`-replaying the workload.
        Rejects checkpoints taken at a different dataset graph_version
        (stale counts). Returns the raw state, or None without one.

        A truncated/corrupt state file falls back to the `.prev`
        generation (bumping `stats["restore_fallbacks"]`); with no
        readable generation the restore is a no-op and the replayed
        workload simply re-runs — corruption costs durability, never
        availability."""
        state, fell_back = read_checkpoint(self.config.state_path)
        if fell_back:
            self.stats["restore_fallbacks"] += 1
        if state is None:
            return None
        ckpt_version = int(state.get("graph_version", 0))
        if ckpt_version != self.dataset.graph_version:
            raise ValueError(
                f"checkpoint was taken at graph_version {ckpt_version} but "
                f"the live dataset is at {self.dataset.graph_version}; its "
                f"counts are stale — re-run the workload instead of "
                f"restoring")
        terminal = state.get("results", {})
        # non-terminal records carry {"attempts", "engine"} (legacy
        # checkpoints stored a bare attempts int — still accepted)
        pending = {**state.get("queued", {}), **state.get("in_flight", {})}
        attempts, engines = {}, {}
        for i, rec in pending.items():
            if isinstance(rec, dict):
                attempts[int(i)] = int(rec.get("attempts", 0))
                engines[int(i)] = rec.get("engine")
            else:
                attempts[int(i)] = int(rec)
        for p in PRIORITIES:
            keep: deque[MatchRequest] = deque()
            for r in self._queues[p]:
                rec = terminal.get(str(r.request_id))
                if rec is not None:
                    self.results[r.request_id] = RequestResult(
                        request_id=r.request_id, tenant=rec["tenant"],
                        priority=rec["priority"], count=rec["count"],
                        ok=rec["ok"], shed=rec["shed"],
                        failed=rec["failed"],
                        latency_s=rec["latency_s"],
                        deadline_missed=rec["deadline_missed"],
                        attempts=rec["attempts"],
                        engine=rec.get("engine"))
                else:
                    r.attempts = attempts.get(r.request_id, r.attempts)
                    r.engine = engines.get(r.request_id, r.engine)
                    keep.append(r)
            self._queues[p] = keep
        self.stats["dispatches"] = int(state.get("dispatches", 0))
        self._next_id = max(self._next_id, int(state.get("next_id", 0)))
        return state


@dataclasses.dataclass
class SupervisedServe:
    """Result of one supervised run: the final (live) service, its drained
    {request_id: count} map, restart count, and total wall time spent in
    the recovery path (rebuild + replay + restore after each crash)."""

    service: MatchService
    counts: dict[int, int | None]
    restarts: int
    recovery_s: float


class ServiceSupervisor:
    """Restart loop for a MatchService — a training supervisor's semantics
    (restore + deterministic replay + re-issue of in-flight work) adapted
    from training steps to match work items.

    `factory()` must build a fresh MatchService over the same
    `state_path`; `workload` is the deterministic list of submit kwargs
    (the `batch_fn` analog — replayable, same order, same ids). On every
    (re)start the supervisor replays the workload with `force=True` (it is
    durable — admission already happened once), reconciles it against the
    checkpoint via `restore()`, and drains; any exception (an injected
    crash from the FaultInjector, a real executor loss escalating) counts
    as a restart, up to `max_restarts`."""

    def __init__(self, factory, workload: list[dict], *,
                 max_restarts: int = 8):
        self.factory = factory
        self.workload = workload
        self.max_restarts = max_restarts

    def run(self, *, injector=None, fail_hook=None) -> SupervisedServe:
        """Run the workload to completion through crashes; raises only
        after `max_restarts` consecutive failures. The replay and restore
        phases run *inside* the crash boundary: a supervisor killed
        mid-restore (after the checkpoint read, before the first bucket)
        restarts like any other crash — the checkpoint on disk is
        immutable through restore, so the retried restore sees identical
        state. A crashed generation's service is always `close()`d, so
        worker-pool generations never leak processes."""
        restarts = 0
        recovery_s = 0.0
        t_crash: float | None = None
        while True:
            svc = self.factory()
            try:
                for kw in self.workload:
                    svc.submit(**kw, force=True)
                svc.restore()
                if t_crash is not None:
                    recovery_s += time.monotonic() - t_crash
                    t_crash = None
                counts = svc.drain(fail_hook=fail_hook, injector=injector)
                return SupervisedServe(service=svc, counts=counts,
                                       restarts=restarts,
                                       recovery_s=recovery_s)
            except Exception:   # noqa: BLE001 — any crash → restart
                svc.close()
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                t_crash = time.monotonic()


# ------------------------------------------------------------- open-loop driver
def arrival_schedule(n: int, qps: float, *, seed: int = 0) -> list[float]:
    """Seeded open-loop (Poisson) arrival process: n arrival offsets in
    seconds with exponential inter-arrival times at rate `qps`."""
    if qps <= 0:
        raise ValueError("qps must be > 0")
    rng = random.Random(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(qps)
        out.append(t)
    return out


def open_loop(service: MatchService, workload: list[dict],
              schedule: list[float], *, fail_hook=None) -> dict:
    """Drive an open-loop arrival process against a live service: each
    workload[i] (submit kwargs) is offered at wall-clock offset
    schedule[i] *regardless of completions* (arrivals never wait — the
    load the admission/backpressure path is designed for), while ready
    buckets are pumped between arrivals. Partial buckets are only forced
    once the arrival stream is exhausted. Returns a summary dict
    (offered/admitted/shed/completed/failed, p50/p99, sustained qps)."""
    if len(workload) != len(schedule):
        raise ValueError("workload and schedule lengths differ")
    t0 = time.monotonic()
    i = 0
    while i < len(schedule) or service.busy():
        now = time.monotonic() - t0
        while i < len(schedule) and schedule[i] <= now:
            service.submit(**workload[i])
            i += 1
        exhausted = i >= len(schedule)
        did = service.pump(force=exhausted, fail_hook=fail_hook)
        if not did and not exhausted:
            # idle until the next arrival (bounded nap: the deadline-flush
            # condition re-evaluates against the clock each iteration)
            time.sleep(min(max(schedule[i] - (time.monotonic() - t0), 0.0),
                           0.001))
    makespan = time.monotonic() - t0
    lat = service.latency_stats()
    s = service.stats
    return {"offered": len(workload), "admitted": s["admitted"],
            "shed": s["shed_admission"] + s["shed_expired"],
            "completed": s["completed"], "failed": s["failed"],
            "p50_s": lat["p50_s"], "p99_s": lat["p99_s"],
            "shed_rate": lat["shed_rate"], "makespan_s": makespan,
            "qps_sustained": (s["completed"] / makespan if makespan > 0
                              else 0.0)}
