"""Distributed work-queue runtime for the CEMR matching engine.

Production posture (DESIGN.md §5): queries scale over pods, frontier tiles
scale over executors within a pod. Tiles are idempotent work items, so the
queue gives fault tolerance (re-issue on executor death), straggler
mitigation (deadline-based re-issue, first-result-wins), elastic scaling
(executors join/leave between items), and checkpoint/restart (persist the
queue + partial counts).

Execution goes through the `api` session layer: one Matcher owns the
preprocessed Dataset and the plan cache, so a re-issued query attempt (or a
duplicate query in the workload) reuses its compiled plan instead of
re-deriving the candidate space — `stats["cache_hits"]` counts those reuses.

This module is runnable on one host (executors are in-process workers driving
the same engines); the scheduling logic is the deliverable. The device is
the Matcher's: the card unless the runtime is given `device="cpu"`, in the
process and in every worker of the pool.

Streaming (docs/streaming.md): `register_standing` pins a query whose count
is rolled forward through every `apply_delta` by the delta identity instead
of re-enumerated, and checkpoints record the dataset's `graph_version` so
`restore()` can refuse counts taken against a graph that no longer exists.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from collections import deque

from ..api import BATCH_MODES, Dataset, Matcher, MatchOptions
from ..core.graph import Graph

from .workers import WorkerPool, as_triples

__all__ = ["QueryItem", "StandingQuery", "MatchQueueRuntime",
           "execute_chunk", "write_checkpoint", "read_checkpoint"]

logger = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class QueryItem:
    query_id: int
    query: Graph
    limit: int = 1_000_000
    max_steps: int | None = 50_000
    attempts: int = 0
    done: bool = False
    count: int | None = None
    elapsed_s: float = 0.0


@dataclasses.dataclass
class StandingQuery:
    """A continuously-maintained query: registered once, its count rolled
    forward through every `apply_delta` via the delta identity (or a full
    recount on fallback). `count`/`graph_version` always describe the live
    dataset after the latest applied delta. `inexact` is True while the
    latest roll-forward was a fallback recount that timed out or hit its
    limit — `count` may then undercount; the flag clears as soon as a
    later delta's recount completes exactly."""

    standing_id: int
    query: Graph
    count: int
    graph_version: int
    deltas_seen: int = 0
    fallbacks: int = 0
    inexact: bool = False


def execute_chunk(matcher: Matcher, chunk: list, *, batch: str = "auto",
                  fail_hook=None) -> list[tuple]:
    """Execute one chunk of query items on a shared Matcher; returns
    [(item, outcome | None, elapsed_s)] in chunk order. Items are anything
    with `.query` / `.limit` / `.max_steps` attributes (QueryItem here,
    MatchRequest in `runtime.service`) — an outcome of None means
    the executor died on that item and the caller must re-issue it.

    The superbatched path (`batch="auto"`, ≥2 items) groups items by
    (limit, max_steps) — submitters normally make these uniform — and
    amortizes each group's wall time per item. A group falls back to
    individual execution (its own budget, its own timing) when its shared
    execution raises — a poison query fails alone instead of burning the
    whole chunk's retry attempts, and successfully-batched groups keep
    their results — or when the bucket's *pooled* step budget capped:
    per-item budgets are a per-query contract, so a runaway query must not
    silently truncate its siblings' counts.

    `fail_hook(item)` (chaos hook) runs before each item's individual
    execution; raising there simulates the executor dying on that item
    (it is reported back with outcome None)."""
    done: dict[int, tuple] = {}            # chunk idx -> (outcome, dt)
    if batch == "auto" and len(chunk) > 1:
        groups: dict[tuple, list[int]] = {}
        for k, it in enumerate(chunk):
            groups.setdefault((it.limit, it.max_steps), []).append(k)
        for (limit, max_steps), ks in groups.items():
            t0 = time.perf_counter()
            try:
                if fail_hook is not None:
                    for k in ks:
                        fail_hook(chunk[k])
                outs = matcher.match_many(
                    [chunk[k].query for k in ks], limit=limit,
                    budget=max_steps, batch="auto")
            except Exception:    # noqa: BLE001 — isolate per item below
                continue
            per = (time.perf_counter() - t0) / len(ks)
            for k, out in zip(ks, outs):
                # a capped *bucket* (batched_queries > 0) pooled its
                # members' budgets, so those counts may be truncated —
                # redo them under their own per-item budget. Sequential
                # fallbacks already honored the per-item contract, so
                # their outcomes (timed out or not) are kept.
                if (out.timed_out
                        and getattr(out.stats, "batched_queries", 0)):
                    continue
                done[k] = (out, per)
    results = []
    for k, it in enumerate(chunk):
        if k in done:
            results.append((it, *done[k]))
            continue
        t0 = time.perf_counter()
        try:
            if fail_hook is not None:
                fail_hook(it)
            out = matcher.count(it.query, limit=it.limit,
                                budget=it.max_steps)
            results.append((it, out, time.perf_counter() - t0))
        except Exception:    # noqa: BLE001 — executor died mid-item
            results.append((it, None, 0.0))
    return results


# ------------------------------------------------------------- checkpoint I/O
def write_checkpoint(path: str, state: dict) -> None:
    """Atomically persist `state` as JSON (tmp + `os.replace`), keeping the
    outgoing live file as a `.prev` generation. The live file is itself
    written atomically, so `.prev` exists for *external* corruption — a
    disk fault, a torn write below the filesystem's atomicity, an operator
    truncating the file — which `read_checkpoint` recovers from instead of
    taking the whole service down with a JSON parse error."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    if os.path.exists(path):
        try:
            os.replace(path, path + ".prev")
        except OSError:
            pass                   # fallback generation is best-effort
    os.replace(tmp, path)


def read_checkpoint(path: str | None) -> tuple[dict | None, bool]:
    """Read a checkpoint written by `write_checkpoint`, falling back to
    the `.prev` generation when the live file is truncated or corrupt.
    Returns `(state, fell_back)`:

      * `(state, False)` — live file read cleanly;
      * `(state, True)`  — live file was unreadable (or lost mid-rotate);
        the previous generation was restored instead, with a logged
        warning — callers bump their `restore_fallbacks` stat;
      * `(None, True)`   — every generation unreadable: treated as *no*
        checkpoint rather than a crash, so corruption degrades durability
        (the workload re-runs), never availability;
      * `(None, False)`  — no checkpoint exists.
    """
    if not path:
        return None, False
    saw_any = False
    for p, is_prev in ((path, False), (path + ".prev", True)):
        if not os.path.exists(p):
            continue
        saw_any = True
        try:
            with open(p) as f:
                state = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            logger.warning(
                "checkpoint %s is truncated or corrupt (%s); %s", p, e,
                "falling back to the .prev generation" if not is_prev
                else "no readable generation remains — restarting the "
                     "workload from scratch")
            continue
        if is_prev:
            logger.warning("restored checkpoint from previous generation "
                           "%s", p)
        return state, is_prev
    return None, saw_any


class MatchQueueRuntime:
    """Queue of queries over a shared data graph. `n_executors` simulates the
    pod-level workers; each executor processes one query item at a time
    (within an item, the engine tiles the frontier).

    With `workers > 0` chunks execute on a `runtime.workers.WorkerPool` of
    out-of-process executors instead of the in-process Matcher: a worker
    that crashes, hangs past `worker_deadline_s`, or is OOM-killed loses only
    its own chunk (re-issued under the normal `attempts` budget) while the
    runtime survives. Close the runtime (`close()` / context manager) to
    reap the worker processes. `device` places the Matcher and every
    worker: the card when None, the CPU only when asked."""

    def __init__(self, data: Graph | Dataset, *, encoding: str = "cost",
                 engine: str = "vector", tile_rows: int = 2048,
                 deadline_s: float = 120.0, max_attempts: int = 3,
                 state_path: str | None = None, plan_cache_size: int = 256,
                 workers: int = 0, worker_deadline_s: float = 120.0,
                 device=None):
        self.dataset = (data if isinstance(data, Dataset)
                        else Dataset.from_graph(data))
        self.options = MatchOptions(engine=engine, encoding=encoding,
                                    tile_rows=tile_rows)
        self.matcher = Matcher(self.dataset, self.options, device=device,
                               plan_cache_size=plan_cache_size)
        self.pool = (WorkerPool(self.dataset, workers, self.options,
                                device=self.matcher.device,
                                deadline_s=worker_deadline_s)
                     if workers else None)
        self.deadline_s = deadline_s
        self.max_attempts = max_attempts
        self.state_path = state_path
        self.pending: deque[QueryItem] = deque()
        self.results: dict[int, QueryItem] = {}
        self.standing: dict[int, StandingQuery] = {}
        self._next_standing_id = 0
        self.stats = {"reissued": 0, "stragglers": 0, "failed": 0,
                      "completed": 0, "checkpoints": 0, "cache_hits": 0,
                      "restore_fallbacks": 0, "deltas_applied": 0,
                      "delta_fallbacks": 0, "delta_inexact": 0}

    def close(self) -> None:
        """Reap the worker pool (no-op without one). Idempotent."""
        if self.pool is not None:
            self.pool.close()

    def __enter__(self) -> "MatchQueueRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def submit(self, queries: list[Graph], *, limit: int = 1_000_000,
               max_steps: int | None = 50_000) -> None:
        for q in queries:
            self.pending.append(QueryItem(query_id=len(self.results)
                                          + len(self.pending),
                                          query=q, limit=limit,
                                          max_steps=max_steps))

    # -------------------------------------------------------------- scheduler
    def run(self, *, fail_hook=None, checkpoint_every: int = 0,
            batch: str = "auto") -> dict:
        """Drain the queue. `fail_hook(item)` may raise to simulate executor
        loss; the item is re-queued up to max_attempts (idempotent).

        With `batch="auto"` (default) pending items drain in superbatch
        chunks through `Matcher.match_many`: one chunk per checkpoint window
        (the whole queue when checkpointing is off), so a single shared
        device dispatch can advance every same-shape query in the chunk.
        A chunk whose shared execution raises falls back to per-item
        execution, so one poison query burns only its own retry attempts.
        Batched `elapsed_s` is the chunk wall time amortized per item
        (per-query latency does not exist inside a shared dispatch), so
        deadline/straggler flagging is chunk-granular there; `batch="off"`
        keeps the per-item executor loop with true per-item timing. Items
        already completed (e.g. seeded by `restore()`) are skipped, so a
        checkpoint taken mid-drain never recounts finished queries."""
        if batch not in BATCH_MODES:
            raise ValueError(f"batch must be one of {BATCH_MODES}, "
                             f"got {batch!r}")
        processed = 0
        while self.pending:
            chunk: list[QueryItem] = []
            window = checkpoint_every or len(self.pending)
            while self.pending and len(chunk) < window:
                item = self.pending.popleft()
                done = self.results.get(item.query_id)
                if done is not None and done.done:
                    # restored: already counted — or already permanently
                    # failed (count=None), which must not be resurrected
                    # with a fresh retry budget
                    continue
                item.attempts += 1
                if self.pool is None:
                    # compile before the failure point: the plan lives in
                    # the shared Matcher, so a re-issued attempt starts
                    # from the cache. cache_hits counts attempts whose
                    # plan was already compiled (re-issues and duplicate
                    # workload queries). A compile-phase fault consumes
                    # this attempt and re-issues, like any other executor
                    # death. With a worker pool the plan caches live in
                    # the workers (the whole point: a poison compile
                    # crashes a worker, not this process), so compilation
                    # and cache accounting happen there instead.
                    hits_before = self.matcher.cache_info().hits
                    try:
                        self.matcher.compile(item.query)
                    except Exception:     # noqa: BLE001
                        self._requeue(item)
                        processed += 1
                        continue
                    self.stats["cache_hits"] += (
                        self.matcher.cache_info().hits - hits_before)
                if fail_hook is not None:
                    try:
                        fail_hook(item)   # test hook: simulated node death
                    except Exception:     # noqa: BLE001
                        self._requeue(item)
                        processed += 1
                        continue
                chunk.append(item)
            if not chunk:
                continue
            for it, out, dt in self._exec_chunk(chunk, batch):
                if out is None:      # executor died on this item: re-issue
                    self._requeue(it)
                    continue
                it.count = out.count
                it.elapsed_s = dt
                it.done = True
                if it.elapsed_s > self.deadline_s:
                    # straggler: the deadline overrun only *flags* the item
                    # (first-result-wins, its count is kept and nothing is
                    # re-executed) — distinct from stats["reissued"], which
                    # counts real re-issues after an executor death
                    self.stats["stragglers"] += 1
                self.results[it.query_id] = it
                self.stats["completed"] += 1
            processed += len(chunk)
            if checkpoint_every and processed >= checkpoint_every:
                processed = 0
                self.checkpoint()
        if checkpoint_every:
            # terminal checkpoint: the last window's results — and any item
            # that permanently failed while the chunk was empty — must be
            # durable before the drain reports idle
            self.checkpoint()
        return {i: r.count for i, r in sorted(self.results.items())}

    def _exec_chunk(self, chunk: list[QueryItem], batch: str):
        """Execute one drained chunk; returns [(item, outcome | None,
        elapsed_s)]. Inline this goes through the shared `execute_chunk`
        helper; with a worker pool the chunk crosses the process boundary
        via `WorkerPool.run_sync` (workers always superbatch with
        `batch="auto"`), a dead/hung worker surfacing as outcome None on
        every item so `_requeue` re-issues under the attempts budget."""
        if self.pool is not None:
            res = self.pool.run_sync(chunk)
            self.stats["cache_hits"] += res.cache_hits
            return as_triples(res)
        return execute_chunk(self.matcher, chunk, batch=batch)

    def _requeue(self, item: QueryItem) -> None:
        if item.attempts < self.max_attempts:
            self.pending.append(item)              # re-issue (idempotent)
            self.stats["reissued"] += 1
        else:
            item.done = True
            item.count = None
            self.results[item.query_id] = item
            self.stats["failed"] += 1

    # --------------------------------------------------------- standing queries
    def register_standing(self, query: Graph, *,
                          limit: int = 1_000_000) -> int:
        """Register a standing query: counted exactly once now, then rolled
        forward by every subsequent `apply_delta`. Returns the standing id
        (key into `self.standing`). Raises ValueError if the initial count
        is inexact (timed out / hit `limit`) — a standing count must be a
        sound delta base."""
        out = self.matcher.count(query, limit=limit)
        if out.timed_out or out.count >= limit:
            raise ValueError(
                "standing query's initial count is inexact (timed out or "
                "hit the limit); raise `limit` or simplify the query")
        sid = self._next_standing_id
        self._next_standing_id += 1
        self.standing[sid] = StandingQuery(
            standing_id=sid, query=query, count=out.count,
            graph_version=out.graph_version)
        return sid

    def apply_delta(self, delta) -> dict[int, object]:
        """Apply one GraphDelta to the shared Dataset and roll every
        standing query's count forward (`Matcher.count_delta`: pinned
        delta enumeration, full recount on fallback). Returns
        {standing_id: DeltaOutcome}. With no standing queries the dataset
        still advances one version.

        A fallback recount that timed out or hit its limit is surfaced,
        not silently adopted: the outcome carries `inexact=True`, the
        standing query is flagged `inexact` (and `stats["delta_inexact"]`
        bumped) until a later delta's recount completes exactly. The
        possibly-undercounted value is still installed — it is the best
        available estimate and its staleness is visible — but it never
        becomes a delta base (`Matcher` only seeds exact counts)."""
        sids = sorted(self.standing)
        if not sids:
            self.dataset.apply_delta(delta)
            self.stats["deltas_applied"] += 1
            return {}
        outs = self.matcher.count_delta(
            [self.standing[s].query for s in sids], delta)
        self.stats["deltas_applied"] += 1
        result = {}
        for sid, out in zip(sids, outs):
            sq = self.standing[sid]
            sq.count = out.count
            sq.graph_version = out.graph_version
            sq.deltas_seen += 1
            sq.inexact = out.inexact
            if out.fallback:
                sq.fallbacks += 1
                self.stats["delta_fallbacks"] += 1
            if out.inexact:
                self.stats["delta_inexact"] += 1
            result[sid] = out
        return result

    # ------------------------------------------------------------- checkpoint
    def checkpoint(self) -> None:
        """Persist queue results, pending ids, per-item retry `attempts`,
        standing-query counts, and the dataset's graph_version (restore()
        refuses a checkpoint taken against a different version — those
        counts are stale). A permanently-failed item is recorded as a
        null count *with* its spent attempts, so a restart resumes it as
        failed instead of resurrecting it with a fresh retry budget."""
        if not self.state_path:
            return
        attempts = {str(i): r.attempts for i, r in self.results.items()
                    if r.attempts}
        attempts.update({str(r.query_id): r.attempts for r in self.pending
                         if r.attempts})
        state = {
            "results": {str(i): r.count for i, r in self.results.items()},
            "pending": [r.query_id for r in self.pending],
            "attempts": attempts,
            "graph_version": self.dataset.graph_version,
            "standing": {str(s): {"count": sq.count,
                                  "graph_version": sq.graph_version,
                                  "inexact": sq.inexact}
                         for s, sq in self.standing.items()},
        }
        write_checkpoint(self.state_path, state)
        self.stats["checkpoints"] += 1

    def restore(self) -> dict | None:
        """Load the last checkpoint and apply it: submitted items whose
        query_id the checkpoint records as completed are pulled out of
        `pending` and their counts seeded into `results`, so a
        subsequent `run()` (batched or not) never recounts them. Items the
        checkpoint records as permanently failed (null count) are seeded
        back as failed — their retry budget was spent before the restart
        and does not refresh, so a poison query burns `max_attempts` once
        over the service's whole lifetime, not per restart. Items still
        pending get their recorded `attempts` restored for the same
        reason. Call after re-`submit()`ing the same workload. Returns the
        raw checkpoint state (or None when there is no checkpoint).

        A checkpoint whose recorded `graph_version` differs from the live
        dataset's is rejected with ValueError instead of silently re-serving
        stale counts — every count in it was taken against a graph that no
        longer exists. (Checkpoints from before the streaming subsystem
        carry no version and are accepted as version 0.)

        A truncated/corrupt state file is not fatal: `read_checkpoint`
        falls back to the `.prev` generation (bumping
        `stats["restore_fallbacks"]`), and with no readable generation
        at all the restore is a no-op — the workload simply re-runs."""
        state, fell_back = read_checkpoint(self.state_path)
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
        finished = {int(i): c for i, c in state.get("results", {}).items()}
        attempts = {int(i): int(a)
                    for i, a in state.get("attempts", {}).items()}
        if finished or attempts:
            still_pending = deque()
            for item in self.pending:
                item.attempts = attempts.get(item.query_id, item.attempts)
                if item.query_id in finished:
                    item.count = finished[item.query_id]
                    item.done = True
                    if item.count is None and not item.attempts:
                        # pre-attempts checkpoint recorded the failure but
                        # not the spent budget; pin it so run() cannot retry
                        item.attempts = self.max_attempts
                    self.results[item.query_id] = item
                else:
                    still_pending.append(item)
            self.pending = still_pending
        for sid, sq in self.standing.items():
            rec = state.get("standing", {}).get(str(sid))
            if rec is not None and rec["graph_version"] == ckpt_version:
                sq.count = rec["count"]
                sq.graph_version = rec["graph_version"]
                sq.inexact = bool(rec.get("inexact", False))
        return state
