"""Out-of-process executor pool for the match service and queue runtime.

An injected in-process "executor death" cannot show what a genuinely
crashed, hung or OOM-killed worker does to a service. This module makes the
failure domain real. A `WorkerPool` owns N worker *processes* (spawned via
`multiprocessing`, so each has its own Python runtime, torch runtime, CUDA
context and address space) and the service/queue dispatch superbatch
buckets to them instead of calling `execute_chunk` inline:

  * **Transport** — one duplex pipe per worker carrying length-prefixed
    pickled payloads (`_send`/`_recv`). The redundant length prefix inside
    the transport frame is deliberate: a frame from a worker that was
    SIGKILLed mid-write fails the prefix check and is treated as a worker
    death rather than fed to `pickle.loads`.
  * **Watchdog deadlines** — every dispatched bucket carries a wall-clock
    deadline; `poll()` SIGKILLs any worker still busy past it (a wedged
    worker — deep DFS, poison compile, runaway query — cannot be
    interrupted any other way) and reports the bucket back with
    `hung=True` so the caller can re-issue it.
  * **Liveness** — `poll()` reaps workers whose process died silently
    (OOM killer, segfault) even when no pipe event fires, and
    `check_health()` pings idle workers and respawns unresponsive ones.
  * **Respawn** — every death (watchdog kill, chaos kill, real crash) is
    followed by an automatic respawn, so the pool returns to its
    configured size; a run of consecutive *startup* failures raises
    instead of crash-looping (`max_boot_failures`).
  * **Chaos hooks** — `kill_ticket()` SIGKILLs the worker currently
    executing a bucket (real process death mid-bucket, driven by
    `FaultInjector.kill_worker`), and a dispatched bucket can carry
    `hang_s` (the worker sleeps before executing — indistinguishable from
    a wedge, which is the point: the watchdog must recover it).

Workers rebuild the `Dataset` from the pickled data `Graph` at startup and
keep per-`(tenant, engine)` Matchers, so a bucket retried under a degraded
engine (`engine="ref"` after repeated vector faults — the service's
degradation ladder, docs/serving.md#process-isolation--failure-domains,
which runs on the CPU only) executes against a plan cache that never mixes tenants or engines.
Execution inside the worker reuses `runtime.queue.execute_chunk`, so
superbatching and per-item poison isolation behave exactly as inline.

Devices: the pool takes the parent's device (the card unless the caller
passes `device="cpu"`) and hands it to every worker as a string; each
worker resolves it with `repro_torch.device.resolve_device` and opens its
own CUDA context before it reports ready, so a worker that cannot reach the
card fails its boot (and `max_boot_failures` turns a run of those into an
error) instead of quietly running on the CPU. Workers are spawned, never
forked: a forked child would inherit the parent's CUDA context. On the
card the parent builds the kernel library before the first spawn, so
workers load it and never compile. Each result frame carries the bitmap
kernel launches the bucket made in its worker (`kernel_launches`), and the
pool records each worker's pid and boot seconds (`boots`).

The pool is single-dispatcher: one parent thread calls
`dispatch()`/`poll()`; workers run concurrently between those calls.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import struct
import time
from multiprocessing.connection import wait as _conn_wait

from ..device import resolve_device

__all__ = ["WorkerPool", "BucketResult", "WorkerOutcome", "as_triples"]

_LEN = struct.Struct("!Q")

# worker lifecycle states (parent-side bookkeeping)
_STARTING, _IDLE, _BUSY = "starting", "idle", "busy"


# ------------------------------------------------------------------ framing
def _send(conn, obj) -> None:
    """Write one length-prefixed pickled frame to a pipe connection."""
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    conn.send_bytes(_LEN.pack(len(blob)) + blob)


def _recv(conn):
    """Read one frame; raises EOFError/OSError on a dead peer and
    ValueError on a torn frame (peer killed mid-write)."""
    data = conn.recv_bytes()
    if len(data) < _LEN.size:
        raise ValueError("torn frame: short header")
    (n,) = _LEN.unpack(data[: _LEN.size])
    if n != len(data) - _LEN.size:
        raise ValueError(f"torn frame: header says {n}, "
                         f"got {len(data) - _LEN.size}")
    return pickle.loads(data[_LEN.size:])


# ----------------------------------------------------------------- outcomes
@dataclasses.dataclass(frozen=True)
class WorkerOutcome:
    """The slice of a MatchOutcome that crosses the process boundary:
    the count and whether the item's budget/limit capped it."""

    count: int
    timed_out: bool = False


@dataclasses.dataclass
class BucketResult:
    """One dispatched bucket's terminal pool-side state. Exactly one of:
    executed (`counts` set — per item `(count | None, timed_out)`, None =
    the item raised inside the worker) or `worker_died=True` (`counts` is
    None: the process crashed, was chaos-killed, or — `hung=True` — was
    SIGKILLed by the watchdog past its deadline; the caller must re-issue
    every item). `exec_s` is the worker-measured execution wall time,
    which excludes dispatch/pickling overhead by construction — the
    service's admission estimate runs on it."""

    ticket: int
    items: list
    engine: str | None
    counts: list | None = None
    exec_s: float = 0.0
    cache_hits: int = 0
    worker_died: bool = False
    hung: bool = False
    launches: dict | None = None      # bitmap kernel launches in the worker


def as_triples(res: BucketResult) -> list[tuple]:
    """Adapt a BucketResult to `execute_chunk`'s return shape
    [(item, outcome | None, elapsed_s)] so pool and inline execution are
    interchangeable to the service/queue finalization code."""
    if res.worker_died:
        return [(it, None, 0.0) for it in res.items]
    per = res.exec_s / max(len(res.items), 1)
    out = []
    for it, (count, timed_out) in zip(res.items, res.counts):
        if count is None:
            out.append((it, None, 0.0))
        else:
            out.append((it, WorkerOutcome(count=count, timed_out=timed_out),
                        per))
    return out


# ------------------------------------------------------------- worker (child)
@dataclasses.dataclass
class _Item:
    """Worker-local work item with the attribute shape `execute_chunk`
    expects (`.query`/`.limit`/`.max_steps`)."""

    query: object
    limit: int
    max_steps: int | None


def _worker_main(conn, graph, options, device: str,
                 spawned_at: float) -> None:
    """Child-process entry: resolve the device (opening this process's CUDA
    context on the card), build the Dataset once, then serve frames.

    Protocol (all frames are length-prefixed pickles):
      child  -> {"op": "ready", pid, boot_s}        (once, at startup)
      parent -> {"op": "ping"}                      -> {"op": "pong"}
      parent -> {"op": "stop"}                      -> exits
      parent -> {"op": "bucket", ticket, items: [(query, limit,
                 max_steps)], tenant, engine, hang_s}
             -> {"op": "result", ticket, counts: [(count | None,
                 timed_out)], exec_s, cache_hits, launches}

    A Python-level exception on one item is already isolated by
    `execute_chunk` (that item's count is None, siblings complete); a
    crash that kills this process is the parent watchdog's problem, and
    an exception before "ready" (no card, say) is a boot failure.
    """
    # heavy imports belong to the child: the parent never pays them here
    import torch

    from ..api import Dataset, Matcher
    from ..kernels import bitmap_intersect as bi
    from .queue import execute_chunk

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)      # open the context before "ready"
    dataset = Dataset.from_graph(graph)
    matchers: dict[tuple, Matcher] = {}

    def matcher_for(tenant: str, engine: str | None) -> Matcher:
        opts = options if engine in (None, options.engine) \
            else options.replace(engine=engine)
        key = (tenant, opts.engine)
        m = matchers.get(key)
        if m is None:
            m = matchers[key] = Matcher(dataset, opts, device=dev,
                                        tenant=tenant)
        return m

    def launches() -> dict:
        return {fn.__name__: fn.launches for fn in bi.WRAPPERS}

    _send(conn, {"op": "ready", "pid": os.getpid(),
                 "boot_s": time.time() - spawned_at})
    while True:
        try:
            msg = _recv(conn)
        except (EOFError, OSError):
            return                              # parent went away
        op = msg["op"]
        if op == "stop":
            return
        if op == "ping":
            _send(conn, {"op": "pong", "pid": os.getpid()})
            continue
        assert op == "bucket", op
        if msg.get("hang_s"):
            time.sleep(msg["hang_s"])           # injected wedge (chaos)
        matcher = matcher_for(msg["tenant"], msg.get("engine"))
        hits0 = matcher.cache_info().hits
        items = [_Item(query=q, limit=lim, max_steps=ms)
                 for (q, lim, ms) in msg["items"]]
        launches0 = launches()
        t0 = time.perf_counter()
        outs = execute_chunk(matcher, items, batch="auto")
        exec_s = time.perf_counter() - t0
        counts = [(None if out is None else int(out.count),
                   bool(out is not None and out.timed_out))
                  for _, out, _ in outs]
        try:
            _send(conn, {"op": "result", "ticket": msg["ticket"],
                         "counts": counts, "exec_s": exec_s,
                         "cache_hits": matcher.cache_info().hits - hits0,
                         "launches": {k: v - launches0[k]
                                      for k, v in launches().items()}})
        except (BrokenPipeError, OSError):
            return                              # parent went away


# -------------------------------------------------------------- pool (parent)
class _Worker:
    """Parent-side handle on one worker process."""

    __slots__ = ("proc", "conn", "state", "ticket", "items", "engine",
                 "deadline", "boot_deadline")

    def __init__(self, proc, conn, boot_timeout_s: float):
        self.proc = proc
        self.conn = conn
        self.state = _STARTING
        self.ticket: int | None = None
        self.items: list | None = None
        self.engine: str | None = None
        self.deadline: float = 0.0
        self.boot_deadline = time.monotonic() + boot_timeout_s


class WorkerPool:
    """A fixed-size pool of out-of-process match executors (module
    docstring for the contract). `data` is a Graph or Dataset — workers
    receive the raw Graph and preprocess their own Dataset, so a respawn
    needs nothing from the crashed predecessor. `device` is the workers'
    device: the card when None, "cpu" only when asked. All deadlines here
    are real wall-clock (`time.monotonic`): processes hang in real time,
    so the watchdog cannot run on an injected test clock."""

    def __init__(self, data, n_workers: int, options=None, *,
                 device=None, deadline_s: float = 30.0,
                 boot_timeout_s: float = 120.0, max_boot_failures: int = 3):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if options is None:
            from ..api import MatchOptions
            options = MatchOptions()
        dev = resolve_device(device)
        if dev.type == "cuda":
            # build the kernel library once, here: workers only load it
            from ..kernels.bitmap_intersect import LIBRARY
            from ..kernels.build import build_library
            build_library(LIBRARY)
        self._device = str(dev)
        self._graph = getattr(data, "graph", data)
        self._options = options
        self._ctx = mp.get_context("spawn")
        self._deadline_s = deadline_s
        self._boot_timeout_s = boot_timeout_s
        self._max_boot_failures = max_boot_failures
        self._boot_failures = 0
        self._next_ticket = 0
        self._closed = False
        self.size = n_workers
        self.stats = {"spawned": 0, "respawned": 0, "deaths": 0,
                      "watchdog_kills": 0, "chaos_kills": 0,
                      "dispatched": 0, "completed": 0, "pings": 0,
                      "worker_cache_hits": 0}
        # bitmap kernel launches summed over every completed bucket, and
        # {"pid", "boot_s"} of every worker that reported ready
        self.kernel_launches: dict[str, int] = {}
        self.boots: list[dict] = []
        self._workers = [self._spawn() for _ in range(n_workers)]

    # --------------------------------------------------------------- lifecycle
    def _spawn(self) -> _Worker:
        parent, child = self._ctx.Pipe(duplex=True)
        # the worker reports its boot seconds from this wall-clock stamp
        # (start() itself blocks while the child reads its arguments)
        proc = self._ctx.Process(
            target=_worker_main,
            args=(child, self._graph, self._options, self._device,
                  time.time()),
            daemon=True, name=f"match-worker-{self.stats['spawned']}")
        proc.start()
        child.close()                 # the child's end lives in the child
        self.stats["spawned"] += 1
        return _Worker(proc, parent, self._boot_timeout_s)

    def _kill(self, w: _Worker) -> None:
        try:
            w.proc.kill()             # SIGKILL: works on wedged processes
            w.proc.join(timeout=5.0)
        except (OSError, ValueError):
            pass
        try:
            w.conn.close()
        except OSError:
            pass

    def _respawn(self, w: _Worker, results: list) -> None:
        """Retire a dead worker: emit its in-flight bucket (if any) as a
        death result, enforce the boot-failure guard, spawn a successor
        in its slot."""
        if w.state == _BUSY and w.ticket is not None:
            results.append(BucketResult(
                ticket=w.ticket, items=w.items, engine=w.engine,
                worker_died=True))
            self.stats["deaths"] += 1
            self._boot_failures = 0
        elif w.state == _STARTING:
            # died before ready: an environment problem, not a poison
            # query — crash-looping the spawn would hide it
            self._boot_failures += 1
            if self._boot_failures >= self._max_boot_failures:
                self._kill(w)
                raise RuntimeError(
                    f"{self._boot_failures} consecutive workers died "
                    f"before becoming ready; the worker environment is "
                    f"broken (not a query fault)")
        self._kill(w)
        self.stats["respawned"] += 1
        self._workers[self._workers.index(w)] = self._spawn()

    def close(self) -> None:
        """Shut the pool down: polite stop for idle workers, SIGKILL for
        the rest. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            if w.state == _IDLE:
                try:
                    _send(w.conn, {"op": "stop"})
                except (BrokenPipeError, OSError, ValueError):
                    pass
        for w in self._workers:
            w.proc.join(timeout=0.5)
            self._kill(w)

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort: never leak worker processes
        try:
            self.close()
        except Exception:   # noqa: BLE001 — interpreter teardown
            pass

    # -------------------------------------------------------------- accounting
    def idle_count(self) -> int:
        """Workers ready to take a bucket right now."""
        return sum(1 for w in self._workers if w.state == _IDLE)

    def waiting_count(self) -> int:
        """Workers the parent is waiting on (starting up or executing) —
        when 0, `poll()` has nothing to block for."""
        return sum(1 for w in self._workers
                   if w.state in (_STARTING, _BUSY))

    def alive_count(self) -> int:
        """Worker processes currently alive (the pool-recovered-to-size
        invariant checks this against `size`)."""
        return sum(1 for w in self._workers if w.proc.is_alive())

    # ---------------------------------------------------------------- dispatch
    def dispatch(self, items: list, *, tenant: str = "default",
                 engine: str | None = None, deadline_s: float | None = None,
                 hang_s: float = 0.0) -> int | None:
        """Hand one bucket to an idle worker; returns the ticket, or None
        when no idle worker could take it (none idle, or the chosen
        worker died at send time — a real death, already scheduled for
        respawn; the caller treats its bucket like any worker loss).
        `items` need `.query`/`.limit`/`.max_steps` attributes."""
        if self._closed:
            raise RuntimeError("dispatch() on a closed WorkerPool")
        payload = [(it.query, it.limit, it.max_steps) for it in items]
        for w in self._workers:
            if w.state != _IDLE:
                continue
            ticket = self._next_ticket
            try:
                _send(w.conn, {"op": "bucket", "ticket": ticket,
                               "items": payload, "tenant": tenant,
                               "engine": engine, "hang_s": hang_s})
            except (BrokenPipeError, OSError, ValueError):
                w.state = _BUSY   # mark dead-with-no-ticket for respawn
                w.ticket, w.items, w.engine = None, None, None
                self._respawn(w, [])
                continue
            self._next_ticket += 1
            w.state = _BUSY
            w.ticket, w.items, w.engine = ticket, list(items), engine
            w.deadline = time.monotonic() + (
                deadline_s if deadline_s is not None else self._deadline_s)
            self.stats["dispatched"] += 1
            return ticket
        return None

    def kill_ticket(self, ticket: int) -> bool:
        """Chaos hook: SIGKILL the worker currently executing `ticket` —
        a real process death mid-bucket. The death surfaces through the
        normal `poll()` path (EOF on the pipe → death result → respawn).
        Returns False if the ticket is not in flight."""
        for w in self._workers:
            if w.state == _BUSY and w.ticket == ticket:
                self.stats["chaos_kills"] += 1
                try:
                    w.proc.kill()
                except (OSError, ValueError):
                    pass
                return True
        return False

    # -------------------------------------------------------------------- poll
    def poll(self, timeout: float = 0.0) -> list[BucketResult]:
        """Collect every finished/failed bucket: reap silently-dead
        processes, read ready/result frames (blocking up to `timeout`
        for the first event), then run the watchdog — any worker busy
        past its bucket deadline (or stuck in startup past
        `boot_timeout_s`) is SIGKILLed, reported, and respawned."""
        results: list[BucketResult] = []
        # 1) pipe events first: ready handshakes and bucket results — and
        #    idle conns too, where readability can only mean EOF (death).
        #    Reading before reaping means a worker that finished its
        #    bucket and *then* died still gets its result honored.
        conns = {w.conn: w for w in self._workers if not w.conn.closed}
        if conns:
            for conn in _conn_wait(list(conns), timeout):
                w = conns[conn]
                try:
                    msg = _recv(conn)
                except (EOFError, OSError, ValueError,
                        pickle.UnpicklingError):
                    self._respawn(w, results)
                    continue
                op = msg.get("op")
                if op == "ready":
                    w.state = _IDLE
                    self._boot_failures = 0
                    self.boots.append({"pid": msg["pid"],
                                       "boot_s": msg["boot_s"]})
                elif op == "result":
                    results.append(BucketResult(
                        ticket=msg["ticket"], items=w.items,
                        engine=w.engine, counts=msg["counts"],
                        exec_s=msg["exec_s"],
                        cache_hits=msg["cache_hits"],
                        launches=msg["launches"]))
                    for k, v in msg["launches"].items():
                        self.kernel_launches[k] = \
                            self.kernel_launches.get(k, 0) + v
                    self.stats["completed"] += 1
                    self.stats["worker_cache_hits"] = \
                        self.stats.get("worker_cache_hits", 0) \
                        + msg["cache_hits"]
                    w.state = _IDLE
                    w.ticket, w.items, w.engine = None, None, None
        # 2) reap silently-dead processes whose pipe event (if any) was
        #    consumed above — covers idle workers lost to the OOM killer
        for w in list(self._workers):
            if not w.proc.is_alive():
                self._respawn(w, results)
        # 3) watchdog: wall-clock deadlines on busy + starting workers
        now = time.monotonic()
        for w in list(self._workers):
            if w.state == _BUSY and w.ticket is not None \
                    and now > w.deadline:
                self.stats["watchdog_kills"] += 1
                self._boot_failures = 0
                ticket, items, engine = w.ticket, w.items, w.engine
                self._kill(w)
                results.append(BucketResult(
                    ticket=ticket, items=items, engine=engine,
                    worker_died=True, hung=True))
                self.stats["deaths"] += 1
                self.stats["respawned"] += 1
                self._workers[self._workers.index(w)] = self._spawn()
            elif w.state == _STARTING and now > w.boot_deadline:
                self._respawn(w, results)
        return results

    def run_sync(self, items: list, *, tenant: str = "default",
                 engine: str | None = None, deadline_s: float | None = None,
                 poll_s: float = 0.05) -> BucketResult:
        """Dispatch one bucket and block until *its* result (or death)
        comes back — the queue runtime's synchronous drain path. Other
        tickets finishing meanwhile would be lost, so this must only be
        used when the caller has no other buckets in flight."""
        ticket = None
        while ticket is None:
            ticket = self.dispatch(items, tenant=tenant, engine=engine,
                                   deadline_s=deadline_s)
            if ticket is None:
                self.poll(poll_s)     # wait for startup / free a worker
        while True:
            for res in self.poll(poll_s):
                if res.ticket == ticket:
                    return res

    # ------------------------------------------------------------------ health
    def check_health(self, *, timeout_s: float = 5.0) -> int:
        """Heartbeat sweep: ping every idle worker and respawn any that
        is dead or fails to pong within `timeout_s`. Returns the number
        of workers respawned (0 = fully healthy). Busy/starting workers
        are the watchdog's job, not the heartbeat's."""
        respawned = 0
        for w in list(self._workers):
            if w.state != _IDLE:
                continue
            ok = False
            try:
                _send(w.conn, {"op": "ping"})
                self.stats["pings"] += 1
                if w.conn.poll(timeout_s):
                    ok = _recv(w.conn).get("op") == "pong"
            except (BrokenPipeError, EOFError, OSError, ValueError,
                    pickle.UnpicklingError):
                ok = False
            if not ok:
                w.state = _BUSY       # dead/unresponsive; no ticket
                w.ticket, w.items, w.engine = None, None, None
                self._respawn(w, [])
                respawned += 1
        return respawned
