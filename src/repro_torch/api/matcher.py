"""Matcher: the session-style facade over both CEMR engines.

Torch port of `repro.api.Matcher`. One Matcher serves many queries against
one Dataset on one device:

  * `compile(query)` — filtering + ordering + encoding + static analysis,
    cached by canonical query signature (LRU-bounded). The vector engine's
    MatchingPlan is built lazily inside the cached CompiledQuery and its
    tables are uploaded to the device once per engine configuration.
  * `count` / `stream` / `match_many` — execution, returning one result
    type (`MatchOutcome`) regardless of engine; `match_many(batch="auto")`
    drains vector-engine queries that share a padded plan shape through
    one cross-query superbatch.
  * `explain` — order, coloring, per-level plan stages, candidate sizes.
  * `count_delta` — apply a `GraphDelta` to the Dataset and roll exact
    counts forward through it (`base + created - destroyed`, pinned host
    enumerations over the delta's edges) instead of re-enumerating; a query
    without a base is recounted on the device. Compiled plans whose query
    labels no delta touched are carried across dataset versions.
  * `tenant_view` — a Matcher with a private plan cache over the same
    Dataset (the serving runtime's isolation primitive).
  * `mesh` — sharded enumeration (`core.shard`): `mesh=k` spreads the
    vector engine's supersteps over k lanes, one a visible card (clamped
    to the cards there are; one card runs the single-device path), and
    `mesh="auto"` picks the lane count by the reference's cost model.

The device is the card (`cuda`) unless the caller passes `device="cpu"`;
with no CUDA and no explicit "cpu", construction raises.

Engine auto-selection (`engine="auto"`), as in the reference:

  1. directed or edge-labeled data → "ref";
  2. total candidate rows Σ|C(u)| < AUTO_VECTOR_MIN_ROWS → "ref";
  3. otherwise → "vector".
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import OrderedDict
from typing import Iterator

import numpy as np

from ..core.encoding import BLACK, QueryAnalysis
from ..core.engine import VectorEngine, VectorStats
from ..core.filtering import CandidateSpace
from ..core.graph import Graph
from ..core.plan import build_plan, plan_shape_signature
from ..core.ref_engine import MatchStats, cemr_match, preprocess
from ..device import resolve_device
from ..launch import mesh as _mesh
from .dataset import Dataset
from .options import BATCH_MODES, MatchOptions, auto_mesh_devices
from .signature import graph_signature

__all__ = ["Matcher", "CompiledQuery", "MatchOutcome", "CacheInfo",
           "AUTO_VECTOR_MIN_ROWS", "BATCH_MODES"]

# auto-heuristic threshold: below this many total candidate rows the DFS
# engine's low fixed overhead wins; above it the tile engine amortizes.
AUTO_VECTOR_MIN_ROWS = 512


@dataclasses.dataclass
class MatchOutcome:
    """Engine-independent result of one matching call."""

    count: int
    engine: str                       # "ref" | "vector" (resolved)
    elapsed_s: float                  # enumeration time (excludes compile)
    timed_out: bool
    stats: object                     # MatchStats (ref) | VectorStats (vector)
    embeddings: list[dict[int, int]] | None = None
    plan_cached: bool = False         # this call hit the plan cache
    compile_s: float = 0.0            # time this call spent compiling
    graph_version: int = 0            # Dataset.graph_version of the count
    engine_requested: str = ""        # the engine option as requested

    @property
    def engine_used(self) -> str:
        """The resolved engine that actually ran ("ref" | "vector")."""
        return self.engine


@dataclasses.dataclass(frozen=True)
class CacheInfo:
    """Plan-cache counters returned by `Matcher.cache_info()` (hits/misses
    are cumulative for the Matcher's lifetime; size/maxsize describe the
    LRU; `carried` counts hits served by carrying a compiled plan across a
    dataset version bump whose deltas provably couldn't affect it)."""

    hits: int
    misses: int
    size: int
    maxsize: int
    carried: int = 0


class CompiledQuery:
    """A query compiled against one Dataset: candidate space + analysis,
    plus lazily-built per-engine artifacts (vector MatchingPlan, engines
    keyed by runtime knobs and device, each holding the plan's tables on
    its device). Cached and reused by Matcher; carried across dataset
    versions with its plan and engines when no delta touched its labels."""

    def __init__(self, query: Graph, dataset: Dataset, options: MatchOptions,
                 cs: CandidateSpace, an: QueryAnalysis):
        self.query = query
        self.dataset = dataset
        self.options = options          # the plan-relevant options at compile
        self.cs = cs
        self.an = an
        self.empty = any(c.shape[0] == 0 for c in cs.cand)
        self._plan = None               # vector MatchingPlan, built once
        self._engines: dict = {}

    @property
    def plan(self):
        """The vector-engine MatchingPlan (packed bitmap tables), built
        lazily on first access and shared by every engine configuration."""
        if self._plan is None:
            self._plan = build_plan(
                self.cs, self.an,
                graph_version=self.dataset.graph_version)
        return self._plan

    def vector_engine(self, opts: MatchOptions, device, intersect_fn=None,
                      mesh=None):
        """Build (or reuse) the VectorEngine for this compiled query under
        the given runtime knobs. `mesh` is an already-resolved `EnumMesh`
        (or None); engines are keyed by every knob that changes the built
        step functions, so option changes never silently share state."""
        key = (opts.tile_rows, opts.use_cv, opts.use_dedup,
               opts.use_cer_buffer, opts.cer_buffer_slots,
               opts.use_failure_cache,
               opts.failure_cache_slots, opts.pack_tiles, opts.overlap,
               opts.intersect, id(intersect_fn), str(device), mesh)
        eng = self._engines.get(key)
        if eng is None:
            eng = VectorEngine(self.cs, self.an, device=device,
                               tile_rows=opts.tile_rows,
                               use_cv=opts.use_cv, use_dedup=opts.use_dedup,
                               use_cer_buffer=opts.use_cer_buffer,
                               cer_buffer_slots=opts.cer_buffer_slots,
                               use_failure_cache=opts.use_failure_cache,
                               failure_cache_slots=opts.failure_cache_slots,
                               pack_tiles=opts.pack_tiles,
                               overlap=opts.overlap,
                               intersect=opts.intersect,
                               intersect_fn=intersect_fn, plan=self.plan,
                               mesh=mesh)
            self._engines[key] = eng
        return eng

    # ---------------------------------------------------------------- explain
    def resolve_engine(self, engine: str) -> str:
        """Resolve "auto" to "ref" or "vector" for this compiled query;
        explicit engine names pass through unchanged."""
        if engine != "auto":
            return engine
        g = self.dataset.graph
        if g.directed or g.edge_labels is not None:
            return "ref"
        if int(self.cs.sizes().sum()) < AUTO_VECTOR_MIN_ROWS:
            return "ref"
        return "vector"

    def explain(self, engine: str = "auto") -> str:
        """Human-readable compilation report: resolved engine, matching
        order, black/white coloring, per-level candidate sizes, and (for
        the vector engine) the plan's stage list."""
        an, cs = self.an, self.cs
        resolved = self.resolve_engine(engine)
        sizes = cs.sizes()
        lines = [
            f"query: |V|={self.query.n} |E|={self.query.n_edges} "
            f"signature={graph_signature(self.query)[:12]}",
            f"dataset: {self.dataset!r}",
            f"graph_version: {self.dataset.graph_version}"
            + (f" (plan packed at v{self._plan.graph_version})"
               if self._plan is not None else ""),
            f"engine: {resolved}" + (" (auto)" if engine == "auto" else ""),
            f"encoding={self.options.encoding} "
            f"order_heuristic={self.options.order_heuristic} "
            f"refine_rounds={self.options.refine_rounds}",
            f"order: {an.order}",
            "stages:",
        ]
        for i, u in enumerate(an.order):
            color = "black" if an.colors[u] == BLACK else "white"
            bwd = an.bwd[i]
            lines.append(
                f"  L{i} u{u} [{color}] |C|={int(sizes[u])} "
                f"bwd={bwd if bwd else '-'} "
                f"cer={'on' if an.cer_enabled[i] else 'off'} "
                f"con={len(an.con[i])}")
        if self.empty:
            lines.append("note: empty candidate set -> 0 embeddings "
                         "(no enumeration)")
        elif resolved == "vector":
            lines.append("vector plan:")
            for op in self.plan.ops:
                store = "IDX" if op.idx_slot >= 0 else "BM"
                lines.append(
                    f"  L{op.level} u{op.vertex} case={op.case} store={store} "
                    f"bk={len(op.bk_pairs)} wt={len(op.wt_vertices)} "
                    f"dedup={'on' if op.dedup_slots else 'off'} "
                    f"words={op.n_words}")
        return "\n".join(lines)


class Matcher:
    """Session facade: one preprocessed Dataset, many queries, one plan cache.

    >>> ds = Dataset.from_graph(data)
    >>> m = Matcher(ds)                       # the card, engine="auto"
    >>> m.count(query).count
    >>> Matcher(ds, device="cpu").count(query, engine="ref").count
    >>> list(m.stream(query, limit=10))
    """

    def __init__(self, dataset: Dataset | Graph,
                 options: MatchOptions | None = None, *, device=None,
                 plan_cache_size: int = 128, intersect_fn=None,
                 tenant: str = "default"):
        self.device = resolve_device(device)
        if isinstance(dataset, Graph):
            dataset = Dataset.from_graph(dataset)
        self.dataset = dataset
        self.options = options if options is not None else MatchOptions()
        self.tenant = tenant
        if plan_cache_size < 1:
            raise ValueError("plan_cache_size must be >= 1")
        self._maxsize = plan_cache_size
        self._cache: OrderedDict[tuple, CompiledQuery] = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._carried = 0
        # (query signature, plan_key) -> newest full cache key, so a compile
        # after a dataset mutation can find the previous version's entry and
        # try to carry it forward instead of recompiling
        self._latest: dict[tuple, tuple] = {}
        # the dataset version whose stale entries were last released
        self._swept_version = dataset.graph_version
        # query signature -> (graph_version, exact count): bases for
        # count_delta / standing queries, seeded by exact count() calls
        self._standing: OrderedDict[str, tuple[int, int]] = OrderedDict()
        self._standing_max = 4 * plan_cache_size
        self._intersect_fn = intersect_fn
        # warm SuperbatchScheduler per (signature, plan identity, knobs):
        # repeated match_many workloads reuse stacked tables and CER
        # buffers. Entries hold their plans strongly, so ids stay
        # unambiguous.
        self._batch_cache: OrderedDict[tuple, object] = OrderedDict()
        self._batch_cache_max = 8
        # resolved enumeration meshes, memoized per lane count
        self._meshes: dict = {}

    # ------------------------------------------------------------------ cache
    def cache_info(self) -> CacheInfo:
        """Plan-cache counters (cumulative hits/misses, current size)."""
        return CacheInfo(hits=self._hits, misses=self._misses,
                         size=len(self._cache), maxsize=self._maxsize,
                         carried=self._carried)

    def tenant_view(self, tenant: str, *,
                    plan_cache_size: int | None = None,
                    options: MatchOptions | None = None) -> "Matcher":
        """A tenant-isolated Matcher over the same preprocessed Dataset and
        device. The query-independent state the Dataset owns is shared; the
        per-query state (plan cache, warm superbatch schedulers and their
        device tables, standing bases, hit/miss counters) is private to the
        view, so one tenant's cold query storm evicts only its own entries.
        Defaults inherit this Matcher's options, cache size and
        intersect_fn."""
        return Matcher(self.dataset,
                       options if options is not None else self.options,
                       device=self.device,
                       plan_cache_size=(plan_cache_size
                                        if plan_cache_size is not None
                                        else self._maxsize),
                       intersect_fn=self._intersect_fn, tenant=tenant)

    def clear_cache(self) -> None:
        """Drop every cached CompiledQuery, standing base and warm
        superbatch scheduler (hit/miss counters are kept)."""
        self._cache.clear()
        self._latest.clear()
        self._standing.clear()
        # warm superbatch schedulers pin their bucket's plans plus stacked
        # device tables; clearing the plan cache must release those too
        self._batch_cache.clear()

    def _resolve_options(self, options: MatchOptions | None,
                         overrides: dict) -> MatchOptions:
        base = options if options is not None else self.options
        return base.replace(**overrides) if overrides else base

    def _resolve_mesh(self, opts: MatchOptions,
                      total_rows: int | None = None):
        """Resolve `opts.mesh` ("auto" | lane count | None) to an `EnumMesh`
        over this Matcher's lane devices (`launch.mesh.lane_devices`: the
        visible cards on CUDA, one lane on the CPU), or None for the
        single-device path. "auto" is cost-based as in the reference
        (`options.auto_mesh_devices`): it shards across every lane device
        only when the workload — `total_rows` candidate rows; None = size
        unknown, assume large — is big enough to beat the shard tax, so
        small queries never pay it. An int is clamped to the lane devices.
        Resolved meshes are memoized per count; counts <= 1 always
        resolve to None (bit-identical fallback)."""
        if opts.mesh is None:
            return None
        if opts.mesh == "auto":
            n = auto_mesh_devices(
                total_rows, n_devices=len(_mesh.lane_devices(self.device)),
                cpu_count=os.cpu_count() or 1,
                platform="gpu" if self.device.type == "cuda" else "cpu")
            if n <= 1:
                return None
        else:
            n = opts.mesh
        if n not in self._meshes:
            self._meshes[n] = _mesh.make_enum_mesh(n, self.device)
        return self._meshes[n]

    # ---------------------------------------------------------------- compile
    def compile(self, query: Graph, options: MatchOptions | None = None,
                **overrides) -> CompiledQuery:
        """Preprocess + analyze `query`, reusing the plan cache. The key is
        (canonical query signature, plan-relevant options, dataset content
        signature, dataset graph_version); runtime knobs (engine, tile_rows,
        limit, ...) share one compiled entry. Keying on dataset content +
        version means a mutated Dataset is never served a stale plan; after
        an `apply_delta` whose touched-vertex labels are all disjoint from
        the query's labels, the previous version's entry — plan, engines
        and their device tables — is carried forward (provably unaffected:
        every candidate row and auxiliary CSR it holds reads only rows of
        query-labeled vertices) and counted in `cache_info().carried`."""
        opts = self._resolve_options(options, overrides)
        self._release_stale()
        qsig = graph_signature(query)
        key = (qsig, opts.plan_key, self.dataset.signature,
               self.dataset.graph_version)
        cq = self._cache.get(key)
        if cq is not None:
            self._hits += 1
            self._cache.move_to_end(key)
            return cq
        cq = self._carry_forward(qsig, opts.plan_key, key, query)
        if cq is not None:
            self._hits += 1
            self._carried += 1
            return cq
        self._misses += 1
        cs, an = preprocess(query, self.dataset.graph,
                            encoding=opts.encoding,
                            order_heuristic=opts.order_heuristic,
                            order=(list(opts.order)
                                   if opts.order is not None else None),
                            refine_rounds=opts.refine_rounds,
                            index=self.dataset.index)
        cq = CompiledQuery(query, self.dataset, opts, cs, an)
        self._cache[key] = cq
        self._latest[(qsig, opts.plan_key)] = key
        while len(self._cache) > self._maxsize:
            evicted, _ = self._cache.popitem(last=False)
            # keep _latest in lockstep with the LRU: a pointer to an
            # evicted entry can never be carried forward
            if self._latest.get((evicted[0], evicted[1])) == evicted:
                del self._latest[(evicted[0], evicted[1])]
        return cq

    def _carriable(self, key: tuple, query: Graph) -> bool:
        """Whether the entry under `key` (an older dataset version) may be
        carried to the current version: every delta since that version
        touched only labels the query does not have. Disjointness is the
        sound criterion: candidate sets, NLF rows and label-CSR rows the
        compile consumed all belong to query-labeled data vertices, which
        such deltas never touch."""
        deltas = self.dataset.deltas_since(key[3])
        if deltas is None:
            return False
        qlabels = set(int(l) for l in query.labels)
        return all(t.isdisjoint(qlabels) for t in deltas)

    def _carry_forward(self, qsig: str, plan_key: tuple, new_key: tuple,
                       query: Graph) -> CompiledQuery | None:
        """Re-key a previous dataset version's CompiledQuery to the current
        version when `_carriable`. Its plan, engines and their device
        tables stay as they are: the tables are the same bits a fresh
        compile would pack."""
        old_key = self._latest.get((qsig, plan_key))
        if old_key is None or old_key == new_key:
            return None
        cq = self._cache.get(old_key)
        if cq is None or cq.dataset is not self.dataset:
            return None
        if not self._carriable(old_key, query):
            return None
        del self._cache[old_key]
        cq.cs.data = self.dataset.graph      # candidates/adjacency unchanged
        self._cache[new_key] = cq
        self._latest[(qsig, plan_key)] = new_key
        return cq

    def _release_stale(self) -> None:
        """Once per dataset version, free the device state of the cached
        entries that version can no longer use. Keys carry the version, so
        an older entry is never served again; only a query's newest entry
        may still be carried forward. Every other older entry — and a newest
        one that an intervening delta's labels touched — drops its engines
        (device tables, ring buffers) and the warm superbatch schedulers
        built over its plan. The entries stay in the LRU, as in the
        reference, so `cache_info()` is unchanged."""
        gv = self.dataset.graph_version
        if gv == self._swept_version:
            return
        self._swept_version = gv
        latest = set(self._latest.values())
        stale_plans = set()
        for key, cq in self._cache.items():
            if key[3] == gv or (key in latest
                                and self._carriable(key, cq.query)):
                continue
            cq._engines.clear()
            if cq._plan is not None:
                stale_plans.add(id(cq._plan))
        for key in [k for k in self._batch_cache
                    if stale_plans.intersection(k[1])]:
            del self._batch_cache[key]

    # ---------------------------------------------------------------- execute
    def count(self, query: Graph, options: MatchOptions | None = None,
              **overrides) -> MatchOutcome:
        """Match `query`; returns a MatchOutcome (count + stats). Accepts a
        full MatchOptions or keyword overrides of the Matcher defaults."""
        opts = self._resolve_options(options, overrides)
        hits_before = self._hits
        t0 = time.perf_counter()
        cq = self.compile(query, opts)
        cached = self._hits > hits_before
        gv = self.dataset.graph_version
        engine = cq.resolve_engine(opts.engine)
        if engine == "vector" and not cq.empty:
            _ = cq.plan               # build the bitmap tables inside the
                                      # compile_s window
        compile_s = time.perf_counter() - t0
        common = dict(plan_cached=cached, compile_s=compile_s,
                      graph_version=gv, engine_requested=opts.engine)
        if cq.empty:
            stats = MatchStats() if engine == "ref" else VectorStats()
            out = MatchOutcome(count=0, engine=engine, elapsed_s=0.0,
                               timed_out=False, stats=stats,
                               embeddings=[] if opts.materialize else None,
                               **common)
        elif engine == "ref":
            res = cemr_match(query, self.dataset.graph,
                             preprocessed=(cq.cs, cq.an),
                             use_cer=opts.use_cer, use_cv=opts.use_cv,
                             use_fs=opts.use_fs, limit=opts.limit,
                             step_budget=opts.budget,
                             materialize=opts.materialize)
            out = MatchOutcome(count=res.count, engine="ref",
                               elapsed_s=res.elapsed_s,
                               timed_out=res.timed_out, stats=res.stats,
                               embeddings=res.embeddings, **common)
        else:
            eng = cq.vector_engine(
                opts, self.device, intersect_fn=self._intersect_fn,
                mesh=self._resolve_mesh(
                    opts, total_rows=int(cq.cs.sizes().sum())))
            t0 = time.perf_counter()
            res = eng.run(limit=opts.limit, max_steps=opts.budget,
                          materialize=opts.materialize)
            out = MatchOutcome(count=res.count, engine="vector",
                               elapsed_s=time.perf_counter() - t0,
                               timed_out=res.timed_out, stats=res.stats,
                               embeddings=res.embeddings, **common)
        self._seed_standing(query, out, opts)
        return out

    def _seed_standing(self, query: Graph, out: MatchOutcome,
                       opts: MatchOptions) -> None:
        """Record an exact count as a count_delta base. Only counts that are
        provably complete qualify (no timeout, under the embedding limit)
        and only for the current dataset version."""
        if (out.timed_out or out.count >= opts.limit
                or out.graph_version != self.dataset.graph_version):
            return
        self._standing[graph_signature(query)] = (out.graph_version,
                                                  out.count)
        while len(self._standing) > self._standing_max:
            self._standing.popitem(last=False)

    def stream(self, query: Graph, options: MatchOptions | None = None,
               **overrides) -> Iterator[dict[int, int]]:
        """Lazily yield embeddings ({query vertex -> data vertex}) up to
        `limit`. Enumeration is batched internally (the engines count in
        aggregated form); the iterator itself is lazy — nothing runs until
        the first item is requested."""
        opts = self._resolve_options(options, overrides)
        opts = opts.replace(materialize=True)

        def gen():
            out = self.count(query, opts)
            emitted = 0
            for emb in out.embeddings or []:
                if emitted >= opts.limit:
                    break
                emitted += 1
                yield emb

        return gen()

    def explain(self, query: Graph, options: MatchOptions | None = None,
                **overrides) -> str:
        """Human-readable compilation report: resolved engine, matching
        order, black/white coloring, candidate sizes, plan stages."""
        opts = self._resolve_options(options, overrides)
        return self.compile(query, opts).explain(engine=opts.engine)

    def match_many(self, queries: list[Graph],
                   options: MatchOptions | None = None, *,
                   batch: str = "auto",
                   **overrides) -> list[MatchOutcome]:
        """Batch API: match each query, sharing the plan cache (duplicate
        queries in the batch compile once).

        `batch="auto"` additionally drains vector-engine queries through
        cross-query superbatches: plans are bucketed by padded shape
        signature (`core.plan.plan_shape_signature`) and every bucket of
        two or more queries advances through shared supersteps with a
        query-id lane. Per-query counts are identical to the sequential
        path; `stats` is the bucket's shared VectorStats, `elapsed_s` the
        bucket wall time amortized per query, and `budget` pools across
        the bucket (N queries share N * budget dispatches; a capped bucket
        flags every query timed_out). Ref-engine, empty, and
        singleton-bucket queries fall back to the sequential path, as does
        the whole call under `materialize=True`, a custom intersect_fn, or
        a forced intersect route (`intersect != "auto"`). On the batched
        path `use_cer_buffer=False` disables the CER ring buffer but still
        runs fused supersteps (there is no batched compat loop).
        `batch="off"` forces sequential execution."""
        if batch not in BATCH_MODES:
            raise ValueError(f"batch must be one of {BATCH_MODES}, "
                             f"got {batch!r}")
        opts = self._resolve_options(options, overrides)
        if (batch == "off" or len(queries) < 2 or opts.materialize
                or self._intersect_fn is not None
                or opts.intersect != "auto"):
            return [self.count(q, opts) for q in queries]
        return self._match_many_batched(queries, opts)

    def _match_many_batched(self, queries: list[Graph],
                            opts: MatchOptions) -> list[MatchOutcome]:
        outcomes: list[MatchOutcome | None] = [None] * len(queries)
        buckets: OrderedDict[tuple, list] = OrderedDict()
        for i, q in enumerate(queries):
            hits_before = self._hits
            t0 = time.perf_counter()
            cq = self.compile(q, opts)
            cached = self._hits > hits_before
            if cq.empty or cq.resolve_engine(opts.engine) != "vector":
                outcomes[i] = self.count(q, opts)    # sequential fallback
                continue
            plan = cq.plan                # built inside the compile_s window
            compile_s = time.perf_counter() - t0
            sig = plan_shape_signature(plan, tile_rows=opts.tile_rows)
            buckets.setdefault(sig, []).append((i, cq, compile_s, cached))
        for sig, items in buckets.items():
            if len(items) < 2:            # no cross-query work to share
                i = items[0][0]
                outcomes[i] = self.count(queries[i], opts)
                continue
            sched = self._superbatch_for(sig, [it[1] for it in items], opts)
            t0 = time.perf_counter()
            # the bucket shares its dispatches, so per-query budgets pool:
            # a bucket of N queries gets N * budget total device steps
            budget = (opts.budget * len(items)
                      if opts.budget is not None else None)
            counts, stats, timed_out = sched.run(limit=opts.limit,
                                                 max_steps=budget)
            per_query_s = (time.perf_counter() - t0) / len(items)
            for (i, _cq, compile_s, cached), c in zip(items, counts):
                outcomes[i] = MatchOutcome(
                    count=c, engine="vector", elapsed_s=per_query_s,
                    timed_out=timed_out, stats=stats, plan_cached=cached,
                    compile_s=compile_s,
                    graph_version=self.dataset.graph_version,
                    engine_requested=opts.engine)
                self._seed_standing(queries[i], outcomes[i], opts)
        return outcomes

    def _superbatch_for(self, sig: tuple, cqs: list, opts: MatchOptions):
        """Build (or reuse) the warm superbatch scheduler for one shape
        bucket; a resolved multi-device mesh selects the sharded variant
        (superbatch query-id lanes compose with the shard axis)."""
        mesh = self._resolve_mesh(
            opts, total_rows=sum(int(cq.cs.sizes().sum()) for cq in cqs))
        key = (sig, tuple(id(cq.plan) for cq in cqs), opts.use_cv,
               opts.use_dedup, opts.use_cer_buffer, opts.cer_buffer_slots,
               opts.use_failure_cache, opts.failure_cache_slots,
               opts.pack_tiles, opts.overlap, mesh)
        sched = self._batch_cache.get(key)
        if sched is None:
            kw = dict(device=self.device, tile_rows=opts.tile_rows,
                      use_cv=opts.use_cv, use_dedup=opts.use_dedup,
                      use_cer_buffer=opts.use_cer_buffer,
                      cer_buffer_slots=opts.cer_buffer_slots,
                      use_failure_cache=opts.use_failure_cache,
                      failure_cache_slots=opts.failure_cache_slots,
                      pack_tiles=opts.pack_tiles, overlap=opts.overlap)
            plans = [cq.plan for cq in cqs]
            if mesh is not None:
                from ..core.shard import ShardedSuperbatchScheduler
                sched = ShardedSuperbatchScheduler(plans, mesh=mesh, **kw)
            else:
                from ..core.scheduler import SuperbatchScheduler
                sched = SuperbatchScheduler(plans, **kw)
            self._batch_cache[key] = sched
            while len(self._batch_cache) > self._batch_cache_max:
                self._batch_cache.popitem(last=False)
        else:
            self._batch_cache.move_to_end(key)
        return sched

    # ----------------------------------------------------------------- deltas
    def count_delta(self, queries, delta, options: MatchOptions | None = None,
                    **overrides):
        """Apply `delta` to the Matcher's Dataset and roll the given
        queries' counts forward through it (docs/streaming.md).

        For each query with a known exact base count (seeded by a previous
        `count`/`match_many`/`count_delta` on the current version), the new
        count is `base + created - destroyed`, where both sides are pinned
        enumerations over only the delta's edges
        (`streaming.embeddings_touching`, on the host) — no re-enumeration.
        A query with no usable base, or whose pinned enumeration overflows
        `opts.delta_limit`, is recounted from scratch on the Matcher's
        device (`fallback=True`); if that recount times out or hits
        `opts.limit` the outcome is also flagged `inexact=True` and never
        seeded as a base. Single-vertex queries are rolled forward by
        counting label-matching vertex inserts directly. The Dataset is
        mutated exactly once (`graph_version` advances by 1) whatever the
        number of queries.

        Accepts one Graph or a list; returns one DeltaOutcome or a list,
        matching the input shape. Raises ValueError (dataset untouched) if
        the delta fails validation.
        """
        from ..streaming.delta import canonicalize_delta
        from ..streaming.standing import (DeltaOutcome, DeltaOverflow,
                                          embeddings_touching)
        single = isinstance(queries, Graph)
        qs: list[Graph] = [queries] if single else list(queries)
        opts = self._resolve_options(options, overrides)
        ds = self.dataset
        old_graph, old_index = ds.graph, ds.index
        old_version = ds.graph_version
        canon = canonicalize_delta(old_graph, delta)  # validate pre-mutation

        t0s = [time.perf_counter()] * len(qs)
        bases: list[int | None] = []
        destroyed: list[int | None] = []
        for i, q in enumerate(qs):
            t0s[i] = time.perf_counter()
            ent = self._standing.get(graph_signature(q))
            base = ent[1] if ent is not None and ent[0] == old_version \
                else None
            d = None
            if base is not None:
                try:
                    d = embeddings_touching(q, old_graph, old_index,
                                            canon.del_pairs,
                                            limit=opts.delta_limit)
                except DeltaOverflow:
                    d = None
            bases.append(base)
            destroyed.append(d)

        ds.apply_delta(delta)
        new_version = ds.graph_version
        self._release_stale()

        outcomes: list[DeltaOutcome] = []
        for i, q in enumerate(qs):
            created: int | None = None
            if bases[i] is not None and destroyed[i] is not None:
                try:
                    created = embeddings_touching(q, ds.graph, ds.index,
                                                  canon.ins_pairs,
                                                  limit=opts.delta_limit)
                except DeltaOverflow:
                    created = None
                if created is not None and q.n == 1:
                    # single-vertex embeddings use no edges, so pinned
                    # enumeration can't see them: created = inserted
                    # vertices with the query's label. Vertex deletes
                    # retire in place (label kept, still matched), so
                    # destroyed correctly stays 0.
                    created += int(np.count_nonzero(
                        canon.new_labels[canon.n_old:]
                        == int(q.labels[0])))
            if created is not None:
                count = bases[i] + created - destroyed[i]
                self._standing[graph_signature(q)] = (new_version, count)
                outcomes.append(DeltaOutcome(
                    count=count, created=created, destroyed=destroyed[i],
                    graph_version=new_version, fallback=False,
                    elapsed_s=time.perf_counter() - t0s[i]))
            else:
                out = self.count(q, opts)    # full recount on the new graph
                outcomes.append(DeltaOutcome(
                    count=out.count, created=None, destroyed=None,
                    graph_version=new_version, fallback=True,
                    inexact=out.timed_out or out.count >= opts.limit,
                    elapsed_s=time.perf_counter() - t0s[i]))
        return outcomes[0] if single else outcomes
