"""Matcher: the session-style facade over both CEMR engines.

Torch port of `repro.api.Matcher`'s single-query surface. One Matcher serves
many queries against one Dataset on one device:

  * `compile(query)` — filtering + ordering + encoding + static analysis,
    cached by canonical query signature (LRU-bounded). The vector engine's
    MatchingPlan is built lazily inside the cached CompiledQuery and its
    tables are uploaded to the device once per engine configuration.
  * `count` / `stream` — execution, returning one result type
    (`MatchOutcome`) regardless of engine.
  * `explain` — order, coloring, per-level plan stages, candidate sizes.

The device is the card (`cuda`) unless the caller passes `device="cpu"`;
with no CUDA and no explicit "cpu", construction raises.

Engine auto-selection (`engine="auto"`), as in the reference:

  1. directed or edge-labeled data → "ref";
  2. total candidate rows Σ|C(u)| < AUTO_VECTOR_MIN_ROWS → "ref";
  3. otherwise → "vector".

Not ported yet: `match_many`'s superbatch, `count_delta`, `tenant_view`.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Iterator

from ..core.encoding import BLACK, QueryAnalysis
from ..core.engine import VectorEngine, VectorStats
from ..core.filtering import CandidateSpace
from ..core.graph import Graph
from ..core.plan import build_plan
from ..core.ref_engine import MatchStats, cemr_match, preprocess
from ..device import resolve_device
from .dataset import Dataset
from .options import MatchOptions
from .signature import graph_signature

__all__ = ["Matcher", "CompiledQuery", "MatchOutcome", "CacheInfo",
           "AUTO_VECTOR_MIN_ROWS"]

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
    LRU)."""

    hits: int
    misses: int
    size: int
    maxsize: int


class CompiledQuery:
    """A query compiled against one Dataset: candidate space + analysis,
    plus lazily-built per-engine artifacts (vector MatchingPlan, engines
    keyed by runtime knobs). Cached and reused by Matcher."""

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

    def vector_engine(self, opts: MatchOptions, device, intersect_fn=None):
        """Build (or reuse) the VectorEngine for this compiled query under
        the given runtime knobs; engines are keyed by every knob that
        changes the built step functions."""
        key = (opts.tile_rows, opts.use_cv, opts.use_dedup,
               opts.cer_buffer_slots, opts.use_failure_cache,
               opts.failure_cache_slots, opts.pack_tiles, opts.overlap,
               opts.intersect, id(intersect_fn), str(device))
        eng = self._engines.get(key)
        if eng is None:
            eng = VectorEngine(self.cs, self.an, device=device,
                               tile_rows=opts.tile_rows,
                               use_cv=opts.use_cv, use_dedup=opts.use_dedup,
                               cer_buffer_slots=opts.cer_buffer_slots,
                               use_failure_cache=opts.use_failure_cache,
                               failure_cache_slots=opts.failure_cache_slots,
                               pack_tiles=opts.pack_tiles,
                               overlap=opts.overlap,
                               intersect=opts.intersect,
                               intersect_fn=intersect_fn, plan=self.plan)
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
                 plan_cache_size: int = 128, intersect_fn=None):
        self.device = resolve_device(device)
        if isinstance(dataset, Graph):
            dataset = Dataset.from_graph(dataset)
        self.dataset = dataset
        self.options = options if options is not None else MatchOptions()
        if plan_cache_size < 1:
            raise ValueError("plan_cache_size must be >= 1")
        self._maxsize = plan_cache_size
        self._cache: OrderedDict[tuple, CompiledQuery] = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._intersect_fn = intersect_fn

    # ------------------------------------------------------------------ cache
    def cache_info(self) -> CacheInfo:
        """Plan-cache counters (cumulative hits/misses, current size)."""
        return CacheInfo(hits=self._hits, misses=self._misses,
                         size=len(self._cache), maxsize=self._maxsize)

    def clear_cache(self) -> None:
        """Drop every cached CompiledQuery (hit/miss counters are kept)."""
        self._cache.clear()

    def _resolve_options(self, options: MatchOptions | None,
                         overrides: dict) -> MatchOptions:
        base = options if options is not None else self.options
        return base.replace(**overrides) if overrides else base

    # ---------------------------------------------------------------- compile
    def compile(self, query: Graph, options: MatchOptions | None = None,
                **overrides) -> CompiledQuery:
        """Preprocess + analyze `query`, reusing the plan cache. The key is
        (canonical query signature, plan-relevant options, dataset content
        signature, dataset graph_version); runtime knobs (engine, tile_rows,
        limit, ...) share one compiled entry."""
        opts = self._resolve_options(options, overrides)
        key = (graph_signature(query), opts.plan_key, self.dataset.signature,
               self.dataset.graph_version)
        cq = self._cache.get(key)
        if cq is not None:
            self._hits += 1
            self._cache.move_to_end(key)
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
        while len(self._cache) > self._maxsize:
            self._cache.popitem(last=False)
        return cq

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
            return MatchOutcome(count=0, engine=engine, elapsed_s=0.0,
                                timed_out=False, stats=stats,
                                embeddings=[] if opts.materialize else None,
                                **common)
        if engine == "ref":
            res = cemr_match(query, self.dataset.graph,
                             preprocessed=(cq.cs, cq.an),
                             use_cer=opts.use_cer, use_cv=opts.use_cv,
                             use_fs=opts.use_fs, limit=opts.limit,
                             step_budget=opts.budget,
                             materialize=opts.materialize)
            return MatchOutcome(count=res.count, engine="ref",
                                elapsed_s=res.elapsed_s,
                                timed_out=res.timed_out, stats=res.stats,
                                embeddings=res.embeddings, **common)
        eng = cq.vector_engine(opts, self.device,
                               intersect_fn=self._intersect_fn)
        t0 = time.perf_counter()
        res = eng.run(limit=opts.limit, max_steps=opts.budget,
                      materialize=opts.materialize)
        return MatchOutcome(count=res.count, engine="vector",
                            elapsed_s=time.perf_counter() - t0,
                            timed_out=res.timed_out, stats=res.stats,
                            embeddings=res.embeddings, **common)

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
