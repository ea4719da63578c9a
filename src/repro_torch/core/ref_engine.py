"""Paper-faithful CEMR reference engine (Algorithms 1–4).

A sequential DFS backtracking enumerator implementing, exactly as published:

  * the four extension cases of the black-white enumeration framework (§4.2)
  * aggregated embeddings (white vertices map to candidate *sets*)
  * CER with Common Extension Buffers keyed by parent vertices (§5.2,
    Algorithm 4: CompExtensions / CacheBuf / ReuseBuf, flag reset on parent
    re-matching)
  * contained-vertex pruning (Lemma 2) and extended failing-set pruning
    (§6.1.2) with backjumping
  * deterministic-mapping promotion of singleton whites (§4.3) and leaf-level
    injectivity via Cartesian semantics (counted in closed form, see count.py)

This engine is the *faithful reproduction baseline*: the vectorized engine
(core/engine.py) is validated against it, and the paper's ablations
(Fig. 10a–d) are reproduced with its flags.

Design note (soundness of CER): white sets stored in an embedding are pure
functions of the reference-set mappings — they are *never* eagerly shrunk by
injectivity, exactly as in the paper, so brother embeddings share them and the
CEB payload transfers. Injectivity against assigned vertices is applied at
conflict checks (deterministic mappings) and at the leaf.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np

from .count import injective_count, iter_injective
from .encoding import BLACK, WHITE, QueryAnalysis, analyze, choose_encoding
from .filtering import CandidateSpace, build_candidate_space
from .graph import Graph
from .ordering import cemr_order, gql_order, ri_order

__all__ = ["MatchStats", "MatchResult", "cemr_match", "preprocess"]

_ORDER_FNS = {"cemr": cemr_order, "ri": ri_order, "gql": gql_order}


@dataclasses.dataclass
class MatchStats:
    nodes: int = 0               # Enumerate invocations (search-tree nodes)
    ext_ops: int = 0             # R_M computations
    intersections: int = 0       # adjacency-row intersection/union operations
    ceb_hits: int = 0            # CER buffer reuses
    ceb_stores: int = 0
    conflicts: int = 0
    cv_prunes: int = 0           # contained-vertex prunes
    fs_skips: int = 0            # siblings skipped by failing-set backjumping
    leaves: int = 0
    peak_frontier_bytes: int = 0


@dataclasses.dataclass
class MatchResult:
    count: int
    stats: MatchStats
    timed_out: bool
    elapsed_s: float
    embeddings: list[dict[int, int]] | None = None
    order: list[int] | None = None
    colors: np.ndarray | None = None


class _LimitReached(Exception):
    pass


class _BudgetExhausted(Exception):
    pass


def preprocess(query: Graph, data: Graph, *, encoding: str = "cost",
               order_heuristic: str = "cemr", order: list[int] | None = None,
               refine_rounds: int = 3, index=None
               ) -> tuple[CandidateSpace, QueryAnalysis]:
    """Filtering + ordering + encoding + static analysis (Algorithm 1 l.1–2).
    `index` is an optional shared DataGraphIndex (see api.Dataset)."""
    cs = build_candidate_space(query, data, refine_rounds=refine_rounds,
                               index=index)
    sizes = cs.sizes()
    if order is None:
        order = _ORDER_FNS[order_heuristic](query, sizes)
    colors = choose_encoding(query, order, sizes, mode=encoding)
    an = analyze(query, order, colors, cand=cs.cand)
    return cs, an


class _Search:
    def __init__(self, cs: CandidateSpace, an: QueryAnalysis, *, use_cer: bool,
                 use_cv: bool, use_fs: bool, limit: int,
                 step_budget: int | None, materialize: bool):
        self.cs, self.an = cs, an
        self.cand = cs.cand
        self.adj_indptr = cs.adj_indptr
        self.adj_indices = cs.adj_indices
        self.labels = cs.query.labels
        self.use_cer, self.use_cv, self.use_fs = use_cer, use_cv, use_fs
        self.limit = limit
        self.step_budget = step_budget
        self.materialize = materialize
        self.stats = MatchStats()
        n = an.n
        self.n = n
        self.black: dict[int, int] = {}          # u -> cand index
        self.white: dict[int, np.ndarray] = {}   # u -> cand indices (pure)
        self.holder: dict[int, int] = {}         # data id -> u
        self.tr: dict[int, int] = {}             # u -> Tr(u)
        self.count = 0
        self.embeddings: list[dict[int, int]] = []
        self.ceb: dict[int, list] = {u: [False, None] for u in an.order}
        self.rs_set = {an.order[i]: set(an.rs[i]) for i in range(n)}
        self.con_size = {an.order[i]: len(an.con[i]) for i in range(n)}
        self.all_vertices = set(an.order)

    # ---------------------------------------------------------------- helpers
    def _row(self, u_from: int, u_to: int, idx: int) -> np.ndarray:
        ptr = self.adj_indptr[(u_from, u_to)]
        return self.adj_indices[(u_from, u_to)][ptr[idx]:ptr[idx + 1]]

    def _intersect_rows(self, rows: list[np.ndarray]) -> np.ndarray:
        rows = sorted(rows, key=lambda r: r.shape[0])
        out = rows[0]
        self.stats.intersections += max(len(rows) - 1, 1)
        for r in rows[1:]:
            if out.shape[0] == 0:
                break
            out = np.intersect1d(out, r, assume_unique=True)
        return out

    def _data_ids(self, u: int, idxs: np.ndarray) -> np.ndarray:
        return self.cand[u][idxs]

    # ------------------------------------------------------------ extensions
    def _compute_extensions(self, i: int):
        """CompExtensions (Algorithm 4 l.10-37). Returns ('ok', exts) or
        ('fail', failing_set). Extensions are (det: {u: cand_idx},
        whites: {u: np.ndarray}) — conflict checking is applied later, at
        apply-time, so payloads are cacheable (Lemma 1)."""
        an, u_i = self.an, self.an.order[i]
        # runtime partition: statically-white backward neighbors that were
        # promoted to deterministic mappings (§4.3) behave as blacks here.
        bk = [u for u in an.bwd[i] if u in self.black]
        wt = [u for u in an.bwd[i] if u not in self.black]
        self.stats.ext_ops += 1

        if not wt:
            # ---- Case 1 / Case 2 -------------------------------------------
            rows = [self._row(u_j, u_i, self.black[u_j]) for u_j in bk]
            r = self._intersect_rows(rows)
            if self.use_cv and r.shape[0] < self.con_size[u_i]:
                self.stats.cv_prunes += 1
                return "fail", set(self.rs_set[u_i])
            if r.shape[0] == 0:
                return "fail", set(self.rs_set[u_i])
            if an.colors[u_i] == BLACK:   # Case 1
                return "ok", [({u_i: int(v)}, {}) for v in r.tolist()]
            return "ok", [({}, {u_i: r})]  # Case 2: one aggregated child

        # ---- Case 3 / Case 4 ------------------------------------------------
        if bk:
            rows = [self._row(u_j, u_i, self.black[u_j]) for u_j in bk]
            r = self._intersect_rows(rows)
        else:
            u_js = min(wt, key=lambda u: self.white[u].shape[0])
            sets = [self._row(u_js, u_i, int(c)) for c in self.white[u_js]]
            self.stats.intersections += max(len(sets), 1)
            r = (np.unique(np.concatenate(sets)) if sets
                 else np.empty(0, dtype=np.int32))
        if self.use_cv and r.shape[0] < self.con_size[u_i]:
            self.stats.cv_prunes += 1
            return "fail", set(self.rs_set[u_i])
        if r.shape[0] == 0:
            return "fail", set(self.rs_set[u_i])

        def case3_like() -> list:
            exts = []
            for v in r.tolist():
                wupd, ok = {}, True
                for u_j in wt:
                    self.stats.intersections += 1
                    wj = np.intersect1d(self.white[u_j],
                                        self._row(u_i, u_j, v),
                                        assume_unique=True)
                    if wj.shape[0] == 0:
                        ok = False
                        break
                    wupd[u_j] = wj
                if ok:
                    exts.append(({u_i: v}, wupd))
            return exts

        if an.colors[u_i] == BLACK:       # Case 3
            return "ok", case3_like()

        # Case 4: adaptive 4.1 vs 4.2 (paper lines 24-31)
        s_size = 1
        for u_j in wt:
            s_size *= int(self.white[u_j].shape[0])
        if s_size >= r.shape[0]:          # Case 4.1 — u_i handled like Case 3
            return "ok", case3_like()
        # Case 4.2 — decompose white backward neighbors, aggregate u_i
        exts = []
        for combo in itertools.product(*[self.white[u_j].tolist() for u_j in wt]):
            det = {u_j: int(c) for u_j, c in zip(wt, combo)}
            rows = []
            for u_j in an.bwd[i]:
                idx = det[u_j] if u_j in det else self.black[u_j]
                rows.append(self._row(u_j, u_i, idx))
            r_t = self._intersect_rows(rows)
            if r_t.shape[0] == 0:
                continue
            exts.append((det, {u_i: r_t}))
        return "ok", exts

    # ----------------------------------------------------------------- apply
    def _apply(self, ext, u_i: int):
        """Apply one extension. Returns ('ok', undo) | ('conflict', holder_u)
        | ('empty', None). Deterministic mappings (blacks, Case-4 whites,
        singleton-promoted whites) join injectivity checking (§4.3)."""
        det, whites = ext
        undo: list = []

        def assign(u: int, idx: int, cause: int):
            did = int(self.cand[u][idx])
            if did in self.holder:
                return self.holder[did]
            if u in self.white:
                undo.append(("white", u, self.white.pop(u)))
            self.black[u] = idx
            undo.append(("black", u))
            self.holder[did] = u
            undo.append(("holder", did))
            undo.append(("tr", u, self.tr.get(u)))
            self.tr[u] = cause
            return None

        for u, idx in det.items():
            h = assign(u, idx, u_i)
            if h is not None:
                self._undo(undo)
                return "conflict", h
        for u, arr in whites.items():
            if arr.shape[0] == 0:
                self._undo(undo)
                return "empty", None
            if arr.shape[0] == 1:
                # §4.3(ii): reduced to a single vertex -> deterministic
                prev = self.white.get(u)
                if prev is not None:
                    undo.append(("white", u, self.white.pop(u)))
                h = assign(u, int(arr[0]), u_i)
                if h is not None:
                    self._undo(undo)
                    return "conflict", h
            else:
                prev = self.white.get(u)
                undo.append(("white_prev", u, prev))
                self.white[u] = arr
        return "ok", undo

    def _undo(self, undo: list) -> None:
        for op in reversed(undo):
            kind = op[0]
            if kind == "white":
                self.white[op[1]] = op[2]
            elif kind == "white_prev":
                if op[2] is None:
                    self.white.pop(op[1], None)
                else:
                    self.white[op[1]] = op[2]
            elif kind == "black":
                self.black.pop(op[1], None)
            elif kind == "holder":
                self.holder.pop(op[1], None)
            elif kind == "tr":
                if op[2] is None:
                    self.tr.pop(op[1], None)
                else:
                    self.tr[op[1]] = op[2]

    # ------------------------------------------------------------------ leaf
    def _leaf(self) -> tuple[bool, set]:
        self.stats.leaves += 1
        groups: dict[int, list[tuple[int, np.ndarray]]] = {}
        for u, arr in self.white.items():
            ids = self._data_ids(u, arr)
            lbl = int(self.labels[u])
            taken = [d for d in ids.tolist() if d in self.holder]
            if taken:
                ids = ids[~np.isin(ids, np.array(taken))]
            if ids.shape[0] == 0:
                return False, set(self.all_vertices)
            groups.setdefault(lbl, []).append((u, ids))

        total = 1
        for sets in groups.values():
            total *= injective_count([s for _, s in sets])
            if total == 0:
                return False, set(self.all_vertices)

        room = self.limit - self.count
        take = min(total, room)
        if self.materialize:
            self._materialize(groups, min(take, room))
        self.count += take
        if self.count >= self.limit:
            raise _LimitReached
        return True, set()

    def _materialize(self, groups, cap: int) -> None:
        base = {u: int(self.cand[u][idx]) for u, idx in self.black.items()}
        group_items = [sets for sets in groups.values()]

        def rec(gi: int, acc: dict):
            if len(self.embeddings) >= self.count + cap:
                return
            if gi == len(group_items):
                self.embeddings.append(dict(acc))
                return
            sets = group_items[gi]
            us = [u for u, _ in sets]
            for combo in iter_injective([s for _, s in sets]):
                if len(self.embeddings) >= self.count + cap:
                    return
                acc2 = dict(acc)
                for u, v in zip(us, combo):
                    acc2[u] = int(v)
                rec(gi + 1, acc2)

        rec(0, base)

    # ------------------------------------------------------------- main loop
    def enumerate(self, i: int) -> tuple[bool, set]:
        """Returns (found_any_embedding, failing_set). failing_set is only
        meaningful when found is False."""
        if self.step_budget is not None and self.stats.nodes > self.step_budget:
            raise _BudgetExhausted
        if i == self.n:
            return self._leaf()
        self.stats.nodes += 1
        an, u_i = self.an, self.an.order[i]
        frontier_bytes = sum(a.nbytes for a in self.white.values())
        if frontier_bytes > self.stats.peak_frontier_bytes:
            self.stats.peak_frontier_bytes = frontier_bytes

        exts = None
        if (self.use_cer and an.cer_enabled[i] and self.ceb[u_i][0]):
            exts = self.ceb[u_i][1]
            self.stats.ceb_hits += 1
        if exts is None:
            status, payload = self._compute_extensions(i)
            if status == "fail":
                return False, payload
            exts = payload
            if self.use_cer and an.cer_enabled[i]:
                self.ceb[u_i] = [True, exts]
                self.stats.ceb_stores += 1

        found = False
        fset: set = set()
        for k, ext in enumerate(exts):
            # u_i is being (re)matched: CEBs of its CER children are invalid
            for c in an.children[u_i]:
                self.ceb[c][0] = False
            status, payload = self._apply(ext, u_i)
            if status == "conflict":
                self.stats.conflicts += 1
                h = payload
                trh = self.tr.get(h, h)
                fset |= (self.rs_set[u_i] | {u_i}
                         | self.rs_set.get(trh, set()) | {trh})
                continue
            if status == "empty":
                fset |= self.rs_set[u_i] | {u_i}
                continue
            undo = payload
            try:
                f, cf = self.enumerate(i + 1)
            finally:
                self._undo(undo)
            if f:
                found = True
            else:
                if self.use_fs and u_i not in cf:
                    # backjump: the failure does not depend on u_i's mapping
                    self.stats.fs_skips += len(exts) - k - 1
                    return found, cf
                fset |= cf
        if found:
            return True, set()
        if not fset:
            fset = set(self.rs_set[u_i])
        return False, fset

    def run(self) -> None:
        u0 = self.an.order[0]
        r = np.arange(self.cand[u0].shape[0], dtype=np.int32)
        if self.use_cv and r.shape[0] < self.con_size[u0]:
            self.stats.cv_prunes += 1
            return
        for idx in r.tolist():
            for c in self.an.children[u0]:
                self.ceb[c][0] = False
            status, payload = self._apply(({u0: int(idx)}, {}), u0)
            if status != "ok":
                continue
            try:
                self.enumerate(1)
            finally:
                self._undo(payload)


def cemr_match(query: Graph, data: Graph, *, encoding: str = "cost",
               order_heuristic: str = "cemr", order: list[int] | None = None,
               use_cer: bool = True, use_cv: bool = True, use_fs: bool = True,
               limit: int = 1_000_000, step_budget: int | None = None,
               materialize: bool = False, refine_rounds: int = 3,
               preprocessed: tuple[CandidateSpace, QueryAnalysis] | None = None,
               ) -> MatchResult:
    """Full CEMR pipeline (Algorithm 1).  `encoding='all_black'` +
    `use_cer=use_cv=use_fs=False` degenerates to the generic Algorithm-2
    baseline used in Fig. 7/10 comparisons."""
    t0 = time.perf_counter()
    if preprocessed is None:
        cs, an = preprocess(query, data, encoding=encoding,
                            order_heuristic=order_heuristic, order=order,
                            refine_rounds=refine_rounds)
    else:
        cs, an = preprocessed
    s = _Search(cs, an, use_cer=use_cer, use_cv=use_cv, use_fs=use_fs,
                limit=limit, step_budget=step_budget, materialize=materialize)
    timed_out = False
    if all(c.shape[0] > 0 for c in cs.cand):
        try:
            s.run()
        except _LimitReached:
            pass
        except _BudgetExhausted:
            timed_out = True
    return MatchResult(count=s.count, stats=s.stats, timed_out=timed_out,
                       elapsed_s=time.perf_counter() - t0,
                       embeddings=s.embeddings if materialize else None,
                       order=an.order, colors=an.colors)
