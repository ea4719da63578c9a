"""MatchingPlan: compile-time metadata + device tables for the vectorized
CEMR engine.

Per-label candidate spaces: all query vertices of label ℓ share one candidate
space space(ℓ) = ∪ C(u). Bitmaps of same-label vertices are therefore
directly comparable (injectivity = bitwise ops), at the cost of slightly
wider bitmaps, where candidate-index translation tables would be
gather-heavy (DESIGN.md §2).

Aggregation invariant (inherited from the paper's four cases): two
*simultaneously aggregated* white vertices are never adjacent in Q — when the
later of an adjacent white pair is extended, Case 4.1 maps it
deterministically or Case 4.2 decomposes the earlier one. Leaf counting may
therefore treat bitmap columns as independent up to same-label injectivity.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .encoding import BLACK, WHITE, QueryAnalysis
from .filtering import CandidateSpace

__all__ = ["LevelOp", "MatchingPlan", "build_plan", "plan_from_arrays",
           "plan_shape_signature", "root_extension_weights",
           "INTERSECT_MODES"]

IDX, BM = 0, 1

# Intersect-kernel selection vocabulary, shared by the engine
# (engine._resolve_intersect_fn) and the options layer (api.MatchOptions);
# the names are the reference's. "fused" routes the boundary
# expand+intersect+popcount through the fused kernel
# (engine._make_expand_fused).
INTERSECT_MODES = ("auto", "jnp", "pallas", "fused")


@dataclasses.dataclass
class LevelOp:
    """Static description of extending u_i = order[i] (one engine step)."""

    vertex: int
    case: int                      # 1..4 (paper §4.2); 42 = case 4.2
    store: int                     # IDX or BM
    bk_pairs: list[tuple[int, int]]      # (idx_slot of u_j, table key id) for black bwd
    wt_vertices: list[int]               # aggregated (BM) backward neighbors
    union_src: int                       # vertex id for the no-black union path, or -1
    decompose: list[tuple[int, int, list[int]]]  # (vertex, new idx slot,
                                         # same-label BM columns at that point) — 4.2
    con_threshold: int                   # contained-vertex pruning bound
    same_label_idx_slots: list[int]      # existing IDX slots with u_i's label
    same_label_bm: list[int]             # existing BM vertices with u_i's label
    dedup_slots: list[int]               # CER dedup key (read set) — [] = disabled
    n_words: int                         # bitmap words of u_i's space
    idx_slot: int                        # slot the new IDX column lands in (-1)
    level: int = 0


@dataclasses.dataclass
class MatchingPlan:
    an: QueryAnalysis
    spaces: dict[int, np.ndarray]        # label → sorted data ids
    words: dict[int, int]                # label → bitmap word count
    label_of: dict[int, int]             # query vertex → label
    masks: dict[int, np.ndarray]         # vertex → (W,) uint32 candidate mask
    tables: dict[tuple[int, int], np.ndarray]  # (u,w) → (S_u, W_w) uint32
    ops: list[LevelOp]
    idx_slots: list[int]                 # final vertex order of IDX columns
    leaf_groups: list[list[int]]         # same-label BM vertex groups at leaf
    leaf_singles: list[int]              # BM vertices alone in their label
    root_vertex: int
    root_words: int
    graph_version: int = -1              # Dataset.graph_version the plan's
                                         # tables were packed against (-1 =
                                         # built outside the Dataset layer)


def _pow2ceil(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def plan_shape_signature(plan: "MatchingPlan", *, tile_rows: int) -> tuple:
    """Canonical padded shape signature of a compiled plan.

    Two plans with equal signatures can share one batched program (and one
    set of supersteps): query vertices are renamed to the level at which
    the matching order binds them, and every bitmap width is padded up to
    the next power of two, so structurally equivalent queries over
    different-size candidate spaces land in the same superbatch bucket.
    Everything numeric that can stay data — contained-vertex thresholds,
    table contents, candidate masks — is excluded and fed to the shared
    program as stacked per-query arrays instead.
    """
    canon = {plan.root_vertex: 0}
    for op in plan.ops:
        canon[op.vertex] = op.level
    widths = tuple(_pow2ceil(plan.words[plan.label_of[v]])
                   for v in sorted(canon, key=canon.get))
    stages: list[tuple] = [("root",)]
    for op in plan.ops:
        for (v, slot, same_bm) in op.decompose:
            stages.append(("d", canon[v], slot,
                           tuple(sorted(canon[u] for u in same_bm))))
        stages.append((
            "e", canon[op.vertex], op.store,
            tuple((s, canon[u]) for (s, u) in op.bk_pairs),
            tuple(sorted(canon[u] for u in op.wt_vertices)),
            canon.get(op.union_src, -1),
            tuple(op.same_label_idx_slots),
            tuple(sorted(canon[u] for u in op.same_label_bm)),
            tuple(op.dedup_slots),
            op.idx_slot))
    leaf = (tuple(sorted(canon[u] for u in plan.leaf_singles)),
            tuple(sorted(tuple(sorted(canon[u] for u in g))
                         for g in plan.leaf_groups)))
    return ("sbv1", int(tile_rows), widths, tuple(stages), leaf)


def root_extension_weights(plan: "MatchingPlan") -> np.ndarray:
    """Per-position branching weights of the root candidate space — the
    degree-weighted balance heuristic for sharded enumeration.

    For every position of the root vertex's label space, the weight is 1
    plus the total number of extension bits its adjacency rows carry across
    every plan table gathered *from* the root vertex (i.e. the exact fanout
    of the level-1 extensions rooted at that candidate). Root candidates
    with heavier subtrees therefore land in lighter shards first
    (`distributed.sharding.partition_bitmap`). Returns a float64 array of
    length `32 * plan.root_words`.
    """
    w = np.ones(32 * plan.root_words, np.float64)
    for (u, _v), tbl in plan.tables.items():
        if u != plan.root_vertex or tbl.size == 0:
            continue
        pops = np.unpackbits(
            np.ascontiguousarray(tbl).view(np.uint8), axis=1).sum(axis=1)
        w[:pops.shape[0]] += pops
    return w


def _space_pos(space: np.ndarray, ids: np.ndarray) -> np.ndarray:
    pos = np.searchsorted(space, ids)
    assert np.all(space[pos] == ids)
    return pos.astype(np.int64)


def _bitmap_from_positions(pos: np.ndarray, n_words: int) -> np.ndarray:
    bm = np.zeros(n_words, dtype=np.uint32)
    np.bitwise_or.at(bm, pos >> 5, np.uint32(1) << (pos & 31).astype(np.uint32))
    return bm


def build_plan(cs: CandidateSpace, an: QueryAnalysis, *,
               graph_version: int = -1) -> MatchingPlan:
    q = cs.query
    n = q.n
    # ---- per-label spaces ----------------------------------------------------
    spaces: dict[int, np.ndarray] = {}
    for u in range(n):
        lbl = int(q.labels[u])
        ids = cs.cand[u]
        spaces[lbl] = (np.union1d(spaces[lbl], ids) if lbl in spaces
                       else np.unique(ids))
    words = {lbl: max(1, (s.shape[0] + 31) // 32) for lbl, s in spaces.items()}
    label_of = {u: int(q.labels[u]) for u in range(n)}

    masks: dict[int, np.ndarray] = {}
    for u in range(n):
        lbl = label_of[u]
        pos = _space_pos(spaces[lbl], cs.cand[u])
        masks[u] = _bitmap_from_positions(pos, words[lbl])

    # ---- adjacency tables in shared-space coordinates ------------------------
    # one vectorized scatter per query edge, straight from the CSR adjacency
    tables: dict[tuple[int, int], np.ndarray] = {}
    for (u, w), ptr in cs.adj_indptr.items():
        lu, lw = label_of[u], label_of[w]
        src_pos = _space_pos(spaces[lu], cs.cand[u])
        tbl = np.zeros((spaces[lu].shape[0], words[lw]), dtype=np.uint32)
        cols = cs.adj_indices[(u, w)].astype(np.int64)
        if cols.shape[0]:
            tgt_pos_of_cand = _space_pos(spaces[lw], cs.cand[w])
            rows = np.repeat(src_pos, np.diff(ptr))
            tpos = tgt_pos_of_cand[cols]
            np.bitwise_or.at(tbl, (rows, tpos >> 5),
                             np.uint32(1) << (tpos & 31).astype(np.uint32))
        tables[(u, w)] = tbl

    # expected aggregated-set size per white vertex (static 4.1/4.2 choice)
    exp_size: dict[int, float] = {}

    def mean_rowpop(u_from: int, u_to: int) -> float:
        t = tables[(u_from, u_to)]
        if t.size == 0:
            return 0.0
        pops = np.unpackbits(t.view(np.uint8), axis=1).sum(axis=1)
        return float(pops.mean())

    # ---- per-level ops --------------------------------------------------------
    kind: dict[int, int] = {}      # vertex → IDX/BM once matched
    idx_slots: list[int] = []
    ops: list[LevelOp] = []

    def slot_of(u: int) -> int:
        return idx_slots.index(u)

    for i in range(n):
        u_i = an.order[i]
        lbl = label_of[u_i]
        if i == 0:
            kind[u_i] = IDX
            idx_slots.append(u_i)
            continue
        bk = [u for u in an.bwd[i] if kind[u] == IDX]
        wt = [u for u in an.bwd[i] if kind[u] == BM]
        color = int(an.colors[u_i])
        decompose: list[tuple[int, int, list[int]]] = []
        if not wt:
            case = 1 if color == BLACK else 2
        else:
            if color == BLACK:
                case = 3
            else:
                s_est = 1.0
                for u_j in wt:
                    s_est *= max(exp_size.get(u_j, 1.0), 1.0)
                if bk:
                    r_est = min(mean_rowpop(u, u_i) for u in bk)
                else:
                    r_est = mean_rowpop(wt[0], u_i) * max(exp_size.get(wt[0], 1.0), 1.0)
                if s_est >= r_est:
                    case = 4        # 4.1 — behaves like case 3, stores IDX
                else:
                    case = 42       # 4.2 — decompose whites, store BM
        if case == 42:
            for u_j in wt:
                bm_now = [u for u, k in kind.items()
                          if k == BM and u != u_j and label_of[u] == label_of[u_j]]
                decompose.append((u_j, len(idx_slots), bm_now))
                kind[u_j] = IDX
                idx_slots.append(u_j)
            bk = [u for u in an.bwd[i] if kind[u] == IDX]
            wt = []
        store = BM if (color == WHITE and case in (2, 42)) else IDX

        union_src = -1
        if not bk:
            union_src = min(wt, key=lambda u: exp_size.get(u, 1.0))

        same_idx = [slot_of(u) for u in idx_slots
                    if label_of[u] == lbl]
        same_bm = [u for u, k in kind.items() if k == BM and label_of[u] == lbl]

        dedup_slots: list[int] = []
        if an.cer_enabled[i] and not wt and bk:
            # vectorized CER: key on the extension's read set (BK idx columns
            # + same-label idx columns used for injectivity subtraction)
            dedup_slots = sorted({slot_of(u) for u in bk} | set(same_idx))

        op = LevelOp(
            vertex=u_i, case=case, store=store,
            bk_pairs=[(slot_of(u), u) for u in bk],
            wt_vertices=wt, union_src=union_src, decompose=decompose,
            con_threshold=len(an.con[i]),
            same_label_idx_slots=same_idx, same_label_bm=same_bm,
            dedup_slots=dedup_slots, n_words=words[lbl],
            idx_slot=(len(idx_slots) if store == IDX else -1), level=i)
        ops.append(op)
        kind[u_i] = store
        if store == IDX:
            idx_slots.append(u_i)
        else:
            if bk:
                exp_size[u_i] = min(mean_rowpop(u, u_i) for u in bk)
            else:
                exp_size[u_i] = mean_rowpop(union_src, u_i)

    # ---- leaf layout ----------------------------------------------------------
    bm_final = [u for u, k in kind.items() if k == BM]
    by_label: dict[int, list[int]] = {}
    for u in bm_final:
        by_label.setdefault(label_of[u], []).append(u)
    leaf_groups = [sorted(g) for g in by_label.values() if len(g) > 1]
    leaf_singles = [g[0] for g in by_label.values() if len(g) == 1]

    root = an.order[0]
    return MatchingPlan(an=an, spaces=spaces, words=words, label_of=label_of,
                        masks=masks, tables=tables, ops=ops,
                        idx_slots=idx_slots, leaf_groups=leaf_groups,
                        leaf_singles=leaf_singles, root_vertex=root,
                        root_words=words[label_of[root]],
                        graph_version=graph_version)


def plan_from_arrays(fields: dict) -> MatchingPlan:
    """Build a MatchingPlan from plain Python and numpy values — the fields
    of a plan as `dataclasses.asdict` gives them: `tables` as a
    (u, w) → uint32 ndarray dict, `masks`, `spaces`, `words`, `label_of`,
    `ops` as a list of LevelOp field dicts, `idx_slots`, `leaf_groups`,
    `leaf_singles`, `root_vertex`, `root_words`, and optionally `an` (a
    QueryAnalysis or its field dict) and `graph_version`. This is how a
    plan built elsewhere (the reference's, say) is carried across: the
    engine then runs on exactly its tables."""
    an = fields.get("an")
    if isinstance(an, dict):
        an = QueryAnalysis(**an)
    ops = [op if isinstance(op, LevelOp) else LevelOp(**{
        **op,
        "bk_pairs": [tuple(p) for p in op["bk_pairs"]],
        "decompose": [(int(v), int(s), list(b))
                      for (v, s, b) in op["decompose"]]})
        for op in fields["ops"]]
    return MatchingPlan(
        an=an,
        spaces={int(k): np.asarray(v) for k, v in fields["spaces"].items()},
        words={int(k): int(v) for k, v in fields["words"].items()},
        label_of={int(k): int(v) for k, v in fields["label_of"].items()},
        masks={int(k): np.asarray(v, dtype=np.uint32)
               for k, v in fields["masks"].items()},
        tables={(int(u), int(w)): np.asarray(t, dtype=np.uint32)
                for (u, w), t in fields["tables"].items()},
        ops=ops,
        idx_slots=[int(u) for u in fields["idx_slots"]],
        leaf_groups=[[int(u) for u in g] for g in fields["leaf_groups"]],
        leaf_singles=[int(u) for u in fields["leaf_singles"]],
        root_vertex=int(fields["root_vertex"]),
        root_words=int(fields["root_words"]),
        graph_version=int(fields.get("graph_version", -1)))
