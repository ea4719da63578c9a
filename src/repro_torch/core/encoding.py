"""Black-white vertex encoding (paper §4.1, §6.3) and static query analysis:
backward neighbors, reference sets, parent/child CER wiring (§5), contained
vertex sets (§6.1.1).

Everything here is *static* per (query, order): it becomes compile-time
metadata of the vectorized engine's MatchingPlan.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import Graph

__all__ = ["QueryAnalysis", "analyze", "choose_encoding"]

BLACK, WHITE = 0, 1
# Same-label white groups larger than this are structurally forced to black:
# leaf-level injectivity correction uses inclusion-exclusion whose cost grows
# with group size (see core/count.py).
MAX_WHITE_GROUP = 3


@dataclasses.dataclass
class QueryAnalysis:
    """Static per-(Q, O, colors) metadata shared by both engines."""

    order: list[int]                  # matching order, query-vertex ids
    pos: np.ndarray                   # pos[u] = index of u in order
    colors: np.ndarray                # colors[u] ∈ {BLACK, WHITE}
    bwd: list[list[int]]              # bwd[i]  = backward neighbors of order[i] (vertex ids)
    fwd: list[list[int]]              # fwd[i]  = forward neighbors
    bk: list[list[int]]               # black backward neighbors (vertex ids)
    wt: list[list[int]]               # white backward neighbors (vertex ids)
    rs: list[list[int]]               # reference set RS(order[i]) (vertex ids)
    parent: list[int]                 # parent vertex id (max-index RS member) or -1
    cer_enabled: list[bool]           # u_i.f — parent exists and is not order[i-1]
    children: list[list[int]]         # CER children per vertex id
    con: list[list[int]]              # contained vertex set Con(order[i]) (vertex ids)
    same_label_black_prior: list[list[int]]  # same-label *black* vertices before i
    white_groups: list[list[int]]     # same-label white vertex groups (ids)

    @property
    def n(self) -> int:
        return len(self.order)


def _backward_closure(bwd_of: dict[int, list[int]], u: int) -> set[int]:
    """Anc(u): backward neighbors and, recursively, their backward neighbors."""
    out: set[int] = set()
    stack = list(bwd_of[u])
    while stack:
        w = stack.pop()
        if w in out:
            continue
        out.add(w)
        stack.extend(bwd_of[w])
    return out


def analyze(query: Graph, order: list[int], colors: np.ndarray,
            cand: list[np.ndarray] | None = None) -> QueryAnalysis:
    n = query.n
    pos = np.empty(n, dtype=np.int64)
    for i, u in enumerate(order):
        pos[u] = i

    bwd: list[list[int]] = []
    fwd: list[list[int]] = []
    for i, u in enumerate(order):
        nb = [int(w) for w in query.all_neighbors(u)]
        bwd.append(sorted((w for w in nb if pos[w] < i), key=lambda w: pos[w]))
        fwd.append(sorted((w for w in nb if pos[w] > i), key=lambda w: pos[w]))
    bwd_of = {order[i]: bwd[i] for i in range(n)}

    bk = [[w for w in bwd[i] if colors[w] == BLACK] for i in range(n)]
    wt = [[w for w in bwd[i] if colors[w] == WHITE] for i in range(n)]

    # RS(u_i) per Eq. (1): Anc(u_i) ∪ {u_k | k < i, u_k adjacent to some white
    # backward neighbor of u_i}
    rs: list[list[int]] = []
    for i, u in enumerate(order):
        s = _backward_closure(bwd_of, u)
        for wj in wt[i]:
            for uk in query.all_neighbors(wj):
                uk = int(uk)
                if pos[uk] < i:
                    s.add(uk)
        rs.append(sorted(s, key=lambda w: pos[w]))

    parent: list[int] = []
    cer_enabled: list[bool] = []
    children: list[list[int]] = [[] for _ in range(n)]
    for i, u in enumerate(order):
        if rs[i]:
            p = rs[i][-1]  # max index in O
            parent.append(p)
            flag = pos[p] < i - 1
            cer_enabled.append(bool(flag))
            if flag:
                children[p].append(u)
        else:
            parent.append(-1)
            cer_enabled.append(False)

    # Con(u_i): same-label u_j with pos[u_j] > i and N^O_-(u_i) ⊆ N^O_-(u_j).
    # Soundness fix over the paper (DESIGN.md §7): Lemma 2's containment chain
    # additionally needs C(u_j) ⊆ C(u_i) — per-vertex LDF/NLF filtering does
    # not guarantee it, so we check it when candidate sets are provided.
    con: list[list[int]] = []
    for i, u in enumerate(order):
        s = []
        bw_i = set(bwd[i])
        for j in range(i + 1, n):
            w = order[j]
            if query.labels[w] != query.labels[u] or not bw_i <= set(bwd[j]):
                continue
            if cand is not None:
                cu, cw = cand[u], cand[w]
                pos_in = np.searchsorted(cu, cw)
                pos_in = np.clip(pos_in, 0, max(cu.shape[0] - 1, 0))
                if cu.shape[0] == 0 or not np.all(cu[pos_in] == cw):
                    continue  # C(w) ⊄ C(u): pigeonhole argument unavailable
            s.append(w)
        con.append(s)

    same_label_black_prior = []
    for i, u in enumerate(order):
        s = [order[j] for j in range(i)
             if query.labels[order[j]] == query.labels[u]
             and colors[order[j]] == BLACK]
        same_label_black_prior.append(s)

    groups: dict[int, list[int]] = {}
    for u in range(n):
        if colors[u] == WHITE:
            groups.setdefault(int(query.labels[u]), []).append(u)
    white_groups = [sorted(g, key=lambda w: pos[w])
                    for g in groups.values() if len(g) > 1]

    return QueryAnalysis(order=order, pos=pos, colors=colors, bwd=bwd, fwd=fwd,
                         bk=bk, wt=wt, rs=rs, parent=parent,
                         cer_enabled=cer_enabled, children=children, con=con,
                         same_label_black_prior=same_label_black_prior,
                         white_groups=white_groups)


def choose_encoding(query: Graph, order: list[int], cand_sizes: np.ndarray,
                    mode: str = "cost") -> np.ndarray:
    """§6.3 cost model. Modes: 'cost' (paper Eq. 4-5), 'all_black',
    'all_white', 'case12' (white iff no forward neighbors — Fig. 10a variant).

    Deviation note: Eq. 4's |WT(u)| factor makes WR(u)=0 whenever u has no
    white backward neighbor, which would force nearly every vertex white
    (degenerate). We read the intent ("less beneficial with many white
    backward neighbors") and use (1 + |WT(u)|); recorded in DESIGN.md §7.
    Structural constraint: same-label white groups are capped at
    MAX_WHITE_GROUP (leaf inclusion-exclusion cost), excess forced black.
    """
    n = query.n
    pos = {u: i for i, u in enumerate(order)}
    colors = np.full(n, BLACK, dtype=np.int32)
    if mode == "all_black":
        return colors
    if mode == "all_white":
        colors[:] = WHITE
    elif mode == "case12":
        for u in range(n):
            has_fwd = any(pos[int(w)] > pos[u] for w in query.all_neighbors(u))
            if not has_fwd:
                colors[u] = WHITE
    elif mode == "cost":
        label_count = {int(l): int((query.labels == l).sum())
                       for l in np.unique(query.labels)}
        for i, u in enumerate(order):
            bwd = [int(w) for w in query.all_neighbors(u) if pos[int(w)] < i]
            fwd = [int(w) for w in query.all_neighbors(u) if pos[int(w)] > i]
            n_wt = sum(1 for w in bwd if colors[w] == WHITE)
            n_bk = len(bwd) - n_wt
            wr = ((1 + sum(int(cand_sizes[w]) for w in fwd))
                  * label_count[int(query.labels[u])] * (1 + n_wt))
            br = int(cand_sizes[u]) * max(n_bk, 1)
            if wr < br:
                colors[u] = WHITE
    else:
        raise ValueError(f"unknown encoding mode {mode!r}")

    # structural cap on same-label white groups (keep earliest-in-order white;
    # keeping later ones white is usually better for leaf batching, but
    # earliest-first is deterministic and keeps conflict detection early).
    if mode != "all_black":
        groups: dict[int, list[int]] = {}
        for u in range(n):
            if colors[u] == WHITE:
                groups.setdefault(int(query.labels[u]), []).append(u)
        for g in groups.values():
            if len(g) > MAX_WHITE_GROUP:
                g_sorted = sorted(g, key=lambda w: pos[w], reverse=True)
                for u in g_sorted[MAX_WHITE_GROUP:]:
                    colors[u] = BLACK
        # the first vertex in the order has no backward neighbors at all —
        # white would mean "all candidates at once", which is exactly what the
        # tile scheduler's root expansion does; keep it black for clarity.
        colors[order[0]] = BLACK
    return colors
