"""Matching-order selection (paper §6.2, Eq. 2–3) plus the alternative
orders used by the Fig. 10d ablation (RI-style and GQL-style heuristics)."""
from __future__ import annotations

import numpy as np

from .graph import Graph

__all__ = ["cemr_order", "ri_order", "gql_order", "validate_order"]


def validate_order(query: Graph, order: list[int]) -> None:
    """A valid order keeps every prefix-induced subquery connected (Def. 2.3)."""
    assert sorted(order) == list(range(query.n)), "order must be a permutation"
    seen = {order[0]}
    for u in order[1:]:
        if not any(int(w) in seen for w in query.all_neighbors(u)):
            raise ValueError(f"order {order} disconnects at {u}")
        seen.add(u)


def cemr_order(query: Graph, cand_sizes: np.ndarray) -> list[int]:
    """Eq. 2: u0 = argmin |C(u)|/d(u); Eq. 3: next = argmin over the frontier of
    |C(u)| / |N(u) ∩ O|."""
    deg = query.degree().astype(np.float64)
    deg[deg == 0] = 1.0
    u0 = int(np.argmin(cand_sizes / deg))
    order = [u0]
    chosen = {u0}
    while len(order) < query.n:
        best, best_score = -1, np.inf
        frontier: set[int] = set()
        for u in order:
            frontier.update(int(w) for w in query.all_neighbors(u))
        frontier -= chosen
        if not frontier:  # disconnected query (shouldn't happen for valid Q)
            frontier = set(range(query.n)) - chosen
        for u in sorted(frontier):
            conn = sum(1 for w in query.all_neighbors(u) if int(w) in chosen)
            score = cand_sizes[u] / max(conn, 1)
            if score < best_score:
                best, best_score = u, score
        order.append(best)
        chosen.add(best)
    validate_order(query, order)
    return order


def ri_order(query: Graph, cand_sizes: np.ndarray) -> list[int]:
    """RI-style: structure-only — greedily maximize backward connectivity,
    tie-break on degree (Bonnici et al.)."""
    deg = query.degree()
    u0 = int(np.argmax(deg))
    order = [u0]
    chosen = {u0}
    while len(order) < query.n:
        best, best_key = -1, (-1, -1)
        for u in range(query.n):
            if u in chosen:
                continue
            conn = sum(1 for w in query.all_neighbors(u) if int(w) in chosen)
            if conn == 0:
                continue
            key = (conn, int(deg[u]))
            if key > best_key:
                best, best_key = u, key
        if best < 0:
            best = next(u for u in range(query.n) if u not in chosen)
        order.append(best)
        chosen.add(best)
    validate_order(query, order)
    return order


def gql_order(query: Graph, cand_sizes: np.ndarray) -> list[int]:
    """GQL-style: smallest candidate set first, connectivity-constrained."""
    u0 = int(np.argmin(cand_sizes))
    order = [u0]
    chosen = {u0}
    while len(order) < query.n:
        frontier = [u for u in range(query.n) if u not in chosen and
                    any(int(w) in chosen for w in query.all_neighbors(u))]
        if not frontier:
            frontier = [u for u in range(query.n) if u not in chosen]
        best = min(frontier, key=lambda u: cand_sizes[u])
        order.append(best)
        chosen.add(best)
    validate_order(query, order)
    return order
