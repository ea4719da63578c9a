"""Vectorized CEMR engine: stage/kernel construction for tile enumeration.

Torch port of `repro.core.engine` (the TPU-native tile engine):

  * a *tile* is a fixed-capacity batch of (aggregated) partial embeddings:
    IDX columns (deterministically mapped vertices, one int32 per row) and
    BM columns (aggregated white mappings, bitmaps over per-label candidate
    spaces, stored as int32 words);
  * extending u_i = gather adjacency bitmap rows for the backward-neighbor
    mappings and AND them — the `bitmap_intersect` CUDA kernel on the card
    (its plain torch version on the CPU), or plain torch gathers with
    intersect="jnp";
  * CEM: Case-2/4.2 extensions *store* R as a bitmap column;
  * expansion to IDX columns is a fixed-capacity enumeration of set bits
    (`bitops.expand_select`); overflow re-enters the host work stack;
  * CER: the cross-tile ring buffer in scheduler.py serves brother rows;
  * contained-vertex pruning = per-row popcount threshold;
  * injectivity: same-label IDX values are kept distinct by eager bit
    clearing, same-label BM×BM overlap is corrected at the leaf by
    inclusion-exclusion.

This module owns the *static* side: the stage plan and the per-stage
compute / expand closures. The runtime — the superstep loop, frontier
compaction, the CER and failure buffers, the leaf reduction — lives in
scheduler.py; `VectorEngine.run()` delegates to it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bitops
from .count import iter_injective
from .encoding import QueryAnalysis
from .filtering import CandidateSpace
from .plan import IDX, INTERSECT_MODES, LevelOp, MatchingPlan, build_plan

__all__ = ["VectorMatchResult", "VectorStats", "VectorEngine",
           "INTERSECT_MODES", "upload_plan"]


@dataclasses.dataclass
class VectorStats:
    """Counters for one vector-engine run; the same fields as
    `repro.core.engine.VectorStats` (docs/engine.md has the glossary).
    `device_steps` counts host dispatches (one per superstep / merge).
    Fields of paths this package does not run (superbatch, sharding, the
    compat loop) stay 0."""

    device_steps: int = 0
    supersteps: int = 0
    tiles: int = 0
    expansions: int = 0
    rows_processed: int = 0
    rows_alive: int = 0
    gather_and_ops: int = 0          # adjacency rows gathered+ANDed (work proxy)
    dedup_keys_seen: int = 0
    dedup_unique: int = 0
    cer_hits: int = 0                # rows served from the cross-tile CER buffer
    cer_misses: int = 0
    fail_hits: int = 0               # frontier rows masked dead by the failure
                                     # cache (one per matching stage lookup)
    fail_misses: int = 0             # failure-cache lookups finding no entry
    fail_inserts: int = 0            # failed read-sets recorded in the ring
    fail_pruned_rows: int = 0        # rows killed before their subtree was
                                     # dispatched (<= fail_hits)
    bucketed_tiles: int = 0          # per-tile CER bucketed computes (compat path)
    packed_tiles: int = 0            # sibling-tile merges (frontier compaction)
    batched_queries: int = 0         # queries advanced by a superbatch run
    bucket_recompiles: int = 0       # batched supersteps built fresh
    shard_lanes: int = 0             # live lanes dispatched by sharded supersteps
    shard_rebalances: int = 0        # idle lanes refilled by chunk splits
    leaf_tiles: int = 0
    leaf_overflows: int = 0          # int64 leaf reductions that fell back to host
    peak_stack: int = 0
    readbacks: int = 0               # host sync points of the superstep loop;
                                     # overlap coalesces them
    overlapped_supersteps: int = 0   # supersteps dispatched while an earlier
                                     # dispatch's readback was outstanding

    @property
    def dedup_ratio(self) -> float:
        return (self.dedup_unique / self.dedup_keys_seen
                if self.dedup_keys_seen else 1.0)


@dataclasses.dataclass
class VectorMatchResult:
    count: int
    stats: VectorStats
    timed_out: bool
    embeddings: list[dict[int, int]] | None = None


def upload_plan(plan: MatchingPlan, device) -> tuple[dict, dict]:
    """The plan's uint32 tables and masks as int32 tensors on `device`
    (same bits), uploaded once: tables keyed "u:w", masks by vertex."""
    def up(a):
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int32)).to(device)
    tables = {f"{u}:{w}": up(t) for (u, w), t in plan.tables.items()}
    masks = {u: up(m) for u, m in plan.masks.items()}
    return tables, masks


def _union_rows(table, bmcol):
    """OR of adjacency rows selected by a bitmap column (no-black-bwd path),
    as a 0/1 matrix product. CUDA has no integer matmul, so it runs in
    float64, which is exact here: entries are 0/1 and each sum is at most
    S < 2**53. Unlike float32, float64 products never go through TF32, so
    the result does not depend on the process's matmul precision flags."""
    dev = table.device
    s, w = table.shape
    ar = torch.arange(s, dtype=torch.int32, device=dev)
    src_bits = ((bmcol[:, (ar >> 5).long()] >> (ar & 31)[None, :]) & 1)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    tab_bits = ((table[:, :, None] >> shifts[None, None, :]) & 1
                ).reshape(s, w * 32)
    hit = (src_bits.to(torch.float64) @ tab_bits.to(torch.float64)) > 0
    hit = hit.reshape(bmcol.shape[0], w, 32).to(torch.int32)
    # distinct powers of two: the int32 sum is their OR (bit 31 wraps to
    # the sign bit, as the uint32 word has it)
    return (hit << shifts[None, None, :]).sum(dim=2, dtype=torch.int32)


def _resolve_intersect_fn(intersect: str):
    """Map the `intersect` knob to an intersect_fn (None = plain torch
    gathers): "auto", "pallas" and "fused" use the bitmap-intersect kernel
    wrapper (the CUDA kernel on the card, its plain version on the CPU);
    "jnp" forces the plain gathers. Unlike the reference, "fused" keeps the
    kernel for the extends it does not fuse: in eager torch the plain
    gathers are k+1 launches where the kernel is one."""
    if intersect not in INTERSECT_MODES:
        raise ValueError(f"intersect must be one of {INTERSECT_MODES}, "
                         f"got {intersect!r}")
    if intersect == "jnp":
        return None
    from ..kernels import ops as _kops
    return _kops.make_intersect_fn()


class VectorEngine:
    """Compiled matcher for one (query, data, encoding) plan on one device."""

    def __init__(self, cs: CandidateSpace, an: QueryAnalysis, *,
                 device, tile_rows: int = 256, use_cv: bool = True,
                 use_dedup: bool = True, intersect_fn=None,
                 plan: MatchingPlan | None = None, intersect: str = "auto",
                 cer_buffer_slots: int = 256,
                 use_failure_cache: bool = True,
                 failure_cache_slots: int = 64,
                 pack_tiles: bool = True, overlap: bool = True):
        self.plan = build_plan(cs, an) if plan is None else plan
        self.cs, self.an = cs, an
        self.device = torch.device(device)
        self.t = tile_rows
        self.use_cv = use_cv
        self.use_dedup = use_dedup
        self.cer_buffer_slots = cer_buffer_slots
        self.use_failure_cache = use_failure_cache
        self.failure_cache_slots = failure_cache_slots
        self.pack_tiles = pack_tiles
        # overlap only changes *when* superstep readbacks happen, never
        # what is computed
        self.overlap = overlap
        self.fused_expand = intersect == "fused" and intersect_fn is None
        if intersect_fn is None:
            intersect_fn = _resolve_intersect_fn(intersect)
        self.intersect_fn = intersect_fn
        self.tables, self.masks = upload_plan(self.plan, self.device)
        self.stats = VectorStats()
        self._stages = self._build_stages()
        self._scheduler = None

    # ------------------------------------------------------------- stage plan
    def _build_stages(self):
        """Flatten per-level ops into micro-op stages. Stage kinds:
        ('decompose', vertex, slot, same_bm, words_src)
        ('extend', LevelOp)"""
        stages: list = []
        root_op = LevelOp(vertex=self.plan.root_vertex, case=1, store=IDX,
                          bk_pairs=[], wt_vertices=[], union_src=-1,
                          decompose=[], con_threshold=len(self.an.con[0]),
                          same_label_idx_slots=[], same_label_bm=[],
                          dedup_slots=[], n_words=self.plan.root_words,
                          idx_slot=0, level=0)
        stages.append(("extend", root_op))
        for op in self.plan.ops:
            for (v, slot, same_bm) in op.decompose:
                words_src = self.plan.words[self.plan.label_of[v]]
                stages.append(("decompose", v, slot, same_bm, words_src))
            stages.append(("extend", op))
        return stages

    # ----------------------------------------------------------- raw closures
    def _make_compute_parts(self, si: int):
        """Return (compute_r, con): compute_r(tile, tables, masks) -> (r, pop)
        produces the extension bitmap *before* any aliveness interaction —
        pure in the extension read-set, which is what makes the result
        cacheable in the CER buffer."""
        stage = self._stages[si]

        if stage[0] == "decompose":
            _, v, _slot, _same_bm, _words_src = stage

            def compute_r(tile, tables, masks):
                r = tile["bm"][v]
                return r, bitops.row_popcount(r)

            return compute_r, 1

        op: LevelOp = stage[1]
        pairs = [(s, u, op.vertex) for (s, u) in op.bk_pairs]
        con = max(op.con_threshold, 1) if self.use_cv else 1
        root = op.level == 0
        ext_fn = self.intersect_fn

        def compute_r(tile, tables, masks):
            pop = None
            if root:
                r = masks[op.vertex][None, :].expand(
                    tile["alive"].shape[0], op.n_words)
            elif pairs:
                if ext_fn is not None:
                    tabs = [tables[f"{u}:{w}"] for (_, u, w) in pairs]
                    idxs = torch.stack([tile["idx"][:, s]
                                        for (s, _, _) in pairs], dim=1)
                    out = ext_fn(tabs, idxs)
                    if not (isinstance(out, tuple) and len(out) == 2):
                        raise TypeError(
                            "intersect_fn must return (R, pop) — the ANDed "
                            "bitmap and its fused per-row popcount (see "
                            "kernels.ops.make_intersect_fn)")
                    r, pop = out
                else:
                    r = None
                    for (s, u_j, u_i) in pairs:
                        rows = tables[f"{u_j}:{u_i}"][tile["idx"][:, s].long()]
                        r = rows if r is None else (r & rows)
            else:
                r = _union_rows(tables[f"{op.union_src}:{op.vertex}"],
                                tile["bm"][op.union_src])
            cleared = 0
            for s in op.same_label_idx_slots:
                r, c = bitops.clear_bit_rows_count(r, tile["idx"][:, s])
                cleared = cleared + c
            pop = bitops.row_popcount(r) if pop is None else pop - cleared
            return r, pop

        return compute_r, con

    @staticmethod
    def finish_compute(tile, r, pop, con):
        """Aliveness + contained-vertex prune; dead rows' bitmaps are zeroed
        so downstream bit enumeration and merges see only live work."""
        ok = tile["alive"] & (pop >= con) & (pop > 0)
        return torch.where(ok[:, None], r, 0), torch.where(ok, pop, 0), ok

    def _make_expand(self, si: int, *, with_sel: bool = False):
        stage = self._stages[si]
        t_out = self.t
        if stage[0] == "decompose":
            _, v, _slot, same_bm, _ = stage
            wt_prune: list[tuple[int, str]] = []
            same_label_bm = list(same_bm)
            drop_bm = v
        else:
            op: LevelOp = stage[1]
            wt_prune = [(u_j, f"{op.vertex}:{u_j}") for u_j in op.wt_vertices]
            same_label_bm = list(op.same_label_bm)
            drop_bm = None

        def expand(tile, r, start, tables):
            rows, bitpos, valid, total = bitops.expand_select(r, start, t_out)
            rows_l = rows.long()
            idx = torch.cat([tile["idx"][rows_l], bitpos[:, None]], dim=1)
            bm_out = {}
            alive = valid
            for u, col in tile["bm"].items():
                if u == drop_bm:
                    continue
                g = col[rows_l]
                for (u_j, tkey) in wt_prune:
                    if u_j == u:
                        g = g & tables[tkey][bitpos.long()]
                if u in same_label_bm:
                    g = bitops.clear_bit_rows(g, bitpos)
                alive = alive & (bitops.row_popcount(g) > 0)
                bm_out[u] = g
            out = {"idx": idx, "bm": bm_out, "alive": alive}
            if with_sel:
                # the raw bit selection, for the fused kernel's double
                # indirection through (rows, bitpos)
                return out, total, rows, bitpos
            return out, total

        return expand

    def _make_expand_fused(self, si: int, sj: int):
        """Fused expand+intersect+popcount across the boundary between
        expand stage `si` and the extend stage `sj` that follows it: the
        fused kernel consumes the bit selection straight from
        `bitops.expand_select` and produces the child intersection
        (R, pop) without materializing the gathered index columns.

        Returns None when the fused path is off (`intersect != "fused"`)
        or the stage pair is ineligible (root / union / decompose extends
        have no backward-pair intersection to fuse). The kernel never masks
        dead rows; `finish_compute` masks downstream."""
        if not self.fused_expand:
            return None
        stage = self._stages[sj]
        if stage[0] != "extend":
            return None
        op: LevelOp = stage[1]
        if op.level == 0 or not op.bk_pairs:
            return None
        from ..kernels import ops as _kops
        pairs = [(s, u, op.vertex) for (s, u) in op.bk_pairs]
        slots = tuple(s for (s, _, _) in pairs)
        fused_fn = _kops.make_fused_expand_intersect_fn()
        expand = self._make_expand(si, with_sel=True)
        same_slots = list(op.same_label_idx_slots)

        def fused(tile, r, start, tables):
            out, total, rows, bitpos = expand(tile, r, start, tables)
            tabs = [tables[f"{u}:{w}"] for (_, u, w) in pairs]
            r2, pop = fused_fn(tabs, tile["idx"], rows, bitpos, slots)
            cleared = 0
            for s in same_slots:
                r2, c = bitops.clear_bit_rows_count(r2, out["idx"][:, s])
                cleared = cleared + c
            return out, total, (r2, pop - cleared)

        return fused

    def _make_leaf_terms(self):
        """tile -> (T, n_terms) int32 popcount terms for leaf counting
        (singles, then per-group inclusion-exclusion terms)."""
        plan = self.plan
        singles = list(plan.leaf_singles)
        groups = [list(g) for g in plan.leaf_groups]
        pc = bitops.row_popcount

        def leaf(tile):
            bm = tile["bm"]
            terms = [pc(bm[u]) for u in singles]
            for g in groups:
                if len(g) == 2:
                    a, b = bm[g[0]], bm[g[1]]
                    terms += [pc(a), pc(b), pc(a & b)]
                else:  # len 3 (encoder cap)
                    a, b, c = bm[g[0]], bm[g[1]], bm[g[2]]
                    terms += [pc(a), pc(b), pc(c), pc(a & b), pc(a & c),
                              pc(b & c), pc(a & b & c)]
            if terms:
                return torch.stack(terms, dim=1)
            return torch.zeros((tile["alive"].shape[0], 0), dtype=torch.int32,
                               device=tile["alive"].device)

        return leaf

    # --------------------------------------------------------------- schedule
    def run(self, *, limit: int = 1_000_000, max_steps: int | None = None,
            materialize: bool = False) -> VectorMatchResult:
        if self._scheduler is None:
            from .scheduler import TileScheduler
            self._scheduler = TileScheduler(self)
        return self._scheduler.run(limit=limit, max_steps=max_steps,
                                   materialize=materialize)

    # ------------------------------------------------------------ materialize
    def _materialize(self, tile) -> list[dict[int, int]]:
        plan = self.plan
        idx = tile["idx"].cpu().numpy()
        alive = tile["alive"].cpu().numpy()
        bm = {u: v.cpu().numpy() for u, v in tile["bm"].items()}
        out = []
        for row in np.nonzero(alive)[0]:
            base = {}
            for k, u in enumerate(plan.idx_slots):
                space = plan.spaces[plan.label_of[u]]
                base[u] = int(space[idx[row, k]])
            sets: dict[int, np.ndarray] = {}
            for u, col in bm.items():
                bits = np.nonzero(np.unpackbits(
                    col[row].view(np.uint8), bitorder="little"))[0]
                space = plan.spaces[plan.label_of[u]]
                sets[u] = space[bits[bits < space.shape[0]]]
            groups: dict[int, list[int]] = {}
            for u in sets:
                groups.setdefault(plan.label_of[u], []).append(u)
            group_list = list(groups.values())

            def rec(gi, acc):
                if gi == len(group_list):
                    out.append(dict(acc))
                    return
                us = group_list[gi]
                for combo in iter_injective([sets[u] for u in us]):
                    acc2 = dict(acc)
                    for u, v in zip(us, combo):
                        acc2[u] = int(v)
                    rec(gi + 1, acc2)

            rec(0, base)
        return out
