"""Vectorized CEMR engine: stage/kernel construction for tile enumeration.

Torch port of `repro.core.engine` (the TPU-native tile engine):

  * a *tile* is a fixed-capacity batch of (aggregated) partial embeddings:
    IDX columns (deterministically mapped vertices, one int32 per row) and
    BM columns (aggregated white mappings, bitmaps over per-label candidate
    spaces, stored as int32 words);
  * extending u_i = gather adjacency bitmap rows for the backward-neighbor
    mappings, AND them and clear the same-label bits — one
    `tile_intersect` CUDA launch on the card (its plain torch version on
    the CPU), or plain torch gathers with intersect="jnp";
  * CEM: Case-2/4.2 extensions *store* R as a bitmap column;
  * expansion to IDX columns is a fixed-capacity enumeration of set bits
    (the `expand_select` kernel, or `bitops.expand_select` with
    intersect="jnp"; with intersect="fused" the `expand_intersect` kernel
    also computes the next extension in the same launch); overflow
    re-enters the host work stack;
  * CER: the cross-tile ring buffer in scheduler.py serves brother rows;
  * contained-vertex pruning = per-row popcount threshold;
  * injectivity: same-label IDX values are kept distinct by eager bit
    clearing, same-label BM×BM overlap is corrected at the leaf by
    inclusion-exclusion.

This module owns the *static* side: the stage plan and the per-stage
compute / expand closures, and the stage-at-a-time compat loop's cached
per-primitive callables (`_compute_fn`, `_expand_fn`, `_leaf_fn`,
`_dedup_fn`, `_bucket_compute_fn`). The runtime — the superstep loop,
frontier compaction, the CER and failure buffers, the leaf reduction, the
compat loop — lives in scheduler.py; `VectorEngine.run()` delegates to it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import bitmap_intersect as _kernels
from . import bitops
from .count import iter_injective
from .encoding import QueryAnalysis
from .filtering import CandidateSpace
from .plan import IDX, INTERSECT_MODES, LevelOp, MatchingPlan, build_plan

__all__ = ["VectorMatchResult", "VectorStats", "VectorEngine",
           "INTERSECT_MODES", "upload_plan", "vector_match"]


@dataclasses.dataclass
class VectorStats:
    """Counters for one vector-engine run; the same fields as
    `repro.core.engine.VectorStats` (docs/engine.md has the glossary).
    `device_steps` counts host dispatches (one per superstep / merge, or
    per primitive in the compat loop). The sharding fields count the lanes
    and rebalances of a sharded run (core/shard.py) and stay 0 on one
    device."""

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


def make_leaf_terms(singles, groups):
    """tile -> (T, n_terms) int32 popcount terms for leaf counting: the BM
    columns `singles`, then per same-label group its inclusion-exclusion
    terms."""
    singles = list(singles)
    groups = [list(g) for g in groups]
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


def _uses_kernels(intersect: str) -> bool:
    """Whether the `intersect` knob routes the extension computes through
    the bitmap kernels' wrappers (the CUDA kernels on the card, their plain
    versions on the CPU): "auto", "pallas" and "fused" do, "jnp" forces
    plain torch gathers and the torch `bitops.expand_select`. Unlike the
    reference, "fused" keeps the kernels for the extends it does not fuse:
    in eager torch the plain gathers are k+1 launches where the kernel is
    one."""
    if intersect not in INTERSECT_MODES:
        raise ValueError(f"intersect must be one of {INTERSECT_MODES}, "
                         f"got {intersect!r}")
    return intersect != "jnp"


class VectorEngine:
    """Compiled matcher for one (query, data, encoding) plan on one device."""

    def __init__(self, cs: CandidateSpace, an: QueryAnalysis, *,
                 device, tile_rows: int = 256, use_cv: bool = True,
                 use_dedup: bool = True, intersect_fn=None,
                 plan: MatchingPlan | None = None, intersect: str = "auto",
                 use_cer_buffer: bool = True, cer_buffer_slots: int = 256,
                 use_failure_cache: bool = True,
                 failure_cache_slots: int = 64,
                 pack_tiles: bool = True, mesh=None, overlap: bool = True):
        # `mesh` is an `EnumMesh` (launch.mesh.make_enum_mesh); size > 1
        # selects the sharded scheduler (core.shard), None / size 1 the
        # single-device path; each lane runs full-width tiles, so one
        # sharded dispatch covers up to mesh.size frontier chunks at once
        self.plan = build_plan(cs, an) if plan is None else plan
        self.cs, self.an = cs, an
        self.device = torch.device(device)
        self.t = tile_rows
        self.use_cv = use_cv
        self.use_dedup = use_dedup
        # False selects the stage-at-a-time compat loop (scheduler.py)
        self.use_cer_buffer = use_cer_buffer
        self.cer_buffer_slots = cer_buffer_slots
        self.use_failure_cache = use_failure_cache
        self.failure_cache_slots = failure_cache_slots
        self.pack_tiles = pack_tiles
        self.mesh = mesh
        # overlap only changes *when* superstep readbacks happen, never
        # what is computed
        self.overlap = overlap
        # the selection kernel expands every boundary on a kernel route;
        # a caller's intersect_fn takes the pair extends' place of
        # tile_intersect, and turns the fused boundary off
        self.kernels = _uses_kernels(intersect)
        self.fused_expand = intersect == "fused" and intersect_fn is None
        self.intersect_fn = intersect_fn
        self.tables, self.masks = upload_plan(self.plan, self.device)
        self.stats = VectorStats()
        self._stages = self._build_stages()
        self._scheduler = None
        self._fns: dict = {}               # the compat loop's callables

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
        tile_kernel = self.kernels and ext_fn is None
        slots = tuple(s for (s, _, _) in pairs)
        same_slots = tuple(op.same_label_idx_slots)

        def compute_r(tile, tables, masks):
            pop = None
            if root:
                r = masks[op.vertex][None, :].expand(
                    tile["alive"].shape[0], op.n_words)
            elif pairs and tile_kernel:
                # keys, AND, same-label clears and popcount: one launch
                tabs = [tables[f"{u}:{w}"] for (_, u, w) in pairs]
                return _kernels.tile_intersect(tabs, tile["idx"], slots,
                                               same_slots)
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
            for s in same_slots:
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

    def _make_expand_rest(self, si: int):
        """The part of expand stage `si` after the bit selection: gather
        the surviving BM columns through `rows`, prune them by the white
        vertices' tables and the same-label bits, and mark rows whose
        columns emptied dead. Returns rest(tile, rows, bitpos, valid,
        child_idx, tables) -> child tile."""
        stage = self._stages[si]
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

        def rest(tile, rows, bitpos, valid, child_idx, tables):
            rows_l = rows.long()
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
            return {"idx": child_idx, "bm": bm_out, "alive": alive}

        return rest

    def _make_expand(self, si: int):
        """expand(tile, r, start, tables) -> (child tile, total): the set
        bits [start, start + tile_rows) of the frontier bitmap r, selected
        by the `expand_select` kernel on a kernel route (with the child's
        index columns) or by `bitops.expand_select` with intersect="jnp"."""
        t_out = self.t
        rest = self._make_expand_rest(si)
        kernels = self.kernels

        def expand(tile, r, start, tables):
            if kernels:
                rows, bitpos, valid, total, child = _kernels.expand_select(
                    r, start, t_out, tile["idx"])
            else:
                rows, bitpos, valid, total = bitops.expand_select(
                    r, start, t_out)
                child = torch.cat([tile["idx"][rows.long()],
                                   bitpos[:, None]], dim=1)
            return rest(tile, rows, bitpos, valid, child, tables), total

        return expand

    def _make_expand_fused(self, si: int, sj: int):
        """Fused expand+intersect+popcount across the boundary between
        expand stage `si` and the extend stage `sj` that follows it: one
        `expand_intersect` launch selects the frontier's bits, builds the
        child's index columns and computes the child's extension (R, pop)
        with its same-label clears — the same pure function of the key
        columns as `_make_compute_parts(sj)`.

        The launch's word-block width is autotuned for the extend's (k, W)
        on the engine's device when the boundary is built, as the
        reference does; every width gives the same bits.

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
        t_out = self.t
        keys = [f"{u}:{op.vertex}" for (_, u) in op.bk_pairs]
        slots = tuple(s for (s, _) in op.bk_pairs)
        same_slots = tuple(op.same_label_idx_slots)
        rest = self._make_expand_rest(si)
        wpb = _kernels.autotune_words_per_block(len(keys), op.n_words,
                                                device=self.device)

        def fused(tile, r, start, tables):
            rows, bitpos, valid, total, child, r2, pop2 = \
                _kernels.expand_intersect(r, start, t_out, tile["idx"],
                                          [tables[k] for k in keys], slots,
                                          same_slots, words_per_block=wpb)
            return (rest(tile, rows, bitpos, valid, child, tables), total,
                    (r2, pop2))

        return fused

    def _make_leaf_terms(self):
        """tile -> (T, n_terms) int32 popcount terms for leaf counting."""
        return make_leaf_terms(self.plan.leaf_singles, self.plan.leaf_groups)

    # ------------------------------------------------- compat-loop callables
    # The stage-at-a-time loop (scheduler.TileScheduler._run_tiles) calls one
    # of these per dispatch. The reference caches a `jax.jit` of each; here
    # the plain closure is cached under the same key.
    def _cached(self, key, make):
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = make()
        return fn

    def _compute_fn(self, si: int):
        """compute(tile, tables, masks) -> (r, ok): stage `si`'s extension
        (through `tile_intersect` on a kernel route) and its prune."""
        def make():
            compute_r, con = self._make_compute_parts(si)

            def compute(tile, tables, masks):
                r, pop = compute_r(tile, tables, masks)
                r, _, ok = self.finish_compute(tile, r, pop, con)
                return r, ok

            return compute

        return self._cached(("compute", si), make)

    def _expand_fn(self, si: int):
        """expand(tile, r, start, tables) -> (child tile, total)."""
        return self._cached(("expand", si), lambda: self._make_expand(si))

    def _leaf_fn(self):
        """leaf(tile) -> (terms (T, n) int32, alive (T,) bool)."""
        def make():
            leaf_terms = self._make_leaf_terms()
            return lambda tile: (leaf_terms(tile), tile["alive"])

        return self._cached(("leaf",), make)

    def _dedup_fn(self, si: int):
        """Brother-embedding analysis (vectorized CER): group rows by the
        extension read-set columns. Returns (n_unique, rep_rows, group_of):
        rep_rows[g] = row index of group g's representative; group_of[t] =
        group id of row t (undefined for dead rows). The reference's
        `lexsort((cols[::-1]..., ~alive))` is one stable sort per key, least
        significant first: alive rows first, then by the columns in order."""
        def make():
            slots = list(self._stages[si][1].dedup_slots)

            def uniq(tile):
                alive = tile["alive"]
                t = alive.shape[0]
                cols = [tile["idx"][:, s] for s in slots]
                order = torch.arange(t, device=alive.device)
                for key in cols[::-1] + [(~alive).to(torch.int32)]:
                    order = order[torch.sort(key[order], stable=True).indices]
                diff = torch.zeros(t, dtype=torch.bool, device=alive.device)
                diff[0] = True
                for c in cols:
                    cs = c[order]
                    diff[1:] |= cs[1:] != cs[:-1]
                gid = torch.cumsum(diff.to(torch.int32), dim=0,
                                   dtype=torch.int32) - 1
                n_unique = (diff & alive[order]).sum(dtype=torch.int32)
                rep = torch.where(diff, order, 0).to(torch.int32)
                rep_rows = torch.zeros(t, dtype=torch.int32,
                                       device=alive.device).scatter_reduce(
                    0, gid.long(), rep, "amax")
                group_of = torch.zeros(t, dtype=torch.int32,
                                       device=alive.device)
                group_of[order] = gid
                return n_unique, rep_rows, group_of

            return uniq

        return self._cached(("dedup", si), make)

    def _bucket_compute_fn(self, si: int, bucket: int):
        """CER-bucketed extension: run the gather+AND on `bucket` unique
        representative rows instead of the full tile, then broadcast R back
        through group ids — one extension computation per brother-embedding
        class. On a kernel route the representatives' AND is one
        `tile_intersect` launch with no clears: the same-label clears run
        after the broadcast, on the full tile's columns, as the reference
        has them."""
        def make():
            op: LevelOp = self._stages[si][1]
            keys = [f"{u}:{op.vertex}" for (_, u) in op.bk_pairs]
            slots = tuple(s for (s, _) in op.bk_pairs)
            con = max(op.con_threshold, 1) if self.use_cv else 1
            tile_kernel = self.kernels and self.intersect_fn is None

            def compute(tile, rep_rows, group_of, tables):
                reps = rep_rows[:bucket].long()
                idx_b = tile["idx"][reps]
                alive_b = tile["alive"][reps]
                if tile_kernel:
                    r, _ = _kernels.tile_intersect(
                        [tables[k] for k in keys], idx_b, slots)
                else:
                    r = None
                    for k, s in zip(keys, slots):
                        rows = tables[k][idx_b[:, s].long()]
                        r = rows if r is None else (r & rows)
                r = torch.where(alive_b[:, None], r, 0)
                r_full = r[torch.clamp(group_of, 0, bucket - 1).long()]
                for s in op.same_label_idx_slots:
                    r_full = bitops.clear_bit_rows(r_full, tile["idx"][:, s])
                pop = bitops.row_popcount(r_full)
                ok = tile["alive"] & (pop >= con) & (pop > 0)
                return torch.where(ok[:, None], r_full, 0), ok

            return compute

        return self._cached(("bucket", si, bucket), make)

    # --------------------------------------------------------------- schedule
    def run(self, *, limit: int = 1_000_000, max_steps: int | None = None,
            materialize: bool = False) -> VectorMatchResult:
        if self._scheduler is None:
            if self.mesh is not None and self.mesh.size > 1:
                from .shard import ShardedTileScheduler
                self._scheduler = ShardedTileScheduler(self, self.mesh)
            else:
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


def vector_match(query, data, *, device=None, encoding: str = "cost",
                 tile_rows: int = 256, limit: int = 1_000_000,
                 max_steps: int | None = None, materialize: bool = False,
                 use_cv: bool = True, use_dedup: bool = True,
                 intersect_fn=None, order: list[int] | None = None,
                 intersect: str = "auto", use_cer_buffer: bool = True,
                 cer_buffer_slots: int = 256, use_failure_cache: bool = True,
                 failure_cache_slots: int = 64, pack_tiles: bool = True,
                 mesh=None, overlap: bool = True) -> VectorMatchResult:
    """End-to-end vectorized CEMR matching (preprocess + tile enumeration)
    on `device` (None = the card)."""
    from ..device import resolve_device
    from .ref_engine import preprocess
    cs, an = preprocess(query, data, encoding=encoding, order=order)
    if any(c.shape[0] == 0 for c in cs.cand):
        return VectorMatchResult(count=0, stats=VectorStats(), timed_out=False,
                                 embeddings=[] if materialize else None)
    eng = VectorEngine(cs, an, device=resolve_device(device),
                       tile_rows=tile_rows, use_cv=use_cv,
                       use_dedup=use_dedup, intersect_fn=intersect_fn,
                       intersect=intersect, use_cer_buffer=use_cer_buffer,
                       cer_buffer_slots=cer_buffer_slots,
                       use_failure_cache=use_failure_cache,
                       failure_cache_slots=failure_cache_slots,
                       pack_tiles=pack_tiles, mesh=mesh, overlap=overlap)
    return eng.run(limit=limit, max_steps=max_steps, materialize=materialize)
