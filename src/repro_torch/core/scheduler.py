"""Device-resident tile scheduler for the vectorized CEMR engine.

Torch port of `repro.core.scheduler`: the fused-superstep path
(`TileScheduler._run_fused` and what it runs), the stage-at-a-time compat
loop (`_run_tiles`, selected by `use_cer_buffer=False`) and the
cross-query superbatch (`BatchProgram`, `SuperbatchScheduler`):

  * **Fused supersteps** — the stage list is cut at *boundary* stages (IDX
    stores and decomposes). One superstep expands a frontier chunk and then
    runs the entire remaining ladder of segments: each boundary's frontier
    is re-expanded in place while it fits one chunk (a device-side
    `proceed` mask; overshooting segments compute on masked-dead rows and
    contribute zero), down to the leaf reduction. The host reads back one
    packed stats vector per superstep.

  * **Frontier compaction + tile packing** — overflowing frontiers with few
    live rows are parked per boundary and merged with siblings.

  * **Cross-tile CER buffer** — a device ring buffer per CER-enabled stage,
    keyed by the extension read-set; values are pure functions of the key.

  * **Failure-reuse negative cache** — the dual ring buffer of read-sets
    whose extension failed; matching frontier rows are masked dead right
    after expansion.

  * **On-device leaf counting** — the inclusion-exclusion product reduces
    in int64 on the device, with a float64 magnitude bound tripping an
    overflow flag; only flagged tiles fall back to exact host arithmetic.

  * **Cross-query superbatch** — plans bucketed by
    `plan.plan_shape_signature` advance through shared supersteps: the
    batched tile carries each row's query id as index column 0 (so the
    `expand_select` kernel copies it into every child tile), adjacency
    gathers read stacked per-query tables through the `tile_intersect`
    kernel's query lane, CER and failure keys are prefixed with the query
    id, and the leaf reduction sums counts per query on the device.

The reference gates the CER compute and both ring-buffer updates behind
`lax.cond`. A Python `if` on a device value would sync on every superstep,
so here both branches are computed masked: a masked insert writes only the
padding row and leaves the ring as it was, which gives the reference's
results with one readback per superstep.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..kernels import bitmap_intersect as _kernels
from . import bitops
from .engine import (VectorMatchResult, VectorStats, _union_rows,
                     make_leaf_terms)
from .plan import IDX, _pow2ceil, plan_shape_signature

__all__ = ["TileScheduler", "SuperbatchScheduler", "BatchProgram",
           "leaf_count_host", "make_leaf_reduce", "make_leaf_reduce_batched",
           "stack_batch_inputs", "OVERFLOW_LIMIT"]

# Conservative magnitude bound for the on-device int64 leaf reduction: every
# per-row product and the tile sum are bounded by a float64 upper bound; if
# that bound reaches 2**62 (half of int64 range, >> float64 rounding error)
# the tile falls back to exact host arithmetic.
OVERFLOW_LIMIT = float(2 ** 62)

_HASH_MUL = 1000003


# ---------------------------------------------------------------------------
# leaf counting
# ---------------------------------------------------------------------------

def leaf_count_host(leaf_singles, leaf_groups, terms, alive):
    """Exact inclusion-exclusion leaf count in Python big-int arithmetic —
    the overflow fallback (and the reference for the device reduction)."""
    if isinstance(terms, torch.Tensor):
        terms = terms.cpu().numpy()
    if isinstance(alive, torch.Tensor):
        alive = alive.cpu().numpy()
    terms = np.asarray(terms)
    alive = np.asarray(alive)
    per_row = np.ones(terms.shape[0], dtype=object)
    k = 0
    for _u in leaf_singles:
        per_row = per_row * terms[:, k].astype(object)
        k += 1
    for g in leaf_groups:
        if len(g) == 2:
            pa, pb, pab = terms[:, k], terms[:, k + 1], terms[:, k + 2]
            per_row = per_row * (pa.astype(object) * pb - pab)
            k += 3
        else:
            pa, pb, pc = terms[:, k], terms[:, k + 1], terms[:, k + 2]
            pab, pac, pbc = terms[:, k + 3], terms[:, k + 4], terms[:, k + 5]
            pabc = terms[:, k + 6]
            per_row = per_row * (
                pa.astype(object) * pb * pc - pab * pc - pac * pb
                - pbc * pa + 2 * pabc)
            k += 7
    counts = np.where(alive, per_row, 0)
    return int(counts.sum())


def _leaf_products(n_singles, group_sizes):
    """Per-row inclusion-exclusion products for the device leaf reduction:
    terms (T, n) int32 -> (per (T,) int64, bound (T,) float64). `bound` is a
    conservative float64 magnitude bound on `per` (see OVERFLOW_LIMIT)."""

    def products(terms):
        t64 = terms.to(torch.int64)
        f64 = terms.to(torch.float64)
        per = torch.ones(terms.shape[0], dtype=torch.int64,
                         device=terms.device)
        bound = torch.ones(terms.shape[0], dtype=torch.float64,
                           device=terms.device)
        k = 0
        for _ in range(n_singles):
            per = per * t64[:, k]
            bound = bound * f64[:, k]
            k += 1
        for gs in group_sizes:
            if gs == 2:
                pa, pb, pab = t64[:, k], t64[:, k + 1], t64[:, k + 2]
                per = per * (pa * pb - pab)
                # pab <= pa*pb, so pa*pb bounds the composite
                bound = bound * f64[:, k] * f64[:, k + 1]
                k += 3
            else:
                pa, pb, pc = t64[:, k], t64[:, k + 1], t64[:, k + 2]
                pab, pac, pbc = t64[:, k + 3], t64[:, k + 4], t64[:, k + 5]
                pabc = t64[:, k + 6]
                per = per * (pa * pb * pc - pab * pc - pac * pb
                             - pbc * pa + 2 * pabc)
                # every subtracted term is <= pa*pb*pc; the +2*pabc tail is
                # covered explicitly
                bound = bound * (f64[:, k] * f64[:, k + 1] * f64[:, k + 2]
                                 + 2.0 * f64[:, k + 6])
                k += 7
        return per, bound

    return products


def make_leaf_reduce(leaf_singles, leaf_groups):
    """Device leaf reduction: (terms (T, n) int32, alive (T,) bool) ->
    (count () int64, overflow () bool)."""
    products = _leaf_products(len(leaf_singles), [len(g) for g in leaf_groups])

    def reduce(terms, alive):
        per, bound = products(terms)
        overflow = torch.where(alive, bound, 0.0).sum() >= OVERFLOW_LIMIT
        count = torch.where(alive, per, 0).sum()
        return count, overflow

    return reduce


def make_leaf_reduce_batched(leaf_singles, leaf_groups, n_queries):
    """Superbatch leaf reduction with a query-id lane:
    (terms (T, n) int32, alive (T,) bool, qid (T,) int32) ->
    (count (Q,) int64 summed per query, overflow (Q,) bool). The sums are
    `index_add_`s: on the card the float64 bound's additions come in no
    fixed order, which moves it by rounding only; the int64 counts are
    exact in any order."""
    products = _leaf_products(len(leaf_singles), [len(g) for g in leaf_groups])

    def reduce(terms, alive, qid):
        per, bound = products(terms)
        per = torch.where(alive, per, 0)
        bound = torch.where(alive, bound, 0.0)
        q = qid.long()
        count_q = torch.zeros(n_queries, dtype=torch.int64,
                              device=terms.device).index_add_(0, q, per)
        bound_q = torch.zeros(n_queries, dtype=torch.float64,
                              device=terms.device).index_add_(0, q, bound)
        return count_q, bound_q >= OVERFLOW_LIMIT

    return reduce


# ---------------------------------------------------------------------------
# ring buffers: the cross-tile CER cache and the failure cache
# ---------------------------------------------------------------------------

def _key_hash(keys):
    """Row-wise fold h = h*1000003 + key of the (T, K) int32 key columns;
    the int32 multiply wraps, as the reference's does, bit for bit."""
    h = torch.zeros(keys.shape[0], dtype=torch.int32, device=keys.device)
    for j in range(keys.shape[1]):
        h = h * _HASH_MUL + keys[:, j]
    return h


def _init_ring(n_slots, key_width, device, **payload):
    """Empty ring: keys (S, K) int32, hash (S,), valid (S,) bool, ptr ()
    int32 cursor, plus one zeroed payload array per `name=(shape, dtype)`."""
    buf = {
        "keys": torch.full((n_slots, key_width), -1, dtype=torch.int32,
                           device=device),
        "hash": torch.full((n_slots,), -1, dtype=torch.int32, device=device),
        "valid": torch.zeros((n_slots,), dtype=torch.bool, device=device),
        "ptr": torch.zeros((), dtype=torch.int32, device=device),
    }
    for name, (shape, dtype) in payload.items():
        buf[name] = torch.zeros((n_slots, *shape), dtype=dtype, device=device)
    return buf


def _probe(keys, h, buf):
    """Hash-first lookup: (hit (T,) bool, slot (T,) int64). The exact key
    check makes a hash collision cost a miss, never a wrong hit."""
    cand = (buf["hash"][None, :] == h[:, None]) & buf["valid"][None, :]
    maybe = cand.any(dim=1)
    hidx = torch.argmax(cand.to(torch.int32), dim=1)   # first candidate slot
    hit = maybe & (buf["keys"][hidx] == keys).all(dim=-1)
    return hit, hidx


def _stable_order(h, sel):
    """The reference's `lexsort((h, ~sel))`: selected rows first, then by
    hash, ties in row order — two stable sorts, least significant first."""
    by_h = torch.sort(h, stable=True).indices
    first = torch.sort((~sel[by_h]).to(torch.int32), stable=True).indices
    return by_h[first]


def _ring_insert(buf, keys, h, sel, payload):
    """Ring-insert one representative per distinct selected key (deduped by
    hash: a same-tile collision just skips an insert), capped at capacity
    so the scatter slots of one call are unique. Unselected rows scatter to
    a padding row that is cut off, so with nothing selected the ring comes
    back unchanged — the masked form of the reference's gated insert.
    Returns (new_buf, n_inserted () int32)."""
    n_slots = buf["keys"].shape[0]
    order = _stable_order(h, sel)
    h_s = h[order]
    diff = torch.ones_like(sel)
    diff[1:] = h_s[1:] != h_s[:-1]
    first = sel[order] & diff
    rank = torch.cumsum(first.to(torch.int32), dim=0, dtype=torch.int32) - 1
    first_ok = first & (rank < n_slots)
    n_ins = first_ok.sum(dtype=torch.int32)
    slot = torch.where(first_ok, (buf["ptr"] + rank) % n_slots,
                       torch.full_like(rank, n_slots)).long()
    src = {"keys": keys, "hash": h,
           "valid": torch.ones_like(sel), **payload}
    new = {}
    for name, val in src.items():
        old = buf[name]
        pad = torch.cat([old, torch.zeros((1, *old.shape[1:]), dtype=old.dtype,
                                          device=old.device)])
        pad[slot] = val[order]
        new[name] = pad[:n_slots]
    new["ptr"] = (buf["ptr"] + n_ins) % n_slots
    return new, n_ins


def _cer_compute(keys, compute, tile, buf):
    """Buffered extension compute for one CER-enabled stage.

    The buffer caches (key = read-set columns) -> (R after same-label bit
    clearing, popcount) *before* any aliveness masking, so a value written
    by one tile is valid for every brother row in any sibling tile.
    `compute` is a zero-argument thunk running the stage's extension
    compute on the whole tile. Returns
    (r, pop, new_buf, (hits, misses, seen, inserted))."""
    alive = tile["alive"]
    h = _key_hash(keys)
    hit, hidx = _probe(keys, h, buf)
    miss = alive & ~hit
    # the reference skips the compute when every live key hits; rows that
    # are neither hits nor alive are masked dead by finish_compute either way
    r_c, pop_c = compute()
    r = torch.where(hit[:, None], buf["vals"][hidx], r_c)
    pop = torch.where(hit, buf["pops"][hidx], pop_c)
    new_buf, n_ins = _ring_insert(buf, keys, h, miss,
                                  {"vals": r_c, "pops": pop_c})
    stats = ((alive & hit).sum(dtype=torch.int32),
             miss.sum(dtype=torch.int32), alive.sum(dtype=torch.int32), n_ins)
    return r, pop, new_buf, stats


# CER caches *successful* extensions; the failure cache records read-sets
# whose extension came back empty or under the contained-vertex threshold,
# with a conflict witness (stage << 1 | cause). The verdict is a pure
# function of the read-set key, so a recorded failure masks every brother
# row in any later tile dead right after expansion.

def _fail_lookup(keys, alive, buf):
    """Known-failure mask for a tile, restricted to `alive` rows. An empty
    buffer has no valid slot, so it yields no hit without a gate."""
    hit, _ = _probe(keys, _key_hash(keys), buf)
    return alive & hit


def _fail_insert(keys, fail, wit, buf):
    """Ring-insert one representative per distinct failing key. Returns
    (new_buf, n_inserted)."""
    return _ring_insert(buf, keys, _key_hash(keys), fail, {"wit": wit})


def _fail_plan(segs, n_bounds_before, fail_seg, slots_of):
    """Static lookup schedule for one ladder: map segment index k to the
    [(stage, dedup slots)] whose failure buffers become checkable right
    after segment k's expansion. A stage is checkable once every key slot
    is an existing idx column (idx width after segment k's expand is
    `n_bounds_before + k + 1`), and is looked up exactly once, at the
    earliest qualifying segment."""
    fail_by_seg: list = [[] for _ in segs]
    for sj, ks in fail_seg.items():
        slots = list(slots_of(sj))
        k0 = min(ks, max(0, max(slots) - n_bounds_before))
        fail_by_seg[k0].append((sj, slots))
    for entries in fail_by_seg:
        entries.sort()
    return fail_by_seg


# ---------------------------------------------------------------------------
# readback
# ---------------------------------------------------------------------------

def _start_readback(packed, cnt, ovf):
    """Queue a superstep's packed stats, leaf count(s) and overflow flag(s)
    for the host: on the card, one non-blocking copy into pinned host
    memory and an event behind it; on the CPU the values are already
    there."""
    vec = torch.cat([packed.to(torch.int64), cnt.reshape(-1).to(torch.int64),
                     ovf.reshape(-1).to(torch.int64)])
    if not vec.is_cuda:
        return vec, None
    host = torch.empty(vec.shape, dtype=torch.int64, pin_memory=True)
    host.copy_(vec, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _sync_inflight(st, inflight):
    """Wait for every in-flight dispatch's readback — the only host sync
    point of the fused loop. A coalesced readback of N overlapped
    supersteps counts as one `readbacks` and N-1 `overlapped_supersteps`,
    which keeps `readbacks + overlapped_supersteps == supersteps`."""
    for p in inflight:
        host, event = p["sync"]
        if event is not None:
            event.synchronize()
        p["np"] = host.numpy()
    st.readbacks += 1
    st.overlapped_supersteps += len(inflight) - 1


def _ladder(b, n_stages, is_boundary):
    """Segments from boundary `b` down to the leaf: [(boundary, the
    BM-store stages fused after it, exit stage)], the exit being the next
    boundary or n_stages (the leaf) for the last segment."""
    segs = []
    si = b
    while True:
        bms = []
        exit_si = si + 1
        while exit_si < n_stages and not is_boundary(exit_si):
            bms.append(exit_si)
            exit_si += 1
        segs.append((si, bms, exit_si))
        if exit_si == n_stages:
            return segs
        si = exit_si


# the packed stats vector's tail, in order: CER, then failure-cache counters
_TAIL_FIELDS = ("cer_hits", "cer_misses", "dedup_keys_seen", "dedup_unique",
                "fail_hits", "fail_misses", "fail_inserts", "fail_pruned_rows")


def _walk_ladder(p, st, t, pack_tiles, stack, pending):
    """Apply one synced superstep readback up to the leaf: fold the packed
    tail counters, resume the root chunk cursor (the only item whose total
    is unknown at dispatch), and walk the ladder — consumed (single-chunk)
    boundaries descended in the device, the first overflowing frontier
    resumes on the host. Returns the readback's leaf part (the count(s),
    then the overflow flag(s)) when the ladder reached the leaf reduction,
    else None."""
    b, tile, r, cursor, tot = p["item"]
    vec = p["np"]
    exit_bounds = p["exit_bounds"]
    nb = len(exit_bounds)
    n_packed = 2 + 2 * nb + len(_TAIL_FIELDS)
    total_in = int(vec[0])
    for field, v in zip(_TAIL_FIELDS, vec[2 + 2 * nb:n_packed]):
        setattr(st, field, getattr(st, field) + int(v))
    if tot < 0 and cursor + t < total_in:
        stack.append((b, tile, r, cursor + t, total_in))
    for k in range(nb):
        alive_k, total_k = int(vec[2 + k]), int(vec[2 + nb + k])
        st.rows_alive += alive_k
        if alive_k == 0:                             # dead end
            return None
        if total_k <= t:
            continue                                 # consumed in-ladder
        ft, fr = p["frontiers"][k]
        _push_frontier(st, t, pack_tiles, exit_bounds[k], ft, fr, alive_k,
                       total_k, stack, pending)
        return None
    st.leaf_tiles += 1
    st.rows_alive += int(vec[1])
    return vec[n_packed:]


def _push_frontier(st, t, pack_tiles, b, tile, r, alive_n, total, stack,
                   pending):
    """Route a host-resumed frontier: pack sub-capacity frontiers with
    pending siblings at the same boundary, dispatch otherwise."""
    if pack_tiles and alive_n * 2 <= t:
        pend = pending.get(b)
        if pend is None:
            pending[b] = [tile, r, alive_n, total]
        elif pend[2] + alive_n <= t:
            mtile, mr = _merge_frontiers(pend[0], pend[1], tile, r, t)
            st.device_steps += 1
            st.packed_tiles += 1
            pending[b] = [mtile, mr, pend[2] + alive_n, pend[3] + total]
        else:
            stack.append((b, pend[0], pend[1], 0, pend[3]))
            pending[b] = [tile, r, alive_n, total]
    else:
        stack.append((b, tile, r, 0, total))


def _merge_frontiers(ta, ra, tb, rb, t):
    """Frontier compaction: concatenate two sub-capacity sibling
    frontiers, live rows (nonzero extension bitmap) packed to the front
    (a stable sort: the reference's `argsort(~live)`), sliced back to tile
    capacity `t`. A batched tile's query ids ride along in its index
    columns."""
    idx = torch.cat([ta["idx"], tb["idx"]])
    bm = {u: torch.cat([ta["bm"][u], tb["bm"][u]]) for u in ta["bm"]}
    r = torch.cat([ra, rb])
    live = bitops.row_popcount(r) > 0
    order = torch.sort((~live).to(torch.int32), stable=True).indices[:t]
    tile = {"idx": idx[order],
            "bm": {u: c[order] for u, c in bm.items()},
            "alive": live[order]}
    return tile, r[order]


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

class TileScheduler:
    """Runtime for one VectorEngine: fused supersteps over a host work stack,
    with per-boundary pending buffers for tile packing and engine-lifetime
    CER ring buffers (sound across runs: cached values are pure functions of
    the read-set given the engine's fixed tables)."""

    def __init__(self, eng):
        self.eng = eng
        self.t = eng.t
        self.device = eng.device
        self._n_stages = len(eng._stages)
        self._steps: dict = {}
        self._cer_stages = [si for si in range(self._n_stages)
                            if self._cer_eligible(si)]
        self._buffers = {}
        for si in self._cer_stages:
            op = eng._stages[si][1]
            self._buffers[si] = _init_ring(
                eng.cer_buffer_slots, len(op.dedup_slots), self.device,
                vals=((op.n_words,), torch.int32), pops=((), torch.int32))
        self._fail_stages = [si for si in range(self._n_stages)
                             if self._fail_eligible(si)]
        self._fail_buffers = {
            si: _init_ring(eng.failure_cache_slots,
                           len(eng._stages[si][1].dedup_slots), self.device,
                           wit=((), torch.int32))
            for si in self._fail_stages}
        self.stats = VectorStats()

    # ----------------------------------------------------------- static shape
    def _is_boundary(self, si: int) -> bool:
        stage = self.eng._stages[si]
        return stage[0] == "decompose" or stage[1].store == IDX

    def _keyed_extend(self, si: int) -> bool:
        stage = self.eng._stages[si]
        return (stage[0] == "extend" and bool(stage[1].dedup_slots)
                and bool(stage[1].bk_pairs))

    def _cer_eligible(self, si: int) -> bool:
        eng = self.eng
        return eng.use_dedup and eng.use_cer_buffer and self._keyed_extend(si)

    def _fail_eligible(self, si: int) -> bool:
        # same read-set requirements as CER (the failure verdict must be a
        # pure function of the dedup-slot key), independent of use_dedup;
        # the compat loop (use_cer_buffer=False) has no failure cache
        eng = self.eng
        return (eng.use_failure_cache and eng.use_cer_buffer
                and self._keyed_extend(si))

    # ------------------------------------------------------------- superstep
    def _build_step(self, b: int):
        """Construct the run-to-completion step for boundary `b`: expand the
        given frontier chunk, then keep descending — each deeper boundary's
        frontier is expanded in place while it fits one chunk (device-side
        `proceed` mask; overshooting work is masked dead and contributes
        zero) — ending in the leaf reduction. Returns every intermediate
        frontier so the host can resume exactly where the ladder stopped.

        Returns (step, exit_bounds, seg_cer, seg_fail, n_computes,
        gather_ops). The step takes an optional trailing `part` bitmap
        (root_words,) that is ANDed into the root extension — the sharded
        scheduler's per-shard partition of the level-0 candidate rows;
        `part=None` (the single-device path) leaves the root mask
        untouched. The step runs on its tile's device."""
        eng = self.eng
        t = self.t
        cer_set = set(self._cer_stages)
        fail_set = set(self._fail_stages)
        segs = _ladder(b, self._n_stages, self._is_boundary)
        exit_bounds = [exit_si for (_, _, exit_si) in segs[:-1]]
        built = []                                       # per-segment closures
        seg_cer: list = []
        fail_seg: dict = {}               # fail stage -> computing segment
        gather_ops = 0
        n_computes = 0
        for ki, (si, bms, exit_si) in enumerate(segs):
            leaf_i = exit_si == self._n_stages
            chain = []
            for sj in bms + ([] if leaf_i else [exit_si]):
                compute_r, con = eng._make_compute_parts(sj)
                chain.append((sj, eng._stages[sj][1], compute_r, con))
                seg_cer += [sj] if sj in cer_set else []
                if sj in fail_set:
                    fail_seg[sj] = ki
                if eng._stages[sj][0] == "extend":
                    gather_ops += t * max(len(eng._stages[sj][1].bk_pairs), 1)
                n_computes += 1
            # the fused expand+intersect kernel covers the boundary
            # expansion and the segment's first extend when eligible
            fused0 = eng._make_expand_fused(si, chain[0][0]) if chain else None
            built.append((eng._make_expand(si), chain, leaf_i, fused0))
        n_bounds_before = sum(1 for j in range(b) if self._is_boundary(j))
        fail_by_seg = _fail_plan(segs, n_bounds_before, fail_seg,
                                 lambda sj: eng._stages[sj][1].dedup_slots)
        seg_fail = sorted(fail_seg)
        leaf_terms = eng._make_leaf_terms()
        leaf_reduce = make_leaf_reduce(eng.plan.leaf_singles,
                                       eng.plan.leaf_groups)
        root = b == 0
        if root:
            root_compute_r, root_con = eng._make_compute_parts(0)

        def key_cols(tile, slots):
            return torch.stack([tile["idx"][:, s] for s in slots], dim=1)

        def run_compute(si, op, compute_r, con, tile, bufs, fbufs, acc, facc,
                        tables, masks, pre=None):
            # `pre` carries the fused kernel's (r, pop) for the segment's
            # first extend: the same pure function of the key columns as
            # compute_r, so the CER cache stays sound
            thunk = ((lambda: pre) if pre is not None
                     else (lambda: compute_r(tile, tables, masks)))
            if si in bufs:
                r, pop, bufs[si], s = _cer_compute(
                    key_cols(tile, op.dedup_slots), thunk, tile, bufs[si])
                acc = [a + v for a, v in zip(acc, s)]
            else:
                r, pop = thunk()
            raw_pop = pop                # true popcount for every alive row
            r, pop, ok = eng.finish_compute(tile, r, pop, con)
            if si in fbufs:
                # failure = an alive row whose extension died here; its
                # verdict is a pure function of the key columns
                failed = tile["alive"] & ~ok
                wit = 2 * si + (raw_pop > 0).to(torch.int32)
                fbufs[si], n_ins = _fail_insert(
                    key_cols(tile, op.dedup_slots), failed, wit, fbufs[si])
                facc[2] = facc[2] + n_ins
            return r, pop, ok, acc

        def apply_fail_masks(k, cur, fbufs, facc):
            # lookup-and-mask right after segment k's expansion (R bit
            # ranks, and so the host chunk cursors, are untouched)
            if not fail_by_seg[k]:
                return
            alive0 = cur["alive"]
            dead = torch.zeros_like(alive0)
            for (sj, slots) in fail_by_seg[k]:
                fhit = _fail_lookup(key_cols(cur, slots), alive0, fbufs[sj])
                facc[0] = facc[0] + fhit.sum(dtype=torch.int32)
                facc[1] = facc[1] + (alive0 & ~fhit).sum(dtype=torch.int32)
                dead = dead | fhit
            cur["alive"] = alive0 & ~dead
            facc[3] = facc[3] + dead.sum(dtype=torch.int32)

        def step(tile, r_in, cursor, bufs, fbufs, tables, masks, part=None):
            bufs = dict(bufs)
            fbufs = dict(fbufs)
            zero = torch.zeros((), dtype=torch.int32,
                               device=tile["alive"].device)
            acc = [zero] * 4                             # hits/misses/seen/ins
            facc = [zero] * 4                            # fail h/m/ins/pruned
            if root:
                r0, pop0 = root_compute_r(tile, tables, masks)
                r_in, _, _ = eng.finish_compute(tile, r0, pop0, root_con)
                if part is not None:
                    # shard partition of the *pruned* root extension: the
                    # contained-vertex threshold must see the global
                    # popcount, never a partition's (a sub-threshold
                    # partition of a viable root set is still live work)
                    r_in = r_in & part[None, :]
            frontiers = []                               # (tile, r) per bound
            alive_l, total_l = [], []
            proceed = None
            cur_tile, cur_r, cur_cursor = tile, r_in, cursor
            total_in = None
            for k, (expand, chain, leaf_i, fused0) in enumerate(built):
                if fused0 is not None:
                    cur, tot, pre0 = fused0(cur_tile, cur_r, cur_cursor,
                                            tables)
                else:
                    cur, tot = expand(cur_tile, cur_r, cur_cursor, tables)
                    pre0 = None
                if k == 0:
                    total_in = tot
                else:
                    cur["alive"] = cur["alive"] & proceed
                apply_fail_masks(k, cur, fbufs, facc)
                last = None
                for ci, (sj, op, compute_r, con) in enumerate(chain):
                    r, pop, ok, acc = run_compute(sj, op, compute_r, con,
                                                  cur, bufs, fbufs, acc,
                                                  facc, tables, masks,
                                                  pre=pre0 if ci == 0
                                                  else None)
                    last = (r, pop, ok)
                    if not leaf_i and sj == chain[-1][0]:
                        break                            # exit compute: no store
                    bm = dict(cur["bm"])
                    bm[op.vertex] = r
                    cur = {"idx": cur["idx"], "bm": bm, "alive": ok}
                if leaf_i:
                    terms = leaf_terms(cur)
                    count, overflow = leaf_reduce(terms, cur["alive"])
                    leaf_alive = cur["alive"].sum(dtype=torch.int32)
                    packed = torch.stack(
                        [total_in, leaf_alive, *alive_l, *total_l, *acc,
                         *facc])
                    return (cur, terms, count, overflow, packed, frontiers,
                            bufs, fbufs)
                r2, pop2, ok2 = last
                alive_k = ok2.sum(dtype=torch.int32)
                total_k = pop2.sum(dtype=torch.int32)
                frontiers.append((cur, r2))
                alive_l.append(alive_k)
                total_l.append(total_k)
                ok_here = (total_k <= t) & (alive_k > 0)
                proceed = ok_here if proceed is None else (proceed & ok_here)
                cur_tile, cur_r, cur_cursor = cur, r2, 0

        return (step, exit_bounds, sorted(set(seg_cer)), seg_fail,
                n_computes, gather_ops)

    def _superstep(self, b: int):
        """Cached `_build_step(b)`."""
        entry = self._steps.get(b)
        if entry is None:
            entry = self._steps[b] = self._build_step(b)
        return entry

    # ------------------------------------------------------------------- run
    def run(self, *, limit: int = 1_000_000, max_steps: int | None = None,
            materialize: bool = False) -> VectorMatchResult:
        """Enumerate to completion (or until `limit` embeddings /
        `max_steps` dispatches, whichever first). `materialize=True`
        additionally decodes explicit embeddings from every counted leaf
        tile. `use_cer_buffer=False` selects the stage-at-a-time compat
        loop."""
        if not self.eng.use_cer_buffer:
            return self._run_tiles(limit=limit, max_steps=max_steps,
                                   materialize=materialize)
        return self._run_fused(limit=limit, max_steps=max_steps,
                               materialize=materialize)

    def _run_fused(self, *, limit, max_steps, materialize):
        eng = self.eng
        st = self.stats = eng.stats = VectorStats()
        count = 0
        timed_out = False
        embeddings: list[dict[int, int]] = []
        dev = self.device

        root_tile = {"idx": torch.zeros((1, 0), dtype=torch.int32, device=dev),
                     "bm": {},
                     "alive": torch.ones((1,), dtype=torch.bool, device=dev)}
        root_r = torch.zeros((1, eng.plan.root_words), dtype=torch.int32,
                             device=dev)                 # recomputed
        # frontier items: (boundary stage, tile, extension bitmap R, cursor,
        # total set bits of R — or -1 for the root item, whose extension is
        # only computed in-dispatch)
        stack: list = [(0, root_tile, root_r, 0, -1)]
        # boundary -> [tile, r, live rows, total bits]: sub-capacity frontiers
        # waiting to be packed with siblings
        pending: dict[int, list] = {}

        while stack or pending:
            if not stack:
                b = max(pending)                         # flush deepest first
                tile_p, r_p, _, tot_p = pending.pop(b)
                stack.append((b, tile_p, r_p, 0, tot_p))
                continue
            if max_steps is not None and st.device_steps >= max_steps:
                timed_out = True
                break
            st.peak_stack = max(st.peak_stack, len(stack) + len(pending))
            # Claim and dispatch up to two items per round (double-buffered
            # frontiers). The claim discipline is identical for overlap
            # on/off — overlap only defers/coalesces the readback — so both
            # settings run the same superstep sequence against the same
            # buffer states.
            first = self._dispatch(stack.pop(), stack)
            if not eng.overlap:
                _sync_inflight(st, [first])
            inflight = [first]
            if stack and (max_steps is None
                          or st.device_steps < max_steps):
                second = self._dispatch(stack.pop(), stack)
                if not eng.overlap:
                    _sync_inflight(st, [second])
                inflight.append(second)
            if eng.overlap:
                _sync_inflight(st, inflight)
            for p in inflight:
                count += self._process(p, stack, pending, embeddings,
                                       materialize)
                if count >= limit:
                    break
            if count >= limit:
                break

        return VectorMatchResult(count=min(count, limit), stats=st,
                                 timed_out=timed_out,
                                 embeddings=embeddings if materialize else None)

    def _dispatch(self, item, stack):
        """Issue one fused superstep and queue its readback without waiting
        for it. The ring buffers fold forward as device tensors, dispatch-
        side stats are charged immediately, and an item with a known bit
        total re-enqueues its next expansion chunk right away. Returns the
        in-flight record for `_sync_inflight`."""
        eng = self.eng
        st = self.stats
        b, tile, r, cursor, tot = item
        fn, exit_bounds, seg_cer, seg_fail, n_computes, gather_ops = \
            self._superstep(b)
        bufs = {si: self._buffers[si] for si in seg_cer}
        fbufs = {si: self._fail_buffers[si] for si in seg_fail}
        (leaf_tile, terms, cnt, ovf, packed, frontiers, bufs2,
         fbufs2) = fn(tile, r, cursor, bufs, fbufs, eng.tables, eng.masks)
        for si in seg_cer:
            self._buffers[si] = bufs2[si]
        for si in seg_fail:
            self._fail_buffers[si] = fbufs2[si]
        st.device_steps += 1
        st.supersteps += 1
        st.tiles += 1
        st.expansions += 1
        st.rows_processed += self.t * max(n_computes, 1)
        st.gather_and_ops += gather_ops
        if tot >= 0 and cursor + self.t < tot:
            stack.append((b, tile, r, cursor + self.t, tot))
        return {"item": item, "exit_bounds": exit_bounds,
                "leaf_tile": leaf_tile, "terms": terms,
                "frontiers": frontiers,
                "sync": _start_readback(packed, cnt, ovf), "np": None}

    def _process(self, p, stack, pending, embeddings, materialize):
        """Apply one synced readback (`_walk_ladder`) and return the leaf
        count (exact host fallback on overflow)."""
        eng = self.eng
        st = self.stats
        leaf = _walk_ladder(p, st, self.t, eng.pack_tiles, stack, pending)
        if leaf is None:
            return 0
        cnt, ovf = int(leaf[0]), bool(leaf[1])
        if ovf:
            st.leaf_overflows += 1
            c = leaf_count_host(eng.plan.leaf_singles, eng.plan.leaf_groups,
                                p["terms"], p["leaf_tile"]["alive"])
        else:
            c = cnt
        if materialize and c:
            embeddings.extend(eng._materialize(p["leaf_tile"]))
        return c

    # ---------------------------------------------------------- compat path
    def _leaf_count(self, tile):
        """Device int64 leaf count with exact host fallback on overflow."""
        st = self.stats
        eng = self.eng
        terms, alive = eng._leaf_fn()(tile)
        st.device_steps += 1
        cnt, ovf = self._leaf_reduce(terms, alive)
        st.device_steps += 1
        if bool(ovf):
            st.leaf_overflows += 1
            return leaf_count_host(eng.plan.leaf_singles, eng.plan.leaf_groups,
                                   terms, alive)
        return int(cnt)

    def _run_tiles(self, *, limit, max_steps, materialize):
        """Stage-at-a-time loop (pre-superstep architecture): one dispatch
        per primitive with host-driven control flow — where the per-tile
        bucketed CER compute lives. Each dispatch charges `device_steps`
        exactly once; the host reads back after most of them, as the
        reference does. The failure cache and the superstep readbacks are
        not part of it: their stats stay 0."""
        eng = self.eng
        st = self.stats = eng.stats = VectorStats()
        t = self.t
        dev = self.device
        n_stages = self._n_stages
        self._leaf_reduce = make_leaf_reduce(eng.plan.leaf_singles,
                                             eng.plan.leaf_groups)
        count = 0
        timed_out = False
        embeddings: list[dict[int, int]] = []

        root_tile = {"idx": torch.zeros((1, 0), dtype=torch.int32, device=dev),
                     "bm": {},
                     "alive": torch.ones((1,), dtype=torch.bool, device=dev)}
        # stack: ("tile", stage, tile) | ("expand", stage, tile, R, cursor)
        stack: list = [("tile", 0, root_tile)]

        while stack:
            if max_steps is not None and st.device_steps >= max_steps:
                timed_out = True
                break
            st.peak_stack = max(st.peak_stack, len(stack))
            item = stack.pop()
            if item[0] == "tile":
                _, si, tile = item
                if si == n_stages:           # leaf
                    st.leaf_tiles += 1
                    c = self._leaf_count(tile)
                    if materialize and c:
                        embeddings.extend(eng._materialize(tile))
                    count += c
                    if count >= limit:
                        break
                    continue
                stage = eng._stages[si]
                st.tiles += 1
                rows = int(tile["alive"].shape[0])
                st.rows_processed += rows
                if stage[0] == "decompose":
                    r, ok = eng._compute_fn(si)(tile, eng.tables, eng.masks)
                    st.device_steps += 1
                    stack.append(("expand", si, tile, r, 0))
                    continue
                op = stage[1]
                bucketed = False
                if eng.use_dedup and op.dedup_slots and op.bk_pairs:
                    u, rep_rows, group_of = eng._dedup_fn(si)(tile)
                    st.device_steps += 1
                    u = int(u)
                    st.dedup_keys_seen += int(tile["alive"].sum())
                    st.dedup_unique += u
                    if 0 < u <= rows // 2:
                        # CER: one extension compute per brother class
                        bucket = min(1 << max(u - 1, 1).bit_length(), rows)
                        r, ok = eng._bucket_compute_fn(si, bucket)(
                            tile, rep_rows, group_of, eng.tables)
                        st.device_steps += 1
                        st.bucketed_tiles += 1
                        st.gather_and_ops += bucket * len(op.bk_pairs)
                        bucketed = True
                if not bucketed:
                    st.gather_and_ops += rows * max(len(op.bk_pairs), 1)
                    r, ok = eng._compute_fn(si)(tile, eng.tables, eng.masks)
                    st.device_steps += 1
                if op.store == IDX:
                    stack.append(("expand", si, tile, r, 0))
                else:
                    bm = dict(tile["bm"])
                    bm[op.vertex] = r
                    if bool(ok.any()):
                        stack.append(("tile", si + 1, {"idx": tile["idx"],
                                                       "bm": bm,
                                                       "alive": ok}))
            else:
                _, si, tile, r, cursor = item
                st.expansions += 1
                out, total = eng._expand_fn(si)(tile, r, cursor, eng.tables)
                st.device_steps += 1
                total = int(total)
                if cursor + t < total:
                    stack.append(("expand", si, tile, r, cursor + t))
                alive_n = int(out["alive"].sum())
                st.rows_alive += alive_n
                if alive_n:
                    stack.append(("tile", si + 1, out))

        return VectorMatchResult(count=min(count, limit), stats=st,
                                 timed_out=timed_out,
                                 embeddings=embeddings if materialize else None)


# ---------------------------------------------------------------------------
# cross-query superbatch
# ---------------------------------------------------------------------------
# `Matcher.match_many(batch="auto")` buckets compiled plans by
# `plan.plan_shape_signature` (vertices renamed to their match level, bitmap
# widths padded to powers of two) and drains each bucket through one
# SuperbatchScheduler. The batched tile's index column 0 is each row's query
# id (plan index slot s is tile column s + 1), so expansion carries it into
# every child tile; adjacency gathers read stacked per-query tables, CER and
# failure keys start with the query id (reuse never crosses queries), and
# the leaf reduction sums counts per query on the device. One BatchProgram
# serves every bucket that shares a signature.


def _canon_inverse(plan) -> dict[int, int]:
    """Canonical vertex id (match level) -> original query vertex id."""
    inv = {0: plan.root_vertex}
    for op in plan.ops:
        inv[op.level] = op.vertex
    return inv


def _batch_table_keys(sig) -> list[tuple[int, int]]:
    """Canonical (src, dst) adjacency-table keys the program gathers from."""
    keys = set()
    for stage in sig[3]:
        if stage[0] != "e":
            continue
        v, bk, wt, union_src = stage[1], stage[3], stage[4], stage[5]
        for (_s, u) in bk:
            keys.add((u, v))
        for u_j in wt:
            keys.add((v, u_j))
        if not bk and union_src >= 0:
            keys.add((union_src, v))
    return sorted(keys)


def stack_batch_inputs(sig, plans, n_queries, device):
    """Stack per-query plan data into the padded device tensors a
    BatchProgram consumes: adjacency tables (Q, 32*Wp(src), Wp(dst)), the
    root candidate mask (Q, Wp(root)), and per-stage contained-vertex
    thresholds (Q,). Bitmaps are int32 tensors holding the reference's
    uint32 bits. Zero-padding is inert everywhere — padded table rows and
    words carry no set bits, and padded queries (len(plans) <= n_queries)
    get no root candidates and threshold 1. `n_real` is len(plans): the
    batched union reads only the real queries' tables."""
    widths, stages = sig[2], sig[3]
    invs = [_canon_inverse(p) for p in plans]

    def up(a):
        return torch.from_numpy(a.view(np.int32)).to(device)

    tabs = {}
    for (cu, cv) in _batch_table_keys(sig):
        arr = np.zeros((n_queries, 32 * widths[cu], widths[cv]), np.uint32)
        for qi, plan in enumerate(plans):
            t = plan.tables[(invs[qi][cu], invs[qi][cv])]
            arr[qi, :t.shape[0], :t.shape[1]] = t
        tabs[f"{cu}:{cv}"] = up(arr)
    mask = np.zeros((n_queries, widths[0]), np.uint32)
    for qi, plan in enumerate(plans):
        m = plan.masks[plan.root_vertex]
        mask[qi, :m.shape[0]] = m
    con = {}
    for si, stage in enumerate(stages):
        if stage[0] == "d":
            continue
        if stage[0] == "root":
            vals = [len(p.an.con[0]) for p in plans]
        else:
            lvl = stage[1]
            vals = [next(op.con_threshold for op in p.ops if op.level == lvl)
                    for p in plans]
        a = np.ones(n_queries, np.int32)
        a[:len(plans)] = np.maximum(vals, 1)
        con[str(si)] = torch.from_numpy(a).to(device)
    return {"tables": tabs, "mask_root": up(mask), "con": con,
            "n_real": len(plans)}


def _union_rows_batched(tables, bmcol, qid, n_real):
    """Batched no-black-bwd union: OR of adjacency rows selected by a bitmap
    column, row t reading query qid[t]'s table. tables (Q, S, W) with
    S = 32 * (bmcol words). The reference ORs a masked (T, S, W) gather,
    which eager torch would materialise (2 GB at T = 256 over eu2005's
    padded widths) and has no OR reduction for; here the exact float64
    `_union_rows` runs once per real query (the first `n_real` of the
    stack; padded queries own no rows) on the whole tile, and each row
    keeps its own query's result. Peak memory is one query's unpacked
    table, (S, 32 W) float64, not T of them."""
    out = torch.zeros((bmcol.shape[0], tables.shape[2]), dtype=torch.int32,
                      device=bmcol.device)
    for q in range(n_real):
        out = torch.where((qid == q)[:, None], _union_rows(tables[q], bmcol),
                          out)
    return out


def _upload(a: np.ndarray, device):
    """A small host array on `device` without waiting for the device: on the
    card through pinned memory with a non-blocking copy (a fresh host
    buffer each time, so a later update never races the copy)."""
    t = torch.from_numpy(a.copy())
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class BatchProgram:
    """Batched (query-id lane) stage closures for one canonical plan shape
    signature. Built from the signature alone — no per-query data — so one
    program and its supersteps serve every plan bucket sharing the
    signature; per-query tables, masks and thresholds arrive as the stacked
    `data` argument (stack_batch_inputs). Mirrors VectorEngine's closures
    with three changes: every adjacency gather reads `tables[key][qid,
    idx]` (the `tile_intersect` kernel's query lane),
    contained-vertex thresholds are per-row data, and the leaf reduction
    sums per query. The reference caches a `jax.jit` of each superstep;
    here the plain closure is cached and fresh builds are counted the same
    way (`compiled_supersteps`)."""

    def __init__(self, sig, n_queries, *, use_cv=True, use_cer=True,
                 use_fail=True, device):
        self.sig = sig
        _, self.t, self.widths, self._stages, self.leaf = sig
        self.nq = n_queries
        self.use_cv = use_cv
        self.device = torch.device(device)
        self._n_stages = len(self._stages)
        self._steps: dict = {}
        self.compiled_supersteps = 0      # fresh builds (bucket_recompiles)
        keyed = [si for si, stg in enumerate(self._stages)
                 if stg[0] == "e" and stg[8] and stg[3]]
        self._cer_stages = keyed if use_cer else []
        # failure-cache stages: same read-set requirements as CER, gated by
        # its own knob (keys are qid-prefixed, like CER, so a recorded
        # failure never crosses queries)
        self._fail_stages = keyed if use_fail else []

    # ----------------------------------------------------------- static shape
    def dedup_slots(self, si: int) -> tuple:
        """CER dedup-key idx slots of stage `si` (empty = CER-ineligible)."""
        stg = self._stages[si]
        return stg[8] if stg[0] == "e" else ()

    def stage_width(self, si: int) -> int:
        """Padded bitmap words of the stage's extension target."""
        stg = self._stages[si]
        return self.widths[0] if stg[0] == "root" else self.widths[stg[1]]

    def _is_boundary(self, si: int) -> bool:
        stg = self._stages[si]
        return stg[0] in ("root", "d") or stg[2] == IDX

    # ----------------------------------------------------------- raw closures
    def _make_compute_parts(self, si: int):
        """(compute_r(tile, data) -> (r, pop), con_key): the batched analogue
        of VectorEngine._make_compute_parts. con_key indexes data["con"]
        (per-query thresholds); None means no contained-vertex prune."""
        stage = self._stages[si]
        con_key = str(si) if self.use_cv else None
        if stage[0] == "root":

            def compute_r(tile, data):
                r = data["mask_root"][tile["idx"][:, 0].long()]
                return r, bitops.row_popcount(r)

            return compute_r, con_key
        if stage[0] == "d":
            v = stage[1]

            def compute_r(tile, data):
                r = tile["bm"][v]
                return r, bitops.row_popcount(r)

            return compute_r, None
        v, bk, union_src, same_idx = stage[1], stage[3], stage[5], stage[6]
        keys = [f"{u}:{v}" for (_, u) in bk]
        slots = tuple(s + 1 for (s, _) in bk)          # tile columns
        clears = tuple(s + 1 for s in same_idx)

        def compute_r(tile, data):
            idx = tile["idx"]
            if bk:
                # the query lane: gathers, AND, clears and popcount in one
                # launch
                return _kernels.tile_intersect(
                    [data["tables"][k] for k in keys], idx, slots, clears,
                    qid_slot=0)
            r = _union_rows_batched(data["tables"][f"{union_src}:{v}"],
                                    tile["bm"][union_src], idx[:, 0],
                                    data["n_real"])
            for s in clears:
                r = bitops.clear_bit_rows(r, idx[:, s])
            return r, bitops.row_popcount(r)

        return compute_r, con_key

    @staticmethod
    def _finish(tile, r, pop, con_key, data):
        con = (data["con"][con_key][tile["idx"][:, 0].long()]
               if con_key is not None else 1)
        ok = tile["alive"] & (pop >= con) & (pop > 0)
        return torch.where(ok[:, None], r, 0), torch.where(ok, pop, 0), ok

    def _make_expand(self, si: int):
        """expand(tile, r, start, data) -> (child tile, total) through the
        `expand_select` kernel (its child index columns carry the query id
        in column 0)."""
        stage = self._stages[si]
        t_out = self.t
        if stage[0] == "d":
            wt_prune: list[tuple[int, str]] = []
            same_label_bm = list(stage[3])
            drop_bm = stage[1]
        elif stage[0] == "root":
            wt_prune, same_label_bm, drop_bm = [], [], None
        else:
            v, wt = stage[1], stage[4]
            wt_prune = [(u_j, f"{v}:{u_j}") for u_j in wt]
            same_label_bm = list(stage[7])
            drop_bm = None

        def expand(tile, r, start, data):
            rows, bitpos, valid, total, idx = _kernels.expand_select(
                r, start, t_out, tile["idx"])
            rows_l, qid = rows.long(), idx[:, 0].long()
            bm_out = {}
            alive = valid
            for u, col in tile["bm"].items():
                if u == drop_bm:
                    continue
                g = col[rows_l]
                for (u_j, tkey) in wt_prune:
                    if u_j == u:
                        g = g & data["tables"][tkey][qid, bitpos.long()]
                if u in same_label_bm:
                    g = bitops.clear_bit_rows(g, bitpos)
                alive = alive & (bitops.row_popcount(g) > 0)
                bm_out[u] = g
            return {"idx": idx, "bm": bm_out, "alive": alive}, total

        return expand

    # ------------------------------------------------------------- superstep
    def build_step(self, b: int):
        """Construct the batched run-to-completion step for boundary `b` —
        the query-id-lane mirror of `TileScheduler._build_step`.

        Returns (step, exit_bounds, seg_cer, seg_fail, n_computes,
        gather_ops). The step's optional trailing `part` bitmap
        (Q, root_words) is ANDed into each query's root extension, row t
        reading its query's partition — the sharded superbatch's per-shard
        partition of every query's level-0 candidate rows; `part=None`
        (single-device) leaves the root masks untouched. The step runs on
        its tile's device."""
        t = self.t
        cer_set = set(self._cer_stages)
        fail_set = set(self._fail_stages)
        segs = _ladder(b, self._n_stages, self._is_boundary)
        exit_bounds = [exit_si for (_, _, exit_si) in segs[:-1]]
        built = []
        seg_cer: list = []
        fail_seg: dict = {}               # fail stage -> computing segment
        gather_ops = 0
        n_computes = 0
        for ki, (si, bms, exit_si) in enumerate(segs):
            leaf_i = exit_si == self._n_stages
            chain = []
            for sj in bms + ([] if leaf_i else [exit_si]):
                compute_r, con_key = self._make_compute_parts(sj)
                chain.append((sj, self.dedup_slots(sj), compute_r, con_key))
                seg_cer += [sj] if sj in cer_set else []
                if sj in fail_set:
                    fail_seg[sj] = ki
                if self._stages[sj][0] == "e":
                    gather_ops += t * max(len(self._stages[sj][3]), 1)
                n_computes += 1
            built.append((self._make_expand(si), chain, leaf_i))
        n_bounds_before = sum(1 for j in range(b) if self._is_boundary(j))
        fail_by_seg = _fail_plan(segs, n_bounds_before, fail_seg,
                                 self.dedup_slots)
        seg_fail = sorted(fail_seg)
        leaf_terms = make_leaf_terms(self.leaf[0], self.leaf[1])
        leaf_reduce = make_leaf_reduce_batched(
            list(self.leaf[0]), [list(g) for g in self.leaf[1]], self.nq)
        root = b == 0
        if root:
            root_compute_r, root_con = self._make_compute_parts(0)

        def key_cols(tile, slots):
            # the query id, then the read-set columns
            return tile["idx"][:, [0] + [s + 1 for s in slots]]

        def run_compute(si, dedup, compute_r, con_key, tile, bufs, fbufs,
                        acc, facc, data):
            if si in bufs:
                r, pop, bufs[si], s = _cer_compute(
                    key_cols(tile, dedup), lambda: compute_r(tile, data),
                    tile, bufs[si])
                acc = [a + v for a, v in zip(acc, s)]
            else:
                r, pop = compute_r(tile, data)
            raw_pop = pop
            r, pop, ok = self._finish(tile, r, pop, con_key, data)
            if si in fbufs:
                # qid-prefixed failure key: per-query thresholds and tables
                # make the verdict a pure function of (qid, read-set)
                failed = tile["alive"] & ~ok
                wit = 2 * si + (raw_pop > 0).to(torch.int32)
                fbufs[si], n_ins = _fail_insert(key_cols(tile, dedup), failed,
                                                wit, fbufs[si])
                facc[2] = facc[2] + n_ins
            return r, pop, ok, acc

        def apply_fail_masks(k, cur, fbufs, facc):
            # post-expansion lookup-and-mask (rank stable), after the
            # `active` mask so deactivated queries' rows neither hit nor
            # count as misses
            if not fail_by_seg[k]:
                return
            alive0 = cur["alive"]
            dead = torch.zeros_like(alive0)
            for (sj, slots) in fail_by_seg[k]:
                fhit = _fail_lookup(key_cols(cur, slots), alive0, fbufs[sj])
                facc[0] = facc[0] + fhit.sum(dtype=torch.int32)
                facc[1] = facc[1] + (alive0 & ~fhit).sum(dtype=torch.int32)
                dead = dead | fhit
            cur["alive"] = alive0 & ~dead
            facc[3] = facc[3] + dead.sum(dtype=torch.int32)

        def step(tile, r_in, cursor, bufs, fbufs, data, active, part=None):
            bufs = dict(bufs)
            fbufs = dict(fbufs)
            zero = torch.zeros((), dtype=torch.int32,
                               device=tile["alive"].device)
            acc = [zero] * 4                     # hits/misses/seen/ins
            facc = [zero] * 4                    # fail h/m/ins/pruned
            if root:
                r0, pop0 = root_compute_r(tile, data)
                r_in, _, _ = self._finish(tile, r0, pop0, root_con, data)
                if part is not None:
                    # per-query shard partition of the globally pruned
                    # root extension (see TileScheduler._build_step)
                    r_in = r_in & part[tile["idx"][:, 0].long()]
            frontiers = []
            alive_l, total_l = [], []
            proceed = None
            cur_tile, cur_r, cur_cursor = tile, r_in, cursor
            total_in = None
            for k, (expand, chain, leaf_i) in enumerate(built):
                cur, tot = expand(cur_tile, cur_r, cur_cursor, data)
                # drop rows of queries that already hit their limit, after
                # expansion so bit ranks (and the host's chunk cursors into
                # this frontier) are unaffected
                cur["alive"] = cur["alive"] & active[cur["idx"][:, 0].long()]
                if k == 0:
                    total_in = tot
                else:
                    cur["alive"] = cur["alive"] & proceed
                apply_fail_masks(k, cur, fbufs, facc)
                last = None
                for (sj, dedup, compute_r, con_key) in chain:
                    r, pop, ok, acc = run_compute(sj, dedup, compute_r,
                                                  con_key, cur, bufs, fbufs,
                                                  acc, facc, data)
                    last = (r, pop, ok)
                    if not leaf_i and sj == chain[-1][0]:
                        break                    # exit compute: no store
                    bm = dict(cur["bm"])
                    bm[self._stages[sj][1]] = r
                    cur = {"idx": cur["idx"], "bm": bm, "alive": ok}
                if leaf_i:
                    terms = leaf_terms(cur)
                    count_q, ovf_q = leaf_reduce(terms, cur["alive"],
                                                 cur["idx"][:, 0])
                    leaf_alive = cur["alive"].sum(dtype=torch.int32)
                    packed = torch.stack(
                        [total_in, leaf_alive, *alive_l, *total_l, *acc,
                         *facc])
                    return (cur, terms, count_q, ovf_q, packed, frontiers,
                            bufs, fbufs)
                r2, pop2, ok2 = last
                alive_k = ok2.sum(dtype=torch.int32)
                total_k = pop2.sum(dtype=torch.int32)
                frontiers.append((cur, r2))
                alive_l.append(alive_k)
                total_l.append(total_k)
                ok_here = (total_k <= t) & (alive_k > 0)
                proceed = ok_here if proceed is None else (proceed & ok_here)
                cur_tile, cur_r, cur_cursor = cur, r2, 0

        return (step, exit_bounds, sorted(set(seg_cer)), seg_fail,
                n_computes, gather_ops)

    def superstep(self, b: int):
        """Cached `build_step(b)`: one dispatch advancing a mixed-query
        frontier chunk from boundary `b` down to the per-query leaf
        reduction. Fresh builds bump `compiled_supersteps` (surfaced as
        `VectorStats.bucket_recompiles`)."""
        entry = self._steps.get(b)
        if entry is None:
            entry = self._steps[b] = self.build_step(b)
            self.compiled_supersteps += 1
        return entry



# one BatchProgram per (signature, padded query count, knobs, device):
# shared by every SuperbatchScheduler whose bucket matches, across Matcher
# sessions. LRU-bounded — a long-running server sees an open-ended stream of
# padded shapes.
_PROGRAMS: "OrderedDict[tuple, BatchProgram]" = OrderedDict()
_PROGRAMS_MAX = 32


def _get_batch_program(sig, n_queries, *, use_cv, use_cer, use_fail, device):
    key = (sig, n_queries, use_cv, use_cer, use_fail, str(device))
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = BatchProgram(sig, n_queries, use_cv=use_cv, use_cer=use_cer,
                            use_fail=use_fail, device=device)
        _PROGRAMS[key] = prog
        while len(_PROGRAMS) > _PROGRAMS_MAX:
            _PROGRAMS.popitem(last=False)
    else:
        _PROGRAMS.move_to_end(key)
    return prog


class SuperbatchScheduler:
    """Cross-query superbatch runtime: one host work loop drains interleaved
    frontiers from every query in a shape-signature bucket through the shared
    BatchProgram supersteps. Per-query counts come back summed from the leaf
    reduction; CER ring buffers are scheduler-lifetime and keyed by
    (query id, read-set), so a warm scheduler (Matcher caches them per
    bucket) reuses extensions across runs without ever crossing queries."""

    def __init__(self, plans, *, device, tile_rows: int = 256,
                 use_cv: bool = True, use_dedup: bool = True,
                 use_cer_buffer: bool = True, cer_buffer_slots: int = 256,
                 use_failure_cache: bool = True,
                 failure_cache_slots: int = 64, pack_tiles: bool = True,
                 overlap: bool = True):
        if not plans:
            raise ValueError("superbatch needs at least one plan")
        sigs = {plan_shape_signature(p, tile_rows=tile_rows) for p in plans}
        if len(sigs) > 1:
            raise ValueError("superbatch plans must share one shape "
                             f"signature, got {len(sigs)}")
        self.sig = next(iter(sigs))
        self.plans = list(plans)
        self.nq = len(plans)
        self.nq_pad = _pow2ceil(self.nq)
        self.t = tile_rows
        self.device = torch.device(device)
        self.pack_tiles = pack_tiles
        self.overlap = overlap
        self.program = _get_batch_program(
            self.sig, self.nq_pad, use_cv=use_cv,
            use_cer=(use_dedup and use_cer_buffer),
            use_fail=use_failure_cache, device=self.device)
        self.data = stack_batch_inputs(self.sig, self.plans, self.nq_pad,
                                       self.device)
        prog = self.program
        self._buffers = {
            si: _init_ring(cer_buffer_slots, 1 + len(prog.dedup_slots(si)),
                           self.device,
                           vals=((prog.stage_width(si),), torch.int32),
                           pops=((), torch.int32))
            for si in prog._cer_stages}
        self._fail_buffers = {
            si: _init_ring(failure_cache_slots,
                           1 + len(prog.dedup_slots(si)), self.device,
                           wit=((), torch.int32))
            for si in prog._fail_stages}
        # test hook: called with the scheduler after every superstep's
        # buffer fold-back (tests corrupt _fail_buffers mid-run through it)
        self.fail_debug_hook = None
        self.stats = VectorStats()

    def run(self, *, limit: int = 1_000_000, max_steps: int | None = None):
        """Drain every query to completion (or `limit` embeddings each /
        `max_steps` total dispatches for the whole bucket). Returns
        (per-query counts, VectorStats, timed_out)."""
        prog = self.program
        st = self.stats = VectorStats()
        st.batched_queries = self.nq
        compiled_before = prog.compiled_supersteps
        t = self.t
        dev = self.device
        nq, nq_pad = self.nq, self.nq_pad
        counts = [0] * nq
        timed_out = False
        singles = list(prog.leaf[0])
        groups = [list(g) for g in prog.leaf[1]]
        # queries that reached `limit` deactivate: their frontier rows are
        # masked dead inside later supersteps (counts freeze and clamp);
        # the mask is uploaded only when it changes
        active_np = np.zeros(nq_pad, bool)
        active_np[:nq] = True
        active = _upload(active_np, dev)

        qids = torch.arange(nq_pad, dtype=torch.int32, device=dev)
        root_tile = {"idx": qids[:, None].contiguous(), "bm": {},
                     "alive": qids < nq}
        root_r = torch.zeros((nq_pad, prog.widths[0]), dtype=torch.int32,
                             device=dev)
        # (boundary, tile, R, cursor, total bits or -1 for the root item)
        stack: list = [(0, root_tile, root_r, 0, -1)]
        pending: dict[int, list] = {}

        def dispatch(item):
            """One batched superstep, no readback wait (see
            TileScheduler._dispatch)."""
            b, tile, r, cursor, tot = item
            fn, exit_bounds, seg_cer, seg_fail, n_computes, gather_ops = \
                prog.superstep(b)
            bufs = {si: self._buffers[si] for si in seg_cer}
            fbufs = {si: self._fail_buffers[si] for si in seg_fail}
            (leaf_tile, terms, cnt_q, ovf_q, packed, frontiers, bufs2,
             fbufs2) = fn(tile, r, cursor, bufs, fbufs, self.data, active)
            for si in seg_cer:
                self._buffers[si] = bufs2[si]
            for si in seg_fail:
                self._fail_buffers[si] = fbufs2[si]
            if self.fail_debug_hook is not None:
                self.fail_debug_hook(self)
            st.device_steps += 1
            st.supersteps += 1
            st.tiles += 1
            st.expansions += 1
            st.rows_processed += t * max(n_computes, 1)
            st.gather_and_ops += gather_ops
            if tot >= 0 and cursor + t < tot:
                stack.append((b, tile, r, cursor + t, tot))
            return {"item": item, "exit_bounds": exit_bounds,
                    "leaf_tile": leaf_tile, "terms": terms,
                    "frontiers": frontiers,
                    "sync": _start_readback(packed, cnt_q, ovf_q),
                    "np": None}

        def process(p):
            """Apply one synced readback (`_walk_ladder`); fold the
            per-query leaf counts when the ladder reached the leaf."""
            leaf = _walk_ladder(p, st, t, self.pack_tiles, stack, pending)
            if leaf is None:
                return
            cnt, ovf = leaf[:nq_pad], leaf[nq_pad:]
            if ovf.any():
                # exact host fallback, per query (qid selects the rows)
                st.leaf_overflows += 1
                terms_np = p["terms"].cpu().numpy()
                alive_np = p["leaf_tile"]["alive"].cpu().numpy()
                qid_np = p["leaf_tile"]["idx"][:, 0].cpu().numpy()
                for qi in range(nq):
                    sel = qid_np == qi
                    counts[qi] += leaf_count_host(singles, groups,
                                                  terms_np[sel],
                                                  alive_np[sel])
            else:
                for qi in range(nq):
                    counts[qi] += int(cnt[qi])

        while stack or pending:
            if not stack:
                b = max(pending)                     # flush deepest first
                tile_p, r_p, _, tot_p = pending.pop(b)
                stack.append((b, tile_p, r_p, 0, tot_p))
                continue
            if max_steps is not None and st.device_steps >= max_steps:
                timed_out = True
                break
            st.peak_stack = max(st.peak_stack, len(stack) + len(pending))
            # double-buffered claim of up to two items; the discipline is
            # shared by overlap on/off (see TileScheduler.run)
            first = dispatch(stack.pop())
            if not self.overlap:
                _sync_inflight(st, [first])
            inflight = [first]
            if stack and (max_steps is None
                          or st.device_steps < max_steps):
                second = dispatch(stack.pop())
                if not self.overlap:
                    _sync_inflight(st, [second])
                inflight.append(second)
            if self.overlap:
                _sync_inflight(st, inflight)
            stop = False
            for p in inflight:
                process(p)
                if all(c >= limit for c in counts):
                    stop = True
                    break
                done = [qi for qi in range(nq)
                        if active_np[qi] and counts[qi] >= limit]
                if done:
                    active_np[done] = False
                    active = _upload(active_np, dev)
            if stop:
                break

        st.bucket_recompiles = prog.compiled_supersteps - compiled_before
        return [min(c, limit) for c in counts], st, timed_out
