"""Device-resident tile scheduler for the vectorized CEMR engine.

Torch port of the fused-superstep path of `repro.core.scheduler`
(`TileScheduler._run_fused` and what it runs):

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

The reference gates the CER compute and both ring-buffer updates behind
`lax.cond`. A Python `if` on a device value would sync on every superstep,
so here both branches are computed masked: a masked insert writes only the
padding row and leaves the ring as it was, which gives the reference's
results with one readback per superstep.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bitops
from .engine import VectorMatchResult, VectorStats
from .plan import IDX

__all__ = ["TileScheduler", "leaf_count_host", "make_leaf_reduce",
           "OVERFLOW_LIMIT"]

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
    """Queue a superstep's packed stats, leaf count and overflow flag for
    the host: on the card, one non-blocking copy into pinned host memory
    and an event behind it; on the CPU the values are already there."""
    vec = torch.cat([packed.to(torch.int64), cnt.reshape(1).to(torch.int64),
                     ovf.reshape(1).to(torch.int64)])
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
        return self.eng.use_dedup and self._keyed_extend(si)

    def _fail_eligible(self, si: int) -> bool:
        # same read-set requirements as CER (the failure verdict must be a
        # pure function of the dedup-slot key), independent of use_dedup
        return self.eng.use_failure_cache and self._keyed_extend(si)

    def _segment(self, b: int):
        """BM-store stages fused after boundary `b`, and the exit stage
        (the next boundary, or n_stages = leaf)."""
        bms = []
        si = b + 1
        while si < self._n_stages and not self._is_boundary(si):
            bms.append(si)
            si += 1
        return bms, si

    def _ladder(self, b: int):
        """Segments from boundary `b` down to the leaf:
        [(boundary, bm_stage list, exit stage), ...]; the last exit is
        n_stages (leaf)."""
        segs = []
        si = b
        while True:
            bms, exit_si = self._segment(si)
            segs.append((si, bms, exit_si))
            if exit_si == self._n_stages:
                return segs
            si = exit_si

    # ------------------------------------------------------------- superstep
    def _build_step(self, b: int):
        """Construct the run-to-completion step for boundary `b`: expand the
        given frontier chunk, then keep descending — each deeper boundary's
        frontier is expanded in place while it fits one chunk (device-side
        `proceed` mask; overshooting work is masked dead and contributes
        zero) — ending in the leaf reduction. Returns every intermediate
        frontier so the host can resume exactly where the ladder stopped.

        Returns (step, exit_bounds, seg_cer, seg_fail, n_computes,
        gather_ops)."""
        eng = self.eng
        t = self.t
        dev = self.device
        cer_set = set(self._cer_stages)
        fail_set = set(self._fail_stages)
        segs = self._ladder(b)
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

        def step(tile, r_in, cursor, bufs, fbufs, tables, masks):
            bufs = dict(bufs)
            fbufs = dict(fbufs)
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            acc = [zero] * 4                             # hits/misses/seen/ins
            facc = [zero] * 4                            # fail h/m/ins/pruned
            if root:
                r0, pop0 = root_compute_r(tile, tables, masks)
                r_in, _, _ = eng.finish_compute(tile, r0, pop0, root_con)
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

    def _merge(self, ta, ra, tb, rb):
        """Frontier compaction: concatenate two sub-capacity sibling
        frontiers, live rows (nonzero extension bitmap) packed to the
        front, sliced back to tile capacity."""
        idx = torch.cat([ta["idx"], tb["idx"]])
        bm = {u: torch.cat([ta["bm"][u], tb["bm"][u]]) for u in ta["bm"]}
        r = torch.cat([ra, rb])
        live = bitops.row_popcount(r) > 0
        order = torch.sort((~live).to(torch.int32),
                           stable=True).indices[:self.t]   # live first
        tile = {"idx": idx[order],
                "bm": {u: c[order] for u, c in bm.items()},
                "alive": live[order]}
        return tile, r[order]

    # ------------------------------------------------------------------- run
    def run(self, *, limit: int = 1_000_000, max_steps: int | None = None,
            materialize: bool = False) -> VectorMatchResult:
        """Enumerate to completion (or until `limit` embeddings /
        `max_steps` dispatches, whichever first). `materialize=True`
        additionally decodes explicit embeddings from every counted leaf
        tile."""
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

    def _push_frontier(self, b, tile, r, alive_n, total, stack, pending):
        """Route a host-resumed frontier: pack sub-capacity frontiers with
        pending siblings at the same boundary, dispatch otherwise."""
        st = self.stats
        if self.eng.pack_tiles and alive_n * 2 <= self.t:
            pend = pending.get(b)
            if pend is None:
                pending[b] = [tile, r, alive_n, total]
            elif pend[2] + alive_n <= self.t:
                mtile, mr = self._merge(pend[0], pend[1], tile, r)
                st.device_steps += 1
                st.packed_tiles += 1
                pending[b] = [mtile, mr, pend[2] + alive_n, pend[3] + total]
            else:
                stack.append((b, pend[0], pend[1], 0, pend[3]))
                pending[b] = [tile, r, alive_n, total]
        else:
            stack.append((b, tile, r, 0, total))

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
        """Apply one synced readback: fold the packed tail counters, resume
        the root chunk cursor (the only item whose total is unknown at
        dispatch), walk the ladder routing the first overflowing frontier,
        and return the leaf count (exact host fallback on overflow)."""
        eng = self.eng
        st = self.stats
        t = self.t
        b, tile, r, cursor, tot = p["item"]
        vec = p["np"]
        exit_bounds = p["exit_bounds"]
        nb = len(exit_bounds)
        total_in = int(vec[0])
        leaf_alive = int(vec[1])
        alive_l = [int(v) for v in vec[2:2 + nb]]
        total_l = [int(v) for v in vec[2 + nb:2 + 2 * nb]]
        tail = [int(v) for v in vec[2 + 2 * nb:2 + 2 * nb + 8]]
        cnt, ovf = int(vec[-2]), bool(vec[-1])
        st.cer_hits += tail[0]
        st.cer_misses += tail[1]
        st.dedup_keys_seen += tail[2]
        st.dedup_unique += tail[3]
        st.fail_hits += tail[4]
        st.fail_misses += tail[5]
        st.fail_inserts += tail[6]
        st.fail_pruned_rows += tail[7]
        if tot < 0 and cursor + t < total_in:
            stack.append((b, tile, r, cursor + t, total_in))
        # walk the ladder: consumed boundaries (single-chunk) descend
        # in-device; the first overflowing frontier resumes on the host
        for k in range(nb):
            st.rows_alive += alive_l[k]
            if alive_l[k] == 0:                      # dead end
                return 0
            if total_l[k] <= t:
                continue                             # consumed in-ladder
            ft, fr = p["frontiers"][k]
            self._push_frontier(exit_bounds[k], ft, fr, alive_l[k],
                                total_l[k], stack, pending)
            return 0
        st.leaf_tiles += 1
        st.rows_alive += leaf_alive
        if ovf:
            st.leaf_overflows += 1
            c = leaf_count_host(eng.plan.leaf_singles, eng.plan.leaf_groups,
                                p["terms"], p["leaf_tile"]["alive"])
        else:
            c = cnt
        if materialize and c:
            embeddings.extend(eng._materialize(p["leaf_tile"]))
        return c
