"""Multi-device sharded enumeration: data-parallel tile scheduling.

Torch port of `repro.core.shard`. CEMR's search tree is embarrassingly
parallel at the root: each root candidate's subtree can be enumerated
independently and the per-query counts summed, while the CER buffers and
pruning stay local to each worker (the failure-reuse locality argument of
Arai et al.). This module runs the fused ladder supersteps of
`core.scheduler` *data-parallel across the lanes of an enumeration mesh*
(`launch.mesh.EnumMesh`, a tuple of lane devices):

  * **Root partition** — the level-0 candidate bitmap is split into
    disjoint per-shard partitions by a degree-weighted balance heuristic
    (`plan.root_extension_weights` scores each candidate by its level-1
    fanout, `distributed.sharding.partition_bitmap` assigns
    heaviest-first). Each partition enters the work pool as its own root
    item carrying its partition mask; the superstep ANDs that mask into
    the *already pruned* root extension (contained-vertex thresholds are
    always judged on the global popcount, never a partition's), so a
    shard only ever enumerates its own subtrees.

  * **Lane supersteps** — one dispatch advances up to `n_shards` lanes
    through the same cached single-lane ladder step (the reference's
    `shard_map` over a "data" mesh): lane s runs on `mesh.devices[s]` with
    its own tile, cursor, partition mask and CER / failure ring buffers,
    and reads the adjacency tables and candidate masks replicated once per
    distinct lane device. A frontier claimed by a lane on another device
    moves there at dispatch (free when the lanes share one device). Lanes
    run one after another, each through the card's bitmap kernels, so a
    dispatch launches each kernel once per live lane. The reference's
    `psum` of the leaf counts is the host sum of the lanes' readbacks; the
    int64-overflow → exact host big-int fallback stays per shard (only an
    overflowing lane's terms are recounted on the host).

  * **Host-side rebalance** — work items live in one *global* pool, not in
    per-shard queues, so a shard whose frontier drains immediately picks
    up any other shard's items at the same boundary (work stealing by
    construction). Idle lanes are additionally refilled by (a) flushing a
    parked sub-capacity pending frontier at the dispatch boundary and (b)
    *chunk-splitting*: an overflowing frontier's remaining expansion
    chunks (disjoint `cursor` windows over the same (tile, R)) fan out
    across idle lanes — this is what keeps a deliberately skewed workload
    (one hot root candidate) from serializing on one shard. Repartitioned
    sub-capacity frontiers continue to merge through the existing
    compaction machinery (`pack_tiles`), which is lane-agnostic.
    `VectorStats.shard_rebalances` counts the refills.

With one device the Matcher's mesh resolves to None and the plain
single-device schedulers run — the fallback is bit-identical by
construction. `ShardedSuperbatchScheduler` composes the cross-query
superbatch (the query id in index column 0) with the shard axis: each
query's root candidates are partitioned per shard, and the per-query leaf
sums are added up across the lanes on the host.

The reference pads a dispatch to the mesh width with all-dead lanes; here
only the claimed lanes run. A step over an all-dead tile inserts nothing
into its lane's rings and adds nothing to any count, so skipping it
changes no result (tests/test_torch_shard.py holds this).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..distributed.sharding import partition_bitmap
from .engine import VectorMatchResult, VectorStats
from .plan import root_extension_weights
from .scheduler import (_TAIL_FIELDS, SuperbatchScheduler, TileScheduler,
                        _merge_frontiers, _start_readback, _sync_inflight,
                        _upload, leaf_count_host)

__all__ = ["ShardedTileScheduler", "ShardedSuperbatchScheduler"]


def _to(tree, dev):
    """`tree` (nested dicts, lists and tuples of tensors) on `dev`; tensors
    already there come back as they are, without a copy."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree


def _replicas(tree, home, devices) -> dict:
    """One copy of `tree` (living on `home`) per distinct device: `home`
    itself keeps the original, every other device gets one copy."""
    return {dev: tree if dev == home else _to(tree, dev)
            for dev in dict.fromkeys(devices)}


class _ShardLoopBase:
    """Machinery shared by the single-query and superbatch sharded
    schedulers: the global work pool, lane filling (with rebalance),
    frontier routing, the per-lane superstep dispatch, and the per-lane
    ladder walk. Work items are
    (boundary, tile, r, cursor, total_bits, part_mask) — `total_bits` is
    always known at push time, so expansion chunks of one item can be
    claimed by several lanes in the same dispatch; `part_mask` is None
    except on root items.

    Subclasses set `t`, `n_shards`, `mesh`, `pack_tiles`, `stats`,
    `_nil_part`, `_buffers` / `_fail_buffers` (one dict of ring buffers a
    lane, on the lane's device) and implement `_lane_step(b)` (the
    single-lane ladder step plus its metadata) and `_aux(dev)` (the step's
    two trailing arguments on `dev`)."""

    def _item(self, b, tile, r, cursor, total):
        return (b, tile, r, cursor, total, self._nil_part)

    def _fill_lanes(self, b, stack, pending):
        """Claim up to `n_shards` work items at boundary `b` from the
        global pool; refill idle lanes from the pending slot and by
        chunk-splitting items with multiple expansion chunks remaining
        (the host-side rebalance). Unclaimed chunk remainders go back on
        the stack."""
        S, t = self.n_shards, self.t
        lanes, keep = [], []
        while stack and len(lanes) < S:
            item = stack.pop()
            (lanes if item[0] == b else keep).append(item)
        stack.extend(reversed(keep))
        if len(lanes) < S and b in pending:
            tile_p, r_p, _, tot_p = pending.pop(b)
            lanes.append(self._item(b, tile_p, r_p, 0, tot_p))
            self.stats.shard_rebalances += 1
        for item in list(lanes):
            bb, tile, r, cur, tot, part = item
            while cur + t < tot and len(lanes) < S:
                cur += t
                lanes.append((bb, tile, r, cur, tot, part))
                self.stats.shard_rebalances += 1
            if cur + t < tot:
                stack.append((bb, tile, r, cur + t, tot, part))
        return lanes

    def _push_frontier(self, b, tile, r, alive_n, total, stack, pending):
        """Route a host-resumed frontier: pack sub-capacity frontiers with
        pending siblings at the same boundary (lane-agnostic compaction,
        on the pending frontier's device), dispatch-queue otherwise."""
        st = self.stats
        if self.pack_tiles and alive_n * 2 <= self.t:
            pend = pending.get(b)
            if pend is None:
                pending[b] = [tile, r, alive_n, total]
            elif pend[2] + alive_n <= self.t:
                dev = pend[1].device
                mtile, mr = _merge_frontiers(pend[0], pend[1], _to(tile, dev),
                                             r.to(dev), self.t)
                st.device_steps += 1
                st.packed_tiles += 1
                pending[b] = [mtile, mr, pend[2] + alive_n, pend[3] + total]
            else:
                stack.append(self._item(b, pend[0], pend[1], 0, pend[3]))
                pending[b] = [tile, r, alive_n, total]
        else:
            stack.append(self._item(b, tile, r, 0, total))

    def _shard_fn(self, b: int):
        """Cached single-lane superstep for boundary `b`: every lane runs
        this same ladder step on its own tile / cursor / partition / CER
        buffers."""
        if not hasattr(self, "_shard_steps"):
            self._shard_steps = {}
        if b not in self._shard_steps:
            self._shard_steps[b] = self._lane_step(b)
        return self._shard_steps[b]

    def _dispatch(self, b, lanes):
        """Run one sharded superstep over the claimed `lanes` — lane s on
        `mesh.devices[s]` — *without waiting for its readback*. The CER /
        failure-cache buffers fold forward as device tensors and the
        dispatch-level stats are charged immediately; the host sync is
        deferred to `scheduler._sync_inflight`, which fills the returned
        record's "np" slot from its "sync" pair (one readback of every
        lane's packed stats, leaf counts and overflow flags). Overlap
        (dispatching superstep N+1 before reading back N) is therefore
        purely a matter of *when* the caller syncs — what is computed
        never changes."""
        n_real = len(lanes)
        (step, exit_bounds, seg_cer, seg_fail, n_computes,
         gather_ops) = self._shard_fn(b)
        outs = []
        for s, (_b, tile, r, cursor, _tot, part) in enumerate(lanes):
            dev = self.mesh.devices[s]
            bufs = {si: self._buffers[s][si] for si in seg_cer}
            fbufs = {si: self._fail_buffers[s][si] for si in seg_fail}
            (leaf_tile, terms, cnt, ovf, packed, frontiers, bufs2,
             fbufs2) = step(_to(tile, dev), r.to(dev), cursor, bufs, fbufs,
                            *self._aux(dev), part=_to(part, dev))
            for si in seg_cer:
                self._buffers[s][si] = bufs2[si]
            for si in seg_fail:
                self._fail_buffers[s][si] = fbufs2[si]
            outs.append((leaf_tile, terms, cnt, ovf, packed, frontiers))
        if self.fail_debug_hook is not None:
            self.fail_debug_hook(self)
        st = self.stats
        st.device_steps += 1
        st.supersteps += 1
        st.tiles += n_real
        st.expansions += n_real
        st.shard_lanes += n_real
        st.rows_processed += n_real * self.t * max(n_computes, 1)
        st.gather_and_ops += n_real * gather_ops
        # one readback for every lane, queued on lane 0's device
        dev0 = self.mesh.devices[0]
        with (torch.cuda.device(dev0) if dev0.type == "cuda"
              else contextlib.nullcontext()):
            sync = _start_readback(
                torch.stack([o[4].to(dev0) for o in outs]).reshape(-1),
                torch.stack([o[2].to(dev0) for o in outs]),
                torch.stack([o[3].to(dev0) for o in outs]))
        return {"n_real": n_real, "exit_bounds": exit_bounds,
                "leaf_tile": [o[0] for o in outs],
                "terms": [o[1] for o in outs],
                "frontiers": [o[5] for o in outs],
                "sync": sync, "np": None}

    @staticmethod
    def _unpack(rec, n_cnt):
        """Split a synced record's readback into per-lane rows: (packed
        (n, L), cnt (n, n_cnt), ovf (n, n_cnt) bool, total (n_cnt,)), the
        total being the host sum of the lanes' leaf counts."""
        n = rec["n_real"]
        n_packed = 2 + 2 * len(rec["exit_bounds"]) + len(_TAIL_FIELDS)
        vec = rec["np"]
        a, c = n * n_packed, n * n_cnt
        packed = vec[:a].reshape(n, n_packed)
        cnt = vec[a:a + c].reshape(n, n_cnt)
        ovf = vec[a + c:a + 2 * c].reshape(n, n_cnt).astype(bool)
        return packed, cnt, ovf, cnt.sum(axis=0)

    def _walk_lane(self, row, exit_bounds, frontiers, stack, pending):
        """Apply one lane's packed readback: CER/boundary stats, then
        route the first overflowing frontier (`frontiers`: the lane's
        (tile, r) per exit boundary) back into the pool. Returns True when
        the lane's ladder reached the leaf reduction."""
        st = self.stats
        nb = len(exit_bounds)
        alive_l = [int(v) for v in row[2:2 + nb]]
        total_l = [int(v) for v in row[2 + nb:2 + 2 * nb]]
        tail = [int(v) for v in row[2 + 2 * nb:]]
        for field, v in zip(_TAIL_FIELDS, tail):
            setattr(st, field, getattr(st, field) + v)
        for k in range(nb):
            st.rows_alive += alive_l[k]
            if alive_l[k] == 0:                      # dead end
                return False
            if total_l[k] <= self.t:
                continue                             # consumed in-ladder
            ft, fr = frontiers[k]
            self._push_frontier(exit_bounds[k], ft, fr, alive_l[k],
                                total_l[k], stack, pending)
            return False
        st.leaf_tiles += 1
        st.rows_alive += int(row[1])
        return True

    def _drain(self, stack, pending, max_steps, overlap, aux_changed,
               consume):
        """The shared double-buffered dispatch loop: drain the pool (or
        stop after `max_steps` dispatches, returning True for timed out),
        feeding each synced record to `consume`, which returns True to
        stop."""
        st = self.stats
        while stack or pending:
            if not stack:
                b = max(pending)                     # flush deepest first
                tile_p, r_p, _, tot_p = pending.pop(b)
                stack.append(self._item(b, tile_p, r_p, 0, tot_p))
                continue
            if max_steps is not None and st.device_steps >= max_steps:
                return True
            st.peak_stack = max(st.peak_stack, len(stack) + len(pending))
            # double-buffered claim of up to two supersteps; claim and
            # dispatch order is identical for overlap on/off — only the
            # readback timing differs (see scheduler._sync_inflight)
            b = stack[-1][0]
            first = self._dispatch(b, self._fill_lanes(b, stack, pending))
            if not overlap:
                _sync_inflight(st, [first])
            inflight = [first]
            if stack and (max_steps is None
                          or st.device_steps < max_steps):
                b2 = stack[-1][0]
                second = self._dispatch(
                    b2, self._fill_lanes(b2, stack, pending))
                if not overlap:
                    _sync_inflight(st, [second])
                inflight.append(second)
            if overlap:
                _sync_inflight(st, inflight)
            for rec in inflight:
                if consume(rec):
                    return False
                aux_changed()
        return False


class ShardedTileScheduler(_ShardLoopBase, TileScheduler):
    """Data-parallel TileScheduler: the fused superstep loop of one
    VectorEngine spread over the lanes of an `EnumMesh`.

    Counts are identical to the single-device scheduler: the root
    partition is a disjoint cover of the (globally pruned) level-0
    extension, every other mechanism (frontier chunking, compaction, CER,
    leaf counting) operates on lane-local state, and leaf contributions
    are summed on the host. The stage-at-a-time compat loop
    (`use_cer_buffer=False`) is not sharded and falls back to the
    single-device path.
    """

    def __init__(self, eng, mesh):
        super().__init__(eng)
        self.mesh = mesh
        self.n_shards = int(mesh.size)
        self.pack_tiles = eng.pack_tiles
        self.fail_debug_hook = None
        devs = mesh.devices
        # one independent CER ring buffer per shard per CER-enabled stage,
        # and ditto for the failure-reuse negative cache, each on its
        # lane's device (the rings update functionally, so lanes on one
        # device may start from the same empty tensors)
        self._buffers = [_to(self._buffers, d) for d in devs]
        self._fail_buffers = [_to(self._fail_buffers, d) for d in devs]
        plan = eng.plan
        parts, counts = partition_bitmap(
            np.asarray(plan.masks[plan.root_vertex]),
            root_extension_weights(plan), self.n_shards)
        # the root contained-vertex prune is global: if the whole root
        # extension fails the threshold every partition is dead, otherwise
        # every partition's bits are live work (a partition may hold fewer
        # bits than the threshold — its subtrees still count)
        con0 = max(len(eng.an.con[0]), 1) if eng.use_cv else 1
        root_alive = int(counts.sum()) >= con0
        self._parts = [torch.from_numpy(p.view(np.int32)).to(devs[s])
                       for s, p in enumerate(parts)]
        self._part_counts = [int(c) if root_alive else 0 for c in counts]
        self._nil_part = None
        # replicate the adjacency tables / candidate masks once per
        # distinct lane device — without this every dispatch would copy
        home = eng.masks[plan.root_vertex].device
        self._aux_by_dev = _replicas((eng.tables, eng.masks), home, devs)

    def _aux(self, dev):
        return self._aux_by_dev[dev]

    def _lane_step(self, b: int):
        return self._build_step(b)

    def run(self, *, limit: int = 1_000_000, max_steps: int | None = None,
            materialize: bool = False) -> VectorMatchResult:
        """Drain the sharded work pool to completion (or `limit`
        embeddings / `max_steps` dispatches). Returns a VectorMatchResult
        with counts identical to the single-device scheduler."""
        if not self.eng.use_cer_buffer:
            # the stage-at-a-time compat loop stays single-device
            return self._run_tiles(limit=limit, max_steps=max_steps,
                                   materialize=materialize)
        eng = self.eng
        st = self.stats = eng.stats = VectorStats()
        S = self.n_shards
        count = 0
        embeddings: list[dict[int, int]] = []
        dev0 = self.mesh.devices[0]

        root_tile = {"idx": torch.zeros((1, 0), dtype=torch.int32,
                                        device=dev0),
                     "bm": {},
                     "alive": torch.ones((1,), dtype=torch.bool, device=dev0)}
        root_r = torch.zeros((1, eng.plan.root_words), dtype=torch.int32,
                             device=dev0)                # recomputed
        # one root item per non-empty partition; empty partitions (more
        # shards than root candidates) produce no work at all
        stack: list = [
            (0, root_tile, root_r, 0, self._part_counts[s], self._parts[s])
            for s in range(S) if self._part_counts[s] > 0]
        pending: dict[int, list] = {}

        def consume(rec):
            """Fold one synced superstep record into the count; True once
            the count reaches `limit`."""
            nonlocal count
            packed_np, cnt_np, ovf_np, total_np = self._unpack(rec, 1)
            any_ovf = bool(ovf_np.any())
            lane_sum = 0
            for s in range(rec["n_real"]):
                if not self._walk_lane(packed_np[s], rec["exit_bounds"],
                                       rec["frontiers"][s], stack, pending):
                    continue
                leaf_tile = rec["leaf_tile"][s]
                if bool(ovf_np[s, 0]):
                    st.leaf_overflows += 1
                    c = leaf_count_host(eng.plan.leaf_singles,
                                        eng.plan.leaf_groups,
                                        rec["terms"][s], leaf_tile["alive"])
                else:
                    c = int(cnt_np[s, 0])
                if materialize and c:
                    embeddings.extend(eng._materialize(leaf_tile))
                lane_sum += c
            # the lanes' host sum is the primary count; the per-lane walk
            # replaces it only when a shard tripped the exact host fallback
            count += lane_sum if any_ovf else int(total_np[0])
            return count >= limit

        timed_out = self._drain(stack, pending, max_steps, eng.overlap,
                                lambda: None, consume)
        return VectorMatchResult(count=min(count, limit), stats=st,
                                 timed_out=timed_out,
                                 embeddings=embeddings if materialize
                                 else None)


class ShardedSuperbatchScheduler(_ShardLoopBase, SuperbatchScheduler):
    """Cross-query superbatch scheduler spread over the lanes of an
    `EnumMesh`: the query-id lane composes with the shard axis.

    Every query's root candidate bitmap is partitioned per shard
    (degree-weighted per query, pruned globally per query), mixed-query
    tiles advance through BatchProgram supersteps lane by lane with
    per-lane CER ring buffers, and the per-query leaf sums are added up
    across the lanes on the host. Per-query counts are identical to the
    unsharded SuperbatchScheduler (and therefore to the sequential and
    ref paths). `device` (the stacked inputs' home) defaults to the first
    lane's.
    """

    def __init__(self, plans, *, mesh, **kw):
        kw.setdefault("device", mesh.devices[0])
        super().__init__(plans, **kw)
        self.mesh = mesh
        self.n_shards = S = int(mesh.size)
        devs = mesh.devices
        self._buffers = [_to(self._buffers, d) for d in devs]
        self._fail_buffers = [_to(self._fail_buffers, d) for d in devs]
        mask = self.data["mask_root"].cpu().numpy().view(np.uint32)  # (Q, W0)
        w_tabs = [v.cpu().numpy().view(np.uint32)
                  for k, v in self.data["tables"].items()
                  if k.startswith("0:")]
        nq_pad, w0 = mask.shape
        parts = np.zeros((S, nq_pad, w0), np.uint32)
        counts = np.zeros(S, np.int64)
        if self.program.use_cv:
            con0 = self.data["con"]["0"].cpu().numpy()
        else:
            con0 = np.ones(nq_pad, np.int32)
        for q in range(nq_pad):
            w = np.ones(32 * w0, np.float64)
            for tab in w_tabs:
                if tab[q].size:
                    w += np.unpackbits(
                        np.ascontiguousarray(tab[q]).view(np.uint8),
                        axis=1).sum(axis=1)
            pq, cq = partition_bitmap(mask[q], w, S)
            parts[:, q] = pq
            # global per-query prune: a query whose whole root extension
            # fails its threshold contributes nothing; otherwise every
            # partition's bits are live work
            if int(cq.sum()) >= max(int(con0[q]), 1):
                counts += cq
        self._parts = [torch.from_numpy(parts[s].view(np.int32)).to(devs[s])
                       for s in range(S)]
        self._part_counts = [int(c) for c in counts]
        self._nil_part = None
        # replicate the stacked per-query tables/masks/thresholds once per
        # distinct lane device — without this every dispatch would copy
        self._data_by_dev = _replicas(self.data, self.data["mask_root"].device,
                                      devs)
        self._active_by_dev: dict = {}

    def _aux(self, dev):
        return self._data_by_dev[dev], self._active_by_dev[dev]

    def _lane_step(self, b: int):
        self.program.compiled_supersteps += 1        # fresh build follows
        return self.program.build_step(b)

    def run(self, *, limit: int = 1_000_000, max_steps: int | None = None):
        """Drain every query in the bucket to completion (or `limit`
        embeddings each / `max_steps` total dispatches). Returns
        (per-query counts, VectorStats, timed_out) with counts identical
        to the unsharded superbatch path."""
        prog = self.program
        st = self.stats = VectorStats()
        st.batched_queries = self.nq
        compiled_before = prog.compiled_supersteps
        S = self.n_shards
        nq, nq_pad = self.nq, self.nq_pad
        counts = [0] * nq
        singles = list(prog.leaf[0])
        groups = [list(g) for g in prog.leaf[1]]
        # queries that reached `limit` deactivate on every lane: their rows
        # are masked dead inside later supersteps; the mask is uploaded to
        # each lane device only when it changes
        active_np = np.zeros(nq_pad, bool)
        active_np[:nq] = True

        def upload_active():
            self._active_by_dev = {d: _upload(active_np, d)
                                   for d in self._data_by_dev}

        upload_active()
        dev0 = self.mesh.devices[0]
        qids = torch.arange(nq_pad, dtype=torch.int32, device=dev0)
        root_tile = {"idx": qids[:, None].contiguous(), "bm": {},
                     "alive": qids < nq}
        root_r = torch.zeros((nq_pad, prog.widths[0]), dtype=torch.int32,
                             device=dev0)
        stack: list = [
            (0, root_tile, root_r, 0, self._part_counts[s], self._parts[s])
            for s in range(S) if self._part_counts[s] > 0]
        pending: dict[int, list] = {}

        def consume(rec):
            """Fold one synced superstep record into the per-query counts;
            True once every query reached `limit`."""
            packed_np, cnt_np, ovf_np, total_np = self._unpack(rec, nq_pad)
            any_ovf = bool(ovf_np.any())
            lane_sums = [0] * nq
            for s in range(rec["n_real"]):
                if not self._walk_lane(packed_np[s], rec["exit_bounds"],
                                       rec["frontiers"][s], stack, pending):
                    continue
                if bool(ovf_np[s].any()):
                    # exact host fallback for this shard's tile, per query
                    st.leaf_overflows += 1
                    leaf_tile = rec["leaf_tile"][s]
                    terms_np = rec["terms"][s].cpu().numpy()
                    alive_np_s = leaf_tile["alive"].cpu().numpy()
                    qid_np = leaf_tile["idx"][:, 0].cpu().numpy()
                    for qi in range(nq):
                        sel = qid_np == qi
                        lane_sums[qi] += leaf_count_host(
                            singles, groups, terms_np[sel], alive_np_s[sel])
                else:
                    for qi in range(nq):
                        lane_sums[qi] += int(cnt_np[s, qi])
            for qi in range(nq):
                # the lanes' host sum is the primary count; per-lane sums
                # replace it only when a shard tripped the exact fallback
                counts[qi] += (lane_sums[qi] if any_ovf
                               else int(total_np[qi]))
            return all(c >= limit for c in counts)

        def deactivate():
            done = [qi for qi in range(nq)
                    if active_np[qi] and counts[qi] >= limit]
            if done:
                active_np[done] = False
                upload_active()

        timed_out = self._drain(stack, pending, max_steps, self.overlap,
                                deactivate, consume)
        st.bucket_recompiles = prog.compiled_supersteps - compiled_before
        return [min(c, limit) for c in counts], st, timed_out
