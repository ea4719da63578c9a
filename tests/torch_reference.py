"""Reference runs of `repro.core.scheduler.TileScheduler` and
`SuperbatchScheduler` for the torch port's parity tests, made in a
subprocess of their own.

The reference scheduler does `from jax.experimental import enable_x64`,
which newer JAX releases no longer have. The subprocess sets
`jax.experimental.enable_x64 = jax.enable_x64` inside itself only, so no
test worker's imports change. Run as a script it reads a JSON list of cases
from argv[1] and prints one JSON list of {"count", "timed_out", "stats"}.

A case names a workload (see WORKLOADS) plus VectorEngine keyword
arguments, and optionally `runs`: how often one engine runs the query (a
second run meets the ring buffers the first one filled); the stats are the
last run's. Both sides build the plan with `reference_plan`, which uses
only the numpy half of `repro` (no JAX).

A case with `"kind": "superbatch"` names a multi-query workload (see
BATCH_WORKLOADS), its `encoding`, `tile_rows` and `limit`, optionally
`max_steps`, `runs` and `overflow_limit` (a patched OVERFLOW_LIMIT), plus
SuperbatchScheduler keyword arguments. Its queries are bucketed as
`Matcher.match_many` buckets them (`reference_buckets`), each bucket of two
or more runs through one SuperbatchScheduler (program cache cleared first),
and the result is one {"indices", "counts", "timed_out", "stats"} per
bucket.

A case with `"kind": "sharded"` runs the reference's sharded
enumeration: a single-query case as above plus `mesh` (a lane count), and
optionally `order` and `materialize` (the result then carries the
embeddings, in the order the reference produced them); with `"batch":
true` it names a multi-query workload instead and runs each bucket through
a `ShardedSuperbatchScheduler`, as the superbatch case does. Any sharded
case makes the subprocess start with 4 forced host devices
(`--xla_force_host_platform_device_count=4`), which the reference meshes
are built over.

A case with `"kind": "matcher"` runs the reference `Matcher` on a named
workload: `call` is "count" (one query) or "match_many" (a multi-query
workload, with `batch`), `options` are MatchOptions fields. The result
is the list of {"count", "stats"} per query.

Run as `python tests/torch_reference.py chip-constants`, it prints the
reference's counters that `chip_smoke.py` holds the port to (about two
minutes on the CPU, 4 forced host devices).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from strategies import (batch_workload, brother_workload, fig1_pair,
                        random_pair)

from repro.core.graph import random_walk_query, synthetic_labeled_graph

__all__ = ["WORKLOADS", "BATCH_WORKLOADS", "workload", "port_graph",
           "reference_plan", "reference_buckets", "run_reference",
           "skewed_star", "clique6_triangle"]

# the forced host device count of every sharded reference run
HOST_DEVICES = 4

_HERE = Path(__file__).resolve().parent
_SRC = _HERE.parent / "src"


def _fig1():
    data, query = fig1_pair()
    return query, data


def _synthetic():
    """Power-law graph whose size-8 query takes many supersteps at small
    tile sizes: exercises chunking, packing, CER hits and failures."""
    data = synthetic_labeled_graph(120, 6.0, 4, seed=0, power_law=True)
    return random_walk_query(data, 8, seed=31), data


def _packing():
    """Dense graph whose overflowing frontiers come back with few live rows
    at tile_rows=8, so sibling frontiers get packed."""
    data = synthetic_labeled_graph(200, 8.0, 3, seed=4, power_law=True)
    return random_walk_query(data, 7, seed=35), data


def skewed_star():
    """(query, data): tests/test_shard_differential.py's skewed star. One
    label-0 hub fans out to 100 label-1 mids with 3 label-2 leaves each;
    with the hub as root every subtree hangs off one root candidate."""
    from repro.core.graph import build_graph
    nmid, nleaf = 100, 3
    labels = [0] + [1] * nmid + [2] * (nmid * nleaf)
    edges = [(0, 1 + i) for i in range(nmid)]
    for i in range(nmid):
        for j in range(nleaf):
            edges.append((1 + i, 1 + nmid + i * nleaf + j))
    data = build_graph(len(labels), edges, labels)
    query = build_graph(3, [(0, 1), (1, 2)], [0, 1, 2])
    return query, data


def clique6_triangle():
    """(query, data): a same-label triangle on a 6-clique, whose root
    contained-vertex threshold of 2 exceeds some shards' partitions."""
    from repro.core.graph import build_graph
    n = 6
    edges = [(i, j) for i in range(n) for j in range(i + 1, n)]
    data = build_graph(n, edges, [0] * n)
    query = build_graph(3, [(0, 1), (0, 2), (1, 2)], [0, 0, 0])
    return query, data


def _overflow_single():
    data = synthetic_labeled_graph(60, 5.0, 3, seed=2, power_law=False)
    return random_walk_query(data, 5, seed=12), data


WORKLOADS = {
    "fig1": _fig1,
    "random0": lambda: random_pair(0),
    "random1": lambda: random_pair(1),
    "random2": lambda: random_pair(2),
    "brother": brother_workload,
    "synthetic": _synthetic,
    "packing": _packing,
    "failing": lambda: random_pair(7, qsize=6),
    "random3": lambda: random_pair(3),
    "random11": lambda: random_pair(11),
    "random42": lambda: random_pair(42),
    "random1234": lambda: random_pair(1234),
    "star": skewed_star,
    "clique6": clique6_triangle,
    "overflow": _overflow_single,
}


def _union_pair():
    """all_white plans of this query have decompose boundaries and a
    no-black-bwd union stage (the batched union)."""
    data = synthetic_labeled_graph(180, 7.0, 2, seed=3)
    q = random_walk_query(data, 6, seed=301)
    return data, [q, q]


def _overflow_pair():
    data = synthetic_labeled_graph(60, 5.0, 3, seed=2, power_law=False)
    q = random_walk_query(data, 5, seed=12)
    return data, [q, q]


def _pair(query, data):
    return data, [query, query]


def _failing_pair():
    """A second run of this pair at tile_rows=16 meets the failures the
    first one recorded."""
    q, data = random_pair(7, qsize=6)
    return data, [q, q]


# multi-query workloads, (data, queries): tests/test_batch_differential.py's
# and a pair whose extensions fail
BATCH_WORKLOADS = {
    "batch1": lambda: batch_workload(seed=1, n=220, n_queries=4, dup=2),
    "batch2": lambda: batch_workload(seed=2, n=260, n_queries=3, dup=2),
    "union": _union_pair,
    "overflow": _overflow_pair,
    "failing": _failing_pair,
    # tests/test_shard_differential.py's superbatch workload
    "shard_batch": lambda: batch_workload(seed=2, n=220, n_queries=4, dup=2),
    "clique6": lambda: _pair(*clique6_triangle()),
}


def reference_buckets(name, *, encoding="cost", tile_rows=256):
    """The superbatch buckets of a multi-query workload as `match_many`
    forms them on the vector engine: [(indices, plans)] per padded shape
    signature with two or more non-empty queries, plans built by the
    reference's numpy compile path."""
    from repro.core.plan import build_plan, plan_shape_signature
    from repro.core.ref_engine import preprocess
    data, queries = BATCH_WORKLOADS[name]()
    buckets: dict = {}
    for i, q in enumerate(queries):
        cs, an = preprocess(q, data, encoding=encoding)
        if any(c.shape[0] == 0 for c in cs.cand):
            continue
        plan = build_plan(cs, an)
        sig = plan_shape_signature(plan, tile_rows=tile_rows)
        buckets.setdefault(sig, ([], []))
        buckets[sig][0].append(i)
        buckets[sig][1].append(plan)
    return [b for b in buckets.values() if len(b[0]) >= 2]


def workload(name):
    """(query, data) reference Graphs of a named workload; "batch:i" is
    query i of the multi-query workload "batch"."""
    if ":" in name:
        batch, i = name.split(":")
        data, queries = BATCH_WORKLOADS[batch]()
        return queries[int(i)], data
    return WORKLOADS[name]()


def port_graph(g):
    """The same graph as a `repro_torch.core.graph.Graph`."""
    from repro_torch.core.graph import Graph
    return Graph(**{f.name: getattr(g, f.name)
                    for f in dataclasses.fields(Graph)})


def reference_plan(name, *, encoding="cost", order=None):
    """(cs, an, plan) of a named workload, built by the reference's numpy
    compile path."""
    from repro.core.plan import build_plan
    from repro.core.ref_engine import preprocess
    query, data = workload(name)
    cs, an = preprocess(query, data, encoding=encoding,
                        order=None if order is None else list(order))
    return cs, an, build_plan(cs, an)


def _run_cases(cases):
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.core.engine import VectorEngine

    out = []
    for case in cases:
        case = dict(case)
        kind = case.pop("kind", None)
        if kind == "superbatch":
            out.append(_run_superbatch(case))
            continue
        if kind == "stack":
            out.append(_run_stack(case))
            continue
        if kind == "sharded":
            out.append(_run_sharded(case))
            continue
        if kind == "matcher":
            out.append(_run_matcher(case))
            continue
        name = case.pop("workload")
        limit = case.pop("limit", 10 ** 9)
        encoding = case.pop("encoding", "cost")
        runs = case.pop("runs", 1)
        cs, an, plan = reference_plan(name, encoding=encoding)
        eng = VectorEngine(cs, an, plan=plan, **case)
        for _ in range(runs):
            res = eng.run(limit=limit)
        out.append({"count": res.count, "timed_out": res.timed_out,
                     "stats": dataclasses.asdict(res.stats)})
    return out


def _run_superbatch(case, mesh=None):
    import repro.core.scheduler as sched
    from repro.core.shard import ShardedSuperbatchScheduler
    name = case.pop("workload")
    encoding = case.pop("encoding", "cost")
    limit = case.pop("limit", 10 ** 9)
    max_steps = case.pop("max_steps", None)
    runs = case.pop("runs", 1)
    saved = sched.OVERFLOW_LIMIT
    sched.OVERFLOW_LIMIT = case.pop("overflow_limit", saved)
    sched._PROGRAMS.clear()
    try:
        out = []
        for indices, plans in reference_buckets(
                name, encoding=encoding,
                tile_rows=case.get("tile_rows", 256)):
            sb = (sched.SuperbatchScheduler(plans, **case) if mesh is None
                  else ShardedSuperbatchScheduler(plans, mesh=mesh, **case))
            for _ in range(runs):
                counts, st, timed_out = sb.run(limit=limit,
                                               max_steps=max_steps)
            out.append({"indices": indices, "counts": counts,
                        "timed_out": timed_out,
                        "stats": dataclasses.asdict(st)})
        return out
    finally:
        sched.OVERFLOW_LIMIT = saved
        sched._PROGRAMS.clear()


def _run_sharded(case):
    """A sharded case (see the module docstring) on a reference mesh of
    `mesh` of the forced host devices."""
    import repro.core.scheduler as sched
    from repro.core.engine import VectorEngine
    from repro.launch.mesh import make_enum_mesh
    mesh = make_enum_mesh(case.pop("mesh"))
    assert mesh is not None and len(mesh.devices.flat) > 1, mesh
    if case.pop("batch", False):
        return _run_superbatch(case, mesh=mesh)
    name = case.pop("workload")
    limit = case.pop("limit", 10 ** 9)
    encoding = case.pop("encoding", "cost")
    order = case.pop("order", None)
    runs = case.pop("runs", 1)
    max_steps = case.pop("max_steps", None)
    materialize = case.pop("materialize", False)
    saved = sched.OVERFLOW_LIMIT
    sched.OVERFLOW_LIMIT = case.pop("overflow_limit", saved)
    try:
        cs, an, plan = reference_plan(name, encoding=encoding, order=order)
        eng = VectorEngine(cs, an, plan=plan, mesh=mesh, **case)
        for _ in range(runs):
            res = eng.run(limit=limit, max_steps=max_steps,
                          materialize=materialize)
    finally:
        sched.OVERFLOW_LIMIT = saved
    out = {"count": res.count, "timed_out": res.timed_out,
           "stats": dataclasses.asdict(res.stats)}
    if materialize:
        out["embeddings"] = [sorted(e.items()) for e in res.embeddings]
    return out


def _run_matcher(case):
    """A reference Matcher call on a named workload (see the module
    docstring)."""
    from repro.api import Dataset, Matcher, MatchOptions
    opts = MatchOptions(**case.get("options", {}))
    if case["call"] == "count":
        query, data = workload(case["workload"])
        outs = [Matcher(Dataset.from_graph(data)).count(query, opts)]
    else:
        data, queries = BATCH_WORKLOADS[case["workload"]]()
        outs = Matcher(Dataset.from_graph(data)).match_many(
            queries, opts, batch=case.get("batch", "auto"))
    return [{"count": o.count, "stats": dataclasses.asdict(o.stats)}
            for o in outs]


def _run_stack(case):
    """The reference's stack_batch_inputs of each bucket, as lists of the
    uint32 words and int32 thresholds."""
    from repro.core.plan import _pow2ceil, plan_shape_signature
    from repro.core.scheduler import stack_batch_inputs
    tile_rows = case.get("tile_rows", 256)
    out = []
    for _indices, plans in reference_buckets(
            case["workload"], encoding=case.get("encoding", "cost"),
            tile_rows=tile_rows):
        sig = plan_shape_signature(plans[0], tile_rows=tile_rows)
        data = stack_batch_inputs(sig, plans, _pow2ceil(len(plans)))
        out.append({
            "tables": {k: np.asarray(v).tolist()
                       for k, v in data["tables"].items()},
            "mask_root": np.asarray(data["mask_root"]).tolist(),
            "con": {k: np.asarray(v).tolist()
                    for k, v in data["con"].items()}})
    return out


def run_reference(cases, *, timeout=600):
    """Run `cases` through the reference scheduler in one subprocess."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_SRC), str(_HERE)] + ([env["PYTHONPATH"]]
                                   if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    if any(c.get("kind") in ("sharded", "matcher") for c in cases):
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_"
                            f"platform_device_count={HOST_DEVICES}").strip()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           json.dumps(cases)], capture_output=True, text=True,
                          env=env, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference run failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


# chip_smoke.py's superbatch mix on synthetic dblp at scale 1.0, as
# (query size, seed), and its compat-route counts, as (dataset, scale,
# size); every compat query is random_query(size, seed=7)
CHIP_MIX = [(4, 2), (4, 3), (4, 4), (4, 8), (4, 9), (8, 7), (8, 7), (3, 1)]
CHIP_COMPAT = [("dblp", 1.0, 8), ("human", 1.0, 8), ("dblp", 0.02, 8)]
CHIP_STATS = ("supersteps", "leaf_tiles", "packed_tiles", "cer_hits",
              "fail_hits", "bucket_recompiles")
CHIP_COMPAT_STATS = ("bucketed_tiles", "dedup_unique", "device_steps")
# chip_smoke.py's sharded phase: its dblp scale-1.0 queries (size, seed 7)
# and the skewed star (tile_rows 16, all_black, order (0, 1, 2)) at these
# lane counts, and the mix's five-query bucket at 4 lanes
CHIP_SHARD_SIZES = (8, 16)
CHIP_SHARD_LANES = (2, 4)
CHIP_SHARD_SB_LANES = 4


def chip_constants():
    """The reference's counters on chip_smoke.py's superbatch mix (one
    SuperbatchScheduler per bucket of two or more, default options,
    limit 1,000,000), compat counts (`use_cer_buffer=False`) and sharded
    runs (every VectorStats field of a ShardedTileScheduler on each
    CHIP_SHARD_SIZES query and the skewed star, and of a
    ShardedSuperbatchScheduler on the mix's first bucket, over meshes of
    the forced host devices)."""
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.api import Dataset, Matcher
    from repro.core.engine import VectorEngine
    from repro.core.plan import plan_shape_signature
    from repro.core.scheduler import SuperbatchScheduler, _PROGRAMS

    limit = 1_000_000
    m = Matcher(Dataset.synthetic("dblp", scale=1.0))
    buckets: dict = {}
    for i, (size, seed) in enumerate(CHIP_MIX):
        cq = m.compile(m.dataset.random_query(size=size, seed=seed))
        sig = plan_shape_signature(cq.plan, tile_rows=256)
        buckets.setdefault(sig, []).append((i, cq.plan))
    _PROGRAMS.clear()
    mix = []
    for items in buckets.values():
        if len(items) < 2:
            mix.append({"indices": [i for i, _ in items]})
            continue
        counts, st, _ = SuperbatchScheduler(
            [p for _, p in items]).run(limit=limit)
        mix.append({"indices": [i for i, _ in items], "counts": counts,
                    **{k: getattr(st, k) for k in CHIP_STATS}})
    compat = []
    for name, scale, size in CHIP_COMPAT:
        mm = Matcher(Dataset.synthetic(name, scale=scale))
        cq = mm.compile(mm.dataset.random_query(size=size, seed=7))
        res = VectorEngine(cq.cs, cq.an, plan=cq.plan, intersect="jnp",
                           use_cer_buffer=False).run(limit=limit)
        compat.append({"workload": [name, scale, size], "count": res.count,
                       **{k: getattr(res.stats, k)
                          for k in CHIP_COMPAT_STATS}})
    return {"mix": mix, "compat": compat,
            "sharded": _chip_sharded(m, buckets, limit)}


def _chip_sharded(m, buckets, limit):
    from repro.core.engine import VectorEngine
    from repro.core.ref_engine import preprocess
    from repro.core.scheduler import _PROGRAMS
    from repro.core.shard import ShardedSuperbatchScheduler
    from repro.launch.mesh import make_enum_mesh

    def run(cs, an, plan, lanes, **kw):
        res = VectorEngine(cs, an, plan=plan, mesh=make_enum_mesh(lanes),
                           **kw).run(limit=limit)
        return {"count": res.count, "stats": dataclasses.asdict(res.stats)}

    out = {"dblp": {}, "star": {}}
    for size in CHIP_SHARD_SIZES:
        cq = m.compile(m.dataset.random_query(size=size, seed=7))
        out["dblp"][str(size)] = {
            str(s): run(cq.cs, cq.an, cq.plan, s) for s in CHIP_SHARD_LANES}
    query, data = skewed_star()
    cs, an = preprocess(query, data, encoding="all_black", order=[0, 1, 2])
    from repro.core.plan import build_plan
    plan = build_plan(cs, an)
    out["star"] = {str(s): run(cs, an, plan, s, tile_rows=16)
                   for s in CHIP_SHARD_LANES}
    items = next(v for v in buckets.values() if len(v) >= 5)
    _PROGRAMS.clear()
    counts, st, _ = ShardedSuperbatchScheduler(
        [p for _, p in items],
        mesh=make_enum_mesh(CHIP_SHARD_SB_LANES)).run(limit=limit)
    out["superbatch"] = {"indices": [i for i, _ in items], "counts": counts,
                         "stats": dataclasses.asdict(st)}
    return out


if __name__ == "__main__":
    if sys.argv[1] == "chip-constants":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_"
            f"device_count={HOST_DEVICES}").strip()
        print(json.dumps(chip_constants()))
    else:
        print(json.dumps(_run_cases(json.loads(sys.argv[1]))))
