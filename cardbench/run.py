"""Run one cell of the port's benchmark once and print its result line.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads` entry) names a configuration
(`cardbench/configs/<name>.json`: a data graph) and a traffic mix
(`cardbench/traffic/<name>.json`: the entry, the query pool, the options).
Set-up loads the data graph (generated once per checkout and cached under
`cardbench/.cache/`), preprocesses it into a `repro_torch.api.Dataset`,
compiles the pool's plans and runs each query once under a small step
budget, so that every kernel, plan and table is built before the window
(the port builds its kernels under the checkout's `build/`). `--seed`
draws the order in which the pool is replayed (`datasets.replay_order`:
each size's queries shuffled, the sizes spread evenly through a pass). The
window is a closed loop of one client: a call starts when the previous one
returned, and the window closes when the call in flight at `--seconds`
returns.

With `--trace 0` the result's metrics are the cell's end-to-end metrics;
with `--trace 1` the per-layer metrics, read by `cardbench/metrics/*.py`
from the window's counters and from a `torch.profiler` trace of a slice of
calls made after the window (the traffic's `trace_calls`: a number of
calls, or "pool" for one call a query of the pool). Then the program's
state is freed and every answer of the window is compared with the plain
reference (`cardbench/reference.py`); each number compared is printed
beside its limit on the last lines of standard error and under the
result's last key. The result is the last line of standard output.
Exits non-zero, with no result, without enough CUDA devices, or when JAX
or the JAX package has been imported.
"""
from __future__ import annotations

import time

T_START = time.time()     # set-up is counted from here, before any import

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
_ROOT = Path(__file__).resolve().parents[1]
for _p in (_ROOT / "src", _ROOT):      # the port, and this harness
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import numpy as np  # noqa: E402

from cardbench import datasets, reference  # noqa: E402
from cardbench.cell import Cell, load_cell  # noqa: E402
from cardbench.trace import CALL_SPAN, raw_events, reduce_trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def _card_line(n: int) -> str:
    fields = "name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return " | ".join(out.stdout.strip().splitlines()[:n])


@dataclasses.dataclass
class Program:
    """The system under test, built by set-up and driven by the window."""

    matcher: object
    queries: list             # the pool, as the port's Graph objects
    options: object           # MatchOptions of the timed calls
    entry: str                # "count" | "match_many"
    batch: str | None

    def warm(self, order, budget: int) -> None:
        """Compile every plan of the pool and run each query under a small
        step budget: plans, engines, device tables and kernels are built."""
        opts = self.options.replace(budget=budget)
        if self.entry == "count":
            for q in order:
                self.matcher.count(self.queries[int(q)], opts)
        else:
            self.matcher.match_many([self.queries[int(q)] for q in order],
                                    opts, batch=self.batch)

    def call(self, qids: list[int]) -> list:
        """One call of the entry; one outcome (or None) per query id."""
        if self.entry == "count":
            return [self.matcher.count(self.queries[qids[0]], self.options)]
        outs = self.matcher.match_many([self.queries[i] for i in qids],
                                       self.options, batch=self.batch)
        return list(outs)[:len(qids)]


def build_program(cell: Cell, g, pool, device) -> Program:
    from repro_torch.api import Dataset, MatchOptions, Matcher
    from repro_torch.core.graph import Graph

    def port_graph(c):
        return Graph(labels=c.labels, indptr=c.indptr, indices=c.indices,
                     n_labels=c.n_labels)

    t = cell.traffic
    ds = Dataset.from_graph(port_graph(g), name=cell.config["name"])
    opts = MatchOptions(**t["options"])
    m = Matcher(ds, opts, device=device,
                plan_cache_size=max(128, 2 * len(pool)))
    return Program(matcher=m, queries=[port_graph(q) for q in pool],
                   options=opts, entry=t["entry"], batch=t.get("batch"))


def _calls(cell: Cell, order: np.ndarray):
    """The window's calls, as lists of pool indices, in the seed's order."""
    if cell.traffic["entry"] == "count":
        i = 0
        while True:
            yield [int(order[i % order.shape[0]])]
            i += 1
    while True:
        yield [int(q) for q in order]


class Tally:
    """What the window's calls returned: answers by query, latencies, and
    the sums of the program's own counters."""

    def __init__(self):
        self.answers: list[tuple[int, int | None]] = []
        self.latencies: list[float] = []
        self.ends: list[float] = []       # perf_counter at each call's return
        self.compile_s = 0.0
        self.stats: dict[str, int] = {}
        self.engines: dict[str, int] = {}

    def add(self, qids, outs, latency: float) -> None:
        self.latencies.append(latency)
        seen = set()
        for j, q in enumerate(qids):
            out = outs[j] if j < len(outs) else None
            self.answers.append((q, None if out is None else int(out.count)))
            if out is None:
                continue
            self.compile_s += float(out.compile_s)
            self.engines[out.engine] = self.engines.get(out.engine, 0) + 1
            st = out.stats
            if id(st) in seen or not hasattr(st, "supersteps"):
                continue
            seen.add(id(st))      # a superbatch bucket shares one stats
            for f in dataclasses.fields(st):
                v = getattr(st, f.name)
                if isinstance(v, int):
                    self.stats[f.name] = self.stats.get(f.name, 0) + v

    @property
    def queries(self) -> int:
        return len(self.answers)


def _sync(devices) -> None:
    import torch
    for d in devices:
        torch.cuda.synchronize(d)


def run_window(prog: Program, calls, seconds: float, devices,
               min_queries: int = 0) -> tuple:
    """Calls until `seconds` have passed and `min_queries` answers came."""
    tally = Tally()
    t0 = time.perf_counter()
    while True:
        qids = next(calls)
        t = time.perf_counter()
        outs = prog.call(qids)
        tally.add(qids, outs, time.perf_counter() - t)
        tally.ends.append(time.perf_counter() - t0)
        if time.perf_counter() - t0 >= seconds and \
                tally.queries >= min_queries:
            break
    _sync(devices)
    return tally, time.perf_counter() - t0


def rate_by_slice(tally: Tally, slice_s: float = 5.0) -> list[float]:
    """Queries returned in each `slice_s` of the window, over `slice_s`:
    whether a slow run is slow throughout or stood still for a while."""
    per_call = len(tally.answers) // max(1, len(tally.ends))
    n = int(max(tally.ends, default=0.0) // slice_s) + 1
    counts = [0] * n
    for e in tally.ends:
        counts[int(e // slice_s)] += per_call
    return [c / slice_s for c in counts]


def host_calibration(devices) -> dict:
    """Seconds of a fixed pure-Python loop, microseconds a small CPU torch
    op and, with a card, the host's microseconds a launch of a small CUDA
    op: the host's own speed at the time, beside the window's rate."""
    import torch
    t = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    py_s = time.perf_counter() - t
    a = torch.ones(8)
    t = time.perf_counter()
    for _ in range(20_000):
        a = a + 1
    op_us = (time.perf_counter() - t) / 20_000 * 1e6
    out = {"python_loop_s": py_s, "cpu_torch_op_us": op_us}
    if devices:
        a = torch.ones(8, device=devices[0])
        _sync(devices)
        t = time.perf_counter()
        for _ in range(20_000):
            a.add_(1)
        _sync(devices)
        out["cuda_launch_us"] = (time.perf_counter() - t) / 20_000 * 1e6
        del a
    return out


def traced_slice(prog: Program, calls, n_calls: int, devices) -> tuple:
    """`n_calls` calls under torch.profiler, after one warm-up step of the
    profiler's own; returns the slice's tally and the trace's reduction."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    acts = [ProfilerActivity.CPU]
    if devices:
        acts.append(ProfilerActivity.CUDA)
    tally = Tally()
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=n_calls, repeat=1)) as prof:
        for j in range(n_calls + 1):
            qids = next(calls)
            t = time.perf_counter()
            with record_function(CALL_SPAN):
                outs = prog.call(qids)
                _sync(devices)
            if j:
                tally.add(qids, outs, time.perf_counter() - t)
            prof.step()
    t = time.perf_counter()
    red = reduce_trace(raw_events(prof), devices=[d.index for d in devices])
    red["reduce_s"] = time.perf_counter() - t
    del prof
    if devices:
        torch.cuda.empty_cache()
    return tally, red


def check_answers(g, pool, answers, limit: int) -> dict:
    """Every answer of the window against the reference's count of its
    query; an answer that never came counts as wrong."""
    t = time.perf_counter()
    d = reference.DataIndex(g)
    index_s = time.perf_counter() - t
    want, slowest = {}, []
    for q in sorted({q for q, _ in answers}):
        tq = time.perf_counter()
        want[q] = reference.count(d, pool[q], limit)
        slowest.append((time.perf_counter() - tq, q))
    wrong = sum(1 for q, c in answers if c != want[q])
    return {"wrong": wrong, "queries_checked": len(want),
            "seconds": time.perf_counter() - t, "index_s": index_s,
            "slowest": sorted(slowest, reverse=True)[:5], "want": want}


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device, t_start: float, cache: bool = True,
             build=build_program, min_queries: int = 0) -> dict:
    """Set up, run the window (and with `trace` the profiled slice), check
    the answers; return the result line's fields and the check's. `build`
    makes what the window drives (the control puts the reference in the
    program's place through it); the window lasts `seconds` and at least
    `min_queries` answers."""
    import torch
    dev = torch.device(device)
    devices = ([torch.device("cuda", i) for i in range(cell.chips)]
               if dev.type == "cuda" else [])
    t = cell.traffic
    limit = int(t["options"]["limit"])
    if limit != int(cell.config.get("limit", limit)):
        raise ValueError(f"the traffic's limit {limit} is not the "
                         f"configuration's {cell.config['limit']}")
    g, cached = datasets.load_graph(cell.config, cache=cache)
    pool = datasets.query_pool(g, t["pool"], cell.config)
    order = datasets.replay_order(datasets.pool_sizes(pool), seed)
    prog = build(cell, g, pool, dev)
    prog.warm(order, int(t["warm_budget"]))
    _sync(devices)
    gc.collect()
    gc.freeze()
    calls = _calls(cell, order)
    setup_s = time.time() - t_start
    tally, elapsed = run_window(prog, calls, seconds, devices, min_queries)
    card_after = _card_line(cell.chips) if devices else ""
    host = host_calibration(devices)
    record = {"entry": prog.entry, "window_s": elapsed,
              "queries": tally.queries, "calls": len(tally.latencies),
              "latencies_s": tally.latencies, "compile_s": tally.compile_s,
              "stats": tally.stats, "trace": None}
    if trace:
        n = len(pool) if t["trace_calls"] == "pool" else int(t["trace_calls"])
        sl, red = traced_slice(prog, calls, n, devices)
        red.update(queries=sl.queries, stats=sl.stats)
        record["trace"] = red
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
               default=0)
    answers = tally.answers
    del prog, calls
    gc.unfreeze()
    gc.collect()
    if devices:
        torch.cuda.empty_cache()
    chk = check_answers(g, pool, answers, limit)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"device_peak_gib": peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if devices else "cpu",
                   "kind": (torch.cuda.get_device_name(devices[0])
                            if devices else "cpu"),
                   "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"correct": chk["wrong"] == 0,
              "attempted": len(answers), "failed": chk["wrong"],
              "metrics": metrics, "device": device_info}
    if trace and record["trace"]:
        tr = record["trace"]
        if devices:
            device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["compared"] = {"wrong_answers": {"value": chk["wrong"],
                                            "limit": 0}}
    info = {"cell": cell.name, "seed": seed, "cached_graph": cached,
            "setup_s": setup_s, "window_s": elapsed,
            "queries": tally.queries, "calls": len(tally.latencies),
            "rate_by_5s": rate_by_slice(tally), "host_after_window": host,
            "card_after_window": card_after,
            "engines": tally.engines,
            "batched_queries": tally.stats.get("batched_queries", 0),
            "stats": tally.stats,
            "check_s": chk["seconds"], "check_index_s": chk["index_s"],
            "check_slowest": chk["slowest"],
            "call_s_by_query": _by_query(tally),
            "queries_checked": chk["queries_checked"],
            "exact_by_size": _exact_by_size(pool, chk["want"], limit),
            "counts": {str(q): c for q, c in chk["want"].items()}}
    if trace and record["trace"]:
        info["trace_reduce_s"] = record["trace"]["reduce_s"]
        info["trace_window_s"] = record["trace"]["window_s"]
        info["trace_queries"] = record["trace"]["queries"]
    return {"result": result, "info": info}


def _exact_by_size(pool, want: dict, limit: int) -> dict:
    """How many of the checked queries of each size have an exact count
    (fewer embeddings than the limit), against how many were checked."""
    out: dict[str, list[int]] = {}
    for q, c in want.items():
        k = out.setdefault(str(pool[q].n), [0, 0])
        k[0] += c < limit
        k[1] += 1
    return dict(sorted(out.items(), key=lambda kv: int(kv[0])))


def _by_query(tally: Tally) -> dict:
    """Mean call seconds by query id (calls of one query each)."""
    if not tally.answers or len(tally.answers) != len(tally.latencies):
        return {}
    sums: dict[int, list[float]] = {}
    for (q, _), lat in zip(tally.answers, tally.latencies):
        sums.setdefault(q, []).append(lat)
    return {str(q): sum(v) / len(v) for q, v in sorted(sums.items())}


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"cardbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(f"card: {_card_line(cell.chips)}", flush=True)
    out = run_cell(cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"cardbench: the process imported {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print("info: " + json.dumps(out["info"]), flush=True)
    for name, c in out["result"]["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
