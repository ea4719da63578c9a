"""Reference runs of `repro.core.scheduler.TileScheduler` for the torch
port's parity tests, made in a subprocess of their own.

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
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

from strategies import brother_workload, fig1_pair, random_pair

from repro.core.graph import random_walk_query, synthetic_labeled_graph

__all__ = ["WORKLOADS", "workload", "port_graph", "reference_plan",
           "run_reference"]

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


WORKLOADS = {
    "fig1": _fig1,
    "random0": lambda: random_pair(0),
    "random1": lambda: random_pair(1),
    "random2": lambda: random_pair(2),
    "brother": brother_workload,
    "synthetic": _synthetic,
    "packing": _packing,
    "failing": lambda: random_pair(7, qsize=6),
}


def workload(name):
    """(query, data) reference Graphs of a named workload."""
    return WORKLOADS[name]()


def port_graph(g):
    """The same graph as a `repro_torch.core.graph.Graph`."""
    from repro_torch.core.graph import Graph
    return Graph(**{f.name: getattr(g, f.name)
                    for f in dataclasses.fields(Graph)})


def reference_plan(name, *, encoding="cost"):
    """(cs, an, plan) of a named workload, built by the reference's numpy
    compile path."""
    from repro.core.plan import build_plan
    from repro.core.ref_engine import preprocess
    query, data = workload(name)
    cs, an = preprocess(query, data, encoding=encoding)
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


def run_reference(cases, *, timeout=600):
    """Run `cases` through the reference scheduler in one subprocess."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_SRC), str(_HERE)] + ([env["PYTHONPATH"]]
                                   if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           json.dumps(cases)], capture_output=True, text=True,
                          env=env, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference run failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    print(json.dumps(_run_cases(json.loads(sys.argv[1]))))
