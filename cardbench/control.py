"""The control of a cell's comparison: the reference put in the program's
place with one stated guarantee broken, which has to come out as not
correct.

    python3 cardbench/control.py --workload <name> --seeds <n> [<n> ...]
        [--kind injective|clamp] [--seconds <s>]

For each seed it runs the cell through the harness's own `run_cell`, with
`ControlProgram` in the program's place: set-up, the window (at least one
whole pass of the pool, in the seed's order) and the check are a run's,
only the answers come from the control. `--kind injective` drops the
distinct-vertices rule (it counts homomorphisms); `--kind clamp` drops the
answer's cap at the limit. It prints one JSON line a seed with `correct`,
`wrong_answers` (the number compared, whose limit is 0), the answers and
the seconds. Needs no card: the reference and the control are NumPy on the
host, and the check runs on the host as in every run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from cardbench import reference, run  # noqa: E402
from cardbench.cell import load_cell  # noqa: E402


@dataclasses.dataclass
class _Outcome:
    count: int
    compile_s: float = 0.0
    engine: str = "control"
    stats: object = None


@dataclasses.dataclass
class ControlProgram:
    """The reference in `run.Program`'s place, with a guarantee broken."""

    index: reference.DataIndex
    queries: list
    limit: int
    kind: str                 # "injective" | "clamp"
    entry: str

    def warm(self, order, budget: int) -> None:
        pass

    def call(self, qids: list[int]) -> list:
        kw = {"injective": False} if self.kind == "injective" else \
            {"clamp": False}
        return [_Outcome(reference.count(self.index, self.queries[q],
                                         self.limit, **kw)) for q in qids]


def builder(kind: str):
    def build(cell, g, pool, device):
        return ControlProgram(index=reference.DataIndex(g), queries=pool,
                              limit=int(cell.traffic["options"]["limit"]),
                              kind=kind, entry=cell.traffic["entry"])
    return build


def run_control(cell, seed: int, kind: str, *, seconds: float = 0.0,
                cache: bool = True) -> dict:
    """One run of `cell` with the control in the program's place; the
    window holds at least one whole pass of the pool."""
    from cardbench import datasets
    t = time.time()
    g, _ = datasets.load_graph(cell.config, cache=cache)
    n_pool = len(datasets.query_pool(g, cell.traffic["pool"], cell.config))
    out = run.run_cell(cell, seed=seed, seconds=seconds, trace=False,
                       device="cpu", t_start=t, cache=cache,
                       build=builder(kind), min_queries=n_pool)
    res = out["result"]
    return {"workload": cell.name, "seed": seed, "kind": kind,
            "correct": res["correct"],
            "wrong_answers": res["compared"]["wrong_answers"]["value"],
            "limit": res["compared"]["wrong_answers"]["limit"],
            "answers": res["attempted"], "pool": n_pool,
            "window_s": out["info"]["window_s"],
            "check_s": out["info"]["check_s"],
            "seconds": time.time() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kind", choices=("injective", "clamp"),
                    default="injective",
                    help="the guarantee the control breaks: distinct "
                         "vertices, or the answer's cap at the limit")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="the window; at least one pass of the pool")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(run_control(cell, seed, args.kind,
                                     seconds=args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
