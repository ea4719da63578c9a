"""The bitmap kernels' shapes at each paper dataset, computed on the CPU.

    PYTHONPATH=src python3 plan_widths.py [--scale 1.0] [--datasets ...]

Compiles the port's plan (numpy, no card) for `random_query(size=8,
seed=7)` on each synthetic paper dataset and prints one JSON line per
dataset: the widest extend (the most gathered words, k tables of W uint32
words), its tables' row counts, and the bytes of all the plan's tables,
which is what must sit in the card's 50 MB L2 for the kernels' gathers to
stay there. These are sizes, not times.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

DATASETS = ("dblp", "youtube", "wordnet", "eu2005")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--datasets", nargs="+", default=list(DATASETS))
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import api

    for name in args.datasets:
        t0 = time.perf_counter()
        ds = api.Dataset.synthetic(name, scale=args.scale)
        m = api.Matcher(ds, device="cpu")
        plan = m.compile(ds.random_query(size=8, seed=7)).plan
        ops = [op for op in plan.ops if op.bk_pairs]
        op = max(ops, key=lambda o: (len(o.bk_pairs) * o.n_words, o.level))
        rows = [int(plan.tables[u, op.vertex].shape[0])
                for (_, u) in op.bk_pairs]
        print(json.dumps({
            "dataset": name, "scale": args.scale, "query_size": 8,
            "vertices": ds.n, "edges": ds.n_edges,
            "widest_extend": {"k": len(op.bk_pairs), "W": op.n_words,
                              "table_rows": rows},
            "all_tables_bytes": int(sum(t.nbytes
                                        for t in plan.tables.values())),
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
