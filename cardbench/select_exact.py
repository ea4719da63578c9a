"""Find random-walk queries whose embeddings number under a limit.

    python3 cardbench/select_exact.py --config dblp_synth --sizes 16 8 4
        --want 8 [--limit 100000] [--first-seed 500000] [--seconds 300]
        [--distinct-matters]

Draws queries as a traffic pool does (`datasets.random_walk_query`, seed
first_seed + 1000 * size + i for i = 0, 1, ...) and counts each with the
plain reference, stopping a count at the limit; prints one JSON line a
size with the seeds whose count came out under the limit (so the answer is
an exact count, not the cap) and the counts; with `--distinct-matters`
only those whose count changes when the distinct-vertices rule is dropped
(two query vertices of one label that can meet). The configuration lists such
pairs [size, seed] under `exact`, and a traffic mix with `pool.exact`
adds those of its sizes to its pool, so that its comparison sees every
embedding of those queries. Host only; the graph is generated (or read
from the cache) as a run does.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from cardbench import datasets, reference  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--sizes", type=int, nargs="+", required=True)
    ap.add_argument("--want", type=int, required=True)
    ap.add_argument("--limit", type=int, default=100_000)
    ap.add_argument("--first-seed", type=int, default=500_000)
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--query-seconds", type=int, default=5,
                    help="skip a query whose count takes longer")
    ap.add_argument("--scale", type=float, default=None,
                    help="a smaller graph than the configuration's")
    ap.add_argument("--distinct-matters", action="store_true",
                    help="keep only queries whose count changes when the "
                         "distinct-vertices rule is dropped")
    args = ap.parse_args(argv)
    cfg = json.loads((_ROOT / "cardbench" / "configs"
                      / f"{args.config}.json").read_text())
    if args.scale is not None:
        cfg["scale"] = args.scale

    def too_slow(*_):
        raise TimeoutError
    signal.signal(signal.SIGALRM, too_slow)
    g, _ = datasets.load_graph(cfg, cache=args.scale is None)
    d = reference.DataIndex(g)
    for size in args.sizes:
        t0 = time.perf_counter()
        found, tried = [], 0
        while len(found) < args.want and \
                time.perf_counter() - t0 < args.seconds:
            seed = args.first_seed + 1000 * size + tried
            tried += 1
            q = datasets.random_walk_query(g, size, seed)
            signal.alarm(args.query_seconds)
            try:
                c = reference.count(d, q, args.limit)
            except TimeoutError:
                continue
            finally:
                signal.alarm(0)
            if c < args.limit and args.distinct_matters:
                signal.alarm(args.query_seconds)
                try:
                    if reference.count(d, q, args.limit,
                                       injective=False) == c:
                        continue
                except TimeoutError:
                    pass          # slower without the rule: it matters
                finally:
                    signal.alarm(0)
            if c < args.limit:
                found.append([seed, c])
        print(json.dumps({"config": args.config, "size": size,
                          "tried": tried, "found": found,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
