"""End-to-end CEMR serving driver on the torch port: a query workload (the
paper's experimental protocol, §7.1.2) through the fault-tolerant
work-queue runtime, on the card unless `--device cpu` is given.

  PYTHONPATH=src python examples/torch_match_queries.py --n-queries 50 \\
      --scale 0.05
  PYTHONPATH=src python examples/torch_match_queries.py --device cpu

The queue checkpoints every 8 queries to `--state-path` (default: a file
of its own in the temporary directory).
"""
import argparse
import os
import tempfile
import time

from repro_torch.api import Dataset
from repro_torch.device import resolve_device
from repro_torch.runtime.queue import MatchQueueRuntime

DEFAULT_STATE = os.path.join(tempfile.gettempdir(),
                             "repro_torch_match_queries.json")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="yeast")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--n-queries", type=int, default=20)
    ap.add_argument("--query-size", type=int, default=6)
    ap.add_argument("--limit", type=int, default=100_000)
    ap.add_argument("--engine", default="vector",
                    choices=["ref", "vector", "auto"])
    ap.add_argument("--state-path", default=DEFAULT_STATE,
                    help="the queue's checkpoint file")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the card; without one, "
                         "an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    dataset = Dataset.synthetic(args.dataset, scale=args.scale)
    print(f"data graph: {dataset!r} on {dev}")
    queries = [dataset.random_query(args.query_size, seed=s)
               for s in range(args.n_queries)]

    rt = MatchQueueRuntime(dataset, engine=args.engine, tile_rows=2048,
                           state_path=args.state_path, device=dev)
    rt.submit(queries, limit=args.limit)
    t0 = time.time()
    results = rt.run(checkpoint_every=8)
    dt = time.time() - t0
    total = sum(c for c in results.values() if c)
    print(f"{len(results)} queries in {dt:.2f}s — {total} embeddings")
    print(f"runtime stats: {rt.stats}")
    print(f"plan cache: {rt.matcher.cache_info()}")
    return {"device": str(dev), "results": results, "seconds": dt,
            "embeddings": total, "stats": dict(rt.stats),
            "cache_info": rt.matcher.cache_info(), "limit": args.limit,
            "dataset": dataset, "queries": queries, "matcher": rt.matcher}


if __name__ == "__main__":
    main()
