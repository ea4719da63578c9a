"""Serving launcher of the port: batched greedy LM decode, BERT4Rec
scoring, and subgraph-match query serving through the `api` session layer
and the `runtime` service.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --tokens 16 --batch 4                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b \\
      --device cpu          # any LM id of configs/registry.py: qwen2-1.5b,
                            # chatglm3-6b, minicpm3-4b, qwen3-moe-30b-a3b,
                            # granite-moe-3b-a800m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch bert4rec \\
      --shape serve_p99                     # top-10 items a history
  PYTHONPATH=src python -m repro_torch.launch.serve --arch match \\
      --dataset yeast --scale 0.05 --n-queries 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch match \\
      --serve-loop --dataset yeast --qps 50 --n-queries 64 --workers 2

`main` serves the reduced LM config, as the reference's launcher does;
`decode_loop` serves any bundle, full width included (`chip_smoke.py`).
`--arch bert4rec` scores one batch of `--shape` (serve_p99 unless given:
the reduced config's 8 histories) through the bundle's serve step, as the
reference's recsys branch does. The GNN ids only train.
LM decode and bert4rec scoring run under `make_local_mesh()` and the
policy's decode or serve rules, as the reference's launcher runs them; in
one process the mesh is (1, 1), which leaves every tensor plain.
`--arch match` is a closed-loop batch: all queries exist up front and
`match_many` drains them as one superbatch (`serve_match`). `--serve-loop`
runs the always-on `MatchService` open loop instead (`serve_match_loop`):
requests arrive on a seeded Poisson schedule at --qps whatever the
completions, pass admission control, and are bucketed deadline-aware; with
`--workers N` buckets run on N spawned worker processes. See
docs/serving.md. Everything runs on the card unless given `--device cpu`.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch.models.api import ModelBundle, build_bundle

__all__ = ["decode_loop", "serve_recsys", "serve_match", "serve_match_loop",
           "parse_args", "main"]


def decode_loop(bundle: ModelBundle, model, *, batch: int,
                tokens: int) -> dict:
    """Greedy decode of `tokens` tokens for `batch` rows on the bundle's
    device, from token 1 and empty float32 caches of `tokens + 8`
    positions, as the reference's launcher has them. Returns the tokens
    (tokens, batch), the wall time, tokens/s and ms per step."""
    dev = bundle.device
    step = bundle.steps["decode"]
    caches = bundle.init_caches(batch, tokens + 8, dtype=torch.float32)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
    token = torch.ones((batch,), dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = []
    for _ in range(tokens):
        logits, caches = step(model, caches,
                              {"token": token, "lengths": lengths})
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        lengths = lengths + 1
        out.append(token)
    out = torch.stack(out).cpu()                 # waits for the device
    dt = time.perf_counter() - t0
    return {"tokens": out, "seconds": dt,
            "tokens_per_s": tokens * batch / dt,
            "ms_per_step": dt / tokens * 1e3}


def serve_recsys(bundle: ModelBundle, shape: str, *,
                 place=lambda model: model) -> dict:
    """Score one batch of `shape`'s inputs (seed 0) through the bundle's
    serve step, random weights from seed 0 (given to `place`, which may
    distribute them), and print the reference launcher's line. Returns
    the top-k values and indices and the wall seconds."""
    model = place(bundle.init_fn(0))
    batch = bundle.make_inputs(shape)
    t0 = time.perf_counter()
    vals, idx = bundle.steps["serve"](model, batch)
    vals, idx = vals.cpu(), idx.cpu()           # waits for the device
    dt = time.perf_counter() - t0
    print(f"scored batch {tuple(batch['ids'].shape)} → top10 "
          f"{tuple(idx.shape)} on {bundle.device} in {dt * 1e3:.1f} ms")
    return {"values": vals, "indices": idx, "seconds": dt}


def serve_match(args) -> dict:
    """Match-query serving: one Dataset preprocessed at startup, a Matcher
    with a warm plan cache serving the query stream (each distinct query
    shape compiles once; repeats are cache hits). Prints the reference
    launcher's summary plus the per-query counts; returns the counts,
    engines, wall seconds, cache info, dataset and queries."""
    from repro_torch.api import Dataset, MatchOptions, Matcher

    dataset = Dataset.synthetic(args.dataset, scale=args.scale)
    matcher = Matcher(dataset, MatchOptions(engine=args.engine,
                                            limit=args.limit),
                      device=args.device)
    queries = [dataset.random_query(args.query_size, seed=s)
               for s in range(args.n_queries)]
    t0 = time.perf_counter()
    outs = matcher.match_many(queries)
    if matcher.device.type == "cuda":
        torch.cuda.synchronize(matcher.device)
    dt = time.perf_counter() - t0
    total = sum(o.count for o in outs)
    info = matcher.cache_info()
    engines = {e: sum(1 for o in outs if o.engine == e)
               for e in ("ref", "vector")}
    print(f"served {len(outs)} queries against {dataset!r} on "
          f"{matcher.device} in {dt:.2f}s ({len(outs) / dt:.1f} qps) — "
          f"{total} embeddings")
    print(f"engines: {engines} plan cache: hits={info.hits} "
          f"misses={info.misses}")
    print(f"counts: {[o.count for o in outs]}")
    return {"counts": [o.count for o in outs], "engines": engines,
            "seconds": dt, "cache_info": info, "dataset": dataset,
            "queries": queries}


def serve_match_loop(args) -> dict:
    """Open-loop match serving through the always-on MatchService: requests
    arrive on a seeded Poisson schedule at --qps whether or not earlier
    ones finished, so under overload the admission controller sheds with
    a typed Overloaded ticket instead of queueing without bound. Prints
    the open-loop summary (sustained qps, p50/p99 latency, shed rate) plus
    service counters; `--workers N` executes buckets on N out-of-process
    workers and reports the pool's lifecycle counters too. Returns the
    summary, the service stats and each request's count."""
    from repro_torch.api import Dataset, MatchOptions
    from repro_torch.runtime.service import (MatchService, ServiceConfig,
                                             arrival_schedule, open_loop)

    dataset = Dataset.synthetic(args.dataset, scale=args.scale)
    queries = [dataset.random_query(args.query_size, seed=s)
               for s in range(min(args.n_queries, 16))]
    svc = MatchService(dataset, config=ServiceConfig(
        inbox_capacity=max(64, args.n_queries), workers=args.workers),
        options=MatchOptions(engine=args.engine, limit=args.limit),
        device=args.device)
    try:
        # warm the plan caches so the measured loop isn't dominated by
        # compiles (with a pool this warms the workers' caches too)
        for q in queries:
            svc.submit(q, limit=args.limit, force=True)
        svc.drain()
        svc.reset_stats()
        workload = [dict(query=queries[i % len(queries)], limit=args.limit)
                    for i in range(args.n_queries)]
        schedule = arrival_schedule(args.n_queries, args.qps, seed=args.seed)
        s = open_loop(svc, workload, schedule)
        print(f"open loop vs {dataset!r} on {svc.device}: offered "
              f"{s['offered']} @ {args.qps:.1f} qps → completed "
              f"{s['completed']} shed {s['shed']} failed {s['failed']} "
              f"(sustained {s['qps_sustained']:.1f} qps)")
        print(f"latency p50 {s['p50_s'] * 1e3:.1f}ms "
              f"p99 {s['p99_s'] * 1e3:.1f}ms "
              f"shed_rate {s['shed_rate']:.3f} makespan {s['makespan_s']:.2f}s")
        print(f"service stats: {svc.stats}")
        if svc.pool is not None:
            print(f"worker pool ({svc.pool.size} workers): {svc.pool.stats}")
        return {"summary": s, "stats": dict(svc.stats),
                "counts": {rid: r.count for rid, r in svc.results.items()},
                "workload": workload}
    finally:
        svc.close()


def parse_args(argv=None):
    """The launcher's arguments (`main`'s parser)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="an LM id of configs/registry.py, bert4rec, or "
                         "match")
    ap.add_argument("--shape", default=None,
                    help="a RECSYS_SHAPES id for --arch bert4rec "
                         "(default serve_p99)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    # --arch match (subgraph-match serving) options
    ap.add_argument("--dataset", default="yeast")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--n-queries", type=int, default=32)
    ap.add_argument("--query-size", type=int, default=6)
    ap.add_argument("--limit", type=int, default=100_000)
    ap.add_argument("--engine", default="auto",
                    choices=["ref", "vector", "auto"])
    ap.add_argument("--serve-loop", action="store_true",
                    help="open-loop MatchService mode (--arch match only): "
                         "Poisson arrivals at --qps through admission "
                         "control instead of a single closed-loop batch")
    ap.add_argument("--qps", type=float, default=50.0,
                    help="offered arrival rate for --serve-loop")
    ap.add_argument("--workers", type=int, default=0,
                    help="out-of-process executor workers for --serve-loop "
                         "(0 = inline execution in the service process)")
    ap.add_argument("--seed", type=int, default=0,
                    help="arrival-schedule seed for --serve-loop")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    if args.arch == "match":
        if args.serve_loop:
            serve_match_loop(args)
        else:
            serve_match(args)
        return 0
    bundle = build_bundle(args.arch, reduced=True, device=args.device)
    if bundle.family not in ("lm", "recsys"):
        raise SystemExit(f"--arch {args.arch}: a {bundle.family} model only "
                         "trains; serve takes an LM id, bert4rec or match")
    with _mesh_context(bundle, args) as place:
        if bundle.family == "recsys":
            serve_recsys(bundle, args.shape or "serve_p99", place=place)
            return 0
        # weights stored in the activation dtype: the same numbers as the
        # reference's float32 weights cast at every use
        model = place(bundle.init_fn(0, dtype=torch.bfloat16))
        res = decode_loop(bundle, model, batch=args.batch,
                          tokens=args.tokens)
    print(f"decoded {args.tokens} tokens × batch {args.batch} on "
          f"{bundle.device} in {res['seconds']:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s)")
    print("sample:", res["tokens"][:10, 0].tolist())
    return 0


@contextlib.contextmanager
def _mesh_context(bundle: ModelBundle, args):
    """The reference launcher's `make_local_mesh()` and sharding context
    (the decode rules for an LM, the serve rules for bert4rec), around the
    serve. Yields place(model): the model distributed by the policy. A
    mesh of one device (one process: a (1, 1) mesh over a group of one)
    distributes nothing and installs no context, so the single-card loop
    launches what it launches without a mesh. A group this call started
    ends with it."""
    import torch.distributed as dist
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.launch.mesh import make_local_mesh
    own = not dist.is_initialized()
    mesh = make_local_mesh(device=bundle.device)
    try:
        if mesh.size() == 1:
            yield lambda model: model
            return
        kind = "decode" if bundle.family == "lm" else "serve"
        rules = policy.activation_rules(bundle.cfg, mesh, kind,
                                        batch=args.batch)
        with sharding_ctx(mesh, rules):
            yield lambda model: policy.distribute_model(model, bundle.cfg,
                                                        mesh)
    finally:
        if own:
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
