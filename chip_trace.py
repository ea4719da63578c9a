"""Where the time of the port's paths goes, on one CUDA card.

    python3 chip_trace.py [--matcher-only] [--superbatch] [--lm-train]
                          [--src DIR] [--words-per-block N]

Runs `repro_torch.api.Matcher.count(engine="vector")` on synthetic dblp at
scale 1.0 with `random_query(size=8, seed=7)`, once to warm up and then
under `torch.profiler` for each `intersect` route, and prints beside the
window's numbers the median wall of 5 unprofiled counts, the launches a
superstep and the bitmap kernels' launches (each wrapper's count over
the profiled count), and the wall of the route's first count
(`count_ms_first`: its engine is built then, so on "fused" it holds the
word-block width's autotune sweeps; the auto route's also holds the
kernels' build where the library is not built yet). `--superbatch`
profiles instead chip_smoke.py's superbatch mix on the same dataset
(`MIX`: eight queries in two buckets and a singleton) through
`Matcher.match_many` with batch="auto" and with batch="off", each warm,
beside the median wall of 3 unprofiled drains: launches a superstep
(over every superstep of the drain, batched or not), the device-busy
share and queries per second. `--src DIR` imports `repro_torch` from DIR
instead of this checkout's `src/` (to profile another tree in the same
call); `--words-per-block N` gives every fused boundary of the matcher
windows the width N instead of the autotune's pick (the route without
its sweeps, for comparing against a tree that has none);
`--matcher-only` skips the LM windows. Then, unless skipped, one full-width
qwen2-1.5b decode step (bfloat16, random weights from seed 0) as the
serve loop has it (batch 4, float32 cache of 24 positions) and as
`decode_32k` has it (batch 32, bfloat16 cache of 32,772 positions filled
with random values, lengths from `make_inputs(seed=0)`), each after a
warm-up step. It prints one JSON line per window: wall time, the device's
busy time (sum of kernel times; one stream, so kernels do not overlap),
the busy share, the number of kernel launches, and the kernels that took
the most device time. `--lm-train` profiles instead full-width
qwen2-1.5b prefill and training (float32 weights from seed 0, bfloat16
activations): one warm `steps["train"]` on `train_4k` at batch 1 (one
microbatch of 4,096 tokens and one AdamW update; chip_smoke.py's batch-4
step runs four such microbatches) and one warm `steps["prefill"]` at
batch 1 on the first 8,192 tokens of `prefill_32k` (a quarter of the
sequence, ~1/14 of its attention blocks, to keep the trace small), each
beside the median wall of 3 unprofiled calls. Needs CUDA; exits non-zero
without it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile


def profiled(fn) -> tuple:
    """Run fn once under torch.profiler; return (its result, the window's
    numbers: wall, device busy time and share, launches, top kernels)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return out, {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                           for e in top}}


def trace_lm(card: str) -> None:
    from repro_torch.models.api import build_bundle
    bundle = build_bundle("qwen2-1.5b")
    model = bundle.init_fn(0, dtype=torch.bfloat16)
    step = bundle.steps["decode"]
    dev = bundle.device
    cases = [("serve", 4, 24, torch.float32, None),
             ("decode_32k", 32, 32_768 + 4, torch.bfloat16, "decode_32k")]
    for name, batch, positions, cache_dtype, shape in cases:
        caches = bundle.init_caches(batch, positions, dtype=cache_dtype)
        if shape is None:
            inputs = {"token": torch.ones(batch, dtype=torch.int32,
                                          device=dev),
                      "lengths": torch.full((batch,), 8, dtype=torch.int32,
                                            device=dev)}
        else:
            gen = torch.Generator(device=dev).manual_seed(1)
            for t in caches.values():
                t.normal_(generator=gen)
            inputs = bundle.make_inputs(shape, seed=0, batch=batch)
        step(model, caches, inputs)                          # warm
        _, stats = profiled(lambda: step(model, caches, inputs))
        print(json.dumps({"card": card, "path": f"lm {name}",
                          "batch": batch, "cache_positions": positions,
                          "cache_dtype": str(cache_dtype), **stats}),
              flush=True)
        del caches
        torch.cuda.empty_cache()


def trace_lm_train(card: str) -> None:
    from repro_torch.models.api import build_bundle
    bundle = build_bundle("qwen2-1.5b")
    model = bundle.init_fn(0)
    state = bundle.optimizer.init(dict(model.named_parameters()))
    train = bundle.make_inputs("train_4k", seed=0, batch=1)
    prefill = {"tokens": bundle.make_inputs("prefill_32k", seed=0, batch=1)
               ["tokens"][:, :8192].contiguous()}
    cases = [("train_4k step", train["tokens"].shape,
              lambda: bundle.steps["train"](model, state, train)[2]),
             ("prefill", prefill["tokens"].shape,
              lambda: bundle.steps["prefill"](model, prefill))]
    for name, shape, fn in cases:
        fn()                                                  # warm
        walls = []
        for _ in range(3):                   # unprofiled, synchronised
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        _, stats = profiled(fn)
        print(json.dumps({"card": card, "path": f"lm {name}",
                          "tokens": list(shape),
                          "ms_unprofiled": sorted(walls)[1],
                          "ms_unprofiled_all": walls,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          **stats}), flush=True)


def trace_superbatch(api, bi, ds, card: str, src: str) -> None:
    from chip_smoke import MIX
    queries = [ds.random_query(size=size, seed=seed) for size, seed in MIX]
    m = api.Matcher(ds)
    for batch in ("auto", "off"):
        m.match_many(queries, engine="vector", batch=batch)     # warm
        walls = []
        for _ in range(3):                   # unprofiled, synchronised
            t0 = time.perf_counter()
            m.match_many(queries, engine="vector", batch=batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        bi.reset_launches()
        outs, stats = profiled(lambda: m.match_many(
            queries, engine="vector", batch=batch))
        distinct = {id(o.stats): o.stats for o in outs}.values()
        steps = max(sum(st.supersteps for st in distinct), 1)
        wall = sorted(walls)[len(walls) // 2]
        print(json.dumps({
            "card": card, "path": "superbatch mix", "src": src,
            "batch": batch, "queries": len(queries),
            "counts": [o.count for o in outs], "supersteps": steps,
            "batched_queries": [st.batched_queries for st in distinct],
            "drain_ms_unprofiled": wall,
            "drain_ms_unprofiled_all": walls,
            "queries_per_s_unprofiled": len(queries) / (wall / 1e3),
            "launches_per_superstep": stats["kernel_launches"] / steps,
            "bitmap_launches": {fn.__name__: fn.launches
                                for fn in bi.WRAPPERS},
            "lane_launches": bi.tile_intersect.lane_launches,
            **stats}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(Path(__file__).resolve().parent
                                             / "src"))
    parser.add_argument("--matcher-only", action="store_true")
    parser.add_argument("--words-per-block", type=int, default=None)
    parser.add_argument("--superbatch", action="store_true")
    parser.add_argument("--lm-train", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import api
    from repro_torch.kernels import bitmap_intersect as bi

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.lm_train:
        trace_lm_train(card)
        return 0
    ds = api.Dataset.synthetic("dblp", scale=1.0)
    if args.superbatch:
        trace_superbatch(api, bi, ds, card, args.src)
        return 0
    if args.words_per_block is not None:
        bi.autotune_words_per_block = \
            lambda k, w, *, device, _wpb=args.words_per_block: _wpb
    q = ds.random_query(size=8, seed=7)
    m = api.Matcher(ds)
    for intersect in ("auto", "fused"):
        t0 = time.perf_counter()
        m.count(q, engine="vector", intersect=intersect)      # warm
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        walls = []
        for _ in range(5):                   # unprofiled, synchronised
            t0 = time.perf_counter()
            m.count(q, engine="vector", intersect=intersect)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        bi.reset_launches()
        out, stats = profiled(lambda: m.count(q, engine="vector",
                                              intersect=intersect))
        steps = max(out.stats.supersteps, 1)
        bitmap = {name: fn.launches for name, fn in vars(bi).items()
                  if callable(fn) and hasattr(fn, "launches")}
        print(json.dumps({
            "card": card, "path": "matcher", "src": args.src,
            "words_per_block": args.words_per_block,
            "intersect": intersect, "count": out.count,
            "supersteps": out.stats.supersteps,
            "count_ms_first": first_ms,
            "count_ms_unprofiled": sorted(walls)[len(walls) // 2],
            "count_ms_unprofiled_all": walls,
            "launches_per_superstep": stats["kernel_launches"] / steps,
            "bitmap_launches_per_superstep": {
                name: n / steps for name, n in bitmap.items()},
            **stats}), flush=True)
    if not args.matcher_only:
        trace_lm(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
