"""Smoke run of the torch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. card   — print the card's name and power limit (nvidia-smi);
  2. build  — build the CUDA kernels from `src/repro_torch/kernels/csrc/`
              with nvcc (sm_90a) and print the build time;
  3. kernels — hold each kernel against its plain torch version on the card,
              bit for bit: k in 1..4 tables, ragged widths, all-zero and
              all-one rows, T = 256, and for the fused kernel K0 = 0 and
              slots through both kinds of indirection;
  4. main path — `repro_torch.api.Matcher.count(engine="vector")` on the
              synthetic dblp (size-8 and size-16 queries) and human
              (size-8) datasets at scale 1.0, plus a size-8 query on dblp
              at scale 0.02 whose count stays below the limit, with
              intersect="auto" and "fused", each count held against the
              port's own `cemr_match` (numpy, CPU). Each route's launch
              counts are set to 0 just before its runs and read just
              after: bitmap_intersect must launch on "auto" and
              fused_expand_intersect on "fused". The two routes'
              VectorStats must be equal, and the scale-1.0 dblp supersteps
              and CER hits equal the JAX reference's (those counts stop
              at the limit);
  5. timing — each kernel's median device time at the main path's shapes
              beside its plain version's and its memory bound;
  6. summary — the kernels line, the card, one JSON line of per-kernel
              numbers, and last the line
              {"ok": true, "device": {"platform": "gpu", ...}}.

It imports nothing of jax or of the JAX package `repro`.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
TILE_ROWS = 256                  # MatchOptions.tile_rows default
LIMIT = 1_000_000                # MatchOptions.limit default
HUMAN_SIZE8_COUNT = 40_860       # ref-engine count of human size-8, seed 7
# (dataset, scale, query size); every query is random_query(size, seed=7).
# The scale-1.0 dblp counts stop at the limit, so a small dblp whose count
# (473,828) stays below it holds a dblp count exactly.
WORKLOADS = (("dblp", 1.0, 8), ("dblp", 1.0, 16), ("human", 1.0, 8),
             ("dblp", 0.02, 8))
# The JAX reference TileScheduler's counters on the same queries (default
# options). They hold the kernels' bits where the clipped count cannot.
REFERENCE_STATS = {("dblp", 1.0, 8): {"supersteps": 35},
                   ("dblp", 1.0, 16): {"supersteps": 37, "cer_hits": 6_927}}
# The route each kernel belongs to: its launch count is read on that route
KERNEL_ROUTE = {"bitmap_intersect": "auto",
                "fused_expand_intersect": "fused"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, *, reps: int = 5, iters: int = 20) -> float:
    """Device time of one call: the median over `reps` of the mean of
    `iters` back-to-back calls, timed with CUDA events after a warm-up.
    A sleep kernel holds the stream while the host queues the calls, so
    the events see the calls' device time, not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)           # ~50 ms at H100 clocks
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return float(np.median(times))


def max_abs_err(got, want) -> int:
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def check_kernels(bi, ref, dev) -> dict:
    """Every kernel against its plain version, bit for bit. Returns the
    largest absolute difference seen per kernel (0 when they agree)."""
    gen = np.random.default_rng(0)
    t = TILE_ROWS
    errs = {"bitmap_intersect": 0, "fused_expand_intersect": 0}

    def tables_for(k, w, fill):
        out = []
        for _ in range(k):
            s = int(gen.integers(1, 300))
            if fill == "random":
                a = gen.integers(0, 2 ** 32, size=(s, w), dtype=np.uint32)
            else:
                a = np.full((s, w), 0 if fill == "zeros" else 0xFFFFFFFF,
                            dtype=np.uint32)
            out.append(torch.from_numpy(a.view(np.int32)).to(dev))
        return out

    for k in (1, 2, 3, 4):
        for w in (1, 5, 33, 82):
            for fill in ("random", "zeros", "ones"):
                tabs = tables_for(k, w, fill)
                idxs = torch.from_numpy(np.stack(
                    [gen.integers(0, x.shape[0], t) for x in tabs], 1
                ).astype(np.int32)).to(dev)
                got = bi.bitmap_intersect(tabs, idxs)
                want = ref.bitmap_intersect_ref(tabs, idxs)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                errs["bitmap_intersect"] = max(errs["bitmap_intersect"], err)
                if err:
                    raise SystemExit(f"bitmap_intersect disagrees: k={k} "
                                     f"w={w} {fill} max_abs_err={err}")
                for k0 in (0, 1, 3):
                    # slot k0 reads bitpos; slots < k0 read parent columns
                    slots = [min(j, k0) for j in range(k)][::-1]
                    t_in = int(gen.integers(1, 40))
                    s_min = min(x.shape[0] for x in tabs)
                    idx = torch.from_numpy(gen.integers(
                        0, s_min, size=(t_in, k0)).astype(np.int32)).to(dev)
                    rows = torch.from_numpy(gen.integers(
                        0, t_in, t).astype(np.int32)).to(dev)
                    bitpos = torch.from_numpy(gen.integers(
                        0, s_min, t).astype(np.int32)).to(dev)
                    got = bi.fused_expand_intersect(tabs, idx, rows, bitpos,
                                                    slots)
                    want = ref.fused_expand_intersect_ref(
                        tabs, idx, rows, bitpos, slots=slots)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    errs["fused_expand_intersect"] = max(
                        errs["fused_expand_intersect"], err)
                    if err:
                        raise SystemExit(
                            f"fused_expand_intersect disagrees: k={k} w={w} "
                            f"{fill} k0={k0} slots={slots} "
                            f"max_abs_err={err}")
    return errs


def prepare(api, cemr_match) -> list:
    """Build the datasets, compile the queries and count each with the
    port's `cemr_match` (numpy, host). Returns one workload per query."""
    work, matchers = [], {}
    for name, scale, size in WORKLOADS:
        if (name, scale) not in matchers:
            t0 = time.perf_counter()
            ds = api.Dataset.synthetic(name, scale=scale)
            matchers[name, scale] = api.Matcher(ds)
            print(f"dataset {name} scale {scale}: |V|={ds.n} "
                  f"|E|={ds.n_edges} "
                  f"preprocess_s={time.perf_counter() - t0:.3f}", flush=True)
        m = matchers[name, scale]
        q = m.dataset.random_query(size=size, seed=7)
        cq = m.compile(q)
        t0 = time.perf_counter()
        ref = cemr_match(q, m.dataset.graph, limit=LIMIT,
                         preprocessed=(cq.cs, cq.an)).count
        print(f"cemr_match {name} scale {scale} size {size}: count={ref} "
              f"s={time.perf_counter() - t0:.3f}", flush=True)
        if (name, scale, size) == ("human", 1.0, 8) \
                and ref != HUMAN_SIZE8_COUNT:
            raise SystemExit(f"human size-8 cemr_match gave {ref}, "
                             f"expected {HUMAN_SIZE8_COUNT}")
        if scale != 1.0 and ref >= LIMIT:
            raise SystemExit(f"{name} scale {scale} size {size} reaches the "
                             "limit: its count is no exact check")
        work.append({"dataset": name, "scale": scale, "query_size": size,
                     "matcher": m, "query": q, "compiled": cq, "ref": ref})
    return work


def drive(bi, work, intersect: str) -> tuple[list, dict]:
    """One intersect route of the main path: every workload through
    Matcher.count, with the launch counts set to 0 just before and read
    just after. Returns the per-run lines (with the full VectorStats) and
    the route's launch counts."""
    runs = []
    bi.reset_launches()
    for w in work:
        t0 = time.perf_counter()
        # engine="vector": human's size-8 candidate space is small
        # enough that engine="auto" would pick the ref engine
        out = w["matcher"].count(w["query"], engine="vector",
                                 intersect=intersect, limit=LIMIT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append({"dataset": w["dataset"], "scale": w["scale"],
                     "query_size": w["query_size"],
                     "intersect": intersect, "count": out.count,
                     "cemr_match_count": w["ref"], "wall_s": wall,
                     "compile_s": out.compile_s, "elapsed_s": out.elapsed_s,
                     "stats": dataclasses.asdict(out.stats)})
    launches = {"bitmap_intersect": bi.bitmap_intersect.launches,
                "fused_expand_intersect": bi.fused_expand_intersect.launches}
    return runs, launches


def check_runs(by_route: dict) -> None:
    """Counts against cemr_match, the overlap invariant, VectorStats equal
    across the two routes, and the reference's supersteps / CER hits."""
    for route, runs in by_route.items():
        for r in runs:
            key = (r["dataset"], r["scale"], r["query_size"])
            where = f"{key} {route}"
            st = r["stats"]
            if r["count"] != r["cemr_match_count"]:
                raise SystemExit(f"{where}: count {r['count']} != "
                                 f"cemr_match {r['cemr_match_count']}")
            if st["readbacks"] + st["overlapped_supersteps"] \
                    != st["supersteps"]:
                raise SystemExit(f"{where}: readbacks + "
                                 "overlapped_supersteps != supersteps")
            want = REFERENCE_STATS.get(key, {})
            for field, value in want.items():
                if st[field] != value:
                    raise SystemExit(f"{where}: {field} {st[field]} != "
                                     f"the reference's {value}")
    for a, f in zip(by_route["auto"], by_route["fused"]):
        if a["stats"] != f["stats"]:
            diff = {k: (v, f["stats"][k]) for k, v in a["stats"].items()
                    if v != f["stats"][k]}
            raise SystemExit(f"{a['dataset']} scale {a['scale']} size "
                             f"{a['query_size']}: VectorStats differ "
                             f"between routes: {diff}")


def time_kernels(bi, ref, cq, dev, launches, errs) -> list:
    """Each kernel at the main path's shapes: the dblp size-8 plan's widest
    extend (most gathered words), T = tile_rows, the plan's own tables."""
    from repro_torch.core.engine import upload_plan
    plan = cq.plan
    tables, _ = upload_plan(plan, dev)
    op = max((o for o in plan.ops if o.bk_pairs),
             key=lambda o: (len(o.bk_pairs) * o.n_words, o.level))
    tabs = [tables[f"{u}:{op.vertex}"] for (_, u) in op.bk_pairs]
    slots = [s for (s, _) in op.bk_pairs]
    k, w, t = len(tabs), op.n_words, TILE_ROWS
    k0 = max(slots)                       # parent width; slot k0 = bitpos
    gen = np.random.default_rng(1)
    s_min = min(x.shape[0] for x in tabs)
    idxs = torch.from_numpy(np.stack(
        [gen.integers(0, x.shape[0], t) for x in tabs], 1
    ).astype(np.int32)).to(dev)
    idx = torch.from_numpy(gen.integers(0, s_min, size=(t, max(k0, 1)))
                           .astype(np.int32)[:, :k0].copy()).to(dev)
    rows = torch.from_numpy(gen.integers(0, t, t).astype(np.int32)).to(dev)
    bitpos = torch.from_numpy(gen.integers(0, s_min, t)
                              .astype(np.int32)).to(dev)
    # bytes the function must move: the k gathered rows, R and pop written,
    # plus the keys — k indices per row, or for the fused kernel rows,
    # bitpos and one parent index per slot below K0
    out_bytes = t * k * w * 4 + t * w * 4 + t * 4
    io_bytes = out_bytes + t * k * 4
    fused_bytes = out_bytes + t * 8 + t * sum(s < k0 for s in slots) * 4
    specs = [
        ("bitmap_intersect", io_bytes,
         lambda: bi.bitmap_intersect(tabs, idxs),
         lambda: ref.bitmap_intersect_ref(tabs, idxs)),
        ("fused_expand_intersect", fused_bytes,
         lambda: bi.fused_expand_intersect(tabs, idx, rows, bitpos, slots),
         lambda: ref.fused_expand_intersect_ref(tabs, idx, rows, bitpos,
                                                slots=slots)),
    ]
    out = []
    for name, nbytes, kern, plain in specs:
        err = max_abs_err(kern(), plain())
        if err:
            raise SystemExit(f"{name} disagrees at the main-path shape")
        ms, plain_ms = median_ms(kern), median_ms(plain)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"time {name}: k={k} W={w} T={t} K0={k0} ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f}", flush=True)
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bitmap_intersect.cu",
            "replaces": ("src/repro/kernels/bitmap_intersect.py:88"
                         if name == "bitmap_intersect"
                         else "src/repro/kernels/bitmap_intersect.py:179"),
            "launches": launches[KERNEL_ROUTE[name]][name],
            "launches_by_route": {route: counts[name]
                                  for route, counts in launches.items()},
            "max_abs_err": max(errs[name], err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "shape": {"k": k, "W": w, "T": t, "K0": k0}})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import api
    from repro_torch.core.ref_engine import cemr_match
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import build, ref

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    lib = build.build_library(bi.LIBRARY)
    print(f"build: {lib.name} in {time.perf_counter() - t0:.3f} s",
          flush=True)

    t0 = time.perf_counter()
    errs = check_kernels(bi, ref, dev)
    print(f"kernels agree with their plain versions bit for bit "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)

    work = prepare(api, cemr_match)
    by_route, launches = {}, {}
    for route in ("auto", "fused"):
        t0 = time.perf_counter()
        by_route[route], launches[route] = drive(bi, work, route)
        for r in by_route[route]:
            print("run " + json.dumps(r), flush=True)
        print(f"main path {route}: {len(work)} runs in "
              f"{time.perf_counter() - t0:.3f} s, launches {launches[route]}",
              flush=True)
    for name, route in KERNEL_ROUTE.items():
        if launches[route][name] <= 0:
            raise SystemExit(f"{name} never launched on the {route} route")
    check_runs(by_route)

    shapes_cq = next(w["compiled"] for w in work
                     if (w["dataset"], w["scale"], w["query_size"])
                     == ("dblp", 1.0, 8))
    kernels = time_kernels(bi, ref, shapes_cq, dev, launches, errs)

    print("kernels: bitmap_intersect, fused_expand_intersect")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
