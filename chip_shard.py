"""Phase 4d of `chip_smoke.py` alone, for a machine with several cards.

    python3 chip_shard.py

Builds the bitmap kernels, prepares phase 4's workloads and phase 4b's mix
(its batched counts), and runs `chip_smoke.drive_sharded`: sharded counts
with 2 and 4 lanes on the first card, and then over meshes of distinct
cards (2 and, with 4 cards, 4), each count held to the single-device
count, every VectorStats field to the JAX reference's sharded schedulers
(`chip_smoke.REFERENCE_SHARD`) and every bitmap kernel to one launch per
live lane per boundary or extend. Exits non-zero with fewer than two
cards, or when any check fails. Prints the card line, the phase's JSON
and, last, `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_shard: needs two or more CUDA devices", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.core import bitops as bitops_mod
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import graph as graph_mod
    from repro_torch.core import scheduler as sched_mod
    from repro_torch.core.ref_engine import cemr_match
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    card = cs.card_line()
    print(f"card: {card}; {torch.cuda.device_count()} cards", flush=True)
    for name, (lib, secs) in cs.build_all(build, (bi.LIBRARY,)).items():
        print(f"build: {lib.name} in {secs:.3f} s", flush=True)
    work = cs.prepare(api, cemr_match)
    dblp = next(w["matcher"].dataset for w in work
                if (w["dataset"], w["scale"]) == ("dblp", 1.0))
    m = api.Matcher(dblp)
    queries = cs.mix_queries(dblp)
    bat = m.match_many(queries, engine="vector", limit=cs.LIMIT,
                       batch="auto")
    sb_res = {"matcher": m, "queries_list": queries,
              "counts": {"auto": [o.count for o in bat]}}
    res = cs.drive_sharded(bi, engine_mod, bitops_mod, sched_mod, graph_mod,
                           work, sb_res, cemr_match, torch.device("cuda"))
    if not res["distinct_cards"]:
        raise SystemExit("no mesh of distinct cards ran")
    print("sharded " + json.dumps(res), flush=True)
    for r in res["distinct_cards"]:
        print(f"distinct cards on {card}: {r['workload']} over {r['cards']} "
              f"cards, supersteps {r['supersteps']}, wall "
              f"{r['wall_s'] * 1e3:.1f} ms", flush=True)
    print(f"chip_shard: all in {time.perf_counter() - t0:.3f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
