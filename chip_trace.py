"""Where the time of the port's main path goes, on one CUDA card.

    python3 chip_trace.py

Runs `repro_torch.api.Matcher.count(engine="vector")` on synthetic dblp at
scale 1.0 with `random_query(size=8, seed=7)`, once to warm up and then
under `torch.profiler` for each `intersect` route, and prints one JSON line
per route: wall time of the profiled count, the device's busy time (sum of
kernel times; one stream, so kernels do not overlap), the busy share, the
number of kernel launches, and the kernels that took the most device time.
Needs CUDA; exits non-zero without it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import api

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ds = api.Dataset.synthetic("dblp", scale=1.0)
    q = ds.random_query(size=8, seed=7)
    m = api.Matcher(ds)
    for intersect in ("auto", "fused"):
        m.count(q, engine="vector", intersect=intersect)      # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = m.count(q, engine="vector", intersect=intersect)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        launches = sum(e.count for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        print(json.dumps({
            "card": card, "intersect": intersect, "count": out.count,
            "supersteps": out.stats.supersteps, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "kernel_launches": launches,
            "launches_per_superstep": launches / max(out.stats.supersteps, 1),
            "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                               for e in top}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
