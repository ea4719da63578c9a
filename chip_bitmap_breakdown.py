"""Where the time of the selection kernel goes, on one CUDA card.

    python3 chip_bitmap_breakdown.py

Builds variants of `src/repro_torch/kernels/csrc/bitmap_intersect.cu` by
text edits of a copy (into `build/bitmap_breakdown/`, one nvcc each, all
started together), and times `expand_select` and `expand_intersect` of
each variant at the dblp and eu2005 shapes of `chip_smoke.py`'s phase 6
(T = 256, sparse frontiers; synthetic tables): the kernel cut after each
phase (an empty kernel, after counting the rows, after their scan), the
full kernel, and the kernel with each knob moved (rows a warp counts at
once, CTAs, warps a CTA). Each variant that computes the whole function is
first held bit for bit against the plain version. Prints one JSON line
per variant and shape, with the card's name and power limit. Needs CUDA;
exits non-zero without it.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
COUNTED = "  __syncthreads();\n  // 2. their exclusive prefix"
# name -> (text edits, whether the variant computes the whole function)
VARIANTS = {
    "full": ([], True),
    "empty": ([("  int* cum = a.scratch ?",
                "  if (a.n_in > 0) return;\n  int* cum = a.scratch ?")],
              False),
    "counted": ([(COUNTED, "  __syncthreads();\n  if (a.n_in > 0) return;\n"
                           "  // 2. their exclusive prefix")], False),
    "scanned": ([("  for (int t = blockIdx.x * kSelectWarps + warp; "
                  "t < a.n_out;",
                  "  for (int t = blockIdx.x * kSelectWarps + warp; t < 0;")],
                False),
    "rows_in_flight_4": ([("kRowsInFlight = 8;", "kRowsInFlight = 4;")],
                         True),
    "rows_in_flight_16": ([("kRowsInFlight = 8;", "kRowsInFlight = 16;")],
                          True),
    "ctas_2": ([("kSelectCtas = 8;", "kSelectCtas = 2;")], True),
    "ctas_16": ([("kSelectCtas = 8;", "kSelectCtas = 16;")], True),
    "warps_16": ([("kSelectWarps = 32;", "kSelectWarps = 16;")], True),
}


def median_ms(fn, *, reps: int = 7, iters: int = 50) -> float:
    """As chip_smoke.median_ms: back-to-back calls queued behind a sleep
    kernel, CUDA events, the median over reps of the mean."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_bitmap_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import build, ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    src = (build.CSRC / f"{bi.LIBRARY}.cu").read_text()
    out = ROOT / "build" / "bitmap_breakdown"
    out.mkdir(parents=True, exist_ok=True)

    def compile_variant(name):
        text = src
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(text)
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                               str(so), str(cu)], capture_output=True,
                              text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr}")
        lib = ctypes.CDLL(str(so))
        lib.cemr_select_ctas.restype = ctypes.c_int
        return so, lib.cemr_select_ctas()

    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = dict(zip(VARIANTS, ex.map(compile_variant, VARIANTS)))

    dev = torch.device("cuda")
    gen = np.random.default_rng(1)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)

    def sparse(t, w):
        bits = (gen.random((t, w, 32)) < 1 / 64).astype(np.uint64)
        bits[gen.random(t) < 0.5] = 0
        return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(
            np.uint32)

    shapes = {"dblp": (28, 82, 1), "eu2005": (246, 246, 2)}
    floor = median_ms(lambda: torch.cuda._sleep(0))
    print(json.dumps({"card": card, "launch_floor_ms": floor}), flush=True)
    t = 256
    for shape, (w_in, w, k) in shapes.items():
        r = on_card(sparse(t, w_in))
        idx = on_card(gen.integers(0, 6_138, (t, 4)).astype(np.int32))
        tabs = [on_card(gen.integers(0, 2 ** 32, (6_138, w), dtype=np.uint32))
                for _ in range(k)]
        slots = [4, 1][:k]
        for name, (so, ctas) in built.items():
            bi._lib.cache_clear()
            bi._TABLE_SETS.clear()
            bi.SELECT_CTAS = ctas
            bi.load_library = lambda _name, so=so: ctypes.CDLL(str(so))
            if VARIANTS[name][1]:
                got = bi.expand_intersect(r, 0, t, idx, tabs, slots, [4])
                want = ref.expand_intersect_ref(r, 0, t, idx, tabs, slots,
                                                [4])
                if any(not torch.equal(g, x) for g, x in zip(got, want)):
                    raise SystemExit(f"variant {name} disagrees at {shape}")
            print(json.dumps({
                "card": card, "shape": shape, "variant": name,
                "k": k, "W": w, "W_in": w_in, "T": t,
                "expand_select_ms": median_ms(
                    lambda: bi.expand_select(r, 0, t, idx)),
                "expand_intersect_ms": median_ms(
                    lambda: bi.expand_intersect(r, 0, t, idx, tabs, slots,
                                                [4]))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
