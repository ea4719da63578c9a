"""Time `flash_decode` of one or more source trees on one CUDA card.

    python3 chip_fd_compare.py SRC [SRC ...]

SRC is a `src/` directory that holds `repro_torch`: this checkout's, or
another commit's unpacked with `git archive` into a directory that
.gitignore lists. Each SRC runs in a process of its own, in the order
given (A B B A shows the spread between runs), builds its own flash_decode
library and times `flash_decode` at one qwen2-1.5b layer's decode_32k
shape (B = 32, H = 12, Hkv = 2, D = 128, S = 32,772, lengths from
`make_inputs("decode_32k", seed=0, batch=32)`) in all four (q, cache)
dtype pairs, each held against the plain version on the same inputs
within chip_smoke.FD_TOL. Prints the card, then one JSON line per SRC and
dtype pair: the kernel's time, the plain version's, the bound (the cache
bytes the lengths cover over the HBM rate: the SRC's own
`launch/roofline.HW`, or this checkout's for a SRC from before that
module) and its share. Needs CUDA; exits non-zero without it.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke

SHAPE = dict(b=32, h=12, hkv=2, s=32_768 + 4, d=128)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def time_one(src: str, hbm_bw: float) -> None:
    """Times this SRC's flash_decode in each dtype pair; one JSON line
    each. `hbm_bw` (bytes/s) serves a SRC that has no roofline module."""
    sys.path.insert(0, str(Path(src).resolve()))
    try:
        from repro_torch.launch.roofline import HW
        hbm_bw = HW["hbm_bw"]
    except ModuleNotFoundError:
        pass
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.models.api import build_bundle
    dev = torch.device("cuda")
    b, h, hkv, s, d = (SHAPE[x] for x in ("b", "h", "hkv", "s", "d"))
    lens = build_bundle("qwen2-1.5b", device=dev).make_inputs(
        "decode_32k", seed=0, batch=b)["lengths"]
    total_len = int(lens.sum())
    gen = torch.Generator(device=dev).manual_seed(3)
    q32 = torch.randn((b, h, d), generator=gen, device=dev)
    k32 = torch.randn((b, s, hkv, d), generator=gen, device=dev)
    v32 = torch.randn((b, s, hkv, d), generator=gen, device=dev)
    for q_name, q_dtype in DTYPES.items():
        for kv_name, kv_dtype in DTYPES.items():
            q, k, v = q32.to(q_dtype), k32.to(kv_dtype), v32.to(kv_dtype)
            want = ref.flash_decode_ref(q, k, v, lens)
            err = chip_smoke.fd_agrees(fd.flash_decode(q, k, v, lens), want,
                                       f"{src} q {q_name} cache {kv_name}")
            ms = chip_smoke.median_ms(lambda: fd.flash_decode(q, k, v, lens))
            plain_ms = chip_smoke.median_ms(
                lambda: ref.flash_decode_ref(q, k, v, lens))
            nbytes = (total_len * hkv * d * 2 * k.element_size()
                      + 2 * q.numel() * q.element_size() + lens.numel() * 4)
            bound_ms = nbytes / hbm_bw * 1e3
            route = fd.route(q, k, v) if hasattr(fd, "route") else None
            print(json.dumps({
                "src": src, "q": q_name, "cache": kv_name, "route": route,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_share": bound_ms / ms, "max_abs_err": err,
                "sum_lengths": total_len, **SHAPE}), flush=True)
            del q, k, v, want


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_fd_compare: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        time_one(sys.argv[2], float(sys.argv[3]))
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(f"card: {chip_smoke.card_line()}", flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    hbm_bw = chip_smoke.hw()["hbm_bw"]
    for src in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", src,
                               repr(hbm_bw)])
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
