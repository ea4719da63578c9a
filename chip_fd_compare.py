"""Time `flash_decode` of one or more source trees on one CUDA card.

    python3 chip_fd_compare.py SRC [SRC ...]
    python3 chip_fd_compare.py --combine-sweep

SRC is a `src/` directory that holds `repro_torch`: this checkout's, or
another commit's unpacked with `git archive` into a directory that
.gitignore lists. Each SRC runs in a process of its own, in the order
given (A B B A shows the spread between runs), builds its own flash_decode
library and times, each call held against the plain version on the same
inputs (chip_smoke.FD_TOL, or chip_smoke.partials_agree for the partial
rows):

* `flash_decode` at one qwen2-1.5b layer's decode_32k shape (B = 32, H =
  12, Hkv = 2, D = 128, S = 32,772, lengths from `make_inputs("decode_32k",
  seed=0, batch=32)`) in all four (q, cache) dtype pairs;
* `flash_decode` at phase 5c's three other GQA decode_32k layers
  (GQA_SHAPES: chatglm3-6b, qwen3-moe-30b-a3b, granite-moe-3b-a800m),
  bfloat16, at the first B of the same lengths;
* `flash_decode` at one long_500k layer (B = 1, S = 524,292, every
  position attended, bfloat16) beside scaled_dot_product_attention
  (`chip_smoke.time_fd_shape`), with its split and combine kernels' device
  times from torch.profiler;
* `flash_decode_partials` on the first block of a 4-lane split of that
  layer (S = 131,073, offset 0, length 524,288).

Prints the card, then one JSON line per SRC and timing: the kernel's time,
the plain version's, the bound (the bytes the lengths cover over the HBM
rate: the SRC's own `launch/roofline.HW`, or this checkout's for a SRC from
before that module) and its share.

`--combine-sweep` times this checkout's combine alone
(`flash_decode_merge` over the workspace shapes of COMBINE_ROWS), the
long_500k layer and the 4-lane block with the combine's warps as the
library picks them, then under each count of COMBINE_WARPS (the CUDA
source built with -DCEMR_COMBINE_WARPS into build/combine_sweep/), then
the layer and the block under each chunk of SPLIT_CHUNKS (`split_plan`
patched). Needs CUDA; exits non-zero without it.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke

SHAPE = dict(b=32, h=12, hkv=2, s=32_768 + 4, d=128)
# phase 5c's GQA decode_32k layers: (B, H, Hkv, D) over S = 32,772
GQA_SHAPES = {"chatglm3-6b": (32, 32, 2, 128),
              "qwen3-moe-30b-a3b": (32, 32, 4, 128),
              "granite-moe-3b-a800m": (8, 24, 8, 64)}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# one long_500k layer (qwen2-1.5b, batch 1): the cache chip_smoke's phase
# 5a holds, every position attended; its 4-lane split's first block
LONG = dict(b=1, h=12, hkv=2, s=524_288 + 4, d=128)
LONG_LENGTH, LANES = 524_288 + 4, 4
BLOCK_LENGTH = 524_288
# the sweep: warps a CTA of the combine (every combine of a build takes
# that many), over workspaces of these (B, H, rows) shapes: 1,025 rows,
# long_500k's 257 chunks of 2,048, decode_32k's; then chunks of the split,
# the long layer's and the 4-lane block's
COMBINE_WARPS = (1, 2, 4, 8, 16)
COMBINE_ROWS = {"1,025 rows": (1, 12, 1025), "257 rows": (1, 12, 257),
                "decode_32k": (32, 12, 33)}
SPLIT_CHUNKS = {"long": (512, 1024, 2048),
                "block": (128, 256, 512, 1024, 2048)}


def long_inputs(dev):
    """q, k, v of one long_500k layer (bfloat16, seeded) and the layer's
    and the 4-lane block's lengths."""
    b, h, hkv, s, d = (LONG[x] for x in ("b", "h", "hkv", "s", "d"))
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    full = torch.full((b,), LONG_LENGTH, dtype=torch.int32, device=dev)
    block = torch.full((b,), BLOCK_LENGTH, dtype=torch.int32, device=dev)
    return q, k, v, full, block


def time_long(fd, ref, q, k, v, full, src: str) -> dict:
    """The long_500k layer: flash_decode beside its plain version, SDPA and
    its bound (`chip_smoke.time_fd_shape`), then its two kernels apart."""
    dev = q.device
    t = chip_smoke.time_fd_shape(fd, ref, dev, k, v, full, q.shape[1],
                                 f"{src} long_500k")
    parts = chip_smoke.kernel_times_ms(lambda: fd.flash_decode(q, k, v, full),
                                       ("split_", "combine_kernel"))
    return {"src": src, "what": "long_500k layer",
            **{x: t[x] for x in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_share", "max_abs_err", "chunk",
                                 "n_chunks")},
            "split_ms": parts["split_"], "combine_ms": parts["combine_kernel"],
            **LONG}


def time_block(fd, ref, q, k, v, block, hbm_bw: float, src: str) -> dict:
    """flash_decode_partials on the first block of the 4-lane split."""
    n = -(-k.shape[1] // LANES)
    kb, vb = k[:, :n], v[:, :n]
    err = chip_smoke.partials_agree(
        fd.flash_decode_partials(q, kb, vb, block, 0),
        ref.flash_decode_partials_ref(q, kb, vb, block, 0),
        f"{src} 4-lane block")
    ms = chip_smoke.median_ms(
        lambda: fd.flash_decode_partials(q, kb, vb, block, 0))
    b, h, d = q.shape
    hkv = k.shape[2]
    nbytes = (n * hkv * d * 2 * k.element_size() + q.numel() * 2 + 4
              + b * h * (d + 2) * 4)
    bound_ms = nbytes / hbm_bw * 1e3
    chunk, n_chunks, _ = fd.split_plan(b, h, hkv, n, d)
    return {"src": src, "what": "flash_decode_partials 4-lane block",
            "ms": ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms,
            "max_abs_err": err, "chunk": chunk, "n_chunks": n_chunks,
            "S": n, "offset": 0, "length": BLOCK_LENGTH}


def time_one(src: str, hbm_bw: float) -> None:
    """Times this SRC's flash_decode in each dtype pair at decode_32k, at
    phase 5c's GQA layers, then at long_500k and its 4-lane block; one
    JSON line each. `hbm_bw` (bytes/s) serves a SRC that has no roofline
    module."""
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
    del q32, k32, v32
    torch.cuda.empty_cache()
    for arch, (b, h, hkv, d) in GQA_SHAPES.items():
        q = torch.randn((b, h, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        k = torch.randn((b, s, hkv, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        v = torch.randn((b, s, hkv, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        ln = lens[:b]
        err = chip_smoke.fd_agrees(fd.flash_decode(q, k, v, ln),
                                   ref.flash_decode_ref(q, k, v, ln),
                                   f"{src} {arch}")
        ms = chip_smoke.median_ms(lambda: fd.flash_decode(q, k, v, ln))
        total = int(ln.sum())
        nbytes = total * hkv * d * 2 * 2 + 2 * q.numel() * 2 + b * 4
        bound_ms = nbytes / hbm_bw * 1e3
        print(json.dumps({
            "src": src, "what": f"{arch} decode_32k layer", "ms": ms,
            "bound_ms": bound_ms, "bound_share": bound_ms / ms,
            "max_abs_err": err, "n_chunks": fd.split_plan(b, h, hkv, s, d)[1],
            "b": b, "h": h, "hkv": hkv, "s": s, "d": d,
            "sum_lengths": total}), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    q, k, v, full, block = long_inputs(dev)
    print(json.dumps(time_long(fd, ref, q, k, v, full, src)), flush=True)
    print(json.dumps(time_block(fd, ref, q, k, v, block, hbm_bw, src)),
          flush=True)


def _forced_split(chunk: int):
    """A split_plan that cuts S into chunks of `chunk` (one chunk if S
    fits), for the sweep."""
    def plan(b, h, hkv, s, d):
        if chunk >= s:
            return s, 1, None
        n = -(-s // chunk)
        return chunk, n, (b, h, n, d + 2)
    return plan


def sweep_libraries(build) -> dict[int, Path]:
    """flash_decode.cu built once for each count of COMBINE_WARPS with
    -DCEMR_COMBINE_WARPS (one nvcc each, all at once) into
    build/combine_sweep/; {warps: library}."""
    out = build.build_dir().parent / "combine_sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "flash_decode.cu"
    libs = {w: out / f"libflash_decode-w{w}.so" for w in COMBINE_WARPS}
    procs = {w: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, f"-DCEMR_COMBINE_WARPS={w}",
         "-o", str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for w, lib in libs.items()}
    for w, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc -DCEMR_COMBINE_WARPS={w} failed:\n{log}")
    return libs


def combine_sweep() -> None:
    """This checkout's combine alone over each workspace shape of
    COMBINE_ROWS, the long_500k layer and the 4-lane block, with the
    library's own warps and then with each count of COMBINE_WARPS; then
    the layer and the block under each split chunk of SPLIT_CHUNKS. One
    JSON line each."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    hbm_bw = chip_smoke.hw()["hbm_bw"]
    q, k, v, full, block = long_inputs(dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    ws = {}
    for name, (b, h, n) in COMBINE_ROWS.items():
        ws[name] = torch.randn((b, h, n, LONG["d"] + 2), generator=gen,
                               device=dev)
        ws[name][..., -1].abs_()
    libs = sweep_libraries(build)
    try:
        for warps in (None, *COMBINE_WARPS):
            if warps is not None:
                # swap the library that the wrapper loads
                build._LOADED[fd.LIBRARY] = ctypes.CDLL(str(libs[warps]))
                fd._lib.cache_clear()
            where = f"combine {warps or 'auto'} warps"
            alone = {}
            for name, x in ws.items():
                chip_smoke.fd_agrees(
                    fd.flash_decode_merge(x, torch.bfloat16),
                    ref.flash_decode_merge_ref(x, torch.bfloat16),
                    f"{where}, {name}")
                # the rows read once, a bfloat16 output row a (b, h)
                nbytes = x.numel() * 4 + x[:, :, 0, 0].numel() * LONG["d"] * 2
                alone[name] = {
                    "ms": chip_smoke.median_ms(
                        lambda: fd.flash_decode_merge(x, torch.bfloat16)),
                    "bound_ms": nbytes / hbm_bw * 1e3}
            layer = time_long(fd, ref, q, k, v, full, where)
            blk = time_block(fd, ref, q, k, v, block, hbm_bw, where)
            print(json.dumps({
                "sweep": "combine", "warps": warps or "auto",
                "combine_alone": alone, "layer_ms": layer["ms"],
                "layer_n_chunks": layer["n_chunks"],
                "layer_split_ms": layer["split_ms"],
                "layer_combine_ms": layer["combine_ms"],
                "sdpa_ms": layer["library_ms"], "block_ms": blk["ms"],
                "block_n_chunks": blk["n_chunks"],
                "block_bound_ms": blk["bound_ms"]}), flush=True)
    finally:
        build._LOADED.pop(fd.LIBRARY, None)
        fd._lib.cache_clear()
    split = fd.split_plan
    try:
        for chunk in SPLIT_CHUNKS["long"]:
            fd.split_plan = _forced_split(chunk)
            layer = time_long(fd, ref, q, k, v, full, f"chunk {chunk}")
            print(json.dumps({
                "sweep": "split", "what": "long_500k layer", "chunk": chunk,
                "n_chunks": layer["n_chunks"], "ms": layer["ms"],
                "split_ms": layer["split_ms"],
                "combine_ms": layer["combine_ms"],
                "sdpa_ms": layer["library_ms"]}), flush=True)
        for chunk in SPLIT_CHUNKS["block"]:
            fd.split_plan = _forced_split(chunk)
            blk = time_block(fd, ref, q, k, v, block, hbm_bw,
                             f"chunk {chunk}")
            print(json.dumps({
                "sweep": "split", "what": "4-lane block", "chunk": chunk,
                "n_chunks": blk["n_chunks"], "ms": blk["ms"],
                "bound_ms": blk["bound_ms"]}), flush=True)
    finally:
        fd.split_plan = split


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
    if sys.argv[1:] == ["--combine-sweep"]:
        combine_sweep()
        return 0
    hbm_bw = chip_smoke.hw()["hbm_bw"]
    for src in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", src,
                               repr(hbm_bw)])
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
