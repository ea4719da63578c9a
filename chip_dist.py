"""Phase 5e of `chip_smoke.py` alone, for a machine with several cards.

    python3 chip_dist.py

Builds the bitmap and flash_decode kernels and runs
`chip_smoke.run_phase_5e` without its dry runs (they trace on the host
alone, whatever the cards; `chip_smoke.py` runs them): one NCCL rank a
visible card on a (data, model) mesh ((2, 2) on four cards), qwen2-1.5b
at full width trained one float32 train_4k step by the policy and held
against the undistributed step, 3 decode_32k steps over a cache sharded
by `cache_bsnd` held against the whole-cache decode in float32 and
against the plain attention in bf16 (each partials and merge call held
against its plain version), and the engine cell at the reference's
default size bit for bit against the plain version and `bitmap_intersect`
over the whole tables; on four cards the FFN's `wi` must be sharded. Exits
non-zero with fewer than two cards, or when any check or rank fails.
Prints the card line, the phase's JSON and, last, `{"ok": true,
"device": {...}}`.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_dist: needs two or more CUDA devices", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd

    t0 = time.perf_counter()
    card = cs.card_line()
    print(f"card: {card}; {torch.cuda.device_count()} cards", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    for name, (lib, secs) in cs.build_all(
            build, (bi.LIBRARY, fd.LIBRARY)).items():
        print(f"build: {lib.name} in {secs:.3f} s", flush=True)
    res = cs.run_phase_5e(card, dryruns=False)
    if res["ranks"] >= 4 and res["train"]["placed"]["wi_local_shape"] \
            == res["train"]["placed"]["wi_shape"]:
        raise SystemExit("wi is not sharded on a mesh of four cards")
    print(f"chip_dist: all in {time.perf_counter() - t0:.3f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
