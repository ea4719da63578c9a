"""Serving launcher of the port: batched greedy LM decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --tokens 16 --batch 4                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

`main` serves the reduced config, as the reference's launcher does;
`decode_loop` serves any bundle, full width included (`chip_smoke.py`).
Subgraph-match serving (`--arch match`) needs the batched `match_many`,
which is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.models.api import ModelBundle, build_bundle

__all__ = ["decode_loop", "main"]


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.arch == "match":
        raise NotImplementedError(
            "--arch match serves through Matcher.match_many, which the port "
            "has not got yet (ROADMAP.md Queue 1, item 7)")
    bundle = build_bundle(args.arch, reduced=True, device=args.device)
    # weights stored in the activation dtype: the same numbers as the
    # reference's float32 weights cast at every use
    model = bundle.init_fn(0, dtype=torch.bfloat16)
    res = decode_loop(bundle, model, batch=args.batch, tokens=args.tokens)
    print(f"decoded {args.tokens} tokens × batch {args.batch} on "
          f"{bundle.device} in {res['seconds']:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s)")
    print("sample:", res["tokens"][:10, 0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
