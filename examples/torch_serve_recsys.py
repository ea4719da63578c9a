"""Serve a BERT4Rec model on the torch port: batched next-item scoring and
1M-candidate retrieval (the reduced config), on the card unless
`--device cpu` is given.

  PYTHONPATH=src python examples/torch_serve_recsys.py               # CUDA
  PYTHONPATH=src python examples/torch_serve_recsys.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models.api import build_bundle


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the card; without one, "
                         "an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    bundle = build_bundle("bert4rec", reduced=True, device=dev)
    model = bundle.init_fn(0)

    serve = bundle.steps["serve"]
    batch = bundle.make_inputs("serve_p99")
    vals, idx = serve(model, batch)      # warm
    top = []
    _sync(dev)
    t0 = time.perf_counter()
    n_req = 20
    for s in range(n_req):
        batch = bundle.make_inputs("serve_p99", seed=s)
        vals, idx = serve(model, batch)
        top.append((vals, idx))
    _sync(dev)
    dt = time.perf_counter() - t0
    b = batch["ids"].shape[0]
    print(f"serve_p99 on {dev}: {n_req} batches of {b} in {dt:.3f}s "
          f"({n_req * b / dt:.0f} req/s), top-10 ids sample "
          f"{idx[0][:5].tolist()}")

    rb = bundle.make_inputs("retrieval_cand")
    scores = bundle.steps["retrieval"](model, rb)
    print(f"retrieval: scored {scores.shape[1]} candidates for "
          f"{scores.shape[0]} query → top={float(scores.max()):.3f}")
    return {"device": str(dev), "batches": n_req, "batch": b,
            "seconds": dt, "requests_per_s": n_req * b / dt,
            "top": top, "retrieval_scores": scores,
            "model": model}


if __name__ == "__main__":
    main()
