"""Train each assigned GNN architecture on its molecule / sampled workloads
on the torch port (the reduced config), on the card unless `--device cpu`
is given.

  PYTHONPATH=src python examples/torch_gnn_train.py --arch nequip --steps 30
  PYTHONPATH=src python examples/torch_gnn_train.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models.api import build_bundle


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="nequip",
                    choices=["nequip", "equiformer-v2", "gatedgcn", "dimenet"])
    ap.add_argument("--shape", default="molecule")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the card; without one, "
                         "an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    bundle = build_bundle(args.arch, reduced=True, device=dev)
    model = bundle.init_fn_for(args.shape)(0)
    opt_state = bundle.optimizer.init(dict(model.named_parameters()))
    step = bundle.steps["train"]       # updates the model in place
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = bundle.make_inputs(args.shape, seed=i % 8)
        _, opt_state, metrics = step(model, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if i % 10 == 0:
            print(f"step {i:4d} loss {losses[-1]:.5f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.5f} on {dev} "
          f"({dt / args.steps * 1e3:.1f} ms a step)")
    assert losses[-1] < losses[0], "training should reduce loss"
    print("OK: loss decreased")
    return {"device": str(dev), "arch": args.arch, "shape": args.shape,
            "losses": losses, "seconds": dt,
            "ms_per_step": dt / args.steps * 1e3}


if __name__ == "__main__":
    main()
