"""End-to-end training driver on the torch port: train a reduced LM (any LM
id of `repro_torch.configs.registry`) for a few hundred steps with
checkpointing and fault tolerance, on the card unless `--device cpu` is
given.

  PYTHONPATH=src python examples/torch_train_lm.py --arch qwen2-1.5b \\
      --steps 200
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20

A run resumes from the newest checkpoint in `--ckpt-dir` (default: a
directory of its own in the temporary directory).
"""
import argparse
import os
import tempfile
import time

from repro_torch.device import resolve_device
from repro_torch.train.trainer import TrainLoop

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_train_lm")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the card; without one, "
                         "an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    loop = TrainLoop(arch=args.arch, reduced=True, n_steps=args.steps,
                     batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                     ckpt_every=50, device=str(dev))
    t0 = time.perf_counter()
    res = loop.run()
    dt = time.perf_counter() - t0
    if not res.history:
        raise SystemExit(f"{args.ckpt_dir} already holds a checkpoint at "
                         f"step {args.steps} or later: nothing to train; "
                         "pass a fresh --ckpt-dir")
    first, last = res.history[0], res.history[-1]
    print(f"steps={res.steps_run} restarts={res.restarts} on {dev} "
          f"({dt / len(res.history) * 1e3:.1f} ms a step, the model's build "
          "included)")
    print(f"loss: {first['loss']:.4f} -> {last['loss']:.4f}")
    assert last["loss"] < first["loss"], "training should reduce loss"
    print("OK: loss decreased")
    return {"device": str(dev), "steps_run": res.steps_run,
            "restarts": res.restarts, "first_loss": first["loss"],
            "last_loss": last["loss"], "seconds": dt,
            "ms_per_step": dt / len(res.history) * 1e3}


if __name__ == "__main__":
    main()
