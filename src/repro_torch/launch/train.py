"""Training launcher of the port: the supervised train step of an LM
bundle, with checkpoints and restart on failure, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 50                            # reduced config, on the card
  PYTHONPATH=src python -m repro_torch.launch.train --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --full --batch 4 \\
      --seq 4096 --steps 3                  # qwen2-1.5b at full width
  PYTHONPATH=src python -m repro_torch.launch.train --arch \\
      granite-moe-3b-a800m --steps 4 --device cpu   # any LM id

Prints `device=… steps=… restarts=…` and `loss a -> b`, the reference
launcher's two lines. Data- and model-parallel meshes (`--data-axis`,
`--model-axis` other than 1) wait for the distributed item of ROADMAP.md
Queue 1. Everything runs on the card unless given `--device cpu`.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.registry import get_config
from repro_torch.train.trainer import TrainLoop

__all__ = ["parse_args", "main"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="an LM id of configs/registry.py")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    family = get_config(args.arch).family
    if family != "lm":
        raise SystemExit(f"--arch {args.arch}: a {family} model; this "
                         "launcher trains the LM ids (its token stream is "
                         "an LM's), as the reference's does")
    if (args.data_axis, args.model_axis) != (1, 1):
        raise NotImplementedError(
            f"--data-axis {args.data_axis} --model-axis {args.model_axis}: "
            "multi-card data and model parallelism wait for the "
            "distributed item (ROADMAP.md Queue 1)")
    loop = TrainLoop(arch=args.arch, reduced=args.reduced,
                     n_steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     device=args.device)
    res = loop.run()
    first, last = res.history[0], res.history[-1]
    device = "cuda" if args.device is None else args.device
    print(f"device={device} steps={res.steps_run} restarts={res.restarts}")
    print(f"loss {first['loss']:.4f} -> {last['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
