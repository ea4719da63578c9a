"""Training launcher of the port: the supervised train step of an LM
bundle, with checkpoints and restart on failure, on one device or over a
(data, model) mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 50                            # reduced config, on the card
  PYTHONPATH=src python -m repro_torch.launch.train --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --full --batch 4 \\
      --seq 4096 --steps 3                  # qwen2-1.5b at full width
  PYTHONPATH=src python -m repro_torch.launch.train --arch \\
      granite-moe-3b-a800m --steps 4 --device cpu   # any LM id
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --device cpu --steps 3 --data-axis 2 \\
      --model-axis 2                        # 4 gloo ranks, a (2, 2) mesh

One process prints `device=… steps=… restarts=…` and `loss a -> b`.
Under `torch.distributed.run` (RANK and WORLD_SIZE set) every rank joins
the default group — NCCL on the cards (rank i on card LOCAL_RANK), gloo
with `--device cpu` — builds `make_local_mesh(--data-axis,
--model-axis)` (`--data-axis` defaults to every rank over the model
axis), distributes the model by the policy and runs the supervised step
in its sharding context, as the reference's launcher does; rank 0 prints
the reference's two lines, `mesh={…} steps=… restarts=…` and the loss.
Everything runs on the card unless given `--device cpu`.
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
    ap.add_argument("--data-axis", type=int, default=None,
                    help="data-parallel ranks (default: every rank over "
                         "--model-axis)")
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
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return _main_distributed(args)
    if (args.data_axis or 1, args.model_axis) != (1, 1):
        raise SystemExit(
            f"--data-axis {args.data_axis} --model-axis {args.model_axis} "
            "needs that many ranks: run under torch.distributed.run")
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


def _main_distributed(args) -> int:
    """One rank of a `torch.distributed.run` launch (see the module
    docstring)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    device = args.device
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        device = f"cuda:{torch.cuda.current_device()}"
    dist.init_process_group("gloo" if cpu else "nccl")
    try:
        mesh = make_local_mesh(args.data_axis, args.model_axis,
                               device="cpu" if cpu else "cuda")
        loop = TrainLoop(arch=args.arch, reduced=args.reduced,
                         n_steps=args.steps, batch=args.batch, seq=args.seq,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         device=device, mesh=mesh)
        res = loop.run()
        if dist.get_rank() == 0:
            first, last = res.history[0], res.history[-1]
            shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
            print(f"mesh={shape} steps={res.steps_run} "
                  f"restarts={res.restarts}")
            print(f"loss {first['loss']:.4f} -> {last['loss']:.4f}")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
