"""Model API of the port: `build_bundle(arch)` → init, step functions and
inputs for the LM decode shapes.

    bundle = build_bundle("qwen2-1.5b", reduced=True, device="cpu")
    model = bundle.init_fn(0)
    caches = bundle.init_caches(batch, max_len)
    logits, caches = bundle.steps["decode"](model, caches, batch_inputs)

Only decode is ported: `steps["train"]` and `steps["prefill"]` raise
NotImplementedError, as do the shape functions for their shapes
(ROADMAP.md Queue 1 lists what remains).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.config import LM_SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.nn import transformer as T

__all__ = ["ModelBundle", "build_bundle"]


@dataclasses.dataclass
class ModelBundle:
    arch: str
    cfg: Any
    device: torch.device
    init_fn: Callable            # (seed=0, dtype=float32) -> LM
    init_caches: Callable        # (batch, max_len, dtype=bf16) -> caches
    steps: dict                  # shape kind -> step callable
    input_specs: Callable        # (shape_id) -> {name: (shape, dtype)}
    make_inputs: Callable        # (shape_id, seed=0, batch=None) -> tensors
    model_flops: Callable        # (shape_id) -> float


def _not_ported(kind: str) -> Callable:
    def step(*args, **kwargs):
        raise NotImplementedError(f"the {kind} step is not ported yet "
                                  "(ROADMAP.md Queue 1)")
    return step


def build_bundle(arch: str, *, reduced: bool = False,
                 device=None) -> ModelBundle:
    """The bundle of `arch` on `device` (the card unless "cpu" is asked
    for). `reduced` selects the tiny same-family config, and the reduced
    shapes that the reference's bundle uses."""
    cfg = get_config(arch, reduced=reduced)
    dev = resolve_device(device)

    def init_fn(seed: int = 0, dtype=torch.float32):
        return T.lm_init(cfg, seed=seed, device=dev, dtype=dtype)

    def init_caches(batch: int, max_len: int, dtype=torch.bfloat16):
        return T.lm_init_caches(cfg, batch, max_len, dtype=dtype, device=dev)

    def decode_step(model, caches, batch, *, dtype=torch.bfloat16,
                    use_kernel: bool = True):
        return T.lm_decode_step(model, batch["token"], caches,
                                batch["lengths"], dtype=dtype,
                                use_kernel=use_kernel)

    def shape_dims(shape_id, batch=None):
        spec = LM_SHAPES[shape_id]
        if spec["kind"] != "decode":
            raise NotImplementedError(f"{shape_id}: {spec['kind']} shapes "
                                      "are not ported yet (ROADMAP.md "
                                      "Queue 1)")
        b, s = spec["global_batch"], spec["seq_len"]
        if reduced:
            b, s = max(b // 64, 2), min(s, 128)
        return (b if batch is None else batch), s

    def input_specs(shape_id):
        b, _ = shape_dims(shape_id)
        return {"token": ((b,), torch.int32), "lengths": ((b,), torch.int32)}

    def make_inputs(shape_id, seed: int = 0, batch: int | None = None):
        """The reference's inputs for `shape_id` (same numpy draws, so the
        same tokens and lengths in [1, S-2]); `batch` cuts the shape's
        batch (the draws then differ from the reference's)."""
        b, s = shape_dims(shape_id, batch)
        rng = np.random.default_rng(seed)
        token = rng.integers(0, cfg.vocab, (b,)).astype(np.int32)
        lengths = rng.integers(1, s - 1, (b,)).astype(np.int32)
        return {"token": torch.from_numpy(token).to(dev),
                "lengths": torch.from_numpy(lengths).to(dev)}

    def model_flops(shape_id):
        b, _ = shape_dims(shape_id)
        return 2.0 * cfg.n_active_params() * b     # one token per row

    return ModelBundle(arch=arch, cfg=cfg, device=dev,
                       init_fn=init_fn, init_caches=init_caches,
                       steps={"decode": decode_step,
                              "train": _not_ported("train"),
                              "prefill": _not_ported("prefill")},
                       input_specs=input_specs, make_inputs=make_inputs,
                       model_flops=model_flops)
