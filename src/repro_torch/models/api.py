"""Model API of the port: `build_bundle(arch)` → init, optimizer, step
functions, inputs and model FLOPs for every LM shape (train, prefill,
decode), for each of the five LM architectures of the registry (dense
GQA, partial rotary, MLA, MoE).

    bundle = build_bundle("qwen2-1.5b", reduced=True, device="cpu")
    model = bundle.init_fn(0)
    opt_state = bundle.optimizer.init(dict(model.named_parameters()))
    model, opt_state, metrics = bundle.steps["train"](
        model, opt_state, bundle.make_inputs("train_4k"))
    logits = bundle.steps["prefill"](model, bundle.make_inputs("prefill_32k"))
    caches = bundle.init_caches(batch, max_len)
    logits, caches = bundle.steps["decode"](model, caches, batch_inputs)

The train step updates the model's parameters and the optimizer's moments
in place (the reference returns new trees; the values are equal).
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
from repro_torch.train.optimizer import AdamW

__all__ = ["ModelBundle", "build_bundle"]


@dataclasses.dataclass
class ModelBundle:
    arch: str
    cfg: Any
    device: torch.device
    init_fn: Callable            # (seed=0, dtype=float32) -> LM
    optimizer: AdamW
    init_caches: Callable        # (batch, max_len, dtype=bf16) -> caches
    steps: dict                  # shape kind -> step callable
    input_specs: Callable        # (shape_id) -> {name: (shape, dtype)}
    make_inputs: Callable        # (shape_id, seed=0, batch=None) -> tensors
    model_flops: Callable        # (shape_id) -> float


def build_bundle(arch: str, *, reduced: bool = False,
                 override: dict | None = None, device=None) -> ModelBundle:
    """The bundle of `arch` on `device` (the card unless "cpu" is asked
    for). `reduced` selects the tiny same-family config, and the reduced
    shapes that the reference's bundle uses; `override` replaces config
    fields, as the reference's does."""
    cfg = get_config(arch, reduced=reduced)
    if override:
        cfg = dataclasses.replace(cfg, **override)
    dev = resolve_device(device)
    opt = AdamW(lr=3e-4)

    def init_fn(seed: int = 0, dtype=torch.float32):
        """The model with each weight drawn on the device and stored in
        `dtype` as it is made (one float32 draw of one tensor at a time,
        never a float32 copy of the model)."""
        return T.lm_init(cfg, seed=seed, device=dev, dtype=dtype)

    def init_caches(batch: int, max_len: int, dtype=torch.bfloat16):
        """Zero decode caches in the attention's layout: GQA {"k", "v"},
        MLA {"c_kv", "k_rope"}, stacked over layers."""
        return T.lm_init_caches(cfg, batch, max_len, dtype=dtype, device=dev)

    def train_step(model, opt_state, batch, *, dtype=torch.bfloat16):
        """Microbatched (gradient-accumulation) train step: `grad_accum`
        microbatches of consecutive rows when the batch divides by it, else
        one; gradients summed in a float32 buffer and divided by their
        count, the loss averaged, then one AdamW update. Returns (model,
        opt_state, {"loss", "gnorm"})."""
        tokens = batch["tokens"]
        b = tokens.shape[0]
        a = cfg.grad_accum if b % max(cfg.grad_accum, 1) == 0 else 1
        params = dict(model.named_parameters())
        leaves = list(params.values())
        gacc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for tok in tokens.reshape(a, b // a, tokens.shape[1]):
            loss, _ = T.lm_loss(model, tok, dtype=dtype)
            # the gradients live only for this statement: the update
            # below runs with the accumulation buffer alone
            torch._foreach_add_(gacc, [g.float() for g in torch.autograd.grad(
                loss, leaves)])
            loss_sum += loss.detach()
        torch._foreach_div_(gacc, a)
        _, opt_state, gnorm = opt.update(dict(zip(params, gacc)), opt_state,
                                         params)
        return model, opt_state, {"loss": loss_sum / a, "gnorm": gnorm}

    def prefill_step(model, batch, *, dtype=torch.bfloat16):
        return T.lm_prefill_logits(model, batch["tokens"], dtype=dtype)

    def decode_step(model, caches, batch, *, dtype=torch.bfloat16,
                    use_kernel: bool = True):
        return T.lm_decode_step(model, batch["token"], caches,
                                batch["lengths"], dtype=dtype,
                                use_kernel=use_kernel)

    def shape_dims(shape_id, batch=None):
        spec = LM_SHAPES[shape_id]
        b, s = spec["global_batch"], spec["seq_len"]
        if reduced:
            b, s = max(b // 64, 2), min(s, 128)
        return spec["kind"], (b if batch is None else batch), s

    def input_specs(shape_id):
        kind, b, s = shape_dims(shape_id)
        if kind in ("train", "prefill"):
            return {"tokens": ((b, s), torch.int32)}
        return {"token": ((b,), torch.int32), "lengths": ((b,), torch.int32)}

    def make_inputs(shape_id, seed: int = 0, batch: int | None = None):
        """The reference's inputs for `shape_id` (same numpy draws: tokens
        (B, S) for train and prefill; for decode one token a row and
        lengths in [1, S-2]); `batch` cuts the shape's batch (the draws
        then differ from the reference's)."""
        kind, b, s = shape_dims(shape_id, batch)
        rng = np.random.default_rng(seed)
        if kind in ("train", "prefill"):
            tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
            return {"tokens": torch.from_numpy(tokens).to(dev)}
        token = rng.integers(0, cfg.vocab, (b,)).astype(np.int32)
        lengths = rng.integers(1, s - 1, (b,)).astype(np.int32)
        return {"token": torch.from_numpy(token).to(dev),
                "lengths": torch.from_numpy(lengths).to(dev)}

    def model_flops(shape_id):
        """2 (6 in training) · active parameters (a MoE counts its top-k
        experts only) · tokens, as the reference counts them."""
        kind, b, s = shape_dims(shape_id)
        n_active = cfg.n_active_params()
        if kind == "train":
            return 6.0 * n_active * b * s
        if kind == "prefill":
            return 2.0 * n_active * b * s
        return 2.0 * n_active * b     # decode: one token per row

    return ModelBundle(arch=arch, cfg=cfg, device=dev,
                       init_fn=init_fn, optimizer=opt,
                       init_caches=init_caches,
                       steps={"train": train_step, "prefill": prefill_step,
                              "decode": decode_step},
                       input_specs=input_specs, make_inputs=make_inputs,
                       model_flops=model_flops)
