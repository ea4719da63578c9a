"""Training loop: bundle + data stream + supervisor, the single entry
point of `launch/train.py` (the reference's `repro.train.trainer`)."""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.api import build_bundle
from repro_torch.runtime.ft import FaultInjector, SuperviseResult, Supervisor

__all__ = ["TrainLoop", "lm_token_stream"]


def lm_token_stream(vocab: int, batch: int, seq: int, *, seed: int = 0,
                    cycle: int = 8, device=None) -> Callable:
    """Deterministic synthetic LM token stream: batch_fn(step) → {"tokens":
    (batch, seq) int32 on `device`, the card unless "cpu" is asked for}.
    `cycle` repeats a finite pool of batches so a smoke-training run has
    learnable structure (memorization → monotone loss). The reference's
    draws: its process index is 0 on one host, as here."""
    dev = resolve_device(device)
    base = seed * 1_000_003

    def batch_fn(step: int):
        rng = np.random.default_rng(base + (step % cycle))
        tokens = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
        return {"tokens": torch.from_numpy(tokens).to(dev)}

    return batch_fn


@dataclasses.dataclass
class TrainLoop:
    """A supervised training run of `arch` on `device` (the card unless
    "cpu" is asked for), with weights from `seed` and checkpoints under
    `ckpt_dir` every `ckpt_every` steps."""
    arch: str
    reduced: bool = True
    n_steps: int = 20
    batch: int = 8
    seq: int = 64
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 5
    seed: int = 0
    device: str | None = None

    def run(self, *, injector: FaultInjector | None = None,
            batch_fn: Callable | None = None) -> SuperviseResult:
        bundle = build_bundle(self.arch, reduced=self.reduced,
                              device=self.device)
        model = bundle.init_fn(self.seed)
        params = dict(model.named_parameters())
        state = {"params": params, "opt": bundle.optimizer.init(params)}
        if batch_fn is None:
            batch_fn = lm_token_stream(bundle.cfg.vocab, self.batch, self.seq,
                                       seed=self.seed, device=bundle.device)
        train = bundle.steps["train"]

        def step_fn(state, batch):
            _, opt, metrics = train(model, state["opt"], batch)
            return {"params": state["params"], "opt": opt}, metrics

        sup = Supervisor(self.ckpt_dir, ckpt_every=self.ckpt_every)
        return sup.run(state, step_fn, batch_fn, self.n_steps,
                       injector=injector)
