"""Training loop: bundle + data stream + supervisor, the single entry
point of `launch/train.py` (the reference's `repro.train.trainer`)."""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import tempfile
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.api import build_bundle
from repro_torch.runtime.ft import FaultInjector, SuperviseResult, Supervisor

__all__ = ["TrainLoop", "lm_token_stream", "mesh_token_stream"]


def lm_token_stream(vocab: int, batch: int, seq: int, *, seed: int = 0,
                    cycle: int = 8, device=None,
                    rank: int | None = None) -> Callable:
    """Deterministic synthetic LM token stream: batch_fn(step) → {"tokens":
    (batch, seq) int32 on `device`, the card unless "cpu" is asked for}.
    `cycle` repeats a finite pool of batches so a smoke-training run has
    learnable structure (memorization → monotone loss). `rank` folds into
    the seed, as the reference folds its process index, so processes draw
    their own slices; None takes this process's rank in the default group
    (0 without one: the reference's draws on one host)."""
    dev = resolve_device(device)
    if rank is None:
        import torch.distributed as dist
        rank = dist.get_rank() if dist.is_initialized() else 0
    base = seed * 1_000_003 + rank

    def batch_fn(step: int):
        rng = np.random.default_rng(base + (step % cycle))
        tokens = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
        return {"tokens": torch.from_numpy(tokens).to(dev)}

    return batch_fn


def mesh_token_stream(vocab: int, batch: int, seq: int, mesh, *,
                      seed: int = 0, cycle: int = 8, device=None) -> Callable:
    """The token stream of a (data, model) `DeviceMesh`: batch_fn(step) →
    {"tokens": a (batch, seq) DTensor placed by `policy.batch_pspecs`}.
    When the batch splits over the data-parallel axes, each data rank
    draws its own batch / dp rows (`lm_token_stream` with the data
    coordinate folded into the seed) and the ranks along `model` share
    them; otherwise every rank draws the whole batch of rank 0's stream,
    replicated."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import to_placements
    spec = policy.batch_pspecs("lm", "train", mesh, batch=batch)["tokens"]
    dp_dims = [mesh.mesh_dim_names.index(a) for a in spec.axes_of(0)]
    n_dp = 1
    coord = 0
    for i in dp_dims:       # the data coordinate, outermost axis first
        coord = coord * mesh.size(i) + mesh.get_coordinate()[i]
        n_dp *= mesh.size(i)
    local = lm_token_stream(vocab, batch // n_dp, seq, seed=seed,
                            cycle=cycle, device=device, rank=coord)
    placements = to_placements(spec, mesh)

    def batch_fn(step: int):
        tokens = local(step)["tokens"]
        return {"tokens": DTensor.from_local(tokens, mesh, placements,
                                             run_check=False)}

    return batch_fn


@dataclasses.dataclass
class TrainLoop:
    """A supervised training run of `arch` on `device` (the card unless
    "cpu" is asked for), with weights from `seed` and checkpoints under
    `ckpt_dir` every `ckpt_every` steps. With a `mesh` (a (data, model)
    `DeviceMesh` over every rank), the model is distributed by the policy
    and each step runs in the mesh's sharding context, as the reference's
    launcher runs it."""
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
    mesh: Any = None

    def run(self, *, injector: FaultInjector | None = None,
            batch_fn: Callable | None = None) -> SuperviseResult:
        bundle = build_bundle(self.arch, reduced=self.reduced,
                              device=self.device)
        model = bundle.init_fn(self.seed)
        ctx = contextlib.nullcontext
        if self.mesh is not None:
            from repro_torch.distributed import policy
            from repro_torch.distributed.sharding import sharding_ctx
            policy.distribute_model(model, bundle.cfg, self.mesh)
            rules = policy.activation_rules(bundle.cfg, self.mesh, "train",
                                            batch=self.batch)
            ctx = functools.partial(sharding_ctx, self.mesh, rules)
        params = dict(model.named_parameters())
        state = {"params": params, "opt": bundle.optimizer.init(params)}
        if batch_fn is None and self.mesh is not None:
            batch_fn = mesh_token_stream(bundle.cfg.vocab, self.batch,
                                         self.seq, self.mesh, seed=self.seed,
                                         device=bundle.device)
        elif batch_fn is None:
            batch_fn = lm_token_stream(bundle.cfg.vocab, self.batch, self.seq,
                                       seed=self.seed, device=bundle.device)
        train = bundle.steps["train"]

        def step_fn(state, batch):
            with ctx():
                _, opt, metrics = train(model, state["opt"], batch)
            return {"params": state["params"], "opt": opt}, metrics

        sup = Supervisor(self.ckpt_dir, ckpt_every=self.ckpt_every)
        return sup.run(state, step_fn, batch_fn, self.n_steps,
                       injector=injector)
