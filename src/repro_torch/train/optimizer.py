"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule, on tensors: the reference's `repro.train.optimizer`.

Parameters, gradients and the moments are flat dicts keyed by parameter
name (`dict(model.named_parameters())`). `AdamW.update` computes what the
reference's does — float32 moments, bias correction, `p - lr·(u + wd·p)`
after clipping the gradients to `clip_norm`, the pre-clip norm returned as
`gnorm` — but writes the parameters and the moments in place, leaf by
leaf, as the decode cache is written in place.
`torch.optim.AdamW` decays before the moment step and has no global-norm
clip, so it is not used. On a mesh the parameters, gradients and moments
are DTensors of one placement each, every update is local to a shard, and
the clipping norm is the global one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.distributed.sharding import full

__all__ = ["AdamW", "cosine_schedule", "global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a dict of
    tensors or a sequence of them). A DTensor leaf counts whole (its
    shards' norms reduced over its mesh), so the norm of a sharded tree is
    the global one; the result is a plain tensor."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    norms = [full(n) for n in torch._foreach_norm([x.float()
                                                   for x in leaves])]
    return torch.linalg.vector_norm(torch.stack(norms))


def _clip_scale(n: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)


def clip_by_global_norm(tree: dict, max_norm: float):
    """(the tree scaled to a global norm of at most max_norm, the norm)."""
    n = global_norm(tree)
    scale = _clip_scale(n, max_norm)
    return {k: x * scale.to(x.dtype) for k, x in tree.items()}, n


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """lr(step): linear warmup to base_lr over `warmup` steps, then a
    cosine decay to 0 at `total`. step: an int or an integer tensor; the
    result is a float32 tensor on step's device."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float | None = 1.0

    def init(self, params: dict) -> dict:
        """Zero float32 moments keyed like `params`, and step 0 (an int32
        scalar on the parameters' device)."""
        params = dict(params)
        dev = next(iter(params.values())).device
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return {"m": zeros,
                "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        """One step: writes `params` and the moments in place and returns
        (params, the new state, the pre-clip gradient norm). Leaf by leaf,
        so the temporaries are a few times the largest leaf, not the
        whole model."""
        step = state["step"] + 1
        gnorm = global_norm([grads[k] for k in params])
        scale = (_clip_scale(gnorm, self.clip_norm)
                 if self.clip_norm is not None else None)
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1c = 1.0 - self.b1 ** step.float()
        b2c = 1.0 - self.b2 ** step.float()
        for k, p in params.items():
            g = grads[k].float()
            if scale is not None:
                g = g * scale
            m, v = state["m"][k], state["v"][k]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            u = (m / b1c).div_((v / b2c).sqrt_().add_(self.eps))
            p32 = p.float()
            p32.sub_(u.add_(p32, alpha=self.weight_decay).mul_(lr))
            if p32 is not p:                # a parameter stored below f32
                p.copy_(p32)
        return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm
