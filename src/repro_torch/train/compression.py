"""Gradient compression for the data-parallel all-reduce: int8 quantization
with error feedback (residual carry), the reference's
`repro.train.compression` on tensors and `torch.distributed`.

`compressed_psum(x, group)` is an int8 all-reduce over a process group:
each rank quantizes its tensor, the codes and one scale a rank are
all-gathered, and every rank dequantizes and sums them locally in rank
order — 4x fewer interconnect bytes than a float32 all-reduce for the
payload, and one quantization's precision loss, not log(n).
`compressed_allreduce_tree(grads, mesh, axes)` applies it leaf by leaf
over the process group of one mesh axis (the reference's `shard_map`
over that axis). Library functions, as in the reference: the trainer
has no flag that calls them.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum",
           "compressed_allreduce_tree", "ef_compress_update"]


def quantize_int8(x: torch.Tensor):
    """(int8 codes, a scale in x's dtype) with x ≈ codes · scale, round
    half to even, codes clipped to ±127."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_update(grad: torch.Tensor, residual: torch.Tensor):
    """Error-feedback compression of one gradient leaf: returns the
    dequantized (communicated) gradient and the new residual."""
    target = grad.float() + residual
    q, scale = quantize_int8(target)
    deq = dequantize_int8(q, scale)
    return deq, target - deq


def compressed_psum(x: torch.Tensor, group) -> torch.Tensor:
    """int8 all-reduce of x over `group` (a process group, or a
    `(DeviceMesh, mesh dim)` pair): quantize locally, all-gather the
    (codes, scale) pairs, dequantize and sum them locally in rank order.
    Returns a float32 tensor of x's shape, the same on every rank."""
    from repro_torch.distributed.sharding import all_gather
    q, scale = quantize_int8(x)
    qs = all_gather(q.reshape(-1), 0, group)
    ss = all_gather(scale.float().reshape(1), 0, group)
    n = ss.shape[0]
    return torch.tensordot(ss, qs.reshape((n,) + tuple(x.shape)).float(),
                           dims=([0], [0]))


def compressed_allreduce_tree(grads: dict, mesh, axes=("data",)) -> dict:
    """`compressed_psum` of every leaf of `grads` (name → tensor; a DTensor
    leaf is summed on its local shard) over the first of `axes` of `mesh`,
    a torch `DeviceMesh`: the reduction of gradients that are
    data-parallel partial sums. Plain leaves come back plain, DTensor
    leaves as DTensors of their placements, a partial sum over the axis
    now replicated over it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dim = list(mesh.mesh_dim_names).index(axes[0])
    out = {}
    for name, g in grads.items():
        if isinstance(g, DTensor):
            pl = [Replicate() if i == dim and isinstance(p, Partial) else p
                  for i, p in enumerate(g.placements)]
            out[name] = DTensor.from_local(
                compressed_psum(g.to_local(), (mesh, dim)), g.device_mesh,
                pl, run_check=False)
        else:
            out[name] = compressed_psum(g, (mesh, dim))
    return out
