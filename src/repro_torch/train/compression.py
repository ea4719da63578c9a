"""Gradient compression for the data-parallel all-reduce: int8 quantization
with error feedback (residual carry), the reference's
`repro.train.compression` on tensors.

The reference's collectives over a `shard_map` mesh axis
(`compressed_psum`, `compressed_allreduce_tree`) wait for the distributed
item of ROADMAP.md Queue 1.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_update"]


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
