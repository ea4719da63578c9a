"""Wrapper of the Hopper decode-attention kernel (`csrc/flash_decode.cu`).

    flash_decode(q, k, v, lengths=None) -> out (B, H, D)

q (B, H, D) and the cache k, v (B, S, Hkv, D) are float32 or bfloat16 (the
cache may differ from q); out has q's dtype. The wrapper takes the plain
torch version (`ref.flash_decode_ref`) only because its tensors lie on the
CPU; CUDA tensors launch the kernel, and anything else raises. It counts
its kernel launches in a plain integer attribute, `launches`.

Contract (kernel and plain version alike): 1 <= lengths[b] <= S. A row with
lengths[b] == 0 has nothing to attend to and gives NaN; the wrapper does
not check the values, which would cost a device-to-host sync per call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import load_library

__all__ = ["flash_decode", "reset_launches", "LIBRARY", "MAX_HEAD_DIM"]

LIBRARY = "flash_decode"
MAX_HEAD_DIM = 256                      # kMaxHeadDim in the CUDA source
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = load_library(LIBRARY)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cemr_flash_decode_max_head_dim.argtypes = []
    lib.cemr_flash_decode_max_head_dim.restype = i
    lib.cemr_error_string.argtypes = [i]
    lib.cemr_error_string.restype = ctypes.c_char_p
    lib.cemr_flash_decode.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                      ctypes.c_float, i, i, p]
    lib.cemr_flash_decode.restype = i
    if lib.cemr_flash_decode_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("flash_decode library and wrapper disagree on "
                           "the largest head dim")
    return lib


def _check(q, k, v, lengths) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, H, D) and k, v (B, S, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or s < 1 or hkv < 1 \
            or h % hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit the cache "
                         f"{tuple(k.shape)} (H a multiple of Hkv, S >= 1)")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise TypeError(f"q and the cache must be float32 or bfloat16, k "
                        f"and v alike; got {q.dtype}, {k.dtype}, {v.dtype}")
    tensors = [("q", q), ("k", k), ("v", v)]
    if lengths is not None:
        if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
            raise TypeError(f"lengths must be int32 of shape ({b},), got "
                            f"{lengths.dtype} {tuple(lengths.shape)}")
        tensors.append(("lengths", lengths))
    for name, x in tensors:
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _scale(d: int) -> float:
    """1/sqrt(D) rounded as the reference rounds it: in float32."""
    return float(1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32)))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token GQA decode attention: per (b, h), the softmax over
    positions < lengths[b] of q·k / sqrt(D), applied to v, with KV head
    h // (H / Hkv). fp32 accumulation; out (B, H, D) in q's dtype."""
    _check(q, k, v, lengths)
    dev = q.device
    if dev.type == "cpu":
        return ref.flash_decode_ref(q, k, v, lengths)
    if dev.type != "cuda":
        raise ValueError(f"flash_decode runs on cpu or cuda, not {dev}")
    lib = _lib()
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cemr_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr() if lengths is not None else None,
            out.data_ptr(), b, h, hkv, s, d, _scale(d),
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
            stream)
    if code != 0:
        msg = lib.cemr_error_string(code).decode()
        raise RuntimeError(f"flash_decode launch failed: CUDA error {code} "
                           f"({msg})")
    flash_decode.launches += 1
    return out


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    flash_decode.launches = 0


reset_launches()
