"""Wrappers of the Hopper bitmap-intersect kernels (`csrc/bitmap_intersect.cu`).

    bitmap_intersect(tables, idxs)                  -> (R (T, W), pop (T, 1))
    fused_expand_intersect(tables, idx, rows, bitpos, slots)
                                                    -> (R (T, W), pop (T, 1))

Bitmaps are int32 tensors carrying the reference's uint32 bits. A wrapper
takes the plain torch version (`ref.py`) only because its tensors lie on the
CPU; CUDA tensors launch the kernel, and anything else raises. Each wrapper
counts its kernel launches in a plain integer attribute, `launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import load_library

__all__ = ["bitmap_intersect", "fused_expand_intersect", "reset_launches",
           "LIBRARY"]

LIBRARY = "bitmap_intersect"

_META: dict[tuple, torch.Tensor] = {}
_META_MAX = 1024


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = load_library(LIBRARY)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cemr_max_tables.argtypes = []
    lib.cemr_max_tables.restype = i
    lib.cemr_error_string.argtypes = [i]
    lib.cemr_error_string.restype = ctypes.c_char_p
    lib.cemr_bitmap_intersect.argtypes = [p, i, p, i, i, p, p, p]
    lib.cemr_bitmap_intersect.restype = i
    lib.cemr_fused_expand_intersect.argtypes = [p, i, p, i, i, p, p, i, i,
                                                p, p, p]
    lib.cemr_fused_expand_intersect.restype = i
    return lib


def _check_tables(tables, device) -> int:
    if not tables:
        raise ValueError("need at least one table")
    w = tables[0].shape[1] if tables[0].dim() == 2 else -1
    for tbl in tables:
        if tbl.dtype != torch.int32 or tbl.dim() != 2:
            raise TypeError(f"tables must be 2-D int32, got {tbl.dtype} "
                            f"{tuple(tbl.shape)}")
        if tbl.shape[1] != w or tbl.shape[0] < 1:
            raise ValueError("tables must share one width and hold >= 1 row")
        if tbl.device != device:
            raise ValueError(f"table on {tbl.device}, indices on {device}")
        if not tbl.is_contiguous():
            raise ValueError("tables must be contiguous")
    return w


def _check_index(name, x, shape, device):
    if x.dtype != torch.int32 or tuple(x.shape) != shape:
        raise TypeError(f"{name} must be int32 of shape {shape}, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _meta(tables, slots=None) -> torch.Tensor:
    """Device int64 array [table addresses, row counts, (slots)], cached by
    its content so a fixed set of tables uploads it once."""
    vals = ([t.data_ptr() for t in tables] + [t.shape[0] for t in tables]
            + (list(slots) if slots is not None else []))
    key = (tables[0].device, tuple(vals))
    m = _META.get(key)
    if m is None:
        if len(_META) >= _META_MAX:
            _META.clear()
        m = torch.tensor(vals, dtype=torch.int64).to(tables[0].device)
        _META[key] = m
    return m


def _raise_on(code: int, lib: ctypes.CDLL, what: str) -> None:
    if code != 0:
        msg = lib.cemr_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _outputs(n_out, w, device):
    return (torch.empty((n_out, w), dtype=torch.int32, device=device),
            torch.empty((n_out, 1), dtype=torch.int32, device=device))


def bitmap_intersect(tables, idxs: torch.Tensor):
    """R[t] = AND_j tables[j][idxs[t, j]]; pop[t] = popcount(R[t]).

    tables: k × (S_j, W) int32, contiguous; idxs: (T, k) int32.
    Returns (R (T, W) int32, pop (T, 1) int32)."""
    tables = tuple(tables)
    dev = idxs.device
    w = _check_tables(tables, dev)
    k = len(tables)
    _check_index("idxs", idxs, (idxs.shape[0], k), dev)
    if dev.type == "cpu":
        return ref.bitmap_intersect_ref(tables, idxs)
    if dev.type != "cuda":
        raise ValueError(f"bitmap_intersect runs on cpu or cuda, not {dev}")
    lib = _lib()
    if k > lib.cemr_max_tables():
        raise ValueError(f"at most {lib.cemr_max_tables()} tables, got {k}")
    n_out = idxs.shape[0]
    r, pop = _outputs(n_out, w, dev)
    if n_out == 0:
        return r, pop
    meta = _meta(tables)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cemr_bitmap_intersect(
            meta.data_ptr(), k, idxs.data_ptr(), n_out, w, r.data_ptr(),
            pop.data_ptr(), stream)
    _raise_on(code, lib, "bitmap_intersect")
    bitmap_intersect.launches += 1
    return r, pop


def fused_expand_intersect(tables, idx: torch.Tensor, rows: torch.Tensor,
                           bitpos: torch.Tensor, slots):
    """Fused frontier expansion + k-way AND + popcount: slot s < K0 reads
    table row idx[rows[t], s], slot s == K0 reads bitpos[t].

    tables: k × (S_j, W) int32; idx: (Tin, K0) int32 parent index columns
    (K0 may be 0); rows, bitpos: (T,) int32; slots: k ints in [0, K0].
    Returns (R (T, W) int32, pop (T, 1) int32), unmasked."""
    tables = tuple(tables)
    slots = tuple(int(s) for s in slots)
    dev = rows.device
    w = _check_tables(tables, dev)
    k = len(tables)
    n_out = rows.shape[0]
    if idx.dim() != 2 or idx.shape[0] < 1:
        raise ValueError(f"idx must be (Tin >= 1, K0), got {tuple(idx.shape)}")
    n_in, k0 = idx.shape
    _check_index("idx", idx, (n_in, k0), dev)
    _check_index("rows", rows, (n_out,), dev)
    _check_index("bitpos", bitpos, (n_out,), dev)
    if len(slots) != k or any(s < 0 or s > k0 for s in slots):
        raise ValueError(f"slots must be {k} ints in [0, {k0}], got {slots}")
    if dev.type == "cpu":
        return ref.fused_expand_intersect_ref(tables, idx, rows, bitpos,
                                              slots=slots)
    if dev.type != "cuda":
        raise ValueError(f"fused_expand_intersect runs on cpu or cuda, "
                         f"not {dev}")
    lib = _lib()
    if k > lib.cemr_max_tables():
        raise ValueError(f"at most {lib.cemr_max_tables()} tables, got {k}")
    r, pop = _outputs(n_out, w, dev)
    if n_out == 0:
        return r, pop
    meta = _meta(tables, slots)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cemr_fused_expand_intersect(
            meta.data_ptr(), k, idx.data_ptr() if k0 else None, n_in, k0,
            rows.data_ptr(), bitpos.data_ptr(), n_out, w, r.data_ptr(),
            pop.data_ptr(), stream)
    _raise_on(code, lib, "fused_expand_intersect")
    fused_expand_intersect.launches += 1
    return r, pop


def reset_launches() -> None:
    """Set both wrappers' launch counts to 0."""
    bitmap_intersect.launches = 0
    fused_expand_intersect.launches = 0


reset_launches()
