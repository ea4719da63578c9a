"""Wrappers of the Hopper bitmap kernels (`csrc/bitmap_intersect.cu`).

    tile_intersect(tables, idx, slots, clear_slots, qid_slot)
                                                      -> (R (T, W), pop (T,))
    expand_select(r, start, n_out, idx)
        -> (rows, bitpos, valid, total, child_idx)
    expand_intersect(r, start, n_out, idx, tables, slots, clear_slots)
        -> (rows, bitpos, valid, total, child_idx, R2, pop2)
    bitmap_intersect(tables, idxs)                    -> (R (T, W), pop (T, 1))
    fused_expand_intersect(tables, idx, rows, bitpos, slots)
                                                      -> (R (T, W), pop (T, 1))

`tile_intersect` is the engine's whole pair-branch extension compute in one
launch: keys read from a tile's index columns, the AND, the same-label
clears and the popcount after them; with `qid_slot` (the superbatch's
query lane) each table is a stack of per-query tables and row t reads the
table of the query in its index column `qid_slot`. `expand_select` is the
frontier's
set-bit selection and the child tile's index columns; `expand_intersect`
adds the child's first extension to the same launch. `bitmap_intersect`
and `fused_expand_intersect` keep the TPU kernels' contracts as thin entry
points over the same device code.

Every entry point with an extend takes `words_per_block`, the word-block
width: the words one warp reads of a row in one pass (32 lanes times the
1, 2 or 4 words each lane keeps in flight of each table), one compiled
instantiation of each kernel per member of `FUSED_TILE_WIDTHS`. The width
changes how HBM is read, never what is computed: every width gives the
same bits, so each width is held against the one plain version, which has
no width (AND and popcount are the same over any blocking of the words).
128 is the default everywhere. The
fused route picks its width with `autotune_words_per_block`, the port of
the reference's sweep; the reference's widths (8, 16, 32 words) are a
TPU's tiling (lanes of a vector register) and do not carry over to a
warp.

Bitmaps are int32 tensors carrying the reference's uint32 bits. A wrapper
takes the plain torch version (`ref.py`) only because its tensors lie on the
CPU; CUDA tensors launch the kernel, and anything else raises. Each wrapper
counts its kernel launches in a plain integer attribute, `launches`;
`tile_intersect.lane_launches` counts those of them with a query lane, and
each wrapper that takes a width counts its launches by width in
`launches_by_width`, and those of them that `autotune_words_per_block`'s
sweeps made in `sweep_launches_by_width`.
"""
from __future__ import annotations

import ctypes
import functools
import operator
import time

import numpy as np
import torch

from ..device import resolve_device
from . import ref
from .build import load_library

__all__ = ["tile_intersect", "expand_select", "expand_intersect",
           "bitmap_intersect", "fused_expand_intersect",
           "autotune_words_per_block", "reset_launches", "WRAPPERS",
           "WIDTH_WRAPPERS", "LIBRARY", "MAX_TABLES", "MAX_CLEARS",
           "FUSED_TILE_WIDTHS", "DEFAULT_WORDS_PER_BLOCK"]

LIBRARY = "bitmap_intersect"
MAX_TABLES = 32                  # kMaxTables in the .cu source
MAX_CLEARS = 32                  # kMaxClears
SELECT_CTAS = 8                  # kSelectCtas
SMEM_CUM_ROWS = 8191             # kSmemCumRows
FUSED_TILE_WIDTHS = (32, 64, 128)   # kWidths: words a warp reads a pass
DEFAULT_WORDS_PER_BLOCK = 128


class _TableSet(ctypes.Structure):
    """The kernels' by-value parameter struct (`TableSet` in the source)."""
    _fields_ = [("base", ctypes.c_void_p * MAX_TABLES),
                ("rows", ctypes.c_int * MAX_TABLES),
                ("slot", ctypes.c_int * MAX_TABLES),
                ("clear", ctypes.c_int * MAX_CLEARS),
                ("k", ctypes.c_int),
                ("n_clear", ctypes.c_int),
                ("qslot", ctypes.c_int),
                ("nq", ctypes.c_int)]


_TABLE_SETS: dict[tuple, _TableSet] = {}
_TABLE_SETS_MAX = 1024


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = load_library(LIBRARY)
    p, i = ctypes.c_void_p, ctypes.c_int
    consts = {"cemr_max_tables": MAX_TABLES, "cemr_max_clears": MAX_CLEARS,
              "cemr_table_set_bytes": ctypes.sizeof(_TableSet),
              "cemr_select_ctas": SELECT_CTAS,
              "cemr_smem_cum_rows": SMEM_CUM_ROWS}
    for name, want in consts.items():
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
        if getattr(lib, name)() != want:
            raise RuntimeError(f"csrc/bitmap_intersect.cu and its wrapper "
                               f"disagree: {name}")
    lib.cemr_num_widths.argtypes = []
    lib.cemr_num_widths.restype = i
    lib.cemr_width.argtypes = [i]
    lib.cemr_width.restype = i
    lib.cemr_error_width.argtypes = []
    lib.cemr_error_width.restype = i
    widths = tuple(lib.cemr_width(j) for j in range(lib.cemr_num_widths()))
    if widths != FUSED_TILE_WIDTHS:
        raise RuntimeError(f"csrc/bitmap_intersect.cu has widths {widths}, "
                           f"its wrapper {FUSED_TILE_WIDTHS}")
    lib.cemr_error_string.argtypes = [i]
    lib.cemr_error_string.restype = ctypes.c_char_p
    lib.cemr_intersect.argtypes = [p, p, i, i, p, p, i, i, p, p, i, p]
    lib.cemr_intersect.restype = i
    lib.cemr_expand_select.argtypes = [p, p, i, i, ctypes.c_longlong, i, p,
                                       i, p, p, p, p, p, p, i, p, p, i, p]
    lib.cemr_expand_select.restype = i
    return lib


def _table_set(tables, slots, clears, qslot=-1) -> _TableSet:
    """The parameter struct for these tables, cached by its values (the
    plan's tables keep their addresses, so a set is built once). With a
    query lane (qslot >= 0) the tables are (Q, S_j, W) stacks: rows are
    each query's S_j."""
    nq = tables[0].shape[0] if qslot >= 0 else 0
    key = (tuple(t.data_ptr() for t in tables),
           tuple(t.shape[-2] for t in tables), slots, clears, qslot, nq)
    ts = _TABLE_SETS.get(key)
    if ts is None:
        if len(_TABLE_SETS) >= _TABLE_SETS_MAX:
            _TABLE_SETS.clear()
        ts = _TableSet()
        for j, (ptr, n, s) in enumerate(zip(key[0], key[1], slots)):
            ts.base[j], ts.rows[j], ts.slot[j] = ptr, n, s
        for j, c in enumerate(clears):
            ts.clear[j] = c
        ts.k, ts.n_clear = len(tables), len(clears)
        ts.qslot, ts.nq = qslot, nq
        _TABLE_SETS[key] = ts
    return ts


def _check_tables(tables, device, stacked=False) -> int:
    """The tables' common width; with `stacked` they are (Q, S_j, W)
    stacks of one query count Q >= 1."""
    if not tables:
        raise ValueError("need at least one table")
    if len(tables) > MAX_TABLES:
        raise ValueError(f"at most {MAX_TABLES} tables, got {len(tables)}")
    dims = 3 if stacked else 2
    lead = tables[0].shape[:-2] if tables[0].dim() == dims else None
    w = tables[0].shape[-1]
    for tbl in tables:
        if tbl.dtype != torch.int32 or tbl.dim() != dims:
            raise TypeError(f"tables must be {dims}-D int32, got {tbl.dtype} "
                            f"{tuple(tbl.shape)}")
        if (tbl.shape[-1] != w or tbl.shape[-2] < 1
                or tbl.shape[:-2] != lead or (stacked and tbl.shape[0] < 1)):
            raise ValueError("tables must share one width (and query "
                             "count) and hold >= 1 row")
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


def _check_slots(name, slots, n, bound) -> tuple:
    slots = tuple(int(s) for s in slots)
    if len(slots) != n or any(s < 0 or s > bound for s in slots):
        raise ValueError(f"{name} must be {n} ints in [0, {bound}], "
                         f"got {slots}")
    return slots


def _check_clears(clear_slots, bound) -> tuple:
    clears = tuple(int(c) for c in clear_slots)
    if len(clears) > MAX_CLEARS or any(c < 0 or c > bound for c in clears):
        raise ValueError(f"clear_slots must be at most {MAX_CLEARS} ints in "
                         f"[0, {bound}], got {clears}")
    return clears


def _check_width(words_per_block) -> int:
    """The word-block width as an int, one of FUSED_TILE_WIDTHS; anything
    else raises (no rounding to a width that has an instantiation)."""
    wpb = operator.index(words_per_block)
    if wpb not in FUSED_TILE_WIDTHS:
        raise ValueError(f"words_per_block must be one of "
                         f"{FUSED_TILE_WIDTHS}, got {wpb}")
    return wpb


def _on_card(dev, what) -> bool:
    """False for the CPU (the plain version runs), True for CUDA; raises
    for any other device."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    return True


def _raise_on(code: int, lib: ctypes.CDLL, what: str) -> None:
    if code == lib.cemr_error_width():
        raise ValueError(f"{what}: {lib.cemr_error_string(code).decode()}")
    if code != 0:
        msg = lib.cemr_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _intersect(tables, slots, clears, idx, rows, bitpos, n_out, w, dev,
               wpb, qslot=-1):
    """Launch intersect_kernel at width `wpb`; returns (R (n_out, W),
    pop (n_out,))."""
    lib = _lib()
    r = torch.empty((n_out, w), dtype=torch.int32, device=dev)
    pop = torch.empty((n_out,), dtype=torch.int32, device=dev)
    if n_out == 0:
        return r, pop
    n_in, k0 = idx.shape
    ts = _table_set(tables, slots, clears, qslot)
    with torch.cuda.device(dev):
        code = lib.cemr_intersect(
            ctypes.addressof(ts), idx.data_ptr() if k0 else None, n_in, k0,
            None if rows is None else rows.data_ptr(),
            None if bitpos is None else bitpos.data_ptr(), n_out, w,
            r.data_ptr(), pop.data_ptr(), wpb, _stream(dev))
    _raise_on(code, lib, "intersect_kernel")
    return r, pop


def _counted(fn, wpb) -> None:
    """One launch of `fn`'s kernel at width `wpb`, made by an autotune
    sweep while `_sweeping` is set."""
    fn.launches += 1
    fn.launches_by_width[wpb] += 1
    if _sweeping:
        fn.sweep_launches_by_width[wpb] += 1


def tile_intersect(tables, idx: torch.Tensor, slots, clear_slots=(),
                   qid_slot=None, words_per_block=DEFAULT_WORDS_PER_BLOCK):
    """The pair branch of an extension compute over a tile's index columns:
    R[t] = AND_j tables[j][idx[t, slots[j]]], then for each c in
    clear_slots the bit idx[t, c] cleared (a negative entry clears
    nothing); pop[t] = popcount(R[t]) after the clears.

    tables: k × (S_j, W) int32, contiguous; idx: (T, K) int32;
    slots: k ints in [0, K); clear_slots: ints in [0, K).
    With qid_slot (an int in [0, K): the query lane) each table is a
    (Q, S_j, W) stack and R[t] = AND_j tables[j][idx[t, qid_slot],
    idx[t, slots[j]]], each index taken on its own axis.
    words_per_block: the width, one of FUSED_TILE_WIDTHS.
    Returns (R (T, W) int32, pop (T,) int32)."""
    tables = tuple(tables)
    dev = idx.device
    lane = qid_slot is not None
    w = _check_tables(tables, dev, stacked=lane)
    if idx.dim() != 2:
        raise TypeError(f"idx must be (T, K), got {tuple(idx.shape)}")
    _check_index("idx", idx, tuple(idx.shape), dev)
    k_cols = idx.shape[1]
    slots = _check_slots("slots", slots, len(tables), k_cols - 1)
    clears = _check_clears(clear_slots, k_cols - 1)
    qslot = (_check_slots("qid_slot", (qid_slot,), 1, k_cols - 1)[0] if lane
             else -1)
    wpb = _check_width(words_per_block)
    if not _on_card(dev, "tile_intersect"):
        return ref.tile_intersect_ref(tables, idx, slots, clears,
                                      qid_slot if lane else None)
    out = _intersect(tables, slots, clears, idx, None, None, idx.shape[0], w,
                     dev, wpb, qslot)
    _counted(tile_intersect, wpb)
    tile_intersect.lane_launches += lane
    return out


def _select(r, start, n_out, idx, tables, slots, clears, w, dev, wpb):
    """Launch expand_select_kernel at width `wpb` (with tables: and the
    intersect)."""
    lib = _lib()
    n_in, w_in = r.shape
    k0 = idx.shape[1]
    i32 = dict(dtype=torch.int32, device=dev)
    # the row scan lives in shared memory unless the frontier is too tall
    scratch = (torch.empty((SELECT_CTAS, n_in + 1), **i32)
               if n_in > SMEM_CUM_ROWS else None)
    rows = torch.empty((n_out,), **i32)
    bitpos = torch.empty((n_out,), **i32)
    valid = torch.empty((n_out,), dtype=torch.bool, device=dev)
    total = torch.empty((), **i32)
    child = torch.empty((n_out, k0 + 1), **i32)
    r2 = torch.empty((n_out, w), **i32)
    pop2 = torch.empty((n_out,), **i32)
    ts = _table_set(tables, slots, clears)
    with torch.cuda.device(dev):
        code = lib.cemr_expand_select(
            ctypes.addressof(ts), r.data_ptr(), n_in, w_in, start, n_out,
            idx.data_ptr() if k0 else None, k0,
            None if scratch is None else scratch.data_ptr(),
            rows.data_ptr(), bitpos.data_ptr(), valid.data_ptr(),
            total.data_ptr(), child.data_ptr(), w,
            r2.data_ptr() if tables else None,
            pop2.data_ptr() if tables else None, wpb, _stream(dev))
    _raise_on(code, lib, "expand_select_kernel")
    return rows, bitpos, valid, total, child, r2, pop2


def _check_select(r, start, n_out, idx):
    dev = r.device
    if r.dim() != 2 or r.shape[0] < 1 or r.shape[1] < 1:
        raise ValueError(f"r must be (T_in >= 1, W_in >= 1), got "
                         f"{tuple(r.shape)}")
    _check_index("r", r, tuple(r.shape), dev)
    if idx.dim() != 2:
        raise TypeError(f"idx must be (T_in, K0), got {tuple(idx.shape)}")
    _check_index("idx", idx, (r.shape[0], idx.shape[1]), dev)
    start, n_out = operator.index(start), operator.index(n_out)
    if start < 0 or n_out < 0 or start + n_out >= 2 ** 31:
        raise ValueError(f"need 0 <= start, 0 <= n_out and start + n_out "
                         f"< 2**31, got start={start} n_out={n_out}")
    return dev, start, n_out


def expand_select(r: torch.Tensor, start, n_out: int, idx: torch.Tensor):
    """Select the set-bit ranks [start, start + n_out) of the frontier
    bitmap r in row-major order (`bitops.expand_select`) and build the
    child tile's index columns.

    r: (T_in, W_in) int32; start: host int >= 0; idx: (T_in, K0) int32
    parent index columns (K0 may be 0). Returns rows (n_out,) int32,
    bitpos (n_out,) int32, valid (n_out,) bool, total () int32 (left on the
    device) and child_idx (n_out, K0 + 1) int32 = idx[rows] ++ bitpos."""
    dev, start, n_out = _check_select(r, start, n_out, idx)
    if not _on_card(dev, "expand_select"):
        return ref.expand_select_ref(r, start, n_out, idx)
    # no extend, so no width: the default instantiation
    out = _select(r, start, n_out, idx, (), (), (), 0, dev,
                  DEFAULT_WORDS_PER_BLOCK)
    expand_select.launches += 1
    return out[:5]


def expand_intersect(r: torch.Tensor, start, n_out: int, idx: torch.Tensor,
                     tables, slots, clear_slots=(),
                     words_per_block=DEFAULT_WORDS_PER_BLOCK):
    """`expand_select` and the child's first extension in one launch: for
    child row t, key slot s < K0 reads idx[rows[t], s] and slot K0 reads
    bitpos[t]; R2[t] is the AND of the keyed table rows with the bit of
    child column c cleared for each c in clear_slots, pop2[t] its popcount
    after the clears. Unmasked: rows at ranks >= total are computed from
    their clamped selection like any other. words_per_block: the extend's
    width, one of FUSED_TILE_WIDTHS.

    Returns (rows, bitpos, valid, total, child_idx, R2 (n_out, W) int32,
    pop2 (n_out,) int32)."""
    tables = tuple(tables)
    dev, start, n_out = _check_select(r, start, n_out, idx)
    w = _check_tables(tables, dev)
    k0 = idx.shape[1]
    slots = _check_slots("slots", slots, len(tables), k0)
    clears = _check_clears(clear_slots, k0)
    wpb = _check_width(words_per_block)
    if not _on_card(dev, "expand_intersect"):
        return ref.expand_intersect_ref(r, start, n_out, idx, tables, slots,
                                        clears)
    out = _select(r, start, n_out, idx, tables, slots, clears, w, dev, wpb)
    _counted(expand_intersect, wpb)
    return out


def bitmap_intersect(tables, idxs: torch.Tensor,
                     words_per_block=DEFAULT_WORDS_PER_BLOCK):
    """R[t] = AND_j tables[j][idxs[t, j]]; pop[t] = popcount(R[t]).

    tables: k × (S_j, W) int32, contiguous; idxs: (T, k) int32;
    words_per_block: the width, one of FUSED_TILE_WIDTHS.
    Returns (R (T, W) int32, pop (T, 1) int32)."""
    tables = tuple(tables)
    dev = idxs.device
    w = _check_tables(tables, dev)
    k = len(tables)
    _check_index("idxs", idxs, (idxs.shape[0], k), dev)
    wpb = _check_width(words_per_block)
    if not _on_card(dev, "bitmap_intersect"):
        return ref.bitmap_intersect_ref(tables, idxs)
    r, pop = _intersect(tables, tuple(range(k)), (), idxs, None, None,
                        idxs.shape[0], w, dev, wpb)
    _counted(bitmap_intersect, wpb)
    return r, pop[:, None]


def fused_expand_intersect(tables, idx: torch.Tensor, rows: torch.Tensor,
                           bitpos: torch.Tensor, slots,
                           words_per_block=DEFAULT_WORDS_PER_BLOCK):
    """Fused frontier expansion + k-way AND + popcount over a given
    selection: slot s < K0 reads table row idx[rows[t], s], slot s == K0
    reads bitpos[t].

    tables: k × (S_j, W) int32; idx: (Tin, K0) int32 parent index columns
    (K0 may be 0); rows, bitpos: (T,) int32; slots: k ints in [0, K0];
    words_per_block: the width, one of FUSED_TILE_WIDTHS.
    Returns (R (T, W) int32, pop (T, 1) int32), unmasked."""
    tables = tuple(tables)
    dev = rows.device
    w = _check_tables(tables, dev)
    n_out = rows.shape[0]
    if idx.dim() != 2 or idx.shape[0] < 1:
        raise ValueError(f"idx must be (Tin >= 1, K0), got {tuple(idx.shape)}")
    n_in, k0 = idx.shape
    _check_index("idx", idx, (n_in, k0), dev)
    _check_index("rows", rows, (n_out,), dev)
    _check_index("bitpos", bitpos, (n_out,), dev)
    slots = _check_slots("slots", slots, len(tables), k0)
    wpb = _check_width(words_per_block)
    if not _on_card(dev, "fused_expand_intersect"):
        return ref.fused_expand_intersect_ref(tables, idx, rows, bitpos,
                                              slots=slots)
    r, pop = _intersect(tables, slots, (), idx, rows, bitpos, n_out, w, dev,
                        wpb)
    _counted(fused_expand_intersect, wpb)
    return r, pop[:, None]


# ------------------------------------------------------------------ autotune
# The sweep's synthetic shape, the reference's: T output rows over tables
# of S rows
_SWEEP_T, _SWEEP_S = 64, 128
_SWEEP_CALLS = 3                  # timed calls a width, after a warm one
# cycles the card spins before the timed calls, so that they queue behind
# it and the events time the device, not the host's launches (about 1 ms,
# several times the host's time for the calls)
_SWEEP_SLEEP_CYCLES = 2_000_000
_AUTOTUNE_CACHE: dict[tuple, int] = {}
_sweeping = False                 # set while a sweep launches


def _sweep_inputs(k: int, w: int, dev):
    """The reference's sweep inputs: table j filled with 0x5A5A5A5A + j,
    one parent column idx[t] = t % S, the selection rows[t] = t and
    bitpos[t] = 7 t % S, slots (1, 0, ..., 0), so one table is keyed by
    the selected bit and the others through the parent column. The
    frontier has the one bit bitpos[t] in row t, so that `expand_select`
    selects exactly (rows, bitpos)."""
    t, s = _SWEEP_T, _SWEEP_S
    tabs = [torch.from_numpy(np.full((s, w), 0x5A5A5A5A + j, np.uint32)
                             .view(np.int32)).to(dev) for j in range(k)]
    idx = (torch.arange(t, dtype=torch.int32) % s)[:, None].to(dev)
    bitpos = (np.arange(t) * 7) % s
    frontier = np.zeros((t, (s + 31) // 32), np.uint32)
    frontier[np.arange(t), bitpos >> 5] = np.uint32(1) << (bitpos & 31)
    r = torch.from_numpy(frontier.view(np.int32)).to(dev)
    return r, idx, tabs, (1,) + (0,) * (k - 1)


def _sweep_seconds(inputs, wpb: int, dev) -> float:
    """Seconds one `expand_intersect` at width `wpb` takes on the sweep's
    inputs: a call outside the timing, then the mean of _SWEEP_CALLS. On
    the card CUDA events on the current stream time the device; on the CPU
    the host clock times the plain version."""
    global _sweeping
    r, idx, tabs, slots = inputs

    def call():
        return expand_intersect(r, 0, _SWEEP_T, idx, tabs, slots,
                                words_per_block=wpb)

    _sweeping = True
    try:
        call()
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(_SWEEP_CALLS):
                call()
            return (time.perf_counter() - t0) / _SWEEP_CALLS
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SWEEP_SLEEP_CYCLES)
            start.record(stream)
            for _ in range(_SWEEP_CALLS):
                call()
            stop.record(stream)
            stop.synchronize()
        return start.elapsed_time(stop) / 1e3 / _SWEEP_CALLS
    finally:
        _sweeping = False


def autotune_words_per_block(k: int, w: int, *, device=None,
                             widths=FUSED_TILE_WIDTHS) -> int:
    """The fused route's word-block width for an extend of k tables of W
    words: the reference's sweep (src/repro/kernels/bitmap_intersect.py,
    `autotune_words_per_block`) on `device` (None: the card), cached per
    (device type, device index, k, W, widths).

    Each width's `expand_intersect`, the kernel the fused route launches,
    is timed on the reference's synthetic shape (`_sweep_inputs`); the
    fastest width wins, the first of `widths` on a tie. On the card the
    winner's time is held against the HBM floor k·T·W·4 B over
    `launch.roofline.HW["hbm_bw"]`: a time under it cannot be, so the
    timer is not trusted and the largest width is returned. On the CPU the
    plain version is timed and the floor is not checked, as the reference
    skips it in interpret mode. Every width gives the same bits, so the
    pick changes how fast the route runs, never what it computes."""
    widths = tuple(_check_width(x) for x in widths)
    if not widths:
        raise ValueError("widths must name at least one width")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev.type, dev.index, int(k), int(w), widths)
    best = _AUTOTUNE_CACHE.get(key)
    if best is not None:
        return best
    inputs = _sweep_inputs(k, w, dev)
    times = {wpb: _sweep_seconds(inputs, wpb, dev) for wpb in widths}
    best = min(widths, key=times.__getitem__)
    if dev.type == "cuda":
        from ..launch.roofline import HW
        floor = k * _SWEEP_T * w * 4 / HW["hbm_bw"]
        if times[best] < floor:
            best = max(widths)
    _AUTOTUNE_CACHE[key] = best
    return best


WRAPPERS = (tile_intersect, expand_select, expand_intersect,
            bitmap_intersect, fused_expand_intersect)
# the wrappers that take a width
WIDTH_WRAPPERS = (tile_intersect, expand_intersect, bitmap_intersect,
                  fused_expand_intersect)


def reset_launches() -> None:
    """Set every wrapper's launch counts to 0."""
    for fn in WRAPPERS:
        fn.launches = 0
    for fn in WIDTH_WRAPPERS:
        fn.launches_by_width = dict.fromkeys(FUSED_TILE_WIDTHS, 0)
        fn.sweep_launches_by_width = dict.fromkeys(FUSED_TILE_WIDTHS, 0)
    tile_intersect.lane_launches = 0


reset_launches()
