"""Wrapper of the Hopper decode-attention kernels (`csrc/flash_decode.cu`).

    flash_decode(q, k, v, lengths=None) -> out (B, H, D)
    flash_decode_partials(q, k, v, lengths=None, offset=0) -> (B, H, D + 2)
    flash_decode_merge(partials, dtype) -> out (B, H, D)

q (B, H, D) and the cache k, v (B, S, Hkv, D) are float32 or bfloat16 (the
cache may differ from q); out has q's dtype. The wrapper takes the plain
torch version (`ref.flash_decode_ref`) only because its tensors lie on the
CPU; CUDA tensors launch the kernels, and anything else raises.

On the card the positions are split into chunks (`split_plan`, from the
shapes alone) and one CTA per (chunk, KV head, b) computes all query heads
of its KV head. It takes one of two routes, chosen before the launch from
dtypes, D and alignment (`route`): "tensor_core" (bf16 q and cache, D a
multiple of 16: the scores on mma.sync) or "cuda_core" (every other case:
fp32 FMA). With more than one chunk the wrapper allocates an fp32
workspace (B, H, n_chunks, D + 2) with `torch.empty` for the per-chunk
partials, and a second kernel, the combine, merges them into out; with one
chunk the first kernel writes out itself. The combine spreads the rows of
one (b, h) over the warps of a CTA (as many as n_chunks calls for), so
that it takes about the time its bytes take. The wrapper never reads
`lengths` on the host: no sync per call.

It counts its calls in `flash_decode.launches` (one per call, whatever the
number of device kernels), per route in `flash_decode.launches_by_route`,
and the device kernels that the library reports it launched in
`flash_decode.launches_by_kernel` ("split" once a call, "combine" when the
call had more than one chunk).

Contract (kernels and plain version alike): 1 <= lengths[b] <= S. A row
with lengths[b] == 0 has nothing to attend to and gives NaN; the wrapper
does not check the values, which would cost a device-to-host sync per call.

The partials entries serve context-parallel decode
(`distributed/context_parallel.py`). `flash_decode_partials` runs the same
split kernels over one block of cache positions [offset, offset + S): k
and v may be views along S of a longer cache (rows contiguous, any batch
stride), lengths are the whole row's and each CTA clamps lengths[b] -
offset to the block on the device. It always writes the workspace and
merges the block's chunks, in the combine kernel's partials mode, into one
fp32 row (acc[D], m, l) per (b, h); a block wholly past lengths[b] gives
(0, -inf, 0). `flash_decode_merge` merges n such rows per (b, h),
(B, H, n, D + 2), into the output with the same combine kernel; rows all
empty give NaN, as above. Their plain versions are
`ref.flash_decode_partials_ref` and `ref.flash_decode_merge_ref`. Each
counts its calls as `flash_decode` does (`launches`, and
`launches_by_route` / `launches_by_kernel`; the merge launches only a
combine and has no route).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import load_library

__all__ = ["flash_decode", "flash_decode_partials", "flash_decode_merge",
           "reset_launches", "split_plan", "route", "WRAPPERS",
           "LIBRARY", "MAX_HEAD_DIM", "ROUTES", "KERNELS"]

LIBRARY = "flash_decode"
MAX_HEAD_DIM = 256                      # kMaxHeadDim in the CUDA source
HEADS_PER_CTA = 16                      # kHeads in the CUDA source
ROUTES = ("tensor_core", "cuda_core")
KERNELS = ("split", "combine")          # in the order a call launches them
_DTYPES = (torch.float32, torch.bfloat16)
# split_plan: aim at this many CTAs (several waves of 2 per SM on 132 SMs
# when half of them are past their row's length), with chunks a power of
# two between the two bounds. A grid of at most _SMALL_GRID (b, KV head,
# head block) columns, one long row of a cache such as long_500k's or a
# context-parallel block of it, aims at _TARGET_CTAS_SMALL, about one CTA
# an SM: there longer chunks save more in the CTAs' prologues and the
# combine's rows than the waves they give up cost (PERF.md, the sweep of
# chip_fd_compare.py)
_TARGET_CTAS, _TARGET_CTAS_SMALL, _SMALL_GRID = 2048, 128, 2
_MIN_CHUNK, _MAX_CHUNK = 128, 2048


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = load_library(LIBRARY)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cemr_flash_decode_max_head_dim.argtypes = []
    lib.cemr_flash_decode_max_head_dim.restype = i
    lib.cemr_error_string.argtypes = [i]
    lib.cemr_error_string.restype = ctypes.c_char_p
    lib.cemr_flash_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                      i, ctypes.c_float, i, i, i, p,
                                      ctypes.POINTER(i)]
    lib.cemr_flash_decode.restype = i
    lib.cemr_flash_decode_partials.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, ctypes.c_longlong, i, i, i,
        ctypes.c_float, i, i, i, p, ctypes.POINTER(i)]
    lib.cemr_flash_decode_partials.restype = i
    lib.cemr_flash_decode_merge.argtypes = [p, p, i, i, i, i, i, p]
    lib.cemr_flash_decode_merge.restype = i
    lib.cemr_flash_decode_max_heads_per_cta.argtypes = []
    lib.cemr_flash_decode_max_heads_per_cta.restype = i
    lib.cemr_flash_decode_smem_bytes.argtypes = [i, i, i, i]
    lib.cemr_flash_decode_smem_bytes.restype = i
    if lib.cemr_flash_decode_max_head_dim() != MAX_HEAD_DIM \
            or lib.cemr_flash_decode_max_heads_per_cta() != HEADS_PER_CTA:
        raise RuntimeError("flash_decode library and wrapper disagree on "
                           "the largest head dim or the heads per CTA")
    return lib


def split_plan(b: int, h: int, hkv: int, s: int, d: int
               ) -> tuple[int, int, tuple | None]:
    """How the kernels split the S positions, from the shapes alone:
    (chunk, n_chunks, workspace shape). The chunk is the power of two
    between 128 and 2048 nearest below the positions per CTA that gives
    about 2,048 CTAs of (KV head, head block, chunk, b), or 128 CTAs when
    B x Hkv x head blocks is at most 2 (one long row: long_500k's layer
    in 257 chunks of 2,048, its 4-lane block in 65 of 2,048). One chunk
    covers S whole (chunk = S) when S fits in one; then no workspace is
    needed (None), else it is (B, H, n_chunks, D + 2) in fp32: each
    chunk's per-head acc[D], m and l."""
    n_hblk = -(-(h // hkv) // HEADS_PER_CTA)
    grid = b * hkv * n_hblk
    target = _TARGET_CTAS_SMALL if grid <= _SMALL_GRID else _TARGET_CTAS
    per_cta = max(grid * s // target, 1)
    chunk = min(max(1 << (per_cta.bit_length() - 1), _MIN_CHUNK),
                _MAX_CHUNK)
    if chunk >= s:
        return s, 1, None
    n_chunks = -(-s // chunk)
    return chunk, n_chunks, (b, h, n_chunks, d + 2)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel route for these tensors, decided before the launch:
    "tensor_core" for a bfloat16 q over a bfloat16 cache with D a multiple
    of 16 and the cache 16-byte aligned, else "cuda_core"."""
    if q.dtype == k.dtype == torch.bfloat16 and q.shape[-1] % 16 == 0 \
            and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0:
        return "tensor_core"
    return "cuda_core"


def _check(q, k, v, lengths, *, block: bool = False) -> None:
    """Raise on what the kernels do not take. With `block`, k and v may be
    views along S: each row of Hkv * D contiguous, one batch stride."""
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
        if not x.is_contiguous() and not (block and name in ("k", "v")):
            raise ValueError(f"{name} must be contiguous")
    if block and (k.stride() != v.stride()
                  or k.stride()[1:] != (hkv * d, d, 1)):
        raise ValueError(f"k and v must be views along S with rows of "
                         f"Hkv * D contiguous elements; strides "
                         f"{k.stride()}, {v.stride()}")


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
    chunk, n_chunks, ws_shape = split_plan(b, h, hkv, s, d)
    way = route(q, k, v)
    out = torch.empty_like(q)
    ws = (torch.empty(ws_shape, dtype=torch.float32, device=dev)
          if ws_shape is not None else None)
    n_launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cemr_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr() if lengths is not None else None,
            out.data_ptr(), ws.data_ptr() if ws is not None else None,
            b, h, hkv, s, d, chunk, n_chunks, _scale(d),
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
            int(way == "tensor_core"), stream, ctypes.byref(n_launched))
    _counted(flash_decode, code, KERNELS[:n_launched.value], way)
    return out


def _counted(fn, code: int, kernels: tuple, way: str | None = None) -> None:
    """Raise if the library returned a CUDA error, else count the call of
    `fn`, on route `way` where it has one, and the device kernels it
    launched."""
    if code != 0:
        msg = _lib().cemr_error_string(code).decode()
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {code} "
                           f"({msg})")
    fn.launches += 1
    if way is not None:
        fn.launches_by_route[way] += 1
    for name in kernels:
        fn.launches_by_kernel[name] += 1


def flash_decode_partials(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, lengths: torch.Tensor | None = None,
                          offset: int = 0) -> torch.Tensor:
    """The decode partials of one block of cache positions [offset,
    offset + S): k, v (B, S, Hkv, D) hold the block (views along S of a
    longer cache are taken as they are), lengths (B,) int32 are the whole
    rows' (None: every position of the block counts). Per (b, h) the fp32
    row (acc[D], m, l) of the positions offset + p < lengths[b]: the
    largest score m, l = sum exp(s - m), acc = sum exp(s - m) v; a block
    with none gives (0, -inf, 0). Returns (B, H, D + 2) float32."""
    _check(q, k, v, lengths, block=True)
    offset = int(offset)
    if offset < 0:
        raise ValueError(f"offset {offset} < 0")
    dev = q.device
    if dev.type == "cpu":
        return ref.flash_decode_partials_ref(q, k, v, lengths, offset)
    if dev.type != "cuda":
        raise ValueError(f"flash_decode_partials runs on cpu or cuda, not "
                         f"{dev}")
    lib = _lib()
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    chunk, n_chunks, _ = split_plan(b, h, hkv, s, d)
    way = route(q, k, v)
    ws = torch.empty((b, h, n_chunks, d + 2), dtype=torch.float32,
                     device=dev)
    part = torch.empty((b, h, d + 2), dtype=torch.float32, device=dev)
    n_launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cemr_flash_decode_partials(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr() if lengths is not None else None,
            ws.data_ptr(), part.data_ptr(), b, h, hkv, s, d, k.stride(0),
            offset, chunk, n_chunks, _scale(d),
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
            int(way == "tensor_core"), stream, ctypes.byref(n_launched))
    _counted(flash_decode_partials, code, KERNELS[:n_launched.value], way)
    return part


def flash_decode_merge(partials: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """n partial rows per (b, h), (B, H, n, D + 2) float32 as
    `flash_decode_partials` writes them (stacked on dim 2), merged by the
    log-sum-exp rescale into out (B, H, D) in `dtype` (float32 or
    bfloat16)."""
    if partials.dim() != 4 or partials.dtype != torch.float32 \
            or not 3 <= partials.shape[-1] <= MAX_HEAD_DIM + 2 \
            or 0 in partials.shape:
        raise ValueError(f"need float32 partials (B, H, n, D + 2) with "
                         f"1 <= D <= {MAX_HEAD_DIM}; got {partials.dtype} "
                         f"{tuple(partials.shape)}")
    if dtype not in _DTYPES:
        raise TypeError(f"the output must be float32 or bfloat16, not "
                        f"{dtype}")
    if not partials.is_contiguous():
        raise ValueError("partials must be contiguous")
    dev = partials.device
    if dev.type == "cpu":
        return ref.flash_decode_merge_ref(partials, dtype)
    if dev.type != "cuda":
        raise ValueError(f"flash_decode_merge runs on cpu or cuda, not "
                         f"{dev}")
    lib = _lib()
    b, h, n, row = partials.shape
    d = row - 2
    out = torch.empty((b, h, d), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cemr_flash_decode_merge(
            partials.data_ptr(), out.data_ptr(), b, h, n, d,
            int(dtype == torch.bfloat16), stream)
    _counted(flash_decode_merge, code, ("combine",))
    return out


# the wrappers that count their launches
WRAPPERS = (flash_decode, flash_decode_partials, flash_decode_merge)


def reset_launches() -> None:
    """Set the wrappers' launch counts to 0."""
    for fn in WRAPPERS:
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(ROUTES, 0)
        fn.launches_by_kernel = dict.fromkeys(KERNELS, 0)


reset_launches()
