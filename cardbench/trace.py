"""What a `torch.profiler` trace of a slice of calls says, reduced to the
numbers the per-layer readers and the result's `breakdown` take.

Busy time is the union of the intervals in which an operation (a kernel,
a copy, a fill) ran on a device, averaged over the devices used; the
device's idle share is 1 - busy / the slice's wall (the arithmetic of the
repository's `chip_trace.py`, with overlapping operations counted once).
Each idle gap of a device is put down to the innermost host operation open
on the calling thread at the gap's middle ("host (no operation open)"
where there is none).
"""
from __future__ import annotations

import collections

__all__ = ["CALL_SPAN", "BITMAP_KERNELS", "raw_events", "reduce_trace"]

CALL_SPAN = "cardbench.call"          # record_function around each call
BITMAP_KERNELS = ("intersect_kernel", "expand_select_kernel")
NO_OP = "host (no operation open)"


def _union(intervals: list[tuple[float, float]]) -> list[list[float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _attribute(gaps, host_ops) -> dict[str, float]:
    """Seconds of idle gap by the innermost host op open at its middle.
    `host_ops`: (start, end, name) of one thread, properly nested."""
    by_name: dict[str, float] = collections.defaultdict(float)
    ops = sorted(host_ops, key=lambda o: (o[0], -o[1]))
    stack: list[tuple[float, float, str]] = []
    i = 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        t = (s + e) / 2
        while i < len(ops) and ops[i][0] <= t:
            while stack and stack[-1][1] <= ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        by_name[stack[-1][2] if stack else NO_OP] += (e - s) / 1e6
    return by_name


def raw_events(prof) -> list[tuple]:
    """The profiler's events as (name, on_device, device_index, start_us,
    end_us, thread, annotation) tuples, read from its raw results (much
    faster than building `prof.events()`'s tree of FunctionEvents)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        out.append((ev.name(), ev.device_type().name == "CUDA",
                    ev.device_index(), start, start + ev.duration_ns() / 1e3,
                    ev.start_thread_id(), ev.is_user_annotation()))
    return out


def reduce_trace(events, *, devices: list[int]) -> dict:
    """Reduce the events (`raw_events`) of one slice, bounded by its first
    and last call span (`CALL_SPAN`). Returns the slice's length and busy
    seconds (averaged over `devices`), kernel launches, device seconds by
    operation name, the bitmap kernels' device seconds, and idle-gap
    seconds by host operation."""
    dev_ops: dict[int, list[tuple[float, float]]] = collections.defaultdict(
        list)
    by_op: dict[str, float] = collections.defaultdict(float)
    launches = 0
    bitmap_s = 0.0
    host: dict[int, list[tuple[float, float, str]]] = collections.defaultdict(
        list)
    call_thread = None
    spans: list[tuple[float, float]] = []
    for name, on_device, index, s, e, thread, annotation in events:
        if on_device:
            if annotation:
                continue           # a span's mirror on the device's line
            dev_ops[index].append((s, e))
            by_op[name] += (e - s) / 1e6
            if not name.startswith(("Memcpy", "Memset")):
                launches += 1
            if any(k in name for k in BITMAP_KERNELS):
                bitmap_s += (e - s) / 1e6
        else:
            if name.startswith("ProfilerStep"):
                name = "ProfilerStep"
            host[thread].append((s, e, name))
            if name == CALL_SPAN:
                call_thread = thread
                spans.append((s, e))
    if not spans:
        return {}
    t_lo_us = min(s for s, _ in spans)
    t_hi_us = max(e for _, e in spans)
    busy = []
    gaps_by_host: dict[str, float] = collections.defaultdict(float)
    for d in devices:
        merged = _union([(max(s, t_lo_us), min(e, t_hi_us))
                         for s, e in dev_ops.get(d, [])
                         if e > t_lo_us and s < t_hi_us])
        busy.append(sum(e - s for s, e in merged) / 1e6)
        for name, secs in _attribute(_gaps(merged, t_lo_us, t_hi_us),
                                     host.get(call_thread, [])).items():
            gaps_by_host[name] += secs / len(devices)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(gaps_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (t_hi_us - t_lo_us) / 1e6,
            "busy_s": sum(busy) / len(devices) if devices else None,
            "kernel_launches": launches,
            "bitmap_kernel_s": bitmap_s,
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
