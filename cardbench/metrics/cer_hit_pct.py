"""Share of CER lookups served from the cross-tile ring buffer over the
window, in %: cer_hits / (cer_hits + cer_misses) of `VectorStats`."""


def read(rec):
    hits = rec["stats"].get("cer_hits", 0)
    total = hits + rec["stats"].get("cer_misses", 0)
    return 100.0 * hits / total if total else None
