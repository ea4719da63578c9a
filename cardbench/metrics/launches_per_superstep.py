"""Kernel launches a superstep in the traced slice: the trace's kernels
(copies and fills left out) over the slice's `VectorStats.supersteps`."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr.get("kernel_launches"):
        return None
    steps = tr["stats"].get("supersteps", 0)
    return tr["kernel_launches"] / steps if steps else None
