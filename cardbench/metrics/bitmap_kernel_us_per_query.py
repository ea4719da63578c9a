"""Device time of the bitmap kernels (`intersect_kernel*`,
`expand_select_kernel*` by name in the trace) a query of the traced
slice, in us."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr.get("bitmap_kernel_s") or not tr["queries"]:
        return None
    return tr["bitmap_kernel_s"] * 1e6 / tr["queries"]
