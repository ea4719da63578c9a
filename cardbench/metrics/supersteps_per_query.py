"""Supersteps a query over the window: `VectorStats.supersteps`, each
superbatch bucket's shared stats counted once, over the queries
answered."""


def read(rec):
    steps = rec["stats"].get("supersteps", 0)
    if not rec["queries"] or not steps:
        return None
    return steps / rec["queries"]
