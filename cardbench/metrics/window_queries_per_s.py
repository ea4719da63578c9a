"""Queries answered in the window over its elapsed time, on the host's
clock: the closed loop's rate. Per-layer, since the host's speed from run
to run spreads it wider than any bound could hold."""


def read(rec):
    if not rec["queries"] or rec["window_s"] <= 0:
        return None
    return rec["queries"] / rec["window_s"]
