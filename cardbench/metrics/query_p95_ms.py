"""The 95th percentile of the window's call latencies, in ms (a call of
`Matcher.count` is one query). Nearest rank, over the unprofiled window."""
import math


def read(rec):
    lat = sorted(rec["latencies_s"])
    if rec["entry"] != "count" or len(lat) < 20:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
