"""Share of the traced slice in which no operation ran on the device, in
%, averaged over the devices used: 100 * (1 - busy / the slice's wall)."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr.get("busy_s") or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
