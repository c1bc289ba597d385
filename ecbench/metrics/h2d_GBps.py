"""h2d_GBps.<op> (copies, device trace): the bytes the traced calls hand
the program over the profiler's device time of its `Memcpy HtoD` ops."""


def read(rec):
    t = rec["trace"]
    if not t or t["h2d_s"] <= 0:
        return None
    return t["in_bytes"] / t["h2d_s"] / 1e9
