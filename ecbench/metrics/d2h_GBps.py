"""d2h_GBps.<op> (copies, device trace): the bytes the traced calls read
back over the profiler's device time of its `Memcpy DtoH` ops."""


def read(rec):
    t = rec["trace"]
    if not t or t["d2h_s"] <= 0:
        return None
    return t["out_bytes"] / t["d2h_s"] / 1e9
