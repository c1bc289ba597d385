"""encode_GBps (end to end, host clock): the data bytes of every call
drained in the window over the window's seconds, from the first issue to
the last drain. Encode cells only."""


def read(rec):
    if rec["op"] != "encode":
        return None
    w = rec["window"]
    return w["in_bytes"] / w["seconds"] / 1e9
