"""rebuild_GBps (end to end, host clock): the survivor bytes (k shards of
the call's width) of every call drained in the window over the window's
seconds, from the first issue to the last drain. Rebuild cells only."""


def read(rec):
    if rec["op"] != "rebuild":
        return None
    w = rec["window"]
    return w["in_bytes"] / w["seconds"] / 1e9
