"""call_p95_ms.<op> (the stream, host clock): the 95th percentile, by
nearest rank, of every untraced call's time from its issue to its drained
bytes, in milliseconds."""

import math


def read(rec):
    lat = sorted(rec["window"]["latency_s"])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
