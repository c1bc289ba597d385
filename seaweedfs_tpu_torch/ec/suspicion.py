"""Process-wide holder-suspicion registry for degraded EC reads.

A wedged holder (a stopped process, a dead NIC: it neither answers nor
errors) costs a degraded read one capped attempt; it is then suspected for
a backoff window and later reads skip it. The state lives here, shared by
every EcVolume of the process, keyed by peer identity when the volume's
remote reader can name the peer behind a shard (its `peer_for` attribute),
so one wedged peer costs one capped attempt process-wide; readers that
cannot name peers fall back to a (volume, shard) key.

The registry also keeps a per-key latency estimate of completed fetches,
from which the read planner derives when to hedge a slow fetch.
Keys are opaque tuples built by `ReadPlanner._holder_key`.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Optional


class HolderSuspicion:
    """Thread-safe map of suspicion keys -> backoff expiry, plus the keys
    whose capped attempt is still blocked inside a reader (suspected past
    any expiry, so no second pool thread is stacked onto the same wedged
    peer)."""

    #: EWMA gains of the Jacobson/Karels estimator (TCP's RTO): the mean
    #: moves at 1/8 per sample, the deviation at 1/4
    _LAT_ALPHA = 0.125
    _LAT_BETA = 0.25
    #: hedge delay = mean + 4 * deviation, a live high-quantile tracker
    _LAT_K = 4.0
    #: below this many samples there is no estimate
    _LAT_MIN_SAMPLES = 3

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._until: dict[tuple, float] = {}
        self._wedged: dict[tuple, object] = {}
        # key -> (ewma, ewdev, samples) of completed remote fetches
        self._lat: dict[tuple, tuple[float, float, int]] = {}

    def suspected(self, key: tuple) -> bool:
        with self._lock:
            until = self._until.get(key)
            if until is not None:
                if until > _time.monotonic():
                    return True
                del self._until[key]  # expired: prune on sight
            return key in self._wedged

    def mark(self, key: tuple, backoff: float) -> None:
        """Start (or extend) the suspicion window for `key`; sweeps every
        expired window, so churn in peers and volumes cannot grow the map."""
        with self._lock:
            now = _time.monotonic()
            for k in [k for k, t in self._until.items() if t <= now]:
                del self._until[k]
            self._until[key] = now + backoff

    def track_wedged(self, key: tuple, fut) -> None:
        """`fut` is a call into a wedged holder whose pool thread is still
        blocked: the key reads as suspected until the call returns."""
        with self._lock:
            self._wedged[key] = fut

        def _clear(f, _k=key):
            with self._lock:
                if self._wedged.get(_k) is f:
                    del self._wedged[_k]

        fut.add_done_callback(_clear)

    def observe_latency(self, key: tuple, seconds: float) -> None:
        """Feed one completed remote-fetch duration into `key`'s estimate.
        Failures and abandoned attempts are never fed."""
        if seconds < 0:
            return
        with self._lock:
            prev = self._lat.get(key)
            if prev is None:
                # first sample: deviation seeded at half the mean, so one
                # sample never yields a zero-width hedge delay
                self._lat[key] = (seconds, seconds / 2.0, 1)
                return
            ewma, ewdev, n = prev
            err = seconds - ewma
            ewma += self._LAT_ALPHA * err
            ewdev += self._LAT_BETA * (abs(err) - ewdev)
            self._lat[key] = (ewma, ewdev, n + 1)

    def latency_estimate(self, key: tuple) -> Optional[tuple[float, float, int]]:
        """(ewma_seconds, ewdev_seconds, samples) or None when unknown."""
        with self._lock:
            return self._lat.get(key)

    def hedge_delay(
        self, key: tuple, floor: float = 0.002, ceiling: float = 30.0
    ) -> Optional[float]:
        """mean + K * deviation of `key`'s fetches, clamped to [floor,
        ceiling]; None below `_LAT_MIN_SAMPLES` completed fetches."""
        with self._lock:
            est = self._lat.get(key)
        if est is None or est[2] < self._LAT_MIN_SAMPLES:
            return None
        ewma, ewdev, _ = est
        return min(ceiling, max(floor, ewma + self._LAT_K * ewdev))

    def forget_volume(self, base: str) -> None:
        """Drop the (volume, shard) keys of one volume (its unmount). Peer
        keys stay: they describe the peer, not the volume."""
        with self._lock:
            for d in (self._until, self._wedged, self._lat):
                for k in [k for k in d if k[0] == "volume-shard" and len(k) > 1 and k[1] == base]:
                    del d[k]

    def reset(self) -> None:
        """Drop all state."""
        with self._lock:
            self._until.clear()
            self._wedged.clear()
            self._lat.clear()


#: the process-wide default every EcVolume shares unless handed its own
GLOBAL = HolderSuspicion()
