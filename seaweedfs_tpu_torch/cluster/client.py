"""Client library — mirror of weed/wdclient (masterclient.go, vid_map.go) +
weed/operation (assign_file_id.go, upload_content.go, lookup.go,
delete_content.go, submit.go).

MasterClient caches vid -> locations (the reference keeps it fresh via the
KeepConnected stream; here a TTL cache refreshed by Lookup on miss/expiry).
Operations: assign, upload (HTTP POST to the volume server), read, delete,
and submit (assign+upload in one call).
"""

from __future__ import annotations

import http.client
import socket
import time
import threading
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Optional

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.obs import trace as trace_mod
from seaweedfs_tpu_torch.pb import MASTER_SERVICE, AssignResponse, Location
from seaweedfs_tpu_torch.security import tls
from seaweedfs_tpu_torch.security.jwt import mint_file_token

_VID_CACHE_TTL = 30.0

# Errors that mean "this replica is unusable, try the next one". A wedged
# server surfaces a bare TimeoutError/ConnectionError from the socket layer
# (NOT urllib.error.URLError) — catching only URLError would abort failover.
_FAILOVER_ERRORS = (
    urllib.error.URLError,
    TimeoutError,
    ConnectionError,
    http.client.HTTPException,
)


class ClusterError(Exception):
    pass


def _trace_headers() -> dict:
    """X-Weedtpu-Trace header when a trace is active in this thread —
    the HTTP half of cross-process propagation (the RPC half rides gRPC
    metadata inside RpcClient)."""
    tid = trace_mod.current_trace_id()
    return {trace_mod.HTTP_HEADER: tid} if tid else {}


@dataclass
class SubmitResult:
    fid: str
    url: str
    size: int


class MasterClient:
    def __init__(
        self,
        master_address: str,
        signing_key: Optional[bytes] = None,
        read_signing_key: Optional[bytes] = None,
        http_timeout: float = 30.0,
    ):
        """Trusted clients share the cluster's security.toml keys and mint
        their own per-fid JWTs for delete/read (the reference's clients do
        the same; Assign only covers the freshly assigned fid).

        `master_address` may be a comma-separated HA quorum list; calls
        fail over between masters and follow raft-leader redirects."""
        self.addresses = [a.strip() for a in master_address.split(",") if a.strip()]
        self.master_address = self.addresses[0]
        self.signing_key = signing_key
        self.read_signing_key = read_signing_key
        self.http_timeout = http_timeout
        self._clients: dict[str, rpc.RpcClient] = {}
        self._current = self.addresses[0]
        self._lock = threading.Lock()
        self._vid_cache: dict[int, tuple[float, list[Location]]] = {}
        # per-thread keep-alive connections to volume servers: read_ex
        # reuses them instead of a fresh TCP connect per request (the
        # volume server speaks HTTP/1.1, and thread-per-connection on
        # its side makes connection churn the dominant per-read cost at
        # kilo-rps). Plain-HTTP only; TLS clusters take the urllib path.
        self._tl = threading.local()
        # location suspicion (client half of the planner's holder
        # suspicion ladder): a replica that just failed over is tried
        # LAST for the next few seconds, so a wedged server costs the
        # first few requests their timeout instead of every request —
        # at kilo-rps an unsuspecting client burns timeout x rate worth
        # of in-flight capacity on a single SIGSTOP'd node
        self._suspect: dict[str, float] = {}

    def _ordered(self, locations: list[Location]) -> list[Location]:
        """Locations with currently-suspect replicas moved to the back
        (still tried — suspicion reorders, it never excludes)."""
        now = time.monotonic()
        fresh = [l for l in locations if self._suspect.get(l.url, 0.0) <= now]
        if len(fresh) == len(locations):
            return locations
        return fresh + [l for l in locations if l not in fresh]

    def _mark_suspect(self, netloc: str, for_s: float = 3.0) -> None:
        self._suspect[netloc] = time.monotonic() + for_s

    def _pooled_conn(self, netloc: str) -> http.client.HTTPConnection:
        conns = getattr(self._tl, "conns", None)
        if conns is None:
            conns = self._tl.conns = {}
        c = conns.get(netloc)
        if c is None:
            c = http.client.HTTPConnection(netloc, timeout=self.http_timeout)
            # Connect eagerly so we can disable Nagle: a reused keep-alive
            # socket otherwise serializes each small request behind the
            # server's ~40 ms delayed ACK.
            c.connect()
            c.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conns[netloc] = c
        return c

    def _drop_conn(self, netloc: str) -> None:
        conns = getattr(self._tl, "conns", None)
        if conns is not None:
            c = conns.pop(netloc, None)
            if c is not None:
                c.close()

    def _client_for(self, address: str) -> rpc.RpcClient:
        with self._lock:
            c = self._clients.get(address)
            if c is None:
                c = rpc.RpcClient(address)
                self._clients[address] = c
            return c

    def master_call(self, method: str, req: dict, timeout: float = 30.0) -> dict:
        """Unary master call with quorum failover + raft-leader redirect.

        Handles BOTH not-leader signals the master emits (the Assign-style
        `{"error": "not the raft leader", "leader": ...}` dict and the
        RpcFault FAILED_PRECONDITION used by the admin lock), so every
        component (clients, shell, sync tools) shares this one path."""
        import grpc as _grpc

        last_err: Optional[Exception] = None
        tried: list[str] = []
        candidates = [self._current] + [a for a in self.addresses if a != self._current]
        for addr in candidates:
            if addr in tried:
                continue
            tried.append(addr)
            try:
                resp = self._client_for(addr).call(
                    MASTER_SERVICE, method, req, timeout=timeout
                )
            except _grpc.RpcError as e:
                detail = e.details() or ""
                if (
                    e.code() == _grpc.StatusCode.FAILED_PRECONDITION
                    and "not the raft leader" in detail
                ):
                    # "…; leader is <addr>" when one is known; an election
                    # in flight says "no leader elected yet" — keep trying
                    leader = (
                        detail.rsplit("leader is ", 1)[1].strip()
                        if "leader is " in detail
                        else ""
                    )
                    if leader and leader not in tried:
                        candidates.append(leader)
                    last_err = e
                    continue
                if e.code() not in (
                    _grpc.StatusCode.UNAVAILABLE,
                    _grpc.StatusCode.DEADLINE_EXCEEDED,
                ):
                    raise  # app-level fault from a healthy master
                last_err = e
                continue
            if isinstance(resp, dict) and "not the raft leader" in str(
                resp.get("error", "")
            ):
                # an election may be in flight: a follower's hint can be
                # stale/empty — follow it if fresh, else keep trying
                leader = resp.get("leader") or ""
                if leader and leader not in tried:
                    candidates.append(leader)
                last_err = ClusterError(f"{addr}: not the raft leader")
                continue
            self._current = addr
            return resp
        raise ClusterError(f"no usable master ({tried}): {last_err}")

    def close(self) -> None:
        with self._lock:
            for c in self._clients.values():
                c.close()
            self._clients.clear()
        # only the calling thread's pooled sockets are reachable here;
        # other threads' daemon sockets close with the process
        conns = getattr(self._tl, "conns", None)
        if conns is not None:
            for c in conns.values():
                c.close()
            conns.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- master RPCs ---------------------------------------------------------

    def assign(
        self,
        count: int = 1,
        collection: str = "",
        replication: str = "",
        ttl: str = "",
    ) -> AssignResponse:
        resp = AssignResponse.from_dict(
            self.master_call(
                "Assign",
                {
                    "count": count,
                    "collection": collection,
                    "replication": replication,
                    "ttl": ttl,
                },
            )
        )
        if resp.error:
            raise ClusterError(f"assign failed: {resp.error}")
        return resp

    def lookup(self, vid: int, refresh: bool = False) -> list[Location]:
        now = time.monotonic()
        with self._lock:
            hit = self._vid_cache.get(vid)
            if hit and not refresh and now - hit[0] < _VID_CACHE_TTL:
                return hit[1]
        resp = self.master_call("Lookup", {"volume_or_file_ids": [str(vid)]})
        entries = resp.get("volume_id_locations", [])
        locations = []
        if entries and not entries[0].get("error"):
            locations = [Location.from_dict(d) for d in entries[0]["locations"]]
        with self._lock:
            self._vid_cache[vid] = (now, locations)
        return locations

    def lookup_ec(self, vid: int) -> dict[int, list[Location]]:
        resp = self.master_call("LookupEcVolume", {"volume_id": vid})
        return {
            e["shard_id"]: [Location.from_dict(d) for d in e["locations"]]
            for e in resp.get("shard_id_locations", [])
        }

    def volume_list(self) -> dict:
        return self.master_call("VolumeList", {})

    def statistics(self) -> dict:
        return self.master_call("Statistics", {})

    # -- data ops (weed/operation analogs) ------------------------------------

    def upload(self, fid: str, data: bytes, mime: str = "", auth: str = "") -> int:
        """POST to the volume server owning fid's volume. `auth` is the
        JWT from Assign (required when the cluster runs secured)."""
        vid = int(fid.split(",", 1)[0])
        locations = self.lookup(vid)
        if not locations:
            raise ClusterError(f"no locations for volume {vid}")
        last_err: Optional[Exception] = None
        headers = _trace_headers()
        if mime:
            headers["Content-Type"] = mime
        if not auth and self.signing_key:
            auth = mint_file_token(self.signing_key, fid)
        if auth:
            headers["Authorization"] = "Bearer " + auth
        for loc in locations:
            try:
                req = urllib.request.Request(
                    f"{tls.scheme()}://{loc.url}/{fid}",
                    data=data,
                    method="POST",
                    headers=headers,
                )
                with tls.urlopen(req, timeout=self.http_timeout) as r:
                    r.read()
                    return len(data)
            except _FAILOVER_ERRORS as e:  # try a replica
                last_err = e
        raise ClusterError(f"upload of {fid} failed: {last_err}")

    def read(self, fid: str) -> bytes:
        return self.read_ex(fid)[0]

    def read_ex(self, fid: str) -> tuple[bytes, Optional[str]]:
        """Like read(), but also surfaces the serving class the volume
        server resolved the read to (X-Weedtpu-Read-Class: healthy /
        ec_intact / cached / degraded), or None when the server predates
        the header. Load harnesses use it to bucket per-request latency
        by what actually happened instead of guessing from topology."""
        vid = int(fid.split(",", 1)[0])
        last_err = None
        pooled = tls.scheme() == "http"
        # second pass refreshes the vid cache: the volume may have moved
        # (ec.encode cut-over, balance) since it was cached
        for attempt in range(2):
            locations = self.lookup(vid, refresh=attempt > 0)
            if not locations and attempt > 0:
                raise ClusterError(f"no locations for volume {vid}")
            headers = _trace_headers()
            if self.read_signing_key:
                headers["Authorization"] = "Bearer " + mint_file_token(
                    self.read_signing_key, fid
                )
            for loc in self._ordered(locations):
                if pooled:
                    # a kept-alive connection the server closed between
                    # requests surfaces as an error on the FIRST op: retry
                    # that once with a fresh connection before failing over
                    for _fresh in (False, True):
                        try:
                            c = self._pooled_conn(loc.url)
                            c.request("GET", "/" + fid, headers=headers)
                            r = c.getresponse()
                            body = r.read()
                        except _FAILOVER_ERRORS as e:
                            self._drop_conn(loc.url)
                            last_err = e
                            continue
                        if r.status == 200:
                            self._suspect.pop(loc.url, None)
                            return body, r.getheader(trace_mod.READ_CLASS_HEADER)
                        # 404 on one replica can be staleness (e.g. it was
                        # down during the write) — try the other replicas,
                        # but an answering server is not suspect
                        last_err = f"HTTP {r.status}"
                        break
                    else:
                        self._mark_suspect(loc.url)
                    continue
                try:
                    req = urllib.request.Request(f"{tls.scheme()}://{loc.url}/{fid}", headers=headers)
                    with tls.urlopen(req, timeout=self.http_timeout) as r:
                        body = r.read()
                        self._suspect.pop(loc.url, None)
                        return body, r.headers.get(trace_mod.READ_CLASS_HEADER)
                except urllib.error.HTTPError as e:
                    last_err = f"HTTP {e.code}"
                except _FAILOVER_ERRORS as e:
                    last_err = e
                    self._mark_suspect(loc.url)
        raise ClusterError(f"read of {fid} failed on all locations: {last_err}")

    def delete(self, fid: str) -> bool:
        vid = int(fid.split(",", 1)[0])
        ok = False
        headers = {}
        if self.signing_key:
            headers["Authorization"] = "Bearer " + mint_file_token(self.signing_key, fid)
        for loc in self.lookup(vid):
            try:
                req = urllib.request.Request(
                    f"{tls.scheme()}://{loc.url}/{fid}", method="DELETE", headers=headers
                )
                with tls.urlopen(req, timeout=self.http_timeout) as r:
                    r.read()
                    ok = True
            except _FAILOVER_ERRORS:
                continue
        return ok

    def submit(
        self, data: bytes, collection: str = "", replication: str = "",
        mime: str = "", ttl: str = "",
    ) -> SubmitResult:
        a = self.assign(collection=collection, replication=replication, ttl=ttl)
        size = self.upload(a.fid, data, mime=mime, auth=a.auth)
        return SubmitResult(fid=a.fid, url=a.url, size=size)
