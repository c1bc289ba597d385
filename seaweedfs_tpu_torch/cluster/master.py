"""Master server — mirror of weed/server/master_server.go +
master_grpc_server*.go.

Hosts the weedtpu.Master RPC service over seaweedfs_tpu_torch.rpc: heartbeat
ingest into Topology, fid assignment (Assign -> grow volumes on demand via
the volume servers' VolumeCreate RPC), volume/EC lookup, and the topology
dump that powers shell commands. Single-master: `peers` (raft HA) raises
until that module is ported.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

import grpc

from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.obs import trace as trace_mod
from seaweedfs_tpu_torch.utils import config, httpd
from seaweedfs_tpu_torch.cluster.sequence import MemorySequencer
from seaweedfs_tpu_torch.security.jwt import mint_file_token
from seaweedfs_tpu_torch.cluster.topology import Topology, VolumeLayout
from seaweedfs_tpu_torch.pb import MASTER_SERVICE, VOLUME_SERVICE, Heartbeat
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement


class MasterServer:
    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        volume_size_limit: Optional[int] = None,
        default_replication: str = "000",
        sequencer=None,
        reap_interval: float = 30.0,
        guard=None,
        peers: Optional[list[str]] = None,
        garbage_threshold: float = 0.3,
        vacuum_interval: float = 900.0,
        http_port: Optional[int] = 0,
    ):
        self.guard = guard
        self.topology = Topology(
            **({"volume_size_limit": volume_size_limit} if volume_size_limit else {})
        )
        self.sequencer = sequencer or MemorySequencer()
        self.default_replication = default_replication
        self._rng = random.Random()
        self._grow_lock = threading.Lock()
        self._admin_locks: dict[str, tuple[int, float, str]] = {}
        self._admin_lock_mu = threading.Lock()
        self._server = rpc.RpcServer(port=port, host=host)
        self._server.add_service(self._build_service())
        self.host = host
        self.port = self._server.port
        # HTTP facade (master_server_handlers*.go analog): the reference's
        # best-known API is `curl master:9333/dir/assign`. None disables.
        self._http = None
        if http_port is not None:
            self._http = _MasterHTTPServer((host, http_port), _MasterHttpHandler)
            self._http.master = self
            self.http_port = self._http.server_address[1]
            self._http_thread = threading.Thread(
                target=self._http.serve_forever, daemon=True
            )
        else:
            self.http_port = 0
        self._reap_interval = reap_interval
        self.garbage_threshold = garbage_threshold
        self._vacuum_interval = vacuum_interval
        self._stop = threading.Event()
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True)
        self._vacuumer = threading.Thread(target=self._vacuum_loop, daemon=True)
        # fleet repair scheduler (WEEDTPU_REPAIR=on): mass-rebuild brain
        # that ranks under-replicated stripes by remaining redundancy and
        # drives batched rebuilds through the admission lane. Soft state,
        # like the topology.
        self.repair = None
        if config.env("WEEDTPU_REPAIR") == "on":
            from seaweedfs_tpu_torch.ec.fleet import RepairScheduler

            self.repair = RepairScheduler(self)
            self.topology.on_ec_shrink = self.repair.kick
        # raft HA (a master quorum, `peers`) is not in this package yet: it
        # raises rather than running a single master without it.
        if peers:
            raise NotImplementedError(
                f"peers {peers}: raft HA (cluster/raft.py) is not ported yet "
                "(ROADMAP Queue 1 item 5)"
            )

    # a single master always leads
    is_leader = True

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._server.start()
        if self._http is not None:
            self._http_thread.start()
        self._reaper.start()
        self._vacuumer.start()
        if self.repair is not None:
            self.repair.start()

    def stop(self) -> None:
        self._stop.set()
        if self.repair is not None:
            self.repair.stop()
        if self._http is not None:
            # shutdown() blocks on an event only serve_forever() sets — a
            # never-started thread (start() raised early) must skip it
            if self._http_thread.is_alive():
                self._http.shutdown()
            self._http.server_close()
        self._server.stop()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def _reap_loop(self) -> None:
        while not self._stop.wait(self._reap_interval):
            dead = self.topology.reap_dead_nodes()
            if dead and self.repair is not None:
                self.repair.kick("nodes reaped")

    # -- automatic vacuum (topology_vacuum.go analog) --------------------------

    def _vacuum_loop(self) -> None:
        while not self._stop.wait(self._vacuum_interval):
            try:
                self.vacuum_once()
            except Exception:  # noqa: BLE001 — maintenance must never die
                pass

    def vacuum_once(self) -> list[int]:
        """One scan: compact every writable volume whose heartbeat-reported
        garbage ratio exceeds the threshold, on every holder. Returns the
        volume ids vacuumed. The reference's master does this on a timer;
        operators can still force it via `volume.vacuum` in the shell.

        Safety: the sweep defers entirely while the cluster admin lock is
        held — every mutating shell operation (ec.encode, balance, ...)
        runs under it, and compacting a volume mid-copy/encode would shift
        every needle offset under the operation's feet. Each holder is
        also re-checked with a live VolumeStatus immediately before the
        compact: the heartbeat-reported read_only flag can be a whole
        heartbeat interval stale."""
        now = time.monotonic()
        with self._admin_lock_mu:
            if any(exp > now for _, exp, _ in self._admin_locks.values()):
                return []  # operator maintenance in flight: next sweep retries
        candidates: dict[int, list[str]] = {}
        with self.topology._lock:
            for node in self.topology.nodes.values():
                for vi in node.volumes.values():
                    if vi.read_only or vi.disk_type == "remote":
                        continue  # frozen or tiered: cannot compact
                    if vi.garbage_ratio >= self.garbage_threshold:
                        candidates.setdefault(vi.id, []).append(node.grpc_address)
        done = []
        for vid, holders in sorted(candidates.items()):
            with self._admin_lock_mu:  # an operator may have locked mid-sweep
                if any(
                    exp > time.monotonic()
                    for _, exp, _ in self._admin_locks.values()
                ):
                    return done  # stop immediately; next sweep retries
            ok = True
            for addr in holders:  # every replica compacts (same live set)
                try:
                    with rpc.RpcClient(addr) as c:
                        status = c.call(
                            VOLUME_SERVICE, "VolumeStatus", {"volume_id": vid},
                            timeout=10,
                        )
                        if status.get("read_only"):
                            ok = False  # marked since the last heartbeat
                            continue
                        c.call(
                            VOLUME_SERVICE,
                            "VolumeCompact",
                            {"volume_id": vid},
                            timeout=600,
                        )
                except Exception:  # noqa: BLE001 — retried next sweep
                    ok = False
            if ok:
                done.append(vid)
        return done

    # -- RPC surface ---------------------------------------------------------

    def _build_service(self) -> rpc.Service:
        svc = rpc.Service(MASTER_SERVICE)
        svc.add("Heartbeat", self._rpc_heartbeat)
        svc.add("Assign", self._rpc_assign)
        svc.add("Lookup", self._rpc_lookup)
        svc.add("LookupEcVolume", self._rpc_lookup_ec)
        svc.add("VolumeList", self._rpc_volume_list)
        svc.add("LeaveCluster", self._rpc_leave)
        svc.add("Statistics", self._rpc_statistics)
        svc.add("LeaseAdminToken", self._rpc_lease_admin_token)
        svc.add("ReleaseAdminToken", self._rpc_release_admin_token)
        svc.add("FilerHeartbeat", self._rpc_filer_heartbeat)
        svc.add("ListClusterNodes", self._rpc_list_cluster_nodes)
        svc.add("RaftListClusterServers", self._rpc_raft_status)
        svc.add("VolumeGrow", self._rpc_volume_grow)
        svc.add("CollectionDelete", self._rpc_collection_delete)
        svc.add("RepairStatus", self._rpc_repair_status)
        return svc

    def _rpc_repair_status(self, req: dict, ctx) -> dict:
        """Fleet-repair view for `ec.status` and the chaos gates: queue
        depth, redundancy histogram, placement-violation audit, and the
        seq-ordered dispatch event log that proves 2-missing stripes
        began repair before any 1-missing stripe."""
        if self.repair is None:
            return {
                "enabled": False,
                "queue_depth": 0,
                "inflight": 0,
                "redundancy_histogram": {},
                "violations": [],
                "events": [],
                "suspects": [],
            }
        return self.repair.status()

    def _rpc_collection_delete(self, req: dict, ctx) -> dict:
        """Drop every volume and EC shard set of one collection across the
        cluster (CollectionDelete analog): per-bucket collections make an
        S3 bucket delete an O(volumes) drop instead of an O(needles) walk."""
        collection = req.get("collection", "")
        if not collection:
            # an empty name matches the DEFAULT collection: refusing it
            # here keeps a buggy caller from wiping every unlabeled volume
            raise rpc.RpcFault(
                "collection name required", code=grpc.StatusCode.INVALID_ARGUMENT
            )
        with self.topology._lock:
            by_addr: dict[str, list[tuple[int, str]]] = {}
            for node in self.topology.nodes.values():
                for vid, vi in node.volumes.items():
                    if getattr(vi, "collection", "") == collection:
                        by_addr.setdefault(node.grpc_address, []).append(
                            (vid, "volume")
                        )
                for vid in node.ec_shards:
                    if self.topology.ec_collections.get(vid, "") == collection:
                        by_addr.setdefault(node.grpc_address, []).append((vid, "ec"))
        # one channel per address, short per-call timeout, addresses in
        # parallel: a dead node costs ~one timeout, not 30s x its volumes
        deleted = [0]
        dl = threading.Lock()

        def drain(addr: str, victims: list[tuple[int, str]]) -> None:
            try:
                with rpc.RpcClient(addr) as c:
                    for vid, kind in victims:
                        try:
                            if kind == "volume":
                                c.call(
                                    VOLUME_SERVICE, "VolumeDelete",
                                    {"volume_id": vid}, timeout=5,
                                )
                            else:
                                c.call(
                                    VOLUME_SERVICE, "VolumeEcShardsDelete",
                                    {"volume_id": vid, "collection": collection,
                                     "shard_ids": []},
                                    timeout=10,
                                )
                            with dl:
                                deleted[0] += 1
                        except Exception:  # noqa: BLE001 — heartbeat
                            continue  # reconciliation reaps stragglers
            except Exception:  # noqa: BLE001 — whole node unreachable
                pass

        threads = [
            threading.Thread(target=drain, args=(a, v)) for a, v in by_addr.items()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        return {"deleted": deleted[0]}

    def _rpc_volume_grow(self, req: dict, ctx) -> dict:
        """Pre-allocate volumes for a (collection, replication, ttl) layout
        without waiting for an Assign to trip growth (volume.grow analog)."""
        collection = req.get("collection", "")
        replication = req.get("replication") or self.default_replication
        ttl = req.get("ttl", "")
        count = max(1, min(int(req.get("count", 1)), 100))
        layout = self.topology.get_layout(collection, replication, ttl)
        grown = 0
        for _ in range(count):
            grown += 1 if self._grow_volumes(
                layout, collection, replication, ttl, force=True
            ) else 0
        return {"grown": grown}

    def _rpc_raft_status(self, req: dict, ctx) -> dict:
        """Raft membership/status for cluster.raft.ps (RaftListClusterServers
        analog): which masters exist, who leads, at what term."""
        return {
            "enabled": False,
            "leader": self.address,
            "state": "leader",
            "term": 0,
            "servers": [self.address],
        }

    # -- filer registry (cluster node list, master_grpc_server_cluster.go
    # analog: filers announce themselves so shells/mounts can discover
    # them through the master) -----------------------------------------------

    FILER_TTL = 20.0

    def _rpc_filer_heartbeat(self, req: dict, ctx) -> dict:
        """Cluster-node announce for filers AND mq brokers (node_type
        distinguishes them; default 'filer' keeps old clients working)."""
        node_type = req.get("node_type") or "filer"
        with self._admin_lock_mu:  # small table; reuse the mutex
            if not hasattr(self, "_cluster_nodes"):
                self._cluster_nodes = {}
            self._cluster_nodes[(node_type, req["http_address"])] = (
                req.get("grpc_address", ""),
                time.monotonic(),
            )
        return {"leader": self.address}

    def _rpc_list_cluster_nodes(self, req: dict, ctx) -> dict:
        now = time.monotonic()
        out: dict[str, list] = {"filers": [], "brokers": []}
        with self._admin_lock_mu:
            for (node_type, url), (grpc_addr, seen) in getattr(
                self, "_cluster_nodes", {}
            ).items():
                if now - seen >= self.FILER_TTL:
                    continue
                row = {"http_address": url, "grpc_address": grpc_addr}
                if node_type == "broker":
                    out["brokers"].append(row)
                else:
                    out["filers"].append(row)
        return out

    # -- cluster exclusive lock (wdclient/exclusive_locks analog) -------------
    #
    # The shell's mutating commands (ec.encode/rebuild/balance, ...) hold a
    # cluster-wide exclusive lock leased from the master
    # (weed/wdclient/exclusive_locks/exclusive_locker.go).

    ADMIN_LOCK_TTL = 30.0

    def _rpc_lease_admin_token(self, req: dict, ctx) -> dict:
        name = req.get("lock_name") or "admin"
        prev = int(req.get("previous_token", 0))
        now = time.monotonic()
        with self._admin_lock_mu:
            holder = self._admin_locks.get(name)
            if holder is not None and holder[1] > now and holder[0] != prev:
                raise rpc.RpcFault(
                    f"lock {name} held by {holder[2]}",
                    code=grpc.StatusCode.FAILED_PRECONDITION,
                )
            token = prev if (holder is not None and holder[0] == prev) else (
                self._rng.getrandbits(63) or 1
            )
            self._admin_locks[name] = (
                token,
                now + self.ADMIN_LOCK_TTL,
                req.get("client_name", ""),
            )
        return {"token": token, "lock_ts_ns": int(now * 1e9)}

    def _rpc_release_admin_token(self, req: dict, ctx) -> dict:
        name = req.get("lock_name") or "admin"
        prev = int(req.get("previous_token", 0))
        with self._admin_lock_mu:
            holder = self._admin_locks.get(name)
            if holder is not None and holder[0] == prev:
                del self._admin_locks[name]
        return {}

    def _rpc_heartbeat(self, req: dict, ctx) -> dict:
        # the reply names the leader (this master) so volume servers can
        # prefer it
        stats.MasterReceivedHeartbeatCounter.inc()
        hb = Heartbeat.from_dict(req)
        self.topology.process_heartbeat(hb)
        if self.repair is not None and hb.unreachable_peers:
            self.repair.note_reports(hb.url, hb.unreachable_peers)
        return {
            "volume_size_limit": self.topology.volume_size_limit,
            "leader": self.address,
        }

    def _rpc_leave(self, req: dict, ctx) -> dict:
        self.topology.unregister_node(req["url"])
        return {}

    def _rpc_assign(self, req: dict, ctx) -> dict:
        # clamped at the RPC layer: a negative count would REWIND the id
        # sequencer (duplicate fids overwriting live needles), and the
        # count reaches here unauthenticated via the HTTP facade
        count = max(1, min(int(req.get("count", 1)), 10000))
        collection = req.get("collection", "")
        replication = req.get("replication") or self.default_replication
        ttl = req.get("ttl", "")
        layout = self.topology.get_layout(collection, replication, ttl)
        picked = self.topology.pick_writable(layout, self._rng)
        if picked is None:
            self._grow_volumes(layout, collection, replication, ttl)
            picked = self.topology.pick_writable(layout, self._rng)
        if picked is None:
            return {"error": "no writable volumes and growth failed", "count": 0}
        vid, nodes = picked
        key = self.sequencer.next_ids(count)
        cookie = self._rng.getrandbits(32)
        node = nodes[self._rng.randrange(len(nodes))]
        stats.MasterAssignCounter.inc()
        fid = str(FileId(vid, key, cookie))
        resp = {
            "fid": fid,
            "url": node.url,
            "public_url": node.public_url,
            "grpc_port": node.grpc_port,
            "count": count,
        }
        if self.guard is not None and self.guard.signing_key:
            # token the client must present to the volume server (jwt.go analog)
            resp["auth"] = mint_file_token(
                self.guard.signing_key, fid, self.guard.expires_seconds
            )
        return resp

    def _rpc_lookup(self, req: dict, ctx) -> dict:
        out = []
        for raw in req.get("volume_or_file_ids", []):
            vid_s = str(raw).split(",", 1)[0]
            try:
                vid = int(vid_s)
            except ValueError:
                out.append({"volume_id": vid_s, "error": "bad volume id", "locations": []})
                continue
            nodes = self.topology.lookup(vid, req.get("collection", ""))
            if not nodes:
                # EC volume: any shard holder can serve the (degraded) read
                seen = set()
                for holders in self.topology.lookup_ec_shards(vid).values():
                    for n in holders:
                        if n.url not in seen:
                            seen.add(n.url)
                            nodes.append(n)
            entry = {
                "volume_id": vid_s,
                "locations": [
                    {"url": n.url, "public_url": n.public_url, "grpc_port": n.grpc_port}
                    for n in nodes
                ],
            }
            if not nodes:
                entry["error"] = "volume not found"
            out.append(entry)
        return {"volume_id_locations": out}

    def _rpc_lookup_ec(self, req: dict, ctx) -> dict:
        vid = int(req["volume_id"])
        shard_map = self.topology.lookup_ec_shards(vid)
        if not shard_map:
            raise rpc.NotFoundFault(f"ec volume {vid} not found")
        # each holder carries its failure-domain labels: readers sort
        # their survivor/hedge ladders same-rack-first on ties, so a
        # degraded read prefers the cheap fetch without a master
        # round-trip at decision time
        return {
            "volume_id": vid,
            "shard_id_locations": [
                {
                    "shard_id": sid,
                    "locations": [
                        {
                            "url": n.url,
                            "public_url": n.public_url,
                            "grpc_port": n.grpc_port,
                            "data_center": n.data_center,
                            "rack": n.rack,
                        }
                        for n in nodes
                    ],
                }
                for sid, nodes in sorted(shard_map.items())
            ],
        }

    def _rpc_volume_list(self, req: dict, ctx) -> dict:
        return self.topology.to_dict()

    def _rpc_statistics(self, req: dict, ctx) -> dict:
        t = self.topology
        with t._lock:
            total = sum(n.max_volume_count for n in t.nodes.values())
            used = sum(len(n.volumes) for n in t.nodes.values())
            return {
                "node_count": len(t.nodes),
                "volume_count": used,
                "max_volume_count": total,
                "ec_volume_count": len(t.ec_locations),
            }

    # -- growth (volume_growth.go analog) ------------------------------------

    def _grow_volumes(
        self,
        layout: VolumeLayout,
        collection: str,
        replication: str,
        ttl: str,
        force: bool = False,
    ) -> int:
        """Create one new volume (all replicas) via VolumeCreate RPCs.
        `force` skips the already-writable short-circuit (volume.grow's
        explicit pre-allocation)."""
        with self._grow_lock:
            if not force and self.topology.pick_writable(layout, self._rng) is not None:
                return 0  # raced: someone grew while we waited
            rp = ReplicaPlacement.parse(replication or "000")
            targets = self.topology.place_replicas(rp)
            if not targets:
                return 0
            vid = self.topology.next_volume_id()
            succeeded = []
            for node in targets:
                try:
                    with rpc.RpcClient(node.grpc_address) as c:
                        c.call(
                            VOLUME_SERVICE,
                            "VolumeCreate",
                            {
                                "volume_id": vid,
                                "collection": collection,
                                "replication": replication or "000",
                                "ttl": ttl,
                            },
                        )
                    succeeded.append(node)
                except Exception:  # noqa: BLE001 — skip unreachable node
                    continue
            # registration happens via the next heartbeats; to serve the
            # pending Assign immediately, register the nodes whose create
            # actually succeeded
            if succeeded:
                from seaweedfs_tpu_torch.pb import VolumeInformation

                with self.topology._lock:
                    for node in succeeded:
                        vi = VolumeInformation(
                            id=vid,
                            collection=collection,
                            replica_placement=replication or "000",
                            ttl=ttl,
                        )
                        node.volumes[vid] = vi
                        layout.register(vi, node)
            return len(succeeded)


# -- HTTP facade (master_server_handlers*.go analog) --------------------------
#
# The reference master's HTTP API is its most-used surface:
#   GET/POST /dir/assign?count=&collection=&replication=&ttl=
#   GET      /dir/lookup?volumeId=<vid or fid>
#   GET      /dir/status           topology dump
#   GET      /cluster/status       raft leadership
#   GET      /cluster/healthz      liveness probe
#   GET      /vol/grow?count=&collection=&replication=&ttl=
#   GET      /col/delete?collection=
#   GET      /metrics              Prometheus text
# Field names follow the reference's JSON (fid/url/publicUrl/count).


class _MasterHTTPServer(httpd.ThreadingHTTPServer):
    master: "MasterServer"


class _MasterHttpHandler(httpd.QuietHandler):
    protocol_version = "HTTP/1.1"

    @property
    def m(self) -> "MasterServer":
        return self.server.master

    def _json(self, code: int, obj: dict) -> None:
        import json as _json

        tid = trace_mod.current_trace_id()
        self.send_reply(
            code, _json.dumps(obj).encode(), "application/json",
            headers={trace_mod.HTTP_HEADER: tid} if tid else None,
        )

    def _route(self):
        import urllib.parse as _up

        path = _up.urlparse(self.path).path
        if path == "/debug/traces":
            self._json(200, trace_mod.debug_payload(self.path))
            return
        if path in ("/metrics", "/cluster/healthz"):
            self._route_inner()  # scrape/probe paths must not churn the ring
            return
        with trace_mod.start(
            "master.http",
            klass="master",
            trace_id=self.headers.get(trace_mod.HTTP_HEADER),
        ):
            trace_mod.annotate(path=path)
            self._route_inner()

    def _route_inner(self):
        import urllib.parse as _up

        u = _up.urlparse(self.path)
        q = {k: v[0] for k, v in _up.parse_qs(u.query).items()}
        path = u.path
        m = self.m
        try:
            if path == "/dir/assign":
                resp = m._rpc_assign(
                    {
                        "count": httpd.safe_int(q.get("count"), 1),
                        "collection": q.get("collection", ""),
                        "replication": q.get("replication", ""),
                        "ttl": q.get("ttl", ""),
                    },
                    None,
                )
                out = {
                    "fid": resp.get("fid", ""),
                    "url": resp.get("url", ""),
                    "publicUrl": resp.get("public_url", ""),
                    "count": resp.get("count", 0),
                }
                if resp.get("error"):
                    out["error"] = resp["error"]
                if resp.get("auth"):
                    out["auth"] = resp["auth"]
                self._json(200, out)
            elif path == "/dir/lookup":
                vid = q.get("volumeId", "")
                resp = m._rpc_lookup({"volume_or_file_ids": [vid]}, None)
                entry = resp["volume_id_locations"][0]
                out = {
                    "volumeId": entry["volume_id"],
                    "locations": [
                        {"url": l["url"], "publicUrl": l["public_url"]}
                        for l in entry["locations"]
                    ],
                }
                if entry.get("error"):
                    out["error"] = entry["error"]
                self._json(200 if not entry.get("error") else 404, out)
            elif path == "/dir/status":
                self._json(200, {"Topology": m.topology.to_dict()})
            elif path == "/cluster/status":
                st = m._rpc_raft_status({}, None)
                self._json(
                    200,
                    {
                        "IsLeader": m.is_leader,
                        "Leader": st.get("leader"),
                        "Peers": st.get("servers", []),
                    },
                )
            elif path == "/cluster/healthz":
                self.send_reply(200, b"ok", "text/plain")
            elif path == "/vol/grow":
                resp = m._rpc_volume_grow(
                    {
                        "count": httpd.safe_int(q.get("count"), 1),
                        "collection": q.get("collection", ""),
                        "replication": q.get("replication", ""),
                        "ttl": q.get("ttl", ""),
                    },
                    None,
                )
                self._json(200, resp)
            elif path == "/col/delete":
                resp = m._rpc_collection_delete(
                    {"collection": q.get("collection", "")}, None
                )
                self._json(200, resp)
            elif path == "/metrics":
                self.send_reply(
                    200, stats.REGISTRY.expose().encode(),
                    "text/plain; version=0.0.4",
                )
            elif path in ("/", "/ui", "/ui/index.html"):
                # operator status page (master_server_handlers_ui.go analog)
                # escaped throughout: dc/rack/url names arrive from
                # unauthenticated heartbeats and render in a browser
                from html import escape as _esc

                topo = m.topology.to_dict()
                node_rows = []
                for dc, racks in sorted(topo.get("data_centers", {}).items()):
                    for rack, nodes in sorted(racks.items()):
                        for n in nodes:
                            node_rows.append(
                                f"<tr><td>{_esc(str(dc))}</td>"
                                f"<td>{_esc(str(rack))}</td>"
                                f"<td>{_esc(str(n['url']))}</td>"
                                f"<td>:{int(n['grpc_port'])}</td>"
                                f"<td>{len(n.get('volumes', []))}"
                                f"/{int(n.get('max_volume_count', 0))}</td>"
                                f"<td>{len(n.get('ec_shards', []))}</td></tr>"
                            )
                st = m._rpc_raft_status({}, None)
                html = (
                    "<!DOCTYPE html><html><head><title>weedtpu master</title>"
                    "<style>body{font-family:monospace}table{border-collapse:"
                    "collapse}td,th{border:1px solid #999;padding:2px 8px}"
                    "</style></head><body>"
                    f"<h1>Master {_esc(m.address)}</h1>"
                    f"<p>leader: {_esc(str(st.get('leader')))} &middot; "
                    f"term {int(st.get('term', 0))}"
                    f" &middot; volume size limit "
                    f"{int(topo.get('volume_size_limit', 0))}</p>"
                    "<h2>Topology</h2><table><tr><th>dc</th><th>rack</th>"
                    "<th>node</th><th>grpc</th><th>volumes</th><th>ec</th></tr>"
                    f"{''.join(node_rows)}</table>"
                    '<p><a href="/dir/status">/dir/status</a> &middot; '
                    '<a href="/cluster/status">/cluster/status</a> &middot; '
                    '<a href="/metrics">/metrics</a></p></body></html>'
                )
                self.send_reply(200, html.encode(), "text/html; charset=utf-8")
            else:
                self._json(404, {"error": f"unknown path {path}"})
        except rpc.RpcFault as e:
            self._json(412, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — facade must not kill keep-alive
            self._json(500, {"error": f"{type(e).__name__}: {e}"})

    def do_GET(self):
        self._route()

    def do_POST(self):
        # drain framing; assign params ride the query string. A chunked
        # body can't be drained (read_body -> None): unread bytes would
        # desync keep-alive, so answer 411 per the helper's contract.
        if self.read_body() is None:
            self.reply_length_required()
            return
        self._route()
