"""Chaos soak: a live multi-process cluster under continuous load while
volume servers are killed and restarted at random: the failure-detection
and recovery paths exercised end to end, not per unit. Verifies ZERO data
loss: every acknowledged write must read back byte-identical for the
whole run, through whatever mix of replica failover and EC degraded reads
the kills force. Every volume server is its own `python -m
seaweedfs_tpu_torch volume ... --device <device>` process, so each one
opens its own CUDA context on the card (`--device cuda`, the default) and
a SIGKILL releases that context.

Topology: 1 master (in this process) + 3 volume servers (subprocesses);
files are written with replication 001 (2 copies) so any single kill
leaves a live replica; mid-run one volume is EC-encoded so degraded reads
join the mix.

`--wedge` switches the chaos from kills to WEDGES: victims get SIGSTOP
(the process is alive but answers nothing: the failure mode a crashed
disk controller or a stopped container exhibits, and the one the
per-holder cap + suspicion window on the degraded-read ladder exists
for) and SIGCONT a few seconds later. No process ever restarts, so any
stall in the read path is the ladder's fault, not a reboot's.

`--latency` additionally records every verification read in the SLO
recorder (`ec/slo.py`) and folds p50/p99 per class (reads against the
EC'd volume vs plain replicated volumes) into the report (closed-loop:
these reads retry and pace themselves, so treat the quantiles as a
floor, not the user-facing tail).

Kill mode also runs a TRACE-REPAIR scenario mid-soak: the EC volume's
shards are replicated onto a second holder, one shard is dropped on
every replica, and a third node rebuilds it with trace_mode=on while
the primary holder is SIGKILLed mid-rebuild: the projection fetch must
fall back to full-slab sources (which fail over to the surviving
replica) inside the SAME rebuild call, with zero lost bytes. Kill-mode
nodes run with a small WEEDTPU_BENCH_RPC_DELAY_MS so the rebuild spans
enough wall time for the kill to land mid-stream.

`--inline` starts every volume server with WEEDTPU_INLINE_EC=on (bench-
scale stripe geometry so rows actually complete) and adds an INLINE-
INGEST scenario to kill mode: a volume taking writes is SIGKILLed ON ITS
OWNER mid-inline-encode (stripe partials + journal on disk), the node
restarts, more writes land (the inline encoder resumes from the journaled
sidecar), and the volume is then sealed with VolumeEcShardsGenerate
{inline:true}: resume-or-fallback must produce a mountable shard set
and the final read pass must verify EVERY byte.

`--convert` (kill mode) adds a GEOMETRY-CONVERSION scenario: the EC
volume's owner is SIGKILLed mid-`ec.convert` (staged target shards +
the crash-resumable .ecc journal on disk), restarted, and proven to
still serve every blob through the OLD geometry (staged state must be
invisible to the read path) before a re-issued convert RESUMES from
the journal and cuts over to the 20+4 merge layout (stale old-geometry
shards on other nodes dropped, the shell's post-cutover discipline).
The final read pass then demands every byte through the new geometry.

`--corrupt` (kill mode) injects SILENT CORRUPTION into live EC shard
files mid-soak (one bit-flip, truncation, or deletion, cycling, per
chaos round) with the background scrubber running hot (WEEDTPU_SCRUB=on,
0.5 s cycles). The servers must detect each injection (scrub or
verify-on-read), quarantine the shard out of serving, and auto-repair it
(clean-replica re-pull or trace-mode rebuild, re-verified against .eci)
while the kill loop keeps running; the run FAILS unless every injection
ends healed AND every byte still reads back exactly (a corrupt byte
served to a client shows up as BYTES DIFFER = lost).

`--rack` runs the FLEET-REPAIR acceptance scenario instead of the kill
loop (see run_rack_mode): 7 rack-labeled servers, four domain-spread EC
volumes, open-loop read traffic, SIGKILL one node and then an entire
two-node rack, with the master's WEEDTPU_REPAIR scheduler required to
carry each settle-window cohort in ONE fused batch (2-missing stripes
ahead of 1-missing ones as the in-batch BLOCK order), converge back
to full coverage, and leave zero failure-domain violations.

Usage:
  python -m seaweedfs_tpu_torch.scripts.chaos_soak [--seconds 300] [--wedge]
      [--latency] [--inline] [--corrupt] [--convert] [--rack]
      [--device cuda|cpu] [--out PATH]
Writes its report to --out (default: SOAK_<mode>.json in the system temp
directory; never under artifacts/) and exits nonzero on any lost byte,
unhealed injection, incomplete conversion, or a fleet-repair gate failure
(ordering / coverage / placement audit). With `--device cuda` (the
default) the harness builds the kernels once before any server starts and
raises when there is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

from seaweedfs_tpu_torch.utils import config

#: the directory that holds the `seaweedfs_tpu_torch` package: the servers'
#: working directory, so `python -m seaweedfs_tpu_torch` resolves this copy
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: counters scraped from every server's /metrics in rack mode: decodes for
#: reads, rebuild RPCs (fused batches included) and their network bytes
RACK_COUNTERS = (
    "weedtpu_ec_reconstruct_seconds_count",
    "weedtpu_degraded_read_seconds_count",
    "weedtpu_ec_rebuild_seconds_count",
    "weedtpu_ec_repair_network_bytes_total",
)


def prepare_device(device: str) -> None:
    """Before any server starts on `device`: with cuda, raise when there is
    no card, and build every kernel library once here, so the servers load
    it instead of running nvcc side by side on the same sources."""
    if device == "cpu":
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {device}: no CUDA device; pass --device cpu for the plain version"
        )
    from seaweedfs_tpu_torch.ops import _build

    _build.build()


# -- shared corruption-injection primitives (weedload.py imports these, so
# the two harnesses can never drift on what "injected" and "healed" mean) --


def ec_shard_path(dirpath: str, vid: int, shard: int) -> str:
    return os.path.join(dirpath, f"{vid}.ec{shard:02d}")


def ec_shard_clean(dirpath: str, vid: int, shard: int, crcs) -> bool:
    """Whole-file CRC32 equals the .eci-recorded value — the HEALED check
    (covers repair-restored bit-flips/truncations and re-created deletes)."""
    import zlib

    try:
        crc = 0
        with open(ec_shard_path(dirpath, vid, shard), "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
        return crc == (crcs[shard] & 0xFFFFFFFF)
    except OSError:
        return False


def inject_shard_fault(path: str, kind: str, rng) -> bool:
    """One bitflip | truncate | delete against a live shard file. False
    when the file vanished underneath (racing repair/kill) — the caller
    just picks another target."""
    try:
        if kind == "bitflip":
            size = os.path.getsize(path)
            off = rng.randrange(max(1, size))
            with open(path, "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([(b[0] if b else 0) ^ 0x40]))
        elif kind == "truncate":
            os.truncate(path, os.path.getsize(path) * 2 // 3)
        else:
            os.remove(path)
        return True
    except OSError:
        return False


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


class Node:
    """One volume server subprocess on `device` (the card by default)."""

    def __init__(self, i: int, dirpath: str, master: str, rack: str = "",
                 device: str = "cuda"):
        self.i = i
        self.dir = dirpath
        self.master = master
        self.rack = rack
        self.device = device
        self.http = _free_port()
        self.grpc = _free_port()
        self.proc: subprocess.Popen | None = None
        self.wedged = False

    def command(self) -> list[str]:
        return (
            [
                sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
                "-port", str(self.http), "-grpcPort", str(self.grpc),
                "-dir", self.dir, "-mserver", self.master, "-max", "30",
            ]
            + (["-rack", self.rack] if self.rack else [])
            + ["--device", self.device]
        )

    def start(self) -> None:
        # per-node log FILE (not a pipe: an unread pipe would deadlock the
        # child); in a chaos test the server logs are the evidence. A new
        # process (fork+exec), never a fork of this one: this process may
        # hold a CUDA context, and the server opens its own
        # weedlint: ignore[open-no-ctx] node-lifetime server log, the child's stdout/stderr, closed in kill()
        self.log = open(os.path.join(self.dir, "server.log"), "ab")
        self.proc = subprocess.Popen(
            self.command(), cwd=PKG_ROOT, stdout=self.log, stderr=self.log
        )

    def kill(self, hard: bool) -> None:
        if self.proc is not None:
            self.proc.send_signal(signal.SIGKILL if hard else signal.SIGTERM)
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
            self.proc = None
            self.log.close()
        self.wedged = False

    def wedge(self) -> None:
        """SIGSTOP: the server is alive (sockets open, connections
        accepted by the kernel backlog) but answers NOTHING — the exact
        shape the per-holder cap on degraded reads must absorb."""
        if self.proc is not None and not self.wedged:
            self.proc.send_signal(signal.SIGSTOP)
            self.wedged = True

    def unwedge(self) -> None:
        if self.proc is not None and self.wedged:
            self.proc.send_signal(signal.SIGCONT)
            self.wedged = False

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


def run_rack_mode(seconds: int, device: str = "cuda", out: str | None = None) -> int:
    """`--rack`: survive a node, then a rack: the fleet-repair
    acceptance scenario. Topology: 7 volume servers in 6 racks (rack rk0
    holds TWO nodes, rk1..rk5 one each). Four EC volumes are spread with
    the failure-domain discipline, shaped so rack rk0 holds ONE shard of
    the A-type volumes and TWO shards of the B-type volumes. Under
    continuous open-loop read traffic:

      phase 1 (a node):  SIGKILL the rk5 node — A volumes go 2-missing,
                         B volumes 1-missing; the master scheduler must
                         carry the whole cohort in ONE fused batch with
                         every 2-missing volume ordered before any
                         1-missing one as the in-batch BLOCK order, and
                         converge the registry back to full coverage.
      phase 2 (a rack):  SIGKILL BOTH rk0 nodes back to back — now the
                         B volumes are 2-missing and the A volumes
                         1-missing (the mirror image), same ordering
                         gate, same convergence gate.

    Since the heterogeneous-fusion change the scheduler no longer splits
    a cohort into per-missing-class batches: 2-before-1 is asserted as a
    per-batch property (block_missing non-increasing inside every
    dispatched batch), and each batch's dispatch→mount wall plus the
    target-reported dispatch_groups are recorded so the heal-time claim
    is backed by per-dispatch occupancy data (an unfused scheduler pays
    one decode dispatch per signature group; the gate here is that every
    batch collapses to dispatch_groups=1).

    The run FAILS on any lost byte, any out-of-order block, residual
    placement violations after healing, or incomplete coverage. Each
    server's /metrics counters (RACK_COUNTERS) and selected backend are
    scraped before it is killed and at the end. Writes the report to
    `out` (default: SOAK_rack.json in the system temp directory)."""
    # scheduler + detection tuning must land BEFORE the master/server
    # processes exist (Node.start copies os.environ; the in-process
    # master reads the registry at construction). No server names a peer
    # unreachable here: a count left over from an earlier phase (two
    # transient misses that no later call to that peer cleared) would
    # confirm ONE victim of the rack at WEEDTPU_REPAIR_DEAD_S while its
    # rack-mate waits for the reaper, and the scheduler would then see
    # one rack failure as two. The fast path has its own scenario
    # (chip_smoke.py's fleet phase).
    config.setdefault_env({
        "WEEDTPU_REPAIR": "on",
        "WEEDTPU_REPAIR_MAX_INFLIGHT": "1",
        "WEEDTPU_REPAIR_SETTLE_S": "6.0",
        "WEEDTPU_REPAIR_SCAN_S": "1.0",
        "WEEDTPU_REPAIR_DEAD_S": "8.0",
        "WEEDTPU_REPAIR_REPORT_FAILURES": str(1 << 30),
    })

    from seaweedfs_tpu_torch.cluster import topology as topo_mod
    from seaweedfs_tpu_torch.cluster.client import MasterClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch import rpc as _rpc
    from seaweedfs_tpu_torch.ec import placement, slo
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.scripts.weedload import CounterScraper

    # the killed rack's holders are parity-only, so no read ever touches
    # them post-kill and the peer-report fast path stays quiet — death
    # detection in this harness rides the reaper, tightened to soak scale
    topo_mod.DEAD_NODE_SECONDS = 20

    rng = random.Random(12)
    racks = ["rk0", "rk0", "rk1", "rk2", "rk3", "rk4", "rk5"]
    report: dict = {
        "when": time.strftime("%FT%TZ", time.gmtime()),
        "mode": "rack",
        "seconds": seconds,
        "racks": {f"n{i}": r for i, r in enumerate(racks)},
        "kills": 0,
        "writes": 0,
        "write_failures": 0,
        "reads": 0,
        "read_failures_transient": 0,
        "lost": [],
    }
    lat_rec = slo.LatencyRecorder()
    scraper = CounterScraper(RACK_COUNTERS)
    with tempfile.TemporaryDirectory() as td:
        master = MasterServer(port=0, reap_interval=3.0)
        master.start()
        nodes: list[Node] = []
        for i, rack in enumerate(racks):
            d = os.path.join(td, f"n{i}")
            os.makedirs(d)
            n = Node(i, d, master.address, rack=rack, device=device)
            n.start()
            nodes.append(n)
        client = None
        stop_traffic = threading.Event()
        traffic_threads: list[threading.Thread] = []
        try:
            client = MasterClient(master.address)
            deadline0 = time.monotonic() + 120
            while time.monotonic() < deadline0:
                if len(master.topology.nodes) == len(nodes):
                    break
                time.sleep(0.5)
            assert len(master.topology.nodes) == len(nodes), "cluster did not form"

            # -- volumes + blobs (single-copy: EC is the only redundancy,
            # so the zero-loss bar is carried entirely by the stripes) ----
            master._rpc_volume_grow({"count": 4, "replication": "000"}, None)
            blobs: dict[str, bytes] = {}
            for _ in range(40):
                size = rng.randrange(4_000, 20_000)
                payload = rng.getrandbits(8 * size).to_bytes(size, "little")
                for _attempt in range(10):
                    try:
                        a = client.assign(replication="000")
                        client.upload(a.fid, payload)
                        blobs[a.fid] = payload
                        report["writes"] += 1
                        break
                    except Exception:  # noqa: BLE001
                        time.sleep(0.5)
                else:
                    report["write_failures"] += 1
            by_vid: dict[int, list[str]] = {}
            for fid in blobs:
                by_vid.setdefault(int(fid.split(",", 1)[0]), []).append(fid)
            vids = sorted(by_vid)[:4]
            assert len(vids) >= 2, f"need >=2 blob-bearing volumes, got {vids}"
            # A-type: rk0 holds ONE shard; B-type: rk0 holds TWO
            plans = {
                "A": {2: [0, 1, 2], 3: [3, 4, 5], 4: [6, 7, 8],
                      5: [9, 10], 6: [11, 12], 0: [13]},
                "B": {2: [0, 1, 2], 3: [3, 4, 5], 4: [6, 7, 8],
                      5: [9, 10], 6: [11], 0: [12], 1: [13]},
            }
            vtypes = {vid: ("A" if i % 2 == 0 else "B") for i, vid in enumerate(vids)}
            report["volumes"] = {str(v): vtypes[v] for v in vids}

            def vs_call(n: Node, method: str, req: dict, timeout=120):
                with _rpc.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                    return c.call(VOLUME_SERVICE, method, req, timeout=timeout)

            def owner_of(vid: int) -> Node:
                for n in nodes:
                    try:
                        st = vs_call(n, "VolumeStatus", {"volume_id": vid}, timeout=5)
                        if st.get("kind") == "normal":
                            return n
                    except Exception:  # noqa: BLE001
                        continue
                raise AssertionError(f"no owner for volume {vid}")

            for vid in vids:
                owner = owner_of(vid)
                plan = plans[vtypes[vid]]
                vs_call(owner, "VolumeMarkReadonly", {"volume_id": vid})
                vs_call(
                    owner, "VolumeEcShardsGenerate",
                    {"volume_id": vid, "large_block_size": 16384,
                     "small_block_size": 4096},
                )
                src = f"127.0.0.1:{owner.grpc}"
                for idx, sids in plan.items():
                    n = nodes[idx]
                    if n is owner:
                        continue
                    vs_call(
                        n, "VolumeEcShardsCopy",
                        {"volume_id": vid, "shard_ids": sids,
                         "source_data_node": src, "copy_ecx_file": True},
                    )
                    vs_call(
                        n, "VolumeEcShardsMount",
                        {"volume_id": vid, "shard_ids": sids},
                    )
                kept = plan.get(owner.i, [])
                moved = [s for s in range(14) if s not in kept]
                if moved:
                    vs_call(
                        owner, "VolumeEcShardsDelete",
                        {"volume_id": vid, "shard_ids": moved},
                    )
                if kept:
                    vs_call(
                        owner, "VolumeEcShardsMount",
                        {"volume_id": vid, "shard_ids": kept},
                    )
                vs_call(owner, "VolumeDelete", {"volume_id": vid})

            def coverage(vid: int) -> list[int]:
                return sorted(master.topology.lookup_ec_shards(vid))

            deadline0 = time.monotonic() + 60
            while time.monotonic() < deadline0:
                if all(coverage(v) == list(range(14)) for v in vids):
                    break
                time.sleep(0.5)
            assert all(coverage(v) == list(range(14)) for v in vids), {
                v: coverage(v) for v in vids
            }

            # -- open-loop read traffic (Poisson arrivals, latency from
            # SCHEDULED time so repair-storm stalls surface as tail) ------
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=16)
            fids = list(blobs)
            offered = [0]
            failed = [0]

            def one_read(scheduled: float, fid: str) -> None:
                try:
                    got = client.read(fid)
                    lat_rec.observe("rack", "read", time.monotonic() - scheduled)
                    if got != blobs[fid]:
                        report["lost"].append({"fid": fid, "why": "BYTES DIFFER"})
                except Exception:  # noqa: BLE001 — holders mid-kill
                    failed[0] += 1
                report["reads"] += 1

            def generator() -> None:
                rps = 20.0
                nxt = time.monotonic()
                lrng = random.Random(99)
                while not stop_traffic.is_set():
                    nxt += lrng.expovariate(rps)
                    delay = nxt - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                    offered[0] += 1
                    pool.submit(one_read, nxt, lrng.choice(fids))

            t = threading.Thread(target=generator, daemon=True)
            t.start()
            traffic_threads.append(t)

            # -- phases ---------------------------------------------------
            def repair_events_after(seq0: int) -> list[dict]:
                return [
                    e for e in master.repair.status()["events"]
                    if e["seq"] > seq0
                ]

            def priority_ok(batches: list[dict]) -> bool:
                """2-before-1 is now an IN-BATCH property: the fused batch
                carries the whole cohort, so the acceptance ordering gate
                is that every dispatched batch lists its >=2-missing
                volumes before its 1-missing ones (block_missing
                non-increasing), and the phase exercised BOTH classes."""
                missing = [m for b in batches for m in b["block_missing"]]
                if not any(m >= 2 for m in missing) or 1 not in missing:
                    return False  # the scenario must produce BOTH classes
                return all(
                    all(a >= b2 for a, b2 in
                        zip(b["block_missing"], b["block_missing"][1:]))
                    for b in batches
                )

            def run_phase(name: str, victims: list[Node], budget: float) -> dict:
                seq0 = max(
                    (e["seq"] for e in master.repair.status()["events"]),
                    default=0,
                )
                nb0 = len(master.repair.status()["batches"])
                for v in victims:
                    scraper.scrape(v.http, f"n{v.i}")  # its counters die with it
                    v.kill(hard=True)
                    report["kills"] += 1
                t0 = time.monotonic()
                deadline = t0 + budget
                # the registry keeps the dead holders until detection
                # lands: coverage must first DROP (the loss is real and
                # visible), and every victim must be out of the topology,
                # before "complete again" means anything
                saw_loss = False

                def registered(v: Node) -> bool:
                    with master.topology._lock:
                        return any(n.grpc_port == v.grpc
                                   for n in master.topology.nodes.values())

                while time.monotonic() < deadline:
                    complete = all(coverage(v) == list(range(14)) for v in vids)
                    if not complete:
                        saw_loss = True
                    elif saw_loss and not any(registered(v) for v in victims):
                        st = master.repair.status()
                        if st["queue_depth"] == 0 and st["inflight"] == 0:
                            break
                    time.sleep(1.0)
                events = repair_events_after(seq0)
                batches = [
                    {k: b[k] for k in
                     ("target", "volumes", "signature_groups",
                      "dispatch_groups", "block_order", "block_missing",
                      "wall_s")}
                    for b in master.repair.status()["batches"][nb0:]
                ]
                phase = {
                    "victims": [v.i for v in victims],
                    "heal_seconds": round(time.monotonic() - t0, 1),
                    "coverage_complete": all(
                        coverage(v) == list(range(14)) for v in vids
                    ),
                    "victims_expelled": not any(registered(v) for v in victims),
                    "priority_ok": priority_ok(batches),
                    # per-dispatch occupancy: wall_s is the scheduler's
                    # dispatch->mount wall (the RPC mounts rebuilt shards
                    # before responding), dispatch_groups the fused decode
                    # count the target reported
                    "batches": batches,
                    "signature_groups_total": sum(
                        b["signature_groups"] for b in batches
                    ),
                    "dispatch_groups_total": sum(
                        b["dispatch_groups"] for b in batches
                    ),
                    "events": [
                        {k: e[k] for k in
                         ("seq", "volume_id", "missing", "state", "target")}
                        for e in events
                    ],
                }
                return phase

            report["phase1_node"] = run_phase("node", [nodes[6]], 150.0)
            nodes[6].start()  # stale shards re-register as duplicates
            time.sleep(8.0)
            report["phase2_rack"] = run_phase("rack", [nodes[0], nodes[1]], 200.0)

            # -- post-heal placement audit --------------------------------
            with master.topology._lock:
                domains = {
                    u: (n.data_center, n.rack)
                    for u, n in master.topology.nodes.items()
                }
            violations: list[str] = []
            for vid in vids:
                holders = {
                    sid: [n.url for n in hs]
                    for sid, hs in master.topology.lookup_ec_shards(vid).items()
                }
                for dom, sids in placement.stripe_violations(holders, domains, 4):
                    violations.append(
                        f"vid={vid} rack={dom[1]} holds {len(sids)} shards {sids}"
                    )
            report["placement_violations"] = violations

            # -- wind down: everyone back, every byte read ----------------
            stop_traffic.set()
            for t in traffic_threads:  # no submit may follow the shutdown
                t.join()
            pool.shutdown(wait=True, cancel_futures=False)
            for n in (nodes[0], nodes[1]):
                n.start()
            time.sleep(8.0)
            for fid, want in list(blobs.items()):
                got = None
                for _attempt in range(12):
                    try:
                        got = client.read(fid)
                        break
                    except Exception:  # noqa: BLE001
                        report["read_failures_transient"] += 1
                        time.sleep(1.0)
                report["reads"] += 1
                if got is None:
                    report["lost"].append({"fid": fid, "why": "unreadable at end"})
                elif got != want:
                    report["lost"].append({"fid": fid, "why": "BYTES DIFFER"})
            for n in nodes:
                scraper.scrape(n.http, f"n{n.i}")
            report["server_counters"] = scraper.by_server
            report["server_backends"] = scraper.backends
            report["traffic"] = {
                "offered": offered[0],
                "failed_transient": failed[0],
                "rps": 20.0,
                "latency": lat_rec.phases().get("rack", {}),
            }
            from seaweedfs_tpu_torch import stats as _stats

            report["repair_counters"] = {
                "dispatch_by_missing": {
                    # per-class dispatch counts straight off the master's
                    # in-process registry
                    k[0]: c.value
                    for k, c in _stats.RepairDispatch._children.items()
                },
                "backoffs": _stats.RepairBackoff.value,
            }
            # fusion accounting: an unfused scheduler pays one decode
            # dispatch per signature group (dispatch_groups ==
            # signature_groups); collapsed means every batch here reported
            # dispatch_groups == 1 while carrying >1 signature overall
            all_batches = [
                b
                for ph in ("phase1_node", "phase2_rack")
                for b in report.get(ph, {}).get("batches", [])
            ]
            report["fusion"] = {
                "fused_volumes_total":
                    master.repair.status()["fused_volumes_total"],
                "signature_groups_total": sum(
                    b["signature_groups"] for b in all_batches
                ),
                "dispatch_groups_total": sum(
                    b["dispatch_groups"] for b in all_batches
                ),
                "collapsed": bool(all_batches) and all(
                    b["dispatch_groups"] == 1 for b in all_batches
                ) and sum(b["signature_groups"] for b in all_batches) > sum(
                    b["dispatch_groups"] for b in all_batches
                ),
            }
        finally:
            stop_traffic.set()
            if client is not None:
                client.close()
            for n in nodes:
                try:
                    n.kill(hard=False)
                except Exception:  # noqa: BLE001
                    pass
            master.stop()

    report["files"] = len(blobs)
    report["ok"] = (
        not report["lost"]
        and report.get("phase1_node", {}).get("coverage_complete", False)
        and report.get("phase1_node", {}).get("priority_ok", False)
        and report.get("phase2_rack", {}).get("coverage_complete", False)
        and report.get("phase2_rack", {}).get("priority_ok", False)
        and report.get("fusion", {}).get("collapsed", False)
        and not report.get("placement_violations")
    )
    _write_report(out or _default_out("rack"), report)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=int, default=300)
    p.add_argument("--rack", action="store_true",
                   help="the fleet-repair acceptance scenario (run_rack_mode)")
    p.add_argument("--wedge", action="store_true", help="SIGSTOP wedges instead of kills")
    p.add_argument("--latency", action="store_true",
                   help="fold per-class p50/p99 of the verification reads into the report")
    p.add_argument("--inline", action="store_true", help="the inline-ingest scenario")
    p.add_argument("--corrupt", action="store_true", help="silent-corruption injection")
    p.add_argument("--convert", action="store_true", help="the geometry-conversion scenario")
    p.add_argument("--device", default="cuda",
                   help="torch device of every volume server (default cuda; cpu runs "
                        "the plain version)")
    p.add_argument("--out", default=None,
                   help="report path (default: SOAK_<mode>.json in the system temp directory)")
    return p.parse_args(argv)


def _default_out(mode: str) -> str:
    return os.path.join(tempfile.gettempdir(), f"SOAK_{mode}.json")


def _write_report(path: str, report: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    prepare_device(args.device)
    seconds = args.seconds
    if args.rack:
        return run_rack_mode(seconds, device=args.device, out=args.out)
    wedge_mode = args.wedge
    latency_mode = args.latency
    inline_mode = args.inline
    corrupt_mode = args.corrupt
    convert_mode = args.convert
    device = args.device
    rng = random.Random(7)
    if corrupt_mode:
        # silent-corruption injection (bit-flips, truncations, deletions of
        # live EC shard files) with the background scrubber running HOT:
        # short cycle, no rate cap, prompt repair retries; detection
        # latency is scan-bound. Must land before the servers start.
        config.setdefault_env({
            "WEEDTPU_SCRUB": "on",
            "WEEDTPU_SCRUB_INTERVAL": "0.5",
            "WEEDTPU_SCRUB_RATE_MB": "0",
            "WEEDTPU_SCRUB_REPAIR_BACKOFF": "1.0",
        })
    if inline_mode:
        # must land before the server subprocesses start (Node.start copies
        # os.environ); bench-scale rows so soak-sized volumes complete them
        config.setdefault_env({
            "WEEDTPU_INLINE_EC": "on",
            "WEEDTPU_INLINE_EC_LARGE_BLOCK": "8192",
            "WEEDTPU_INLINE_EC_SMALL_BLOCK": "2048",
        })
    modeled_delay_ms = 0.0
    if not wedge_mode:
        # stretch rebuild windows so the trace scenario's mid-rebuild kill
        # lands mid-stream, not after a loopback-instant rebuild (wedge
        # mode runs without it: the ladder under test there is
        # latency-sensitive)
        config.setdefault_env({"WEEDTPU_BENCH_RPC_DELAY_MS": "25"})
        modeled_delay_ms = float(config.env("WEEDTPU_BENCH_RPC_DELAY_MS"))

    from seaweedfs_tpu_torch.cluster.client import MasterClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch import rpc as _rpc
    from seaweedfs_tpu_torch.ec import slo
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE

    lat_rec = slo.LatencyRecorder() if latency_mode else None

    report: dict = {
        "when": time.strftime("%FT%TZ", time.gmtime()),
        "seconds": seconds,
        "mode": "wedge" if wedge_mode else "kill",
        "inline_ec": inline_mode,
        "corrupt": corrupt_mode,
        "convert_mode": convert_mode,
        # kill-mode nodes run with this per-RPC server-side sleep on shard/
        # slab reads (the trace scenario needs rebuilds to span wall time);
        # latency quantiles below therefore include it on any degraded read
        # that fetched remote shards — do not compare them against wedge-
        # mode (delay-free) soaks
        "modeled_rpc_delay_ms": modeled_delay_ms,
        "kills": 0,
        "wedges": 0,
        "writes": 0,
        "write_failures": 0,
        "reads": 0,
        "read_failures_transient": 0,
        "lost": [],
    }
    with tempfile.TemporaryDirectory() as td:
        master = MasterServer(port=0, reap_interval=5)
        master.start()
        nodes = []
        for i in range(3):
            d = os.path.join(td, f"n{i}")
            os.makedirs(d)
            n = Node(i, d, master.address, device=device)
            n.start()
            nodes.append(n)
        client = None
        try:
            client = MasterClient(master.address)
            deadline0 = time.monotonic() + 60
            while time.monotonic() < deadline0:
                if len(master.topology.nodes) == 3:
                    break
                time.sleep(0.5)
            assert len(master.topology.nodes) == 3, "cluster did not form"

            blobs: dict[str, bytes] = {}  # fid -> expected bytes

            def write_one() -> None:
                size = rng.randrange(200, 50_000)
                payload = rng.getrandbits(8 * size).to_bytes(size, "little")
                for attempt in range(10):
                    try:
                        a = client.assign(replication="001")
                        client.upload(a.fid, payload)
                        blobs[a.fid] = payload
                        report["writes"] += 1
                        return
                    except Exception:
                        time.sleep(0.5)
                # silent drops would make ok:true vacuous under a collapsed
                # cluster — every exhausted retry is on the record
                report["write_failures"] += 1

            def read_all(final: bool) -> None:
                for fid, want in list(blobs.items()):
                    got = None
                    for attempt in range(12 if final else 3):
                        try:
                            t0 = time.monotonic()
                            got = client.read(fid)
                            if lat_rec is not None:
                                klass = (
                                    "ec"
                                    if int(fid.split(",", 1)[0])
                                    == report.get("ec_encoded_vid")
                                    else "replicated"
                                )
                                lat_rec.observe(
                                    "soak", klass, time.monotonic() - t0
                                )
                            break
                        except Exception:
                            report["read_failures_transient"] += 1
                            time.sleep(1.0 if final else 0.3)
                    report["reads"] += 1
                    if got is not None and got != want:
                        report["lost"].append({"fid": fid, "why": "BYTES DIFFER"})
                        blobs.pop(fid, None)  # record a corruption ONCE
                    elif final and got is None:
                        report["lost"].append({"fid": fid, "why": "unreadable at end"})

            for _ in range(30):
                write_one()

            # EC-encode the first volume mid-soak so degraded reads join in
            def try_ec_encode() -> None:
                vids = sorted({int(f.split(",")[0]) for f in blobs})
                if not vids:
                    return
                vid = vids[0]
                for n in nodes:
                    if not n.alive:
                        continue
                    try:
                        with _rpc.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                            c.call(VOLUME_SERVICE, "VolumeMarkReadonly", {"volume_id": vid})
                            c.call(
                                VOLUME_SERVICE, "VolumeEcShardsGenerate",
                                {"volume_id": vid}, timeout=120,
                            )
                            # mount FIRST, delete LAST (the shell's ec.encode
                            # order): the data must be served from somewhere at
                            # every instant
                            c.call(VOLUME_SERVICE, "VolumeEcShardsMount", {"volume_id": vid})
                            c.call(VOLUME_SERVICE, "VolumeDelete", {"volume_id": vid})
                        report["ec_encoded_vid"] = vid
                        return
                    except Exception:  # noqa: BLE001 — not the owner: next node
                        continue

            try_ec_encode()

            def shard_mounted_somewhere(vid: int, shard: int) -> bool:
                """Does ANY live node currently serve `shard` of `vid`? The
                fleet-repair scheduler (WEEDTPU_REPAIR=on in the hosting
                environment) races these scenarios: a shard the scenario
                deliberately dropped may be mass-rebuilt and mounted by
                the scheduler before the scenario's own rebuild runs —
                that is repair SUCCEEDING, not the scenario failing, and
                the outcome records it as such."""
                for n in nodes:
                    if not n.alive:
                        continue
                    try:
                        with _rpc.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                            st = c.call(
                                VOLUME_SERVICE, "VolumeStatus",
                                {"volume_id": vid}, timeout=5,
                            )
                        if shard in st.get("shard_ids", ()):
                            return True
                    except Exception:  # noqa: BLE001 — no view of vid here
                        continue
                return False

            def try_remote_rebuild() -> None:
                """Remote-rebuild scenario: drop one EC shard ON the holder,
                then ask a DIFFERENT node to regenerate it via the
                distributed (remote:true) rebuild — survivors stream over
                VolumeEcShardSlabRead while peers are being killed around
                it. Success = the rebuilt shard mounts on the target and
                reads keep verifying. When the fleet-repair scheduler is
                live it may win the race instead; `repaired_by: scheduler`
                records that equally-successful outcome."""
                vid = report.get("ec_encoded_vid")
                if vid is None:
                    return
                holder, target = None, None
                for n in nodes:
                    if not n.alive:
                        continue
                    try:
                        with _rpc.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                            st = c.call(VOLUME_SERVICE, "VolumeStatus", {"volume_id": vid})
                        if st.get("kind") == "ec" and st.get("shard_ids"):
                            holder = n
                        else:
                            target = target or n
                    except Exception:  # noqa: BLE001 — node has no view of vid
                        target = target or n
                if holder is None or target is None:
                    return
                try:
                    # lose one shard on the holder (unmount+delete just it)
                    with _rpc.RpcClient(f"127.0.0.1:{holder.grpc}") as c:
                        c.call(
                            VOLUME_SERVICE, "VolumeEcShardsDelete",
                            {"volume_id": vid, "shard_ids": [13]},
                        )
                    with _rpc.RpcClient(f"127.0.0.1:{target.grpc}") as c:
                        resp = c.call(
                            VOLUME_SERVICE, "VolumeEcShardsRebuild",
                            {"volume_id": vid, "remote": True}, timeout=300,
                        )
                        rebuilt = resp.get("rebuilt_shard_ids", [])
                        if rebuilt:
                            c.call(
                                VOLUME_SERVICE, "VolumeEcShardsMount",
                                {"volume_id": vid, "shard_ids": rebuilt},
                            )
                    if not rebuilt and shard_mounted_somewhere(vid, 13):
                        # the scheduler rebuilt + mounted 13 before the
                        # scenario's target could: repair worked, just not
                        # by the hand this scenario was watching
                        report["remote_rebuild"] = {
                            "vid": vid, "rebuilt": [13],
                            "repaired_by": "scheduler",
                        }
                        return
                    report["remote_rebuild"] = {
                        "vid": vid,
                        "rebuilt": rebuilt,
                        "target": target.i,
                        "failed_over": resp.get("failed_over", []),
                    }
                except Exception as e:  # noqa: BLE001 — recorded, not fatal:
                    # the kill loop may have taken the holder down; reads
                    # below still verify zero loss either way
                    if shard_mounted_somewhere(vid, 13):
                        report["remote_rebuild"] = {
                            "vid": vid, "rebuilt": [13],
                            "repaired_by": "scheduler",
                        }
                    else:
                        report["remote_rebuild"] = {"vid": vid, "error": str(e)[:200]}

            def try_trace_rebuild() -> bool:
                """Trace-repair chaos scenario: replicate the EC volume's
                shards onto a SECOND holder, drop one shard on every
                replica, and rebuild it with trace_mode=on on a third
                node while the primary holder is SIGKILLed mid-rebuild.
                The projection group dies with the holder; the rebuild
                must fall back to full-slab sources inside the same call
                (slabs fail over to the surviving replica) and the final
                read pass must still verify every byte."""
                import threading as _threading

                vid = report.get("ec_encoded_vid")
                if vid is None or wedge_mode:
                    return True  # nothing to do in this mode: stop retrying
                holder, shard_ids = None, []
                for n in nodes:
                    if not n.alive:
                        continue
                    try:
                        with _rpc.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                            st = c.call(VOLUME_SERVICE, "VolumeStatus", {"volume_id": vid})
                        if st.get("kind") == "ec" and len(st.get("shard_ids", [])) > len(shard_ids):
                            holder, shard_ids = n, list(st["shard_ids"])
                    except Exception:  # noqa: BLE001 — node has no view of vid
                        continue
                others = [n for n in nodes if n is not holder and n.alive]
                if holder is None or len(others) < 2 or len(shard_ids) < 11:
                    return False  # a kill raced the setup: retry next round

                def node_answers(n, timeout=30.0) -> bool:
                    """A restarted node's process is alive well before its
                    RPC surface is (python + torch startup, a CUDA context): wait until it
                    actually answers, or the scenario would blame a boot
                    race instead of testing the mid-rebuild kill."""
                    deadline = time.monotonic() + timeout
                    while time.monotonic() < deadline:
                        try:
                            with _rpc.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                                c.call(
                                    VOLUME_SERVICE, "VolumeStatus",
                                    {"volume_id": vid}, timeout=5,
                                )
                            return True
                        except Exception as e:  # noqa: BLE001
                            if "not found" in str(e).lower():
                                return True  # answered: just has no view of vid
                            time.sleep(0.5)
                    return False

                if not all(node_answers(n) for n in others):
                    return False
                replica, target = others[0], others[1]
                drop = next(s for s in sorted(shard_ids, reverse=True) if s != 13)
                outcome: dict = {"vid": vid, "holder_killed": holder.i, "dropped": drop}
                try:
                    with _rpc.RpcClient(f"127.0.0.1:{replica.grpc}") as c:
                        c.call(
                            VOLUME_SERVICE, "VolumeEcShardsCopy",
                            {
                                "volume_id": vid,
                                "shard_ids": shard_ids,
                                "source_data_node": f"127.0.0.1:{holder.grpc}",
                            },
                            timeout=120,
                        )
                        c.call(VOLUME_SERVICE, "VolumeEcShardsMount", {"volume_id": vid})
                    for n in (holder, replica):
                        with _rpc.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                            c.call(
                                VOLUME_SERVICE, "VolumeEcShardsDelete",
                                {"volume_id": vid, "shard_ids": [drop]},
                            )

                    def run_rebuild() -> None:
                        try:
                            with _rpc.RpcClient(f"127.0.0.1:{target.grpc}") as c:
                                resp = c.call(
                                    VOLUME_SERVICE, "VolumeEcShardsRebuild",
                                    {
                                        "volume_id": vid,
                                        "remote": True,
                                        "trace_mode": "on",
                                        # small windows: many delay-modeled
                                        # round-trips for the kill to land in
                                        "buffer_size": 16384,
                                        "max_batch_bytes": 163840,
                                    },
                                    timeout=300,
                                )
                                outcome.update(
                                    mode=resp.get("mode"),
                                    trace_fallback=resp.get("trace_fallback"),
                                    wire_bytes=resp.get("wire_bytes"),
                                    rebuilt=resp.get("rebuilt_shard_ids"),
                                    failed_over=resp.get("failed_over"),
                                )
                                if resp.get("rebuilt_shard_ids"):
                                    c.call(
                                        VOLUME_SERVICE, "VolumeEcShardsMount",
                                        {"volume_id": vid,
                                         "shard_ids": resp["rebuilt_shard_ids"]},
                                    )
                        except Exception as e:  # noqa: BLE001 — recorded below
                            outcome["error"] = str(e)[:200]

                    # kill the node the trace planner will group on: both
                    # replica holders fully cover the chosen survivors, and
                    # the planner breaks that tie by LARGEST grpc address —
                    # so killing that node guarantees the kill hits the
                    # holder actually serving the projection stream
                    kill_victim = max(
                        (holder, replica), key=lambda n: f"127.0.0.1:{n.grpc}"
                    )
                    outcome["holder_killed"] = kill_victim.i
                    th = _threading.Thread(target=run_rebuild, daemon=True)
                    th.start()
                    time.sleep(0.2)  # let the trace stream get inflight
                    kill_victim.kill(hard=True)
                    report["kills"] += 1
                    th.join(timeout=320)
                except Exception as e:  # noqa: BLE001 — scenario setup raced a kill
                    outcome["setup_error"] = str(e)[:200]
                finally:
                    for n in (holder, replica):
                        if not n.alive:
                            n.start()
                            time.sleep(2.0)
                if not outcome.get("rebuilt") and shard_mounted_somewhere(vid, drop):
                    # the fleet scheduler repaired the dropped shard while
                    # this scenario's rebuild was losing its holder — the
                    # shard is served again, which is the success condition
                    outcome["repaired_by"] = "scheduler"
                    outcome["rebuilt"] = [drop]
                    outcome.pop("error", None)
                report["trace_rebuild"] = outcome
                return True

            def try_inline_seal() -> bool:
                """Inline-ingest chaos scenario (--inline, kill mode): pick
                a volume still taking writes, SIGKILL its owner while the
                encode-on-write encoder has stripe partials + journal on
                disk, restart it, land more writes (the encoder must
                RESUME from the journaled sidecar), then seal with
                VolumeEcShardsGenerate{inline:true}. resume-or-fallback
                must yield a mountable shard set; the final read pass
                proves zero lost bytes either way."""
                if not inline_mode or wedge_mode:
                    return True  # nothing to do in this mode: stop retrying
                ec_vid = report.get("ec_encoded_vid")
                vids = sorted(
                    {int(f.split(",")[0]) for f in blobs}
                    - {ec_vid if ec_vid is not None else -1}
                )
                outcome: dict = {}
                for vid in vids:
                    owner = None
                    for n in nodes:
                        if not n.alive:
                            continue
                        try:
                            with _rpc.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                                st = c.call(
                                    VOLUME_SERVICE, "VolumeStatus",
                                    {"volume_id": vid}, timeout=5,
                                )
                            if st.get("kind") == "normal" and not st.get("read_only"):
                                owner = n
                                break
                        except Exception:  # noqa: BLE001 — not the owner
                            continue
                    if owner is None:
                        continue
                    outcome = {"vid": vid, "owner_killed": owner.i}
                    try:
                        # a couple of writes so the encoder is live, then
                        # the kill lands with partials mid-flight
                        for _ in range(3):
                            write_one()
                        owner.kill(hard=True)
                        report["kills"] += 1
                        owner.start()
                        time.sleep(2.5)
                        for _ in range(3):
                            write_one()  # resume path: the encoder reloads its journal
                        with _rpc.RpcClient(f"127.0.0.1:{owner.grpc}") as c:
                            c.call(
                                VOLUME_SERVICE, "VolumeMarkReadonly",
                                {"volume_id": vid}, timeout=30,
                            )
                            resp = c.call(
                                VOLUME_SERVICE, "VolumeEcShardsGenerate",
                                {"volume_id": vid, "inline": True}, timeout=120,
                            )
                            outcome.update(
                                mode=resp.get("mode"),
                                inline_rows=resp.get("inline_rows"),
                            )
                            c.call(
                                VOLUME_SERVICE, "VolumeEcShardsMount",
                                {"volume_id": vid}, timeout=30,
                            )
                            c.call(
                                VOLUME_SERVICE, "VolumeDelete",
                                {"volume_id": vid}, timeout=30,
                            )
                        outcome["sealed"] = True
                    except Exception as e:  # noqa: BLE001 — recorded; reads
                        # below still hold the zero-loss bar either way
                        outcome["error"] = str(e)[:200]
                    report["inline_seal"] = outcome
                    return True
                return False  # no live unsealed volume this round: retry

            # -- corruption injection (--corrupt): one bit-flip/truncate/
            # delete per chaos round against a live holder's EC shard
            # file; the servers' scrubber + verify-on-read must detect,
            # quarantine, and auto-repair each one while the kill loop
            # keeps running. Healing is verified at the END (bytes match
            # the .eci record again) so injections and kills interleave
            # freely mid-run.
            corruption = {"injected": [], "all_healed": True}
            corrupt_kind = [0]

            def _eci_crcs(vid: int):
                for n in nodes:
                    try:
                        with open(os.path.join(n.dir, f"{vid}.eci")) as f:
                            rec = json.load(f).get("shard_crc32")
                        if rec:
                            return rec
                    except (OSError, ValueError):
                        continue
                return None

            def try_corrupt_one() -> None:
                vid = report.get("ec_encoded_vid")
                if not corrupt_mode or vid is None:
                    return
                crcs = _eci_crcs(vid)
                if crcs is None:
                    return
                # data shards 1..9 only: 0 would also be hit by legitimate
                # scenario deletes' neighbors, and the trace scenario
                # deliberately drops the largest shard ids — injections
                # must stay distinguishable from scripted shard loss
                cands = [
                    (n, s)
                    for n in nodes
                    for s in range(1, 10)
                    if n.alive and not n.wedged
                    and os.path.exists(ec_shard_path(n.dir, vid, s))
                ]
                if not cands:
                    return
                node, s = rng.choice(cands)
                kind = ("bitflip", "truncate", "delete")[corrupt_kind[0] % 3]
                corrupt_kind[0] += 1
                if not inject_shard_fault(ec_shard_path(node.dir, vid, s), kind, rng):
                    return  # raced a repair/kill: next round injects again
                corruption["injected"].append(
                    {"node": node.i, "vid": vid, "shard": s, "kind": kind}
                )

            def try_convert() -> bool:
                """Geometry-conversion chaos scenario (--convert, kill
                mode): SIGKILL the EC volume's holder mid-`ec.convert`
                (staged .cv.* target + .ecc journal on disk), restart it,
                prove the OLD geometry still serves every blob (staged
                state is invisible to the read path), then re-issue the
                convert — it must RESUME from the journal and cut over to
                merge_20_4, after which stale old-geometry shards on
                other nodes are dropped (the shell's post-cutover
                discipline: a stale shard answering a new-geometry locate
                would serve wrong bytes). The final read pass holds the
                zero-loss bar through the 24-shard layout."""
                if not convert_mode or wedge_mode:
                    return True  # nothing to do in this mode: stop retrying
                vid = report.get("ec_encoded_vid")
                if vid is None:
                    return True
                if not all(n.alive for n in nodes):
                    return False  # a dead node would resurrect stale
                    # old-geometry shards after our cut-over: retry when
                    # the loop bottom has everyone back up
                holder, most = None, 0
                spread: dict[int, list[int]] = {}
                for n in nodes:
                    try:
                        with _rpc.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                            st = c.call(
                                VOLUME_SERVICE, "VolumeStatus",
                                {"volume_id": vid}, timeout=5,
                            )
                        sids = list(st.get("shard_ids") or [])
                        if st.get("kind") == "ec" and sids:
                            spread[n.i] = sids
                            if len(sids) > most:
                                holder, most = n, len(sids)
                    except Exception:  # noqa: BLE001 — no view of vid
                        continue
                if holder is None or most < 10:
                    return False  # spread too thin to convert: retry
                outcome: dict = {
                    "vid": vid, "owner_killed": holder.i, "src_shards": most,
                }

                def _stage() -> None:
                    try:
                        with _rpc.RpcClient(f"127.0.0.1:{holder.grpc}") as c:
                            c.call(
                                VOLUME_SERVICE, "VolumeEcShardsConvert",
                                {
                                    "volume_id": vid,
                                    "target_family": "merge_20_4",
                                    "cutover": False,
                                    # tiny batches/watermarks: many .ecc
                                    # records, so the kill lands BETWEEN
                                    # journaled batches and the resume
                                    # has real progress to pick up
                                    "max_batch_bytes": 8192,
                                    "journal_bytes": 8192,
                                },
                                timeout=120,
                            )
                    except Exception:  # noqa: BLE001 — expected: the
                        pass  # owner dies mid-call

                try:
                    th = threading.Thread(target=_stage, daemon=True)
                    th.start()
                    # kill when the first fsync'd watermark hits the .ecc
                    # journal — mid-conversion by construction, not a
                    # sleep race: the resume then has real journaled
                    # progress to pick up (and if the tiny volume finishes
                    # staging first, the re-issued call still resumes from
                    # the completed journal rather than re-encoding)
                    jpath = os.path.join(holder.dir, f"{vid}.ecc")
                    deadline = time.monotonic() + 15
                    while time.monotonic() < deadline and th.is_alive():
                        try:
                            with open(jpath, "rb") as f:
                                if b'"watermark"' in f.read():
                                    break
                        except OSError:
                            pass
                        time.sleep(0.005)
                    holder.kill(hard=True)
                    report["kills"] += 1
                    th.join(10)
                    holder.start()
                    # the restarted process is alive well before its RPC
                    # surface is (python + torch startup, a CUDA context): wait until it
                    # answers, or the resume call blames a boot race
                    deadline = time.monotonic() + 60
                    while time.monotonic() < deadline:
                        try:
                            with _rpc.RpcClient(f"127.0.0.1:{holder.grpc}") as c:
                                c.call(
                                    VOLUME_SERVICE, "VolumeStatus",
                                    {"volume_id": vid}, timeout=5,
                                )
                            break
                        except Exception:  # noqa: BLE001 — still booting
                            time.sleep(0.5)
                    # old geometry still serving after the crash
                    stale = 0
                    for fid, want in list(blobs.items()):
                        if int(fid.split(",", 1)[0]) != vid:
                            continue
                        got = None
                        for _ in range(6):
                            try:
                                got = client.read(fid)
                                break
                            except Exception:  # noqa: BLE001 — holder
                                time.sleep(0.5)  # still rejoining
                        if got != want:
                            stale += 1
                    outcome["old_geometry_unreadable"] = stale
                    with _rpc.RpcClient(f"127.0.0.1:{holder.grpc}") as c:
                        resp = c.call(
                            VOLUME_SERVICE, "VolumeEcShardsConvert",
                            {
                                "volume_id": vid,
                                "target_family": "merge_20_4",
                                "cutover": True,
                            },
                            timeout=300,
                        )
                    for n in nodes:
                        if n.i == holder.i or not spread.get(n.i):
                            continue
                        with _rpc.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                            c.call(
                                VOLUME_SERVICE, "VolumeEcShardsDelete",
                                {"volume_id": vid, "shard_ids": spread[n.i]},
                                timeout=30,
                            )
                    outcome.update(
                        mode=resp.get("mode"),
                        target_shards=len(resp.get("shard_ids") or []),
                        reconstructed_bytes=int(
                            resp.get("reconstructed_bytes") or 0
                        ),
                    )
                    outcome["completed"] = (
                        stale == 0
                        and resp.get("mode") in ("resumed", "converted", "cutover")
                        and len(resp.get("shard_ids") or []) == 24
                    )
                except Exception as e:  # noqa: BLE001 — recorded; reads
                    # below still hold the zero-loss bar either way
                    outcome["error"] = str(e)[:200]
                    outcome["completed"] = False
                report["convert"] = outcome
                return True

            # the inline-ingest scenario runs BEFORE the kill loop (it
            # brings its own SIGKILL): every node is alive, so seeding a
            # fresh non-EC volume with writes is reliable — mid-loop the
            # replication fan-out fails too often to guarantee a candidate
            for _ in range(5):
                if try_inline_seal():
                    break
                for _ in range(3):
                    write_one()

            t_end = time.monotonic() + seconds
            rebuild_tried = False
            trace_tried = False
            convert_tried = False
            while time.monotonic() < t_end:
                if not trace_tried and rebuild_tried:
                    # run at loop TOP: every node restarted at the bottom
                    # of the previous round, so the scenario has the two
                    # live non-holder nodes it needs (the scenario brings
                    # its own mid-rebuild kill)
                    trace_tried = try_trace_rebuild()
                elif convert_mode and not convert_tried and trace_tried:
                    # after trace: the conversion may find a shard missing
                    # on its holder (trace dropped one everywhere) — the
                    # degraded-source path reconstructs it inline, which
                    # is exactly the production migration posture
                    convert_tried = try_convert()
                victim = rng.choice(nodes)
                if wedge_mode:
                    # wedge rather than kill: the victim stays alive but
                    # answers nothing for a few seconds — reads and
                    # writes must route around it (per-holder cap +
                    # suspicion on the EC ladder, replica failover on
                    # the plain path), never stall on it
                    if victim.alive and sum(
                        n.alive and not n.wedged for n in nodes
                    ) > 1:
                        victim.wedge()
                        report["wedges"] += 1
                elif victim.alive and sum(n.alive for n in nodes) > 1:
                    victim.kill(hard=rng.random() < 0.5)
                    report["kills"] += 1
                for _ in range(rng.randrange(2, 6)):
                    write_one()
                try_corrupt_one()
                read_all(final=False)
                if not rebuild_tried and report.get("ec_encoded_vid") is not None:
                    rebuild_tried = True
                    try_remote_rebuild()
                if wedge_mode and victim.wedged:
                    # the wedge must OUTLAST the volume server's per-holder
                    # transport timeout (EC_SHARD_READ_TIMEOUT = 10 s) or
                    # the degraded-read suspicion path under test never
                    # fires — reads would just ride out a short stall
                    time.sleep(rng.uniform(11.0, 14.0))
                else:
                    time.sleep(rng.uniform(1.0, 3.0))
                if wedge_mode:
                    victim.unwedge()
                elif not victim.alive:
                    victim.start()
                    time.sleep(2.0)

            # every node back up (and un-wedged); the final pass demands
            # every byte
            for n in nodes:
                n.unwedge()
                if not n.alive:
                    n.start()
            time.sleep(8.0)
            read_all(final=True)

            if corrupt_mode:
                # every injection must have been detected and auto-repaired:
                # the shard file carries .eci-matching bytes again wherever
                # a corruption landed (repairs interrupted by the last kill
                # round get a bounded grace window to finish). Zero
                # injections = vacuously healed (nothing was at stake),
                # matching the weedload semantics.
                if corruption["injected"]:
                    vid = report["ec_encoded_vid"]
                    crcs = _eci_crcs(vid)
                    deadline = time.monotonic() + 120
                    while time.monotonic() < deadline:
                        if all(
                            ec_shard_clean(nodes[e["node"]].dir, vid, e["shard"], crcs)
                            for e in corruption["injected"]
                        ):
                            break
                        time.sleep(1.0)
                    for e in corruption["injected"]:
                        e["healed"] = ec_shard_clean(
                            nodes[e["node"]].dir, vid, e["shard"], crcs
                        )
                corruption["count"] = len(corruption["injected"])
                corruption["all_healed"] = all(
                    e["healed"] for e in corruption["injected"]
                )
                report["corruption"] = corruption

        finally:
            # teardown must run on ANY exit path (a failed form-up assert
            # must not leak three subprocesses writing into the tempdir).
            # SIGCONT first: a SIGSTOPped child cannot process SIGTERM and
            # would eat the 10 s escalation wait.
            if client is not None:
                client.close()
            for n in nodes:
                try:
                    n.unwedge()
                    n.kill(hard=False)
                except Exception:
                    pass
            master.stop()

    report["files"] = len(blobs)
    if lat_rec is not None:
        # closed-loop quantiles per read class: SLO evidence riding along
        # with every soak run (weedload's open-loop artifact is the
        # user-facing number; this one is the floor under retries)
        report["latency"] = lat_rec.phases().get("soak", {})
    report["ok"] = (
        not report["lost"]
        and (
            not corrupt_mode
            or bool(report.get("corruption", {}).get("all_healed", True))
        )
        and (
            not convert_mode
            or bool(report.get("convert", {}).get("completed", False))
        )
    )
    mode = (
        "convert" if convert_mode else "corrupt" if corrupt_mode else report["mode"]
    )
    _write_report(args.out or _default_out(mode), report)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
