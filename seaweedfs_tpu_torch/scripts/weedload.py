"""weedload: open-loop SLO load harness for hot-set and degraded EC reads.

Grown out of chaos_soak.py's real-cluster harness: a live master + volume
servers, zipfian keys over the master HTTP front (or the S3 gateway with
--front s3), a CONFIGURABLE degraded fraction (data shards of the EC'd
volume dropped cluster-wide, so their needles reconstruct on every read),
and mid-run chaos (SIGKILL restarts and SIGSTOP wedges of shard holders).
Unlike the soak, the generator is OPEN-LOOP: arrivals fire on a Poisson
schedule at the target rate whether or not earlier requests returned, and
each latency is measured from the request's SCHEDULED arrival: a stalled
server shows up as queueing delay in the tail, exactly like it would for
real users, instead of silently throttling the offered load (the
closed-loop "coordinated omission" failure mode).

Every volume server is its own `python -m seaweedfs_tpu_torch volume ...
--device <device>` process (chaos_soak.Node), with its own CUDA context on
the card under `--device cuda` (the default); the master runs in this
process. `--smoke` runs the servers in this process instead.

Kilo-rps scale comes from --procs N: the main process preloads and classifies,
then spawns N GENERATOR WORKER subprocesses (each its own Python process
and client connection pool, each offering rps/N on its own Poisson clock,
all phase-aligned to one absolute start instant) while the main process runs
chaos; workers ship their latency recorders back as JSON and the main process
merges them bucket-exactly. One GIL never caps the offered load. A worker
is a client: it imports the cluster client, the SLO recorder and the
trace module, never torch, and opens no CUDA context.

Every preloaded needle is classified up front by the stripe math
(.ecx index + interval locate): a read is `degraded` when any of its
intervals lands on a dropped shard (it MUST reconstruct), `ec_intact`
when it lives on the EC volume's surviving shards, `healthy` when it
lives on a plain replicated volume. At serving time the volume server's
X-Weedtpu-Read-Class response header refines that: a statically-degraded
read answered from the decoded-interval cache records as `cached`, so
the report separates cache hits from real decodes: the hot-set serving
comparison (cached p99 vs decoded p99) this harness exists for. The
decoded-interval cache runs with a short TTL (the "epoch") so the
decoded class keeps earning fresh samples after warmup instead of
starving behind a fully-warm cache.

Chaos runs start the master with WEEDTPU_REPAIR=on: the fleet-repair
scheduler is part of the serving story under kills, not a separate mode.
A guard thread re-drops the DELIBERATELY dropped shards whenever the
scheduler dutifully rebuilds them (counted as repairs_reverted) so the
degraded class keeps existing.

Shards 5-9 are spread to TWO extra holders so degraded fan-outs cross
the network and hedged fetches have a second holder to race.

The S3 front (`--front s3`) runs a filer and the S3 gateway in this
process and sends signed V4 requests through them into bucket `load`;
it takes --procs 1 and no --corrupt, --rebuild-storm or --put-fraction.

Usage (real run, on the card):
  python -m seaweedfs_tpu_torch.scripts.weedload --seconds 30 --rps 1000 \
      --procs 4 --chaos [--rebuild-storm] [--out PATH]
Smoke (in-process servers, schema + cache-hit + zero-loss gate):
  python -m seaweedfs_tpu_torch.scripts.weedload --smoke --device cpu
Reports go to --out and --trace-out, by default SLO*.json and
TRACE_ATTRIB*.json in the system temp directory, never under artifacts/.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

#: the directory that holds the `seaweedfs_tpu_torch` package: the generator
#: workers' working directory, so `python -m` resolves this copy
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: S3-front credentials (loopback bench identity, not a secret)
S3_AK, S3_SK = "weedloadAccessKey", "weedloadSecretKey"

#: serving classes the volume server's read-class header may answer; a
#: header value outside this set (or a front that strips it) falls back
#: to the static stripe-math classification
OBSERVED_CLASSES = ("healthy", "ec_intact", "cached", "degraded")

#: counters scraped from every node's /metrics at run end — the server-side
#: evidence that hedging/coalescing/admission/caching actually engaged
SCRAPED_COUNTERS = (
    "weedtpu_hedge_fired_total",
    "weedtpu_hedge_won_total",
    "weedtpu_coalesced_reads_total",
    "weedtpu_rebuild_admission_waits_total",
    "weedtpu_degraded_read_seconds_count",
    "weedtpu_degraded_read_errors_total",
    "weedtpu_ec_repair_network_bytes_total",
    "weedtpu_inline_ec_rows_total",
    "weedtpu_inline_ec_bytes_total",
    "weedtpu_inline_ec_delta_updates_total",
    "weedtpu_inline_ec_seals_total",
    "weedtpu_scrub_bytes_scanned_total",
    "weedtpu_scrub_corruptions_found_total",
    "weedtpu_scrub_repairs_total",
    "weedtpu_scrub_cycles_total",
    "weedtpu_ec_convert_bytes_total",
    "weedtpu_ec_convert_seconds_count",
    # fleet repair scheduler (master-side: the master's /metrics is
    # scraped too on subprocess runs) + inline parity spreading
    "weedtpu_repair_dispatch_total",
    "weedtpu_repair_backoff_total",
    "weedtpu_inline_ec_spread_bytes_total",
    "weedtpu_inline_ec_spread_commits_total",
    # decoded-interval cache (read planner)
    "weedtpu_read_cache_hits_total",
    "weedtpu_read_cache_misses_total",
    "weedtpu_read_cache_evictions_total",
    "weedtpu_read_cache_invalidations_total",
    # decodes on the servers' encoders: reads' reconstructs and rebuild RPCs
    "weedtpu_ec_reconstruct_seconds_count",
    "weedtpu_ec_rebuild_seconds_count",
)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seconds", type=float, default=120.0,
                   help="measured load time (split steady/chaos)")
    p.add_argument("--rps", type=float, default=40.0, help="offered arrival rate")
    p.add_argument("--procs", type=int, default=1,
                   help="generator worker processes; >1 spawns that many "
                        "subprocess open-loop generators each offering "
                        "rps/N (kilo-rps needs more than one GIL), phase-"
                        "aligned to one absolute start time while the "
                        "main process runs chaos and merges their recorders")
    p.add_argument("--front", choices=("master", "s3"), default="master",
                   help="serving front the load goes through: the master "
                        "HTTP redirect front (direct fid reads, per-read "
                        "class header), or the S3 gateway (signed V4 "
                        "requests through filer+s3 in-process; classes "
                        "come from the objects' chunk fids)")
    p.add_argument("--objects", type=int, default=160, help="preloaded objects")
    p.add_argument("--zipf", type=float, default=1.1, help="zipf skew s")
    p.add_argument("--concurrency", type=int, default=64,
                   help="client worker threads (open-loop: queueing counts)")
    p.add_argument("--client-timeout", type=float, default=2.0,
                   help="per-location HTTP timeout: a wedged replica costs "
                        "this much before the client fails over, for healthy "
                        "and degraded traffic alike (30 s would let one "
                        "SIGSTOP dominate every class's tail)")
    p.add_argument("--put-fraction", type=float, default=0.0,
                   help="fraction of arrivals that are PUTs (assign + upload "
                        "over the master HTTP front). Any value > 0 also "
                        "starts the servers with WEEDTPU_INLINE_EC=on so "
                        "every PUT streams through the encode-on-write "
                        "stripe encoders — the write-heavy workload. PUT "
                        "latency lands in the report under class `put`. "
                        "Requires --procs 1 and --front master")
    p.add_argument("--dropped-shards", type=int, nargs="*", default=[0, 1],
                   help="data shards deleted cluster-wide (degraded fraction)")
    p.add_argument("--ec-large-block", type=int, default=1 << 20,
                   help="EC large-block size for the converted volume: "
                        "small relative to the volume so needles stripe "
                        "across shards (the production 1 GB default would "
                        "put a bench-sized volume entirely on shard 0)")
    p.add_argument("--ec-small-block", type=int, default=16 << 10)
    p.add_argument("--chaos", action="store_true",
                   help="second phase with kills + SIGSTOP wedges; the "
                        "master runs the fleet-repair scheduler "
                        "(WEEDTPU_REPAIR=on) for the whole run")
    p.add_argument("--rebuild-storm", action="store_true",
                   help="launch concurrent remote rebuilds mid-chaos so "
                        "bulk slab streams contend with foreground reads "
                        "through the admission gate (servers start with "
                        "WEEDTPU_REBUILD_MAX_INFLIGHT=4 unless overridden)")
    p.add_argument("--corrupt", action="store_true",
                   help="inject silent corruption on live servers mid-run "
                        "(bit-flips, truncations, deletions of EC shard "
                        "files, cycling) with the background scrubber ON — "
                        "measures detect -> quarantine -> auto-repair under "
                        "load, and the SLO with scrub + repair active; "
                        "every injection is verified healed (bytes match "
                        "the .eci record again) in the report")
    p.add_argument("--wedge-seconds", type=float, default=12.0,
                   help="SIGSTOP duration (must outlast the 10 s per-holder "
                        "transport timeout for the suspicion path to fire)")
    p.add_argument("--slo-factor", type=float, default=5.0)
    p.add_argument("--out", default=None,
                   help="report path; defaults to SLO.json (SLO_corrupt.json "
                        "with --corrupt, SLO_smoke.json with --smoke) in the "
                        "system temp directory")
    p.add_argument("--trace-out", default=None,
                   help="tail-attribution report path (per-stage p50/p99 "
                        "per class + the slowest full span trees, scraped "
                        "from every node's /debug/traces); defaults to "
                        "TRACE_ATTRIB.json (TRACE_ATTRIB_smoke.json with "
                        "--smoke) in the system temp directory")
    p.add_argument("--smoke", action="store_true",
                   help="tiny in-process cluster, <=20 s, schema + "
                        "cache-hit-rate gate")
    p.add_argument("--device", default="cuda",
                   help="torch device of every volume server's encoder "
                        "(default cuda; cpu runs the plain version)")
    p.add_argument("--require-slo", action="store_true",
                   help="exit 2 when the SLO verdict is not ok")
    p.add_argument("--seed", type=int, default=7)
    # -- generator-worker mode (internal; the main process spawns these) ----
    p.add_argument("--gen-worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--worker-out", default=None, help=argparse.SUPPRESS)
    p.add_argument("--worker-index", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def classify_needles(base: str, dropped: set[int]) -> tuple[set[int], set[int]]:
    """(degraded_ids, all_ids) for the EC volume at `base`: a needle is
    degraded when ANY of its record intervals maps to a dropped shard —
    the same locate math the serving path runs, executed offline on the
    committed .ecx/.eci, so the classification is exact, not sampled."""
    from seaweedfs_tpu_torch.ec import locate as locate_mod
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.storage import idx as idx_mod
    from seaweedfs_tpu_torch.storage import types

    info = stripe.read_ec_info(base)
    assert info is not None, f"{base}.eci missing — cannot classify"
    large, small = int(info["large_block_size"]), int(info["small_block_size"])
    dat_size = int(info["dat_size"])
    with open(base + ".ecx", "rb") as f:
        entries = idx_mod.index_entries_array(f.read())
    degraded, everyone = set(), set()
    for i in range(len(entries)):
        key = int(entries[i]["key"])
        size = int(entries[i]["size"])
        if types.is_deleted(size):
            continue
        everyone.add(key)
        off = types.offset_to_actual(int(entries[i]["offset"]))
        whole = types.actual_size(size, 3)
        ivs = locate_mod.locate_data(large, small, dat_size, off, whole)
        if any(iv.to_shard_id_and_offset(large, small)[0] in dropped for iv in ivs):
            degraded.add(key)
    return degraded, everyone


def zipf_cdf(n: int, s: float) -> list[float]:
    weights = [1.0 / (rank ** s) for rank in range(1, n + 1)]
    total = sum(weights)
    cdf, acc = [], 0.0
    for w in weights:
        acc += w / total
        cdf.append(acc)
    return cdf


def pick_zipf(rng: random.Random, keys: list, cdf: list[float]):
    import bisect

    return keys[min(bisect.bisect_left(cdf, rng.random()), len(keys) - 1)]


def measure_trace_overhead(
    client, fids: list, rounds: int = 8, batch: int = 40,
    attempts: int = 3, tol: float = 0.05, abs_floor_us: float = 100.0,
) -> dict:
    """The tracing-on overhead gate: healthy reads against the SAME live
    cluster with `WEEDTPU_TRACE` toggled per batch, interleaved ABBA
    (which mode goes first alternates per round) so clock drift, page
    cache, and GC land evenly on both sides — the only honest way to
    resolve a 5% bound on a shared machine. A real regression fails all
    `attempts` measurements; a scheduler artifact fails at most one, so
    the gate passes if ANY attempt holds both bounds (p99 within `tol`,
    throughput within `tol`). Each bound also accepts an absolute floor:
    loopback reads run in the hundreds of microseconds, where tracing's
    fixed few-dozen-µs cost is a large *fraction* yet invisible against
    any real (ms-scale, network + decode) read — so a delta at or under
    `abs_floor_us` per read passes even when the ratio does not.
    Smoke-only: the in-process cluster shares this process's
    environment, which is what makes the per-batch toggle land on the
    servers."""
    import itertools

    prev = os.environ.get("WEEDTPU_TRACE")

    def pct(xs: list, q: float) -> float:
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def one_attempt() -> dict:
        lat = {"on": [], "off": []}
        busy = {"on": 0.0, "off": 0.0}
        it = itertools.cycle(fids)
        for r in range(rounds):
            for mode in ("on", "off") if r % 2 == 0 else ("off", "on"):
                os.environ["WEEDTPU_TRACE"] = mode
                t0 = time.monotonic()
                for _ in range(batch):
                    fid = next(it)
                    s0 = time.monotonic()
                    client.read(fid)
                    lat[mode].append(time.monotonic() - s0)
                busy[mode] += time.monotonic() - t0
        n = rounds * batch
        p99_on, p99_off = pct(lat["on"], 0.99), pct(lat["off"], 0.99)
        rps_on, rps_off = n / busy["on"], n / busy["off"]
        mean_delta_us = (busy["on"] - busy["off"]) / n * 1e6
        p99_delta_us = (p99_on - p99_off) * 1e6
        return {
            "samples_per_mode": n,
            "p50_ms": {
                "on": round(pct(lat["on"], 0.5) * 1e3, 3),
                "off": round(pct(lat["off"], 0.5) * 1e3, 3),
            },
            "p99_ms": {
                "on": round(p99_on * 1e3, 3),
                "off": round(p99_off * 1e3, 3),
            },
            "rps": {"on": round(rps_on, 1), "off": round(rps_off, 1)},
            "p99_ratio": round(p99_on / p99_off, 4) if p99_off else None,
            "throughput_ratio": round(rps_on / rps_off, 4) if rps_off else None,
            "mean_delta_us_per_read": round(mean_delta_us, 1),
            "p99_delta_us": round(p99_delta_us, 1),
            "ok": (
                p99_off > 0
                and (p99_on / p99_off <= 1.0 + tol or p99_delta_us <= abs_floor_us)
                and (rps_on / rps_off >= 1.0 - tol or mean_delta_us <= abs_floor_us)
            ),
        }

    out = {
        "method": "interleaved-ABBA",
        "tolerance": tol,
        "abs_floor_us": abs_floor_us,
        "attempts": [],
    }
    try:
        for fid in fids[: min(len(fids), 20)]:
            client.read(fid)  # warmup: page cache + connection reuse
        for _ in range(attempts):
            a = one_attempt()
            out["attempts"].append(a)
            if a["ok"]:
                break
    finally:
        if prev is None:
            os.environ.pop("WEEDTPU_TRACE", None)
        else:
            os.environ["WEEDTPU_TRACE"] = prev
    out["ok"] = any(a["ok"] for a in out["attempts"])
    return out


class TraceScraper:
    """Accumulates every node's retained `/debug/traces` span trees
    across process generations (same discipline as CounterScraper: a
    victim is scraped right before its kill, everyone at run end).
    Dedup is by RECORD identity — (node, trace id, kind, start,
    duration) — so scraping the same generation twice cannot double a
    record in the attribution quantiles, while one propagated id's
    DISTINCT records (the serving http.read root, EACH holder's
    rpc.server continuation, even two continuations inside one holder)
    all survive: any coarser key lets whichever record scrapes first
    shadow the rest."""

    def __init__(self) -> None:
        self._traces: dict[tuple, dict] = {}

    @property
    def traces(self) -> dict:
        return self._traces

    def scrape(self, http_port: int) -> None:
        url = f"http://127.0.0.1:{http_port}/debug/traces?limit=1000000"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                payload = json.loads(r.read().decode())
        except Exception:  # noqa: BLE001 — a dead node scrapes as nothing
            return
        for t in payload.get("traces", ()):
            key = (
                http_port, t["trace_id"], t["kind"],
                t.get("start"), t.get("duration_s"),
            )
            self._traces.setdefault(key, t)


class CounterScraper:
    """Accumulates the servers' /metrics counters ACROSS process
    generations: a killed-and-restarted node comes back with zeroed
    counters, so the chaos loop scrapes each victim right before the
    kill and the run end scrapes everyone: every generation is counted
    exactly once and a restart can no longer erase the evidence that
    hedging/coalescing/admission engaged. A scrape that names its
    `server` is also summed under that name (`by_server`), and records the
    backends `weedtpu_ec_backend_selected` shows at 1 (`backends`, one
    list per scraped generation): the evidence of which encoder served."""

    def __init__(self, names=SCRAPED_COUNTERS) -> None:
        self.totals: dict[str, float] = {name: 0.0 for name in names}
        self.by_server: dict[str, dict[str, float]] = {}
        self.backends: dict[str, list[list[str]]] = {}

    def scrape(self, http_port: int, server: str | None = None) -> None:
        url = f"http://127.0.0.1:{http_port}/metrics"
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                text = r.read().decode()
        except Exception:  # noqa: BLE001 — a dead node scrapes as zero
            return
        mine = None
        if server is not None:
            mine = self.by_server.setdefault(server, dict.fromkeys(self.totals, 0.0))
        selected = []
        for line in text.splitlines():
            if line.startswith("#") or " " not in line:
                continue
            name_part, _, value = line.rpartition(" ")
            bare, _, labels = name_part.partition("{")
            try:
                v = float(value)
            except ValueError:
                continue
            if bare in self.totals:
                self.totals[bare] += v
                if mine is not None:
                    mine[bare] += v
            elif bare == "weedtpu_ec_backend_selected" and v == 1.0:
                selected.append(labels.split('backend="', 1)[-1].split('"', 1)[0])
        if server is not None:
            self.backends.setdefault(server, []).append(sorted(selected))


def ec_encode_and_spread(
    rpc_mod, VOLUME_SERVICE, nodes, vid: int, dropped: list[int],
    large_block: int, small_block: int, collection: str = "",
) -> str:
    """EC-encode `vid` on its owner, spread shards 5-9 to two other
    holders (hedging needs a second holder to race), drop `dropped`
    cluster-wide, and return the owner's base path (for classification).
    `collection` must match the volume's collection (s3-front objects
    land in their bucket's collection, so the on-disk base is
    `<collection>_<vid>`, and every shard RPC resolves paths from it).
    `nodes` entries expose .grpc (port) and .dir — true for both the
    subprocess Node and the in-process shim."""
    owner = None
    for n in nodes:
        try:
            with rpc_mod.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                st = c.call(VOLUME_SERVICE, "VolumeStatus", {"volume_id": vid})
            if st.get("kind") == "normal":
                owner = n
                break
        except Exception:  # noqa: BLE001 — not the owner
            continue
    assert owner is not None, f"no node owns volume {vid}"
    with rpc_mod.RpcClient(f"127.0.0.1:{owner.grpc}") as c:
        c.call(VOLUME_SERVICE, "VolumeMarkReadonly", {"volume_id": vid})
        c.call(
            VOLUME_SERVICE, "VolumeEcShardsGenerate",
            {
                "volume_id": vid,
                "collection": collection,
                "large_block_size": large_block,
                "small_block_size": small_block,
            },
            timeout=300,
        )
        c.call(
            VOLUME_SERVICE, "VolumeEcShardsMount",
            {"volume_id": vid, "collection": collection},
        )
    # the normal volume must vanish from EVERY holder, replicas included:
    # with replication 001 a surviving replica would keep serving these
    # needles as a plain volume and the "degraded" class would silently
    # measure replica reads whenever the master lists the replica first
    for n in nodes:
        try:
            with rpc_mod.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                c.call(VOLUME_SERVICE, "VolumeDelete", {"volume_id": vid})
        except Exception:  # noqa: BLE001 — node never held a replica
            continue
    # survivable 2-resident placement: owner keeps the non-spread shards,
    # both peers take 5-9, the second peer additionally mirrors the rest —
    # every surviving shard then has TWO holders, so one killed/wedged
    # node never makes the stripe unreadable (and every hedged fetch has
    # a second holder to race)
    spread = [s for s in (5, 6, 7, 8, 9) if s not in dropped]
    rest = [s for s in range(14) if s not in dropped and s not in spread]
    others = [n for n in nodes if n is not owner][:2]
    for peer, shard_sets in ((others[0], [spread]), (others[1], [spread, rest])):
        with rpc_mod.RpcClient(f"127.0.0.1:{peer.grpc}") as c:
            for shard_ids in shard_sets:
                c.call(
                    VOLUME_SERVICE, "VolumeEcShardsCopy",
                    {
                        "volume_id": vid,
                        "collection": collection,
                        "shard_ids": shard_ids,
                        "source_data_node": f"127.0.0.1:{owner.grpc}",
                        "copy_ecx_file": True,
                    },
                    timeout=120,
                )
            c.call(
                VOLUME_SERVICE, "VolumeEcShardsMount",
                {"volume_id": vid, "collection": collection},
            )
    with rpc_mod.RpcClient(f"127.0.0.1:{owner.grpc}") as c:
        c.call(
            VOLUME_SERVICE, "VolumeEcShardsDelete",
            {
                "volume_id": vid,
                "collection": collection,
                "shard_ids": sorted(set(spread) | set(dropped)),
            },
        )
    base_name = f"{collection}_{vid}" if collection else str(vid)
    return os.path.join(owner.dir, base_name)


class _InprocNode:
    """chaos_soak.Node-shaped shim around an in-process VolumeServer on the
    factory's encoder on `device`, so the smoke path reuses the exact
    encode/spread/load machinery (no subprocess spawn in the smoke's
    budget). Wedges/kills are no-ops: you cannot SIGSTOP your own test
    process."""

    def __init__(self, i: int, dirpath: str, master_addr: str, device: str = "cuda"):
        from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
        from seaweedfs_tpu_torch.ops.rs_codec import new_encoder

        self.i = i
        self.dir = dirpath
        self.vs = VolumeServer(
            [dirpath], master_addr, heartbeat_interval=0.5, max_volume_count=30,
            encoder=new_encoder(device=device),
        )
        self.vs.start()
        self.grpc = self.vs.grpc_port
        self.http = self.vs.port
        self.wedged = False

    @property
    def alive(self) -> bool:
        return True

    def stop(self) -> None:
        self.vs.stop()


def run_load(
    args, read_fn, rec, lost, keys, cdf, klass_of, phases: list[tuple[str, float]],
    chaos_fn=None, put_fn=None,
):
    """Open-loop Poisson arrivals over `phases` ([(name, seconds), ...]):
    latency is measured from each request's SCHEDULED time, so server
    stalls surface as tail latency instead of reduced offered load.
    `read_fn(key) -> (bytes, served_class|None)` is the front adapter;
    the served class (the volume server's read-class header) overrides
    the static stripe-math class when present, so a cache hit on a
    statically-degraded key records as `cached`. `put_fn(sched, phase)`
    (when given) serves the --put-fraction share of arrivals — write
    traffic interleaved with the read mix, same open-loop accounting."""
    rng = random.Random(args.seed + 1)
    pool = ThreadPoolExecutor(max_workers=args.concurrency)
    issued = 0

    def one(fid: str, want: bytes, sched: float, phase: str) -> None:
        static_klass = klass_of(fid)
        try:
            got, served = read_fn(fid)
        except Exception:  # noqa: BLE001 — open loop records, never retries
            rec.error(phase, static_klass)
            return
        lat = time.monotonic() - sched
        if got != want:
            lost.append({"fid": fid, "why": "BYTES DIFFER (live read)"})
            rec.error(phase, static_klass)
        else:
            klass = served if served in OBSERVED_CLASSES else static_klass
            rec.observe(phase, klass, lat)

    try:
        for phase, seconds in phases:
            stop_chaos = threading.Event()
            chaos_thread = None
            if chaos_fn is not None and phase == "chaos":
                chaos_thread = threading.Thread(
                    target=chaos_fn, args=(stop_chaos,), daemon=True
                )
                chaos_thread.start()
            t_end = time.monotonic() + seconds
            next_t = time.monotonic()
            while True:
                now = time.monotonic()
                if now >= t_end:
                    break
                if now < next_t:
                    time.sleep(min(next_t - now, 0.02))
                    continue
                if put_fn is not None and rng.random() < args.put_fraction:
                    pool.submit(put_fn, next_t, phase)
                else:
                    fid = pick_zipf(rng, keys, cdf)
                    pool.submit(one, fid, client_blobs[fid], next_t, phase)
                issued += 1
                next_t += rng.expovariate(args.rps)
            stop_chaos.set()
            if chaos_thread is not None:
                chaos_thread.join(timeout=args.wedge_seconds + 10)
    finally:
        pool.shutdown(wait=True)
    return issued


def run_worker(args) -> int:
    """One generator worker subprocess (--gen-worker): an independent
    open-loop Poisson generator at spec rps, phase-aligned to the spec's
    absolute start instant shared by every worker and the main process's chaos
    clock. Blob bytes stay in the main process; the spec carries each fid's
    sha256 + static class, and each read verifies content by digest.
    Results (bucketed latency cells, issued count, losses) are written
    as JSON for the main process to merge."""
    with open(args.gen_worker, encoding="utf-8") as f:
        spec = json.load(f)
    from seaweedfs_tpu_torch.cluster.client import MasterClient
    from seaweedfs_tpu_torch.ec import slo

    rec = slo.LatencyRecorder()
    lost: list[dict] = []
    fids: dict[str, dict] = spec["fids"]
    keys = sorted(fids)
    # the SAME shuffle in every worker: the zipf hot set must be shared
    # across generators or the aggregate offered load has no hot set and
    # the cache has nothing to serve
    random.Random(spec["seed"]).shuffle(keys)
    cdf = zipf_cdf(len(keys), spec["zipf"])
    # arrivals are per-worker independent Poisson clocks (superposition
    # of N Poisson streams at rps/N is one Poisson stream at rps)
    rng = random.Random(spec["seed"] * 7919 + args.worker_index)
    client = MasterClient(spec["master"], http_timeout=spec["client_timeout"])
    pool = ThreadPoolExecutor(max_workers=spec["concurrency"])
    issued = 0

    def one(fid: str, sched: float, phase: str) -> None:
        info = fids[fid]
        try:
            got, served = client.read_ex(fid)
        except Exception:  # noqa: BLE001 — open loop records, never retries
            rec.error(phase, info["klass"])
            return
        lat = time.monotonic() - sched
        if hashlib.sha256(got).hexdigest() != info["sha256"]:
            lost.append({
                "fid": fid,
                "why": "BYTES DIFFER (live read)",
                "worker": args.worker_index,
            })
            rec.error(phase, info["klass"])
        else:
            klass = served if served in OBSERVED_CLASSES else info["klass"]
            rec.observe(phase, klass, lat)

    delay = spec["start_at"] - time.time()
    if delay > 0:
        time.sleep(delay)
    try:
        next_t = time.monotonic()
        for phase, seconds in spec["phases"]:
            t_end = time.monotonic() + seconds
            while True:
                now = time.monotonic()
                if now >= t_end:
                    break
                if now < next_t:
                    time.sleep(min(next_t - now, 0.02))
                    continue
                fid = pick_zipf(rng, keys, cdf)
                pool.submit(one, fid, next_t, phase)
                issued += 1
                next_t += rng.expovariate(spec["rps"])
    finally:
        pool.shutdown(wait=True)
        client.close()
    with open(args.worker_out, "w", encoding="utf-8") as f:
        json.dump({"issued": issued, "cells": rec.to_dict(), "lost": lost}, f)
    return 0


client_blobs: dict[str, bytes] = {}  # fid -> expected bytes (module-level
# so the worker closure in run_load stays picklable-simple)


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.gen_worker:
        return run_worker(args)
    from seaweedfs_tpu_torch.scripts.chaos_soak import Node, prepare_device

    prepare_device(args.device)
    rng = random.Random(args.seed)

    from seaweedfs_tpu_torch import rpc as rpc_mod
    from seaweedfs_tpu_torch.cluster.client import MasterClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.ec import slo
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.utils import config

    if args.smoke:
        args.seconds = min(args.seconds, 4.0)
        args.objects = min(args.objects, 30)
        args.rps = min(args.rps, 30.0)
        args.chaos = False
        args.procs = 1
    if args.put_fraction > 0:
        assert args.procs == 1, "--put-fraction requires --procs 1"
        assert args.front == "master", "--put-fraction requires --front master"
    if args.front == "s3":
        assert args.procs == 1, "--front s3 requires --procs 1"
        assert not args.corrupt, "--corrupt requires --front master"
        assert not args.rebuild_storm, "--rebuild-storm requires --front master"
    if args.out is None:
        name = "SLO_smoke" if args.smoke else "SLO_corrupt" if args.corrupt else "SLO"
        args.out = os.path.join(tempfile.gettempdir(), name + ".json")
    if args.trace_out is None:
        name = "TRACE_ATTRIB_smoke" if args.smoke else "TRACE_ATTRIB"
        args.trace_out = os.path.join(tempfile.gettempdir(), name + ".json")
    # tracing rides along by default (WEEDTPU_TRACE=on): widen the
    # sampled ring so the per-stage quantiles aggregate over ~the whole
    # run's traces, not a tail-biased subset (retention bias would
    # flatter exactly the stages the attribution is about). Subprocess
    # servers pick the env up at exec; the in-process smoke cluster's
    # module-global RING was already constructed at import (possibly by
    # the hosting test process, long before this env write), so its
    # capacity is widened directly.
    os.environ.setdefault("WEEDTPU_TRACE_RING", "65536")
    from seaweedfs_tpu_torch.obs import trace as trace_obs

    trace_obs.RING.capacity = max(trace_obs.RING.capacity, 65536)

    # hot-set serving is the point of this harness: force the decoded-
    # interval cache ON even when the hosting environment zeroed the
    # budget (the test suite's autouse fixture runs the cache default-off
    # to protect decode-count assertions elsewhere). The TTL ("epoch")
    # stays SHORT so warm entries keep expiring and the decoded class
    # keeps earning real reconstruction samples alongside cache hits.
    try:
        _cache_mb = float(os.environ.get("WEEDTPU_READ_CACHE_MB", "0") or 0.0)
    except ValueError:
        _cache_mb = 0.0
    if _cache_mb <= 0:
        os.environ["WEEDTPU_READ_CACHE_MB"] = "64"
    os.environ.setdefault(
        "WEEDTPU_READ_CACHE_TTL_S", "2.0" if args.smoke else "5.0"
    )

    if args.chaos:
        # the fleet-repair scheduler is part of the serving story under
        # kills: killed holders' shards draw mass-rebuild dispatches
        # while the load runs. Must land BEFORE MasterServer() — the
        # master reads it once at construction.
        os.environ.setdefault("WEEDTPU_REPAIR", "on")
    if args.rebuild_storm:
        # must land BEFORE the server processes start (they read it once
        # at init); a tight gate makes the storm actually queue
        os.environ.setdefault("WEEDTPU_REBUILD_MAX_INFLIGHT", "4")
    if args.put_fraction > 0:
        # write traffic exercises the encode-on-write path: servers start
        # with inline EC on and a bench-scale stripe geometry so PUT-fed
        # volumes actually complete large rows within the run (the
        # production 1 GiB rows would never fill here)
        os.environ.setdefault("WEEDTPU_INLINE_EC", "on")
        os.environ.setdefault("WEEDTPU_INLINE_EC_LARGE_BLOCK", str(256 << 10))
        os.environ.setdefault("WEEDTPU_INLINE_EC_SMALL_BLOCK", str(16 << 10))
    if args.corrupt:
        # corruption mode runs the scrubber hot (short cycle, no rate cap,
        # prompt repair retries) so detection latency is scan-bound, not
        # idle-bound; must land before the server processes start
        os.environ.setdefault("WEEDTPU_SCRUB", "on")
        os.environ.setdefault("WEEDTPU_SCRUB_INTERVAL", "0.5")
        os.environ.setdefault("WEEDTPU_SCRUB_RATE_MB", "0")
        os.environ.setdefault("WEEDTPU_SCRUB_REPAIR_BACKOFF", "1.0")

    rec = slo.LatencyRecorder()
    lost: list[dict] = []
    trace_overhead = None
    chaos_report = {"mode": "kill+wedge" if args.chaos else "none",
                    "kills": 0, "wedges": 0}
    if args.chaos:
        chaos_report["repair_scheduler"] = "on"
        chaos_report["repairs_reverted"] = 0

    # wall seconds of each stage of the run, set-up apart from the load
    stage_s: dict[str, float] = {}
    t_mark = [time.monotonic()]

    def mark(stage: str) -> None:
        now = time.monotonic()
        stage_s[stage] = round(now - t_mark[0], 3)
        t_mark[0] = now

    with tempfile.TemporaryDirectory() as td:
        master = MasterServer(port=0, reap_interval=3600)
        master.start()
        nodes = []
        client = None
        filer_srv = s3_srv = filer_client = None
        try:
            if args.smoke:
                for i in range(3):
                    d = os.path.join(td, f"n{i}")
                    os.makedirs(d)
                    nodes.append(_InprocNode(i, d, master.address, device=args.device))
            else:
                for i in range(3):
                    d = os.path.join(td, f"n{i}")
                    os.makedirs(d)
                    n = Node(i, d, master.address, device=args.device)
                    n.start()
                    nodes.append(n)
            client = MasterClient(master.address, http_timeout=args.client_timeout)
            deadline0 = time.monotonic() + 60
            while time.monotonic() < deadline0 and len(master.topology.nodes) < 3:
                time.sleep(0.3)
            assert len(master.topology.nodes) == 3, "cluster did not form"
            mark("cluster_form")

            # -- front adapters: how objects get written, read back, and
            # mapped to the needle fids the stripe math classifies ----------
            if args.front == "s3":
                from seaweedfs_tpu_torch.filer import FilerServer
                from seaweedfs_tpu_torch.filer.client import FilerClient
                from seaweedfs_tpu_torch.s3api import (
                    Iam, Identity, S3ApiServer, sign_request,
                )

                filer_srv = FilerServer(master.address, chunk_size=1 << 20)
                filer_srv.start()
                s3_srv = S3ApiServer(
                    filer_srv.url,
                    filer_srv.grpc_address,
                    iam=Iam([Identity("weedload", S3_AK, S3_SK)]),
                )
                s3_srv.start()
                filer_client = FilerClient(filer_srv.grpc_address)

                def _s3_req(method, key, body=b""):
                    url = f"http://{s3_srv.url}{key}"
                    h = sign_request(S3_AK, S3_SK, method, url, body)
                    req = urllib.request.Request(
                        url, data=body if body else None, method=method,
                        headers=h,
                    )
                    with urllib.request.urlopen(
                        req, timeout=args.client_timeout + 10
                    ) as r:
                        return r.read(), r.headers

                _s3_req("PUT", "/load")
                s3_seq = [0]
                _chunk_cache: dict[str, list[str]] = {}

                def fids_of(key: str) -> list[str]:
                    chunks = _chunk_cache.get(key)
                    if chunks is None:
                        ent = filer_client.lookup(f"/buckets{key}")
                        chunks = [c.fid for c in (ent.chunks or [])] if ent else []
                        _chunk_cache[key] = chunks
                    return chunks

                def write_one_blob(payload: bytes) -> str:
                    key = f"/load/o{s3_seq[0]:06d}"
                    s3_seq[0] += 1
                    _s3_req("PUT", key, payload)
                    return key

                def read_fn(key: str):
                    # the s3 gateway reads needles filer-side, so the
                    # read-class header does not reach this client:
                    # classification stays the static chunk-fid class
                    body, _headers = _s3_req("GET", key)
                    return body, None
            else:

                def fids_of(key: str) -> list[str]:
                    return [key]

                def write_one_blob(payload: bytes) -> str:
                    a = client.assign(replication="001")
                    client.upload(a.fid, payload)
                    return a.fid

                def read_fn(key: str):
                    return client.read_ex(key)

            # -- preload batch 1: the objects that will live on the EC'd
            # volume (written first so they share one volume) --------------
            client_blobs.clear()

            def write_some(count: int) -> None:
                for _ in range(count):
                    size = rng.randrange(500, 40_000)
                    payload = rng.getrandbits(8 * size).to_bytes(size, "little")
                    key = write_one_blob(payload)
                    client_blobs[key] = payload

            n_ec = max(10, args.objects // 2)
            write_some(n_ec)
            mark("preload_ec")

            # -- EC the busiest volume, spread + drop shards --------------
            by_vid: dict[int, int] = {}
            for key in client_blobs:
                for fid in fids_of(key):
                    vid = int(fid.split(",", 1)[0])
                    by_vid[vid] = by_vid.get(vid, 0) + 1
            ec_vid = max(by_vid, key=lambda v: by_vid[v])
            dropped = set(args.dropped_shards)
            # s3-front objects live in their bucket's collection, which
            # prefixes the on-disk base (`load_<vid>`); master-front
            # assigns land in the default (empty) collection
            ec_collection = "load" if args.front == "s3" else ""
            base = ec_encode_and_spread(
                rpc_mod, VOLUME_SERVICE, nodes, ec_vid, sorted(dropped),
                args.ec_large_block, args.ec_small_block,
                collection=ec_collection,
            )
            degraded_ids, _ = classify_needles(base, dropped)
            mark("encode_spread")

            # -- preload batch 2: the EC'd volume left the writable set, so
            # these land on freshly-grown replicated volumes = the healthy
            # comparison class ---------------------------------------------
            write_some(args.objects - n_ec)
            mark("preload_healthy")

            def klass_of(key: str) -> str:
                best = "healthy"
                for fid in fids_of(key):
                    f = FileId.parse(fid)
                    if f.volume_id != ec_vid:
                        continue
                    if f.key in degraded_ids:
                        return "degraded"
                    best = "ec_intact"
                return best

            by_klass = {"healthy": 0, "degraded": 0, "ec_intact": 0}
            for key in client_blobs:
                by_klass[klass_of(key)] += 1

            # -- warmup: one unrecorded pass over the EC volume's needles
            # so the steady phase measures steady state, not the first
            # read's decode-matrix build and the operand caches' first fill. This
            # also populates the decoded-interval cache: the measured
            # phases then serve the hot set from it until each entry's
            # TTL epoch lapses and a real decode refreshes it -------------
            for key in client_blobs:
                if klass_of(key) != "healthy":
                    try:
                        read_fn(key)
                    except Exception:  # noqa: BLE001 — warmup best-effort
                        pass

            mark("warmup")

            # -- open-loop load -------------------------------------------
            keys = sorted(client_blobs)
            rng.shuffle(keys)
            cdf = zipf_cdf(len(keys), args.zipf)
            if args.chaos:
                phases = [("steady", args.seconds / 2), ("chaos", args.seconds / 2)]
            else:
                phases = [("steady", args.seconds)]

            scraper = CounterScraper()
            tracer = TraceScraper()

            put_rng = random.Random(args.seed + 3)
            put_lock = threading.Lock()
            puts_done = [0]

            def put_one(sched: float, phase: str) -> None:
                """One open-loop PUT: assign + upload over the master front.
                New blobs join client_blobs so the final zero-loss pass
                verifies them; a read-only race (a volume sealing under
                the writer) retries once with a fresh assign before it
                counts as an error — exactly what a real client does.
                Payload construction stays OUTSIDE the lock (os.urandom,
                not the shared RNG): latency is measured from scheduled
                time, so serialized generation would read as server tail."""
                with put_lock:
                    size = put_rng.randrange(500, 40_000)
                payload = os.urandom(size)
                for _ in range(2):
                    try:
                        a = client.assign(replication="001")
                        client.upload(a.fid, payload)
                        client_blobs[a.fid] = payload
                        with put_lock:
                            puts_done[0] += 1
                        rec.observe(phase, "put", time.monotonic() - sched)
                        return
                    except Exception:  # noqa: BLE001 — re-assign once
                        continue
                rec.error(phase, "put")

            # -- repair-revert guard: with WEEDTPU_REPAIR=on the fleet
            # scheduler sees the DELIBERATELY dropped shards as damage and
            # rebuilds them, silently un-degrading the measured class. The
            # guard watches every holder and re-drops them the moment they
            # come back, keeping score: the scheduler staying busy is part
            # of the chaos, the degraded class surviving it is the point.
            def redrop_dropped() -> None:
                for n in nodes:
                    if not n.alive or n.wedged:
                        continue
                    try:
                        with rpc_mod.RpcClient(f"127.0.0.1:{n.grpc}") as c:
                            st = c.call(
                                VOLUME_SERVICE, "VolumeStatus",
                                {"volume_id": ec_vid}, timeout=5,
                            )
                            back = sorted(set(st.get("shard_ids", ())) & dropped)
                            if back:
                                c.call(
                                    VOLUME_SERVICE, "VolumeEcShardsDelete",
                                    {
                                        "volume_id": ec_vid,
                                        "collection": ec_collection,
                                        "shard_ids": back,
                                    },
                                    timeout=10,
                                )
                                chaos_report["repairs_reverted"] += len(back)
                    except Exception:  # noqa: BLE001 — racing a kill
                        continue

            storm_threads: list[threading.Thread] = []
            if args.rebuild_storm:
                # concurrent remote rebuilds of the dropped shards at the
                # two non-owner holders, launched INTO the steady phase:
                # their survivor slab pulls ride the token-gated rebuild
                # lane while foreground reads keep flowing (the rebuilt
                # files stay unmounted, so the degraded classification is
                # untouched; launching them under kills would just race
                # the sole holder of the unspread shards). Under --chaos
                # the scheduler has had the preload to rebuild the dropped
                # shards already: re-drop them first, or the storm finds
                # nothing missing
                chaos_report["rebuilds"] = []
                if args.chaos:
                    redrop_dropped()

                def one_rebuild(node) -> None:
                    try:
                        with rpc_mod.RpcClient(f"127.0.0.1:{node.grpc}") as c:
                            # trace auto: projections when every holder
                            # speaks them, full slabs otherwise — the storm
                            # now also measures the repair-bandwidth path
                            # under load, and records which mode served
                            resp = c.call(
                                VOLUME_SERVICE, "VolumeEcShardsRebuild",
                                {
                                    "volume_id": ec_vid,
                                    "remote": True,
                                    "trace_mode": "auto",
                                },
                                timeout=240,
                            )
                            # the storm measures the rebuild LANE, not the
                            # repair result: scrub the rebuilt files so a
                            # later chaos restart cannot rescan them into
                            # service and quietly un-degrade the volume (an
                            # empty list would delete every shard there)
                            if resp.get("rebuilt_shard_ids"):
                                c.call(
                                    VOLUME_SERVICE, "VolumeEcShardsDelete",
                                    {
                                        "volume_id": ec_vid,
                                        "shard_ids": resp["rebuilt_shard_ids"],
                                    },
                                )
                        chaos_report["rebuilds"].append({
                            "target": node.i,
                            "rebuilt": resp.get("rebuilt_shard_ids", []),
                            "mode": resp.get("mode"),
                            "wire_bytes": resp.get("wire_bytes"),
                            "trace_fallback": resp.get("trace_fallback") or None,
                        })
                    except Exception as e:  # noqa: BLE001 — recorded, not fatal
                        chaos_report["rebuilds"].append(
                            {"target": node.i, "error": str(e)[:160]}
                        )

                for n in nodes:
                    if not base.startswith(n.dir):
                        t = threading.Thread(
                            target=one_rebuild, args=(n,), daemon=True
                        )
                        t.start()
                        storm_threads.append(t)

            corrupt_stop = threading.Event()
            corrupt_thread = None
            corruption_report = None
            if args.corrupt:
                from seaweedfs_tpu_torch.ec import stripe as stripe_mod

                # injection/healed primitives are SHARED with chaos_soak
                # so the two harnesses cannot drift on their semantics
                from seaweedfs_tpu_torch.scripts.chaos_soak import (
                    ec_shard_clean,
                    ec_shard_path,
                    inject_shard_fault,
                )

                eci = stripe_mod.read_ec_info(base)
                assert eci and eci.get("shard_crc32"), "corrupt mode needs .eci CRCs"
                golden_crcs = eci["shard_crc32"]
                corruption_report = {"injected": [], "all_healed": False}

                def shard_path(node, s: int) -> str:
                    return ec_shard_path(node.dir, ec_vid, s)

                def shard_clean(node, s: int) -> bool:
                    return ec_shard_clean(node.dir, ec_vid, s, golden_crcs)

                def corrupt_fn() -> None:
                    """One corruption at a time, cycling bit-flip ->
                    truncate -> delete across live holders' shard files,
                    each verified SELF-HEALED (bytes match the .eci
                    record again) before the next lands — so the stripe
                    never carries two concurrent injections and every
                    entry gets an exact healed-or-not verdict."""
                    crng = random.Random(args.seed + 9)
                    kinds = ("bitflip", "truncate", "delete")
                    k = 0
                    while not corrupt_stop.is_set():
                        cands = [
                            (n, s)
                            for n in nodes
                            for s in range(2, 10)
                            if n.alive and not n.wedged
                            and os.path.exists(shard_path(n, s))
                        ]
                        if not cands:
                            corrupt_stop.wait(1.0)
                            continue
                        node, s = crng.choice(cands)
                        kind = kinds[k % len(kinds)]
                        k += 1
                        if not inject_shard_fault(shard_path(node, s), kind, crng):
                            continue  # racing repair/kill: pick again
                        ent = {"node": node.i, "shard": s, "kind": kind}
                        corruption_report["injected"].append(ent)
                        t0 = time.monotonic()
                        deadline = t0 + 60
                        while (
                            time.monotonic() < deadline
                            and not corrupt_stop.is_set()
                            and not shard_clean(node, s)
                        ):
                            corrupt_stop.wait(0.5)
                        ent["healed"] = shard_clean(node, s)
                        ent["healed_after_s"] = (
                            round(time.monotonic() - t0, 2) if ent["healed"] else None
                        )
                        corrupt_stop.wait(2.0)

                corrupt_thread = threading.Thread(target=corrupt_fn, daemon=True)
                corrupt_thread.start()

            def chaos_fn(stop: threading.Event) -> None:
                crng = random.Random(args.seed + 2)
                while not stop.is_set():
                    victims = [n for n in nodes if n.alive and not n.wedged]
                    if len(victims) > 1:
                        victim = crng.choice(victims)
                        # both failure modes must actually land in every
                        # chaos window (a short window + an unlucky rng
                        # would otherwise produce a kills-only or
                        # wedges-only artifact): first a wedge, then a
                        # kill, then the 60/40 mix
                        if chaos_report["wedges"] == 0 or (
                            chaos_report["kills"] > 0 and crng.random() < 0.6
                        ):
                            victim.wedge()
                            chaos_report["wedges"] += 1
                            stop.wait(args.wedge_seconds)
                            victim.unwedge()
                        else:
                            # harvest the dying generation's counters +
                            # trace ring first (both die with the process)
                            scraper.scrape(victim.http, f"n{victim.i}")
                            tracer.scrape(victim.http)
                            victim.kill(hard=True)
                            chaos_report["kills"] += 1
                            stop.wait(3.0)
                            victim.start()
                            stop.wait(2.0)
                    stop.wait(crng.uniform(1.0, 3.0))

            guard_stop = threading.Event()
            guard_thread = None
            if args.chaos:

                def repair_guard() -> None:
                    while not guard_stop.is_set():
                        redrop_dropped()
                        guard_stop.wait(2.0)

                guard_thread = threading.Thread(target=repair_guard, daemon=True)
                guard_thread.start()

            if args.procs > 1:
                # -- multi-process generators: spec out, spawn, drive chaos
                # on the shared absolute clock, merge recorders ------------
                spec = {
                    "master": master.address,
                    "client_timeout": args.client_timeout,
                    "rps": args.rps / args.procs,
                    "zipf": args.zipf,
                    "concurrency": max(16, args.concurrency // args.procs),
                    "seed": args.seed,
                    "phases": [[name, secs] for name, secs in phases],
                    # absolute start instant: late enough for every worker
                    # to finish interpreter startup + imports, shared so
                    # worker phase boundaries align with the main process's
                    # chaos window
                    "start_at": time.time() + max(6.0, 1.5 * args.procs),
                    "fids": {
                        fid: {
                            "klass": klass_of(fid),
                            "sha256": hashlib.sha256(data).hexdigest(),
                        }
                        for fid, data in client_blobs.items()
                    },
                }
                spec_path = os.path.join(td, "genspec.json")
                with open(spec_path, "w", encoding="utf-8") as f:
                    json.dump(spec, f)
                workers = []
                for i in range(args.procs):
                    out_i = os.path.join(td, f"gen{i}.json")
                    log_i = open(  # weedlint: ignore[open-no-ctx]
                        os.path.join(td, f"gen{i}.log"), "ab"
                    )
                    proc = subprocess.Popen(
                        [
                            sys.executable, "-m", "seaweedfs_tpu_torch.scripts.weedload",
                            "--gen-worker", spec_path,
                            "--worker-out", out_i,
                            "--worker-index", str(i),
                        ],
                        cwd=PKG_ROOT, stdout=log_i, stderr=log_i,
                    )
                    workers.append((proc, out_i, log_i))

                # the main process mirrors the workers' phase clock and owns
                # chaos: kills/wedges land inside the chaos window every
                # worker is measuring
                delay = spec["start_at"] - time.time()
                if delay > 0:
                    time.sleep(delay)
                for phase, seconds in phases:
                    stop_chaos = threading.Event()
                    chaos_thread = None
                    if args.chaos and phase == "chaos":
                        chaos_thread = threading.Thread(
                            target=chaos_fn, args=(stop_chaos,), daemon=True
                        )
                        chaos_thread.start()
                    time.sleep(seconds)
                    stop_chaos.set()
                    if chaos_thread is not None:
                        chaos_thread.join(timeout=args.wedge_seconds + 10)

                issued = 0
                drain_deadline = time.time() + 120
                for proc, out_i, log_i in workers:
                    try:
                        rc_w = proc.wait(
                            timeout=max(5.0, drain_deadline - time.time())
                        )
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        rc_w = -9
                    log_i.close()
                    if rc_w != 0 or not os.path.exists(out_i):
                        # a dead generator invalidates the run as loudly as
                        # a lost byte — its samples are simply gone
                        lost.append({
                            "fid": None,
                            "why": f"generator worker exited rc={rc_w}",
                        })
                        continue
                    with open(out_i, encoding="utf-8") as f:
                        wout = json.load(f)
                    issued += wout["issued"]
                    rec.merge_dict(wout["cells"])
                    lost.extend(wout["lost"])
            else:
                issued = run_load(
                    args, read_fn, rec, lost, keys, cdf, klass_of, phases,
                    chaos_fn=chaos_fn if args.chaos else None,
                    put_fn=put_one if args.put_fraction > 0 else None,
                )
            guard_stop.set()
            if guard_thread is not None:
                guard_thread.join(timeout=10)
            for t in storm_threads:
                t.join(timeout=10)
            if corrupt_thread is not None:
                corrupt_stop.set()
                corrupt_thread.join(timeout=70)

            mark("load")

            # -- heal + final zero-loss verification ----------------------
            for n in nodes:
                if not args.smoke:
                    n.unwedge()
                    if not n.alive:
                        n.start()
            if args.chaos:
                time.sleep(6.0)
            for key, want in client_blobs.items():
                got = None
                for _ in range(12):
                    try:
                        got = read_fn(key)[0]
                        break
                    except Exception:  # noqa: BLE001 — post-chaos settle
                        time.sleep(1.0)
                if got is None:
                    lost.append({"fid": key, "why": "unreadable at end"})
                elif got != want:
                    lost.append({"fid": key, "why": "BYTES DIFFER"})

            mark("verify")
            if corruption_report is not None:
                # final heal verdict: every injected corruption must have
                # been detected + auto-repaired — shard bytes match the
                # .eci record again everywhere an injection landed (give
                # stragglers whose repair raced the run end one last wait)
                deadline = time.monotonic() + 60
                def _unhealed():
                    return [
                        e for e in corruption_report["injected"]
                        if not shard_clean(nodes[e["node"]], e["shard"])
                    ]
                while time.monotonic() < deadline and _unhealed():
                    time.sleep(1.0)
                for e in corruption_report["injected"]:
                    if not e.get("healed") and shard_clean(
                        nodes[e["node"]], e["shard"]
                    ):
                        e["healed"] = True
                corruption_report["all_healed"] = not _unhealed()
                corruption_report["count"] = len(corruption_report["injected"])

            # -- tracing-overhead gate (smoke): leave-it-on is a design
            # claim, so the smoke MEASURES it — interleaved trace-on vs
            # trace-off healthy reads on the same live cluster ------------
            if args.smoke and args.front == "master":
                healthy_fids = [
                    f for f in client_blobs if klass_of(f) == "healthy"
                ]
                trace_overhead = measure_trace_overhead(client, healthy_fids)

            # in-process smoke nodes SHARE the module-global stats
            # registry — scraping all three would triple-count; one node's
            # /metrics already holds the whole process's counters
            for n in (nodes[:1] if args.smoke else nodes):
                scraper.scrape(n.http, f"n{n.i}")
            if not args.smoke:
                # the in-process master's registry carries the fleet
                # repair scheduler counters (weedtpu_repair_*); smoke
                # runs share ONE process registry already scraped above
                scraper.scrape(master.http_port, "master")
            for n in (nodes[:1] if args.smoke else nodes):
                tracer.scrape(n.http)
            counters = scraper.totals
        finally:
            if client is not None:
                client.close()
            teardown = [filer_client.close] if filer_client is not None else []
            teardown += [srv.stop for srv in (s3_srv, filer_srv) if srv is not None]
            for step in teardown:
                try:
                    step()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
            for n in nodes:
                try:
                    if args.smoke:
                        n.stop()
                    else:
                        n.unwedge()
                        n.kill(hard=False)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
            master.stop()

    report = slo.assemble_report(
        rec,
        workload={
            "open_loop": True,
            "arrivals": "poisson",
            "rps": args.rps,
            "seconds": args.seconds,
            "issued": issued,
            "zipf_s": args.zipf,
            "objects": args.objects,
            "objects_by_class": by_klass,
            "dropped_shards": sorted(dropped),
            "ec_volume": ec_vid,
            "concurrency": args.concurrency,
            "procs": args.procs,
            "front": "s3" if args.front == "s3" else "master-http",
            "servers": "in-process" if args.smoke else "subprocess",
            "put_fraction": args.put_fraction,
            "puts_acked": puts_done[0],
        },
        chaos=chaos_report,
        knobs={
            name: config.env(name)
            for name in (
                "WEEDTPU_HEDGE_READS", "WEEDTPU_HEDGE_DELAY_MS",
                "WEEDTPU_COALESCE_READS", "WEEDTPU_REBUILD_MAX_INFLIGHT",
                "WEEDTPU_REBUILD_YIELD_MS", "WEEDTPU_LOOKUP_RETRIES",
                "WEEDTPU_INLINE_EC", "WEEDTPU_INLINE_EC_SEAL_BYTES",
                "WEEDTPU_INLINE_EC_DELTA",
                "WEEDTPU_READ_CACHE_MB", "WEEDTPU_READ_CACHE_TTL_S",
                "WEEDTPU_REPAIR",
            )
        },
        counters=counters,
        lost=lost,
        slo_factor=args.slo_factor,
        corruption=corruption_report,
        classes=("healthy", "ec_intact", "cached", "degraded", "put")
        if args.put_fraction > 0
        else ("healthy", "ec_intact", "cached", "degraded"),
    )
    # hot-set serving evidence: the decoded-interval cache's server-side
    # counters next to the client-observed per-class quantiles. `degraded`
    # now means READS THAT ACTUALLY DECODED (the read-class header routes
    # cache hits into `cached`), so cached-vs-decoded is a true A/B over
    # the same keys under the same load.
    cached_s = rec.merged("cached").summary()
    decoded_s = rec.merged("degraded").summary()
    cache_hits = counters.get("weedtpu_read_cache_hits_total", 0.0)
    cache_misses = counters.get("weedtpu_read_cache_misses_total", 0.0)
    report["cache"] = {
        "budget_mb": config.env("WEEDTPU_READ_CACHE_MB"),
        "ttl_s": config.env("WEEDTPU_READ_CACHE_TTL_S"),
        "hits": int(cache_hits),
        "misses": int(cache_misses),
        "hit_rate": (
            round(cache_hits / (cache_hits + cache_misses), 4)
            if cache_hits + cache_misses
            else None
        ),
        "evictions": int(counters.get("weedtpu_read_cache_evictions_total", 0.0)),
        "invalidations": int(
            counters.get("weedtpu_read_cache_invalidations_total", 0.0)
        ),
        "cached": cached_s,
        "decoded": decoded_s,
        "cached_below_decoded_p99": (
            bool(cached_s["p99"] < decoded_s["p99"])
            if cached_s["count"] and decoded_s["count"]
            else None
        ),
    }
    # tail attribution: which STAGE owns each class's latency. Embedded
    # in the SLO report (summary + slowest exemplars) and written as its
    # own report (--trace-out).
    attrib = slo.assemble_trace_attribution(
        list(tracer.traces.values()),
        classes=("healthy", "ec_intact", "cached", "degraded", "put"),
    )
    attrib["workload"] = report["workload"]
    attrib["chaos"] = report["chaos"]
    report["trace_attribution"] = attrib
    report["stage_seconds"] = stage_s
    report["counters_by_server"] = scraper.by_server
    report["server_backends"] = scraper.backends
    if trace_overhead is not None:
        report["trace_overhead"] = trace_overhead
    slo.write_trace_attribution(args.trace_out, attrib)
    slo.write_report(args.out, report)
    print(json.dumps(report, indent=1))
    if report["lost"]:
        return 1
    if args.corrupt and not report["corruption"]["all_healed"]:
        return 1  # an unhealed injection is as disqualifying as a lost byte
    if args.smoke and args.front == "master" and report["cache"]["hits"] < 1:
        # the cache-hit-rate gate: a hot zipf set over a warmed cache that
        # never hits means the decoded-interval cache is broken or off —
        # the smoke exists to catch exactly that before a real run does
        print(
            "SMOKE GATE FAILED: decoded-interval cache never hit "
            f"(hits={report['cache']['hits']} misses={report['cache']['misses']})",
            file=sys.stderr,
        )
        return 1
    if args.require_slo and not report["slo"]["ok"]:
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
