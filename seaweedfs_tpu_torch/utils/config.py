"""The port's WEEDTPU_* environment registry: only the knobs this package
reads, with the reference defaults and clamps. Unknown names raise, so a
typo'd knob fails loudly instead of reading as its default forever.

Also the servers' TOML configuration (weed/util/config.go): named files
(security.toml, ...) searched in `.`, `~/.seaweedfs_tpu/` and
`/etc/seaweedfs_tpu/`, parsed with the standard library's tomllib, and
the commented templates `scaffold` prints for them; `env_table_markdown`
renders the registry as the README's table."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tomllib
from typing import Any, Callable, Iterator, Optional

SEARCH_PATHS = [".", "~/.seaweedfs_tpu", "/etc/seaweedfs_tpu"]


def load_configuration(name: str, required: bool = False) -> dict[str, Any]:
    """`<name>.toml` from the first search path that has it; {} when none
    does (or FileNotFoundError when `required`)."""
    fname = name if name.endswith(".toml") else name + ".toml"
    for d in SEARCH_PATHS:
        path = os.path.join(os.path.expanduser(d), fname)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return tomllib.load(f)
    if required:
        raise FileNotFoundError(
            f"{fname} not found in {[os.path.expanduser(d) for d in SEARCH_PATHS]}"
        )
    return {}


def get_nested(conf: dict, dotted: str, default: Any = None) -> Any:
    """conf lookup by an 'a.b.c' path."""
    cur: Any = conf
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


SCAFFOLDS = {
    "security": '''\
# security.toml — put in ., ~/.seaweedfs_tpu/, or /etc/seaweedfs_tpu/
# JWT signing on the volume-server write path. Empty key = auth disabled.

[jwt.signing]
key = ""
expires_after_seconds = 10

# optional separate key gating reads
[jwt.signing.read]
key = ""
expires_after_seconds = 10

[guard]
# IPs allowed to bypass JWT checks
white_list = []

# TLS/mTLS for the gRPC control plane. Setting `ca` turns TLS on for every
# server and client in the process. Generate a throwaway CA + leaf pair with
#   python -c "from seaweedfs_tpu.security.tls import generate_self_signed; \\
#              print(generate_self_signed('./certs'))"
[grpc]
ca = ""
cert = ""
key = ""
require_client_auth = true    # mTLS: peers must present a CA-signed cert
# override_authority = "weedtpu-cluster"   # when certs name the cluster, not each host

# HTTPS on the HTTP data path (volume/filer/s3/webdav/iam servers); uses the
# [grpc] cert material
[https]
enabled = false
''',
    "master": '''\
# master.toml
[master.volume_growth]
copy_1 = 7
copy_2 = 6
copy_3 = 3
copy_other = 1

[master.sequencer]
type = "memory"   # memory | snowflake
''',
    "shell": '''\
# shell.toml
[cluster]
default = "localhost"

[cluster.localhost]
master = "127.0.0.1:9333"
''',
    "filer": '''\
# filer.toml — filer metadata store selection
[memory]
enabled = false

[sqlite]
enabled = true
dbFile = "./filer.db"

# from-scratch embedded log-structured store (the leveldb2-analog):
# append-only CRC-framed log + in-memory index, auto-compaction
[log]
enabled = false
dir = "./filerlog"
''',
}


def scaffold(name: str) -> Optional[str]:
    return SCAFFOLDS.get(name)


@dataclasses.dataclass(frozen=True)
class EnvVar:
    name: str
    default: Any
    doc: str
    parse: Callable[[str], Any] = int

    @property
    def type(self) -> type:
        """The knob's value type, as the registry's table names it."""
        return type(self.default)

    def value(self) -> Any:
        raw = os.environ.get(self.name)
        if raw is None or raw == "":
            return self.default
        return self.parse(raw)


def _at_least(minimum: int) -> Callable[[str], int]:
    return lambda raw: max(minimum, int(raw))


def _flag(raw: str) -> bool:
    return raw.strip().lower() in ("1", "true", "yes", "on")


def _nonneg_float(raw: str) -> float:
    return max(0.0, float(raw))


def _enum(*allowed: str) -> Callable[[str], str]:
    def parse(raw: str) -> str:
        v = raw.strip().lower()
        if v not in allowed:
            raise ValueError(f"expected one of {allowed}, got {raw!r}")
        return v

    return parse


ENV_REGISTRY: dict[str, EnvVar] = {
    v.name: v
    for v in (
        EnvVar(
            "WEEDTPU_PIPELINE_DEPTH", 2,
            "Inflight depth of the streaming encode/rebuild pipelines "
            "(clamped to >= 1); costs (depth+1) staging buffers.",
            _at_least(1),
        ),
        EnvVar(
            "WEEDTPU_REBUILD_PREFETCH_BATCHES", 2,
            "Batches ahead of the reading cursor the rebuild pipeline asks "
            "its slab sources to prefetch (clamped to >= 1).",
            _at_least(1),
        ),
        EnvVar(
            "WEEDTPU_EVIDENCE_MAX_AGE_DAYS", 120.0,
            "Committed on-chip measurement evidence older than this no longer "
            "moves the kernel choice away from int8.",
            float,
        ),
        EnvVar(
            "WEEDTPU_MESH_SHAPE", "",
            "dp x sp axis shape of the mesh backend's device mesh, as `DPxSP` "
            "(e.g. `2x2`). Empty/`auto` resolves from the best achievable shape "
            "in committed GPU_MULTICHIP_r*.json evidence, falling back to "
            "(devices/2) x 2 (or devices x 1 below 4 devices).",
            str,
        ),
        EnvVar(
            "WEEDTPU_MESH_REBUILD", "ring",
            "Distributed-rebuild formulation of the mesh backend: `ring` hands "
            "one resident survivor block per card along the ring (peak per-card "
            "memory = one block), `alltoall` regroups shard-major survivors to "
            "byte-major with one all_to_all of tile copies. Both are "
            "byte-identical to the single-device decode.",
            _enum("ring", "alltoall"),
        ),
        EnvVar(
            "WEEDTPU_DECODE_MATRIX_CACHE", 512,
            "LRU cap on cached decode matrices.",
        ),
        EnvVar(
            "WEEDTPU_BACKEND", "",
            "Operator override of the encoder factory for callers that name no "
            "backend: one of cuda | torch | native | xorsched | mesh | auto. "
            "native and xorsched are the host codecs (csrc/gf_host.cc) and run "
            "on the CPU whatever the device; auto runs the measured decision "
            "(on the CPU, committed same-host CPU bench evidence). Empty keeps "
            "the port's default (the card's kernel, or the plain version with "
            "device cpu), not auto. Explicit new_encoder(backend=...) callers "
            "are never overridden.",
            str,
        ),
        EnvVar(
            "WEEDTPU_XORSCHED_TILE_KB", 4,
            "Width-axis tile of the xorsched executors, in KB per shard: each "
            "tile keeps the whole bit-plane slot frame (inputs + grouped temps + "
            "outputs) cache-resident while the XOR program replays. 4 KB keeps "
            "the frame L1-sized; clamped to >= 1.",
            _at_least(1),
        ),
        EnvVar(
            "WEEDTPU_XORSCHED_CACHE", 64,
            "Entry cap of the compiled XOR-schedule LRU (keyed by matrix bytes "
            "+ tile geometry, like the decode-matrix memo). A compile takes tens "
            "of milliseconds (a 10+4 parity) to about a second (a 20+4 decode "
            "of four shards) and programs are KBs, so a small cap covers every "
            "live (geometry, erasure-pattern) pair; clamped to >= 1.",
            _at_least(1),
        ),
        EnvVar(
            "WEEDTPU_XORSCHED_THREADS", 1,
            "Worker threads of the width-parallel native xorsched executor: the "
            "fused block-diagonal decode flattens to independent (block, "
            "width-tile) tasks, spread across this many threads. 0 means "
            "hardware concurrency (resolved natively); 1 keeps the "
            "single-stream path; clamped to >= 0.",
            _at_least(0),
        ),
        EnvVar(
            "WEEDTPU_V", 0,
            "glog verbosity level: glog.V(n) call sites with n <= this emit.",
        ),
        EnvVar(
            "WEEDTPU_READ_CACHE_MB", 64.0,
            "Byte budget (MiB) of the process-wide decoded-interval read cache; "
            "0 disables it (no lookups, no counters). Clamped to >= 0.",
            _nonneg_float,
        ),
        EnvVar(
            "WEEDTPU_READ_CACHE_TTL_S", 30.0,
            "Age (seconds) after which a cached decoded interval expires and the "
            "next read decodes again; 0 means no expiry by age. Clamped to >= 0.",
            _nonneg_float,
        ),
        EnvVar(
            "WEEDTPU_COALESCE_READS", True,
            "Single-flight coalescing of concurrent degraded decodes of the same "
            "(shard, interval): one leader decodes, waiters get copies.",
            _flag,
        ),
        EnvVar(
            "WEEDTPU_HEDGE_READS", True,
            "Hedged survivor fetches: once a fetch has run past the peer's hedge "
            "delay, launch one backup against another holder; first success wins.",
            _flag,
        ),
        EnvVar(
            "WEEDTPU_TRACE_CHUNK", 4 * 1024 * 1024,
            "Projection-window sub-range size (bytes) a TraceSlabSource fetches "
            "per request (clamped to >= 64 KiB).",
            _at_least(64 * 1024),
        ),
        EnvVar(
            "WEEDTPU_SLAB_FANOUT", 4,
            "Concurrent sub-range fetches per remote slab or projection source, "
            "spread across a shard's holders by least-inflight pick (clamped to >= 1).",
            _at_least(1),
        ),
        EnvVar(
            "WEEDTPU_REBUILD_FUSE", "on",
            "'on' fuses every signature group of a rebuild_ec_files_batch call into "
            "one block-diagonal decode pipeline; 'off' runs one pipeline per group.",
            _enum("on", "off"),
        ),
        EnvVar(
            "WEEDTPU_HEDGE_DELAY_MS", 0.0,
            "Fixed hedge delay (ms); 0 derives it per peer from the latency "
            "estimate in the suspicion registry.",
            float,
        ),
        EnvVar(
            "WEEDTPU_INLINE_EC_SEAL_BYTES", 0,
            "Auto-seal threshold for inline-EC ingest: an IngestManager seals a "
            "volume whose .dat crosses this many bytes (0 = never auto-seal).",
            _at_least(0),
        ),
        EnvVar(
            "WEEDTPU_INLINE_EC_LARGE_BLOCK", 1024 * 1024 * 1024,
            "Large stripe-block size (bytes) the inline-EC builders encode with; "
            "must match the seal-time geometry (clamped to >= 4096).",
            _at_least(4096),
        ),
        EnvVar(
            "WEEDTPU_INLINE_EC_SMALL_BLOCK", 1024 * 1024,
            "Small (tail) stripe-block size (bytes) for inline-EC ingest "
            "(clamped to >= 512).",
            _at_least(512),
        ),
        EnvVar(
            "WEEDTPU_INLINE_EC_DELTA", True,
            "Delta parity updates for overwrites inside already-encoded inline "
            "rows (parity' = parity ^ G_col * (old ^ new)); off = such an "
            "overwrite breaks the builder and the seal re-encodes warm.",
            _flag,
        ),
        EnvVar(
            "WEEDTPU_CONVERT_BATCH", 64 * 1024 * 1024,
            "Device-batch budget (bytes) of the geometry-conversion pipeline "
            "(clamped to >= 1 MiB).",
            _at_least(1024 * 1024),
        ),
        EnvVar(
            "WEEDTPU_CONVERT_JOURNAL_MB", 64.0,
            "MB of converted output between fsync'd .ecc journal watermarks "
            "(clamped to > 0).",
            lambda raw: max(0.001, float(raw)),
        ),
        EnvVar(
            "WEEDTPU_CONVERT_VERIFY", True,
            "Re-read every converted shard from disk against the streamed CRCs "
            "before cut-over may retire the old geometry.",
            _flag,
        ),
        EnvVar(
            "WEEDTPU_INLINE_EC", "off",
            "Inline-EC ingest (encode-on-write): `on` polls every volume's "
            "stripe builder after each acked append, so a sealing volume is "
            "born EC'd; `off` keeps EC a warm-storage conversion.",
            _enum("on", "off"),
        ),
        EnvVar(
            "WEEDTPU_INLINE_EC_SPREAD", "off",
            "Inline-ingest parity spreading: `on` streams each parity shard's "
            "encoded rows to its placement-planned holder while the volume "
            "still ingests; any spread failure keeps that shard local. "
            "Requires WEEDTPU_INLINE_EC=on.",
            _enum("on", "off"),
        ),
        EnvVar(
            "WEEDTPU_LOOKUP_RETRIES", 2,
            "Bounded retries (decorrelated jitter) of the single-flight master "
            "shard-location lookup before it fails its waiters (clamped to >= 0).",
            _at_least(0),
        ),
        EnvVar(
            "WEEDTPU_PLACEMENT_MAX_PER_DOMAIN", 0,
            "Override of the failure-domain placement cap (shards of one "
            "stripe a rack may hold); 0 = the volume's parity count m.",
            _at_least(0),
        ),
        EnvVar(
            "WEEDTPU_REBUILD_MAX_INFLIGHT", 8,
            "Token gate on concurrent VolumeEcShardSlabRead rebuild streams per "
            "volume server (clamped to >= 1): a rebuild storm queues instead "
            "of starving foreground interval reads.",
            _at_least(1),
        ),
        EnvVar(
            "WEEDTPU_REBUILD_YIELD_MS", 0.0,
            "Yield (ms) a rebuild slab stream sleeps between chunks, ceding "
            "the GIL and the disk to foreground reads. 0 = off.",
            float,
        ),
        EnvVar(
            "WEEDTPU_REPAIR", "off",
            "Master-side fleet repair scheduler: `on` enumerates every stripe "
            "left under-replicated by a dead/quarantined holder, ranks by "
            "remaining redundancy (2-missing strictly before 1-missing, ties by "
            "stripe bytes then single-domain exposure), and drives batched "
            "remote rebuilds through the rebuild admission lane; `off` (default) "
            "leaves mass repair to the operator's ec.rebuild.",
            _enum("on", "off"),
        ),
        EnvVar(
            "WEEDTPU_REPAIR_MAX_INFLIGHT", 2,
            "Cluster-wide cap on concurrently-running batched rebuild dispatches "
            "from the fleet repair scheduler (clamped to >= 1) — the scheduler's "
            "own pacing budget on top of each holder's "
            "WEEDTPU_REBUILD_MAX_INFLIGHT admission gate.",
            _at_least(1),
        ),
        EnvVar(
            "WEEDTPU_REPAIR_BATCH", 8,
            "How many same-priority-class stripes one repair dispatch may carry "
            "to a single rebuild target (clamped to >= 1). The target fuses "
            "equal missing-signature volumes into shared decode dispatches, so "
            "bigger batches amortize device/staging setup across volumes.",
            _at_least(1),
        ),
        EnvVar(
            "WEEDTPU_REPAIR_SCAN_S", 30.0,
            "Seconds between full under-replication scans of the master's EC "
            "registry. Death signals (reaped nodes, shrinking heartbeats, "
            "confirmed peer-unreachable reports) trigger an immediate scan on "
            "top of this cadence.",
            float,
        ),
        EnvVar(
            "WEEDTPU_REPAIR_SETTLE_S", 2.0,
            "Correlation window the repair scheduler waits after a death signal "
            "before dispatching: a rack's nodes die together but their heartbeat "
            "silences stagger, and ranking before the dust settles would start "
            "1-missing repairs that should have been 2-missing.",
            float,
        ),
        EnvVar(
            "WEEDTPU_REPAIR_DEAD_S", 15.0,
            "Heartbeat-silence age after which a holder that peers ALSO report "
            "unreachable is treated as dead for repair purposes (unreported "
            "holders die at 4x this, bounded below by 60 s, so a long GC pause "
            "alone never triggers a mass rebuild).",
            float,
        ),
        EnvVar(
            "WEEDTPU_REPAIR_BACKOFF", 2.0,
            "Base seconds of the per-stripe exponential backoff after a repair "
            "dispatch is refused (503/RESOURCE_EXHAUSTED from the admission "
            "lane) or fails in transport; doubles per failure, capped at 12x.",
            float,
        ),
        EnvVar(
            "WEEDTPU_REPAIR_REPORT_FAILURES", 3,
            "Consecutive unreachable-peer failures on the degraded-read and "
            "rebuild paths before a volume server names that peer in its "
            "heartbeat (clamped to >= 1; a success resets the count).",
            _at_least(1),
        ),
        EnvVar(
            "WEEDTPU_SCRUB", "off",
            "Background shard scrubber: `on` starts a per-volume-server thread "
            "that CRC32-verifies every mounted EC shard against its .eci "
            "record, quarantines failures and repairs them; `off` leaves "
            "verification to VolumeEcShardsVerify.",
            _enum("on", "off"),
        ),
        EnvVar(
            "WEEDTPU_SCRUB_RATE_MB", 64.0,
            "Scrub read-rate cap in MB/s per volume server (rolling 1 s "
            "window); 0 = unthrottled.",
            float,
        ),
        EnvVar(
            "WEEDTPU_SCRUB_CHUNK", 4 * 1024 * 1024,
            "Scrub chunk size in bytes, the unit of admission-gated, rate-"
            "metered CRC folding (clamped to >= 64 KiB).",
            _at_least(64 * 1024),
        ),
        EnvVar(
            "WEEDTPU_SCRUB_INTERVAL", 30.0,
            "Seconds the scrubber sleeps between full passes over the mounted "
            "EC volumes.",
            float,
        ),
        EnvVar(
            "WEEDTPU_SCRUB_CURSOR", "",
            "Path of the fsync'd scrub cursor file (scan progress and pending "
            "quarantine entries). Empty = `.scrub_cursor.json` in the server's "
            "first storage directory.",
            str,
        ),
        EnvVar(
            "WEEDTPU_SCRUB_REPAIR_BACKOFF", 5.0,
            "Base backoff in seconds between repair attempts for one "
            "quarantined shard (doubles per failure, capped at 12x the base).",
            float,
        ),
        EnvVar(
            "WEEDTPU_SCRUB_MAX_REPAIRS", 1,
            "Concurrent automatic shard repairs per volume server (clamped to "
            ">= 1).",
            _at_least(1),
        ),
        EnvVar(
            "WEEDTPU_TRACE_REPAIR", "auto",
            "Trace-repair projections for distributed rebuilds: `on` fetches "
            "projections wherever holders advertise them, `off` forces full "
            "survivor slabs (and stops serving projections), `auto` also "
            "declines them when the plan would not move fewer bytes.",
            _enum("on", "off", "auto"),
        ),
        EnvVar(
            "WEEDTPU_BENCH_RPC_DELAY_MS", 0.0,
            "Per-RPC server-side sleep (ms) on the EC read and slab streams, "
            "modelling network RTT on loopback hosts. 0 = off.",
            float,
        ),
        EnvVar(
            "WEEDTPU_WIRE", "json",
            "Process-wide RPC wire selection: `proto` flips every unary JSON "
            "method in the pinned schema to binary protobuf; anything else means "
            "JSON. All processes of a cluster must agree.",
            lambda raw: "proto" if raw.strip().lower() == "proto" else "json",
        ),
        EnvVar(
            "WEEDTPU_TRACE", "on",
            "Request tracing: `on` records context-local span trees into the "
            "bounded per-process ring and propagates trace ids across RPC "
            "metadata and the X-Weedtpu-Trace HTTP header; `off` collapses every "
            "trace call site to a no-op.",
            _enum("on", "off"),
        ),
        EnvVar(
            "WEEDTPU_TRACE_SAMPLE", 1.0,
            "Probability a completed non-tail trace enters the sampled ring "
            "(error traces and the N slowest per (kind, class) are always "
            "retained). Clamped to [0, 1].",
            lambda raw: min(1.0, max(0.0, float(raw))),
        ),
        EnvVar(
            "WEEDTPU_TRACE_RING", 256,
            "Capacity of the per-process sampled-trace FIFO (error and slowest "
            "traces live in their own bounded structures). Clamped to >= 8.",
            _at_least(8),
        ),
        EnvVar(
            "WEEDTPU_TRACE_SLOWEST", 5,
            "How many slowest traces per (kind, class) the ring always retains, "
            "independent of sampling (clamped to >= 1).",
            _at_least(1),
        ),
        EnvVar(
            "WEEDTPU_TRACE_SEED", 0,
            "Seed for the trace-sampling RNG (deterministic retention for tests "
            "and replays); 0 = OS entropy.",
        ),
        EnvVar(
            "WEEDTPU_FSREPLAY_MAX_PREFIXES", 48,
            "Crash-prefix replay budget per recorded workload: at most this many "
            "prefixes of the op trace are materialized and driven through the "
            "real resume entrypoints (evenly sampled, endpoints always kept) so "
            "the tier-1 replay gate stays inside its time budget. <=0 = every "
            "prefix.",
        ),
    )
}


def env(name: str) -> Any:
    """Parsed value of a registered knob (its default when unset/empty)."""
    var: Optional[EnvVar] = ENV_REGISTRY.get(name)
    if var is None:
        raise KeyError(f"{name} is not in the WEEDTPU env registry")
    return var.value()


def setdefault_env(knobs: dict[str, str]) -> None:
    """Set each registered knob in `knobs` that the environment does not
    hold yet (`os.environ.setdefault`): the settings a harness gives the
    server processes it starts, which a value the caller exported keeps.
    An unregistered name raises KeyError."""
    for name in knobs:
        if name not in ENV_REGISTRY:
            raise KeyError(f"{name} is not in the WEEDTPU env registry")
    for name, value in knobs.items():
        os.environ.setdefault(name, value)


def set_env(name: str, value: Optional[str]) -> None:
    """Set a registered knob for this process and the ones it starts
    (None or "" unsets it). An unregistered name raises KeyError."""
    if name not in ENV_REGISTRY and name not in HARNESS_REGISTRY:
        raise KeyError(f"{name} is not in the WEEDTPU env registry")
    if value is None or value == "":
        os.environ.pop(name, None)
    else:
        os.environ[name] = str(value)


@contextlib.contextmanager
def override_env(name: str, value: Optional[str]) -> Iterator[None]:
    """`set_env(name, value)` for the body, then the environment's own
    value again (or none): a harness that models a knob in-process leaves
    the next caller what it found, whatever the body set meanwhile."""
    if name not in ENV_REGISTRY and name not in HARNESS_REGISTRY:
        raise KeyError(f"{name} is not in the WEEDTPU env registry")
    prev = os.environ.get(name)
    set_env(name, value)
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


#: the measurement harness's knobs (`bench.py`, `scripts/device_window.py`),
#: under the reference bench's names. They tune a measurement run, not a
#: server, so they stay out of ENV_REGISTRY and the README's table.
HARNESS_REGISTRY: dict[str, EnvVar] = {
    v.name: v
    for v in (
        EnvVar("BENCH_MODE", "", "The mode `python -m seaweedfs_tpu_torch.bench` runs; "
               "empty runs the staged main.", str),
        EnvVar("BENCH_WATCHDOG_SECS", 900, "The staged main's whole budget, seconds."),
        EnvVar("BENCH_PROBE_SECS", 75, "The device probe child's timeout, seconds."),
        EnvVar("BENCH_CPU_SECS", 420, "The cpu suite child's timeout, seconds."),
        EnvVar("BENCH_TRACE_DIR", "", "Where the device mode writes its torch.profiler "
               "trace; empty: no trace.", str),
        EnvVar("WINDOW_BUDGET_S", 1500.0, "The device window's budget, seconds: the sweep "
               "runs only with more than 600 s of it left.", float),
    )
}


def harness_env(name: str) -> Any:
    """Parsed value of a registered harness knob (its default when unset)."""
    var: Optional[EnvVar] = HARNESS_REGISTRY.get(name)
    if var is None:
        raise KeyError(f"{name} is not in the harness env registry")
    return var.value()


def env_table_markdown() -> str:
    """The README `WEEDTPU_*` table, generated from the registry."""
    lines = [
        "| Variable | Type | Default | Description |",
        "| --- | --- | --- | --- |",
    ]
    for name in sorted(ENV_REGISTRY):
        var = ENV_REGISTRY[name]
        default = "(empty)" if var.default == "" else f"`{var.default}`"
        doc = " ".join(var.doc.split()).replace("|", "\\|")
        lines.append(
            f"| `{name}` | {var.type.__name__} | {default} | {doc} |"
        )
    return "\n".join(lines) + "\n"
