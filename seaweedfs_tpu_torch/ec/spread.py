"""Inline-ingest parity spreading — stream parity rows to their
placement-planned eventual holders WHILE the volume is still taking
writes.

Without spreading, an inline-sealed volume is born with ALL k+m shards
on its owner: cut-over to a spread layout is a later bulk copy, and
until then one node failure risks the whole stripe. With
WEEDTPU_INLINE_EC_SPREAD=on the owner tees each parity shard's encoded
rows to a target chosen by the failure-domain planner
(`placement.plan_parity_targets`) as the rows land in the local
partials: `VolumeEcShardPartialWrite` appends into the target's
`.ecNN.inp` (invisible to shard discovery), and at seal time
`VolumeEcShardSpreadCommit` truncates, CRC-verifies against the .eci
record, renames the partial into a real shard, pulls the index files
from the owner, and mounts — so the cut-over ships only the small tail
and the owner never hosts all k+m.

Spreading is STRICTLY an optimization: every parity byte also lands in
the owner's local partial exactly as before, any ship/commit failure
marks that shard's spread broken and the seal keeps the local copy, and
delta parity patches below the shipped watermark simply mark the range
dirty for an idempotent absolute-offset re-ship. Zero new failure modes
on the ingest path.
"""

from __future__ import annotations

import threading
import zlib

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.obs import trace as trace_mod
from seaweedfs_tpu_torch.pb import VOLUME_SERVICE

#: one partial-write RPC's payload bound (b64-inflated on the JSON wire)
SHIP_CHUNK = 1024 * 1024
#: per-RPC deadline — a slow target breaks the spread (local fallback),
#: never stalls the encoder worker behind a wedged peer
SHIP_TIMEOUT = 10.0


class ShardSpreadState:
    __slots__ = ("shard_id", "addr", "shipped", "dirty", "broken", "committed")

    def __init__(self, shard_id: int, addr: str):
        self.shard_id = shard_id
        self.addr = addr  # target grpc host:port
        self.shipped = 0  # bytes [0, shipped) already at the target
        self.dirty: list[tuple[int, int]] = []  # delta-patched ranges to re-ship
        self.broken = False
        self.committed = False


class SpreadSession:
    """One ingesting volume's parity tee. Methods are called from the
    ingest encoder worker (poll) and the seal path; a lock serializes
    them against the delta-patch notifications arriving from the
    builder's overwrite path."""

    def __init__(
        self,
        vid: int,
        collection: str,
        base: str,
        targets: dict[int, str],
        pool,
        data_shards: int,
        large_block: int,
    ):
        self.vid = vid
        self.collection = collection
        self.base = base
        self.pool = pool  # rpc.ClientPool (shared with the server's peers)
        self.data_shards = int(data_shards)
        self.large = int(large_block)
        self._lock = threading.Lock()
        self.shards: dict[int, ShardSpreadState] = {
            sid: ShardSpreadState(sid, addr) for sid, addr in targets.items()
        }

    # -- builder hooks -------------------------------------------------------

    def note_patch(self, shard_id: int, pos: int, length: int) -> None:
        """A delta parity update rewrote [pos, pos+length) of a parity
        partial. The range is ALWAYS marked dirty — a concurrent poll()
        may already have read the pre-patch bytes for an offset past
        `shipped` without having advanced the watermark yet, so gating
        on `pos < shipped` would drop exactly those patches. Re-shipping
        an unshipped (or twice-shipped) range is an idempotent
        absolute-offset write; deltas are rare, the redundancy is
        cheap."""
        with self._lock:
            st = self.shards.get(shard_id)
            if st is None or st.broken:
                return
            st.dirty.append((pos, length))

    def poll(self, encoded_rows: int) -> None:
        """Ship each parity shard's new rows [shipped, encoded_rows*large)
        plus any dirty ranges, reading from the owner's local partial.
        Failures mark just that shard broken — the seal keeps its local
        copy and the other targets keep receiving."""
        limit = int(encoded_rows) * self.large
        for st in list(self.shards.values()):
            if st.broken or st.committed:
                continue
            with self._lock:
                dirty, st.dirty = st.dirty, []
                start = st.shipped
            from seaweedfs_tpu_torch.ec import ingest as ingest_mod

            try:
                # one open, no exists-check first: the seal may rename the
                # partial into its final shard at any moment, also between
                # a check and an open
                f = open(ingest_mod.part_path(self.base, st.shard_id), "rb")
            except FileNotFoundError:
                # renamed: finalize() owns the tail from here — NOT a
                # failure (marking broken here would undo the whole
                # spread in the poll/seal race window)
                continue
            try:
                with f:
                    for off, length in dirty:
                        f.seek(off)
                        self._ship(st, off, f.read(length))
                    pos = start
                    while pos < limit:
                        f.seek(pos)
                        chunk = f.read(min(SHIP_CHUNK, limit - pos))
                        if not chunk:
                            break
                        self._ship(st, pos, chunk)
                        pos += len(chunk)
                with self._lock:
                    st.shipped = max(st.shipped, pos)
            except Exception:  # noqa: BLE001 — spread is best-effort
                st.broken = True

    def _ship(self, st: ShardSpreadState, offset: int, data: bytes) -> None:
        import base64 as _b64

        self.pool.get(st.addr).call(
            VOLUME_SERVICE,
            "VolumeEcShardPartialWrite",
            {
                "volume_id": self.vid,
                "collection": self.collection,
                "shard_id": st.shard_id,
                "offset": int(offset),
                "data": _b64.b64encode(data).decode(),
            },
            timeout=SHIP_TIMEOUT,
        )
        stats.InlineEcSpreadBytes.inc(len(data))

    # -- seal ----------------------------------------------------------------

    def finalize(
        self, source_grpc: str, shard_crcs, shard_size: int
    ) -> list[int]:
        """Seal cut-over: ship each unbroken target its tail (reading the
        FINAL shard files — the partials were just renamed into place),
        then commit (truncate to size, CRC-verify vs .eci, rename, pull
        index files, mount). Returns the parity shard ids now hosted
        remotely; the caller unlinks/unmounts those locally. Any failure
        leaves that shard local — never both-or-neither."""
        from seaweedfs_tpu_torch.ec import stripe

        done: list[int] = []
        for st in list(self.shards.values()):
            if st.broken:
                continue
            try:
                with trace_mod.span("ingest.spread.commit", shard=st.shard_id):
                    with open(
                        stripe.shard_file_name(self.base, st.shard_id), "rb"
                    ) as f:
                        with self._lock:
                            dirty, st.dirty = st.dirty, []
                            pos = st.shipped
                        for off, length in dirty:
                            f.seek(off)
                            self._ship(st, off, f.read(length))
                        while pos < shard_size:
                            f.seek(pos)
                            chunk = f.read(min(SHIP_CHUNK, shard_size - pos))
                            if not chunk:
                                break
                            self._ship(st, pos, chunk)
                            pos += len(chunk)
                    resp = self.pool.get(st.addr).call(
                        VOLUME_SERVICE,
                        "VolumeEcShardSpreadCommit",
                        {
                            "volume_id": self.vid,
                            "collection": self.collection,
                            "shard_id": st.shard_id,
                            "size": int(shard_size),
                            "crc32": int(shard_crcs[st.shard_id]) & 0xFFFFFFFF,
                            "source_data_node": source_grpc,
                            "mount": True,
                        },
                        timeout=60,
                    )
                if resp.get("mounted"):
                    st.committed = True
                    stats.InlineEcSpreadCommits.labels("ok").inc()
                    done.append(st.shard_id)
                else:
                    st.broken = True
                    stats.InlineEcSpreadCommits.labels("failed").inc()
            except Exception:  # noqa: BLE001 — keep the shard local
                st.broken = True
                stats.InlineEcSpreadCommits.labels("failed").inc()
        return done

    def abort(self) -> None:
        """Discard remote partials (size=0 commit = delete the .inp) —
        called when the builder aborts or a warm/shell seal supersedes
        the spread."""
        for st in list(self.shards.values()):
            if st.committed:
                continue
            try:
                self.pool.get(st.addr).call(
                    VOLUME_SERVICE,
                    "VolumeEcShardSpreadCommit",
                    {
                        "volume_id": self.vid,
                        "collection": self.collection,
                        "shard_id": st.shard_id,
                        "size": 0,  # contract: 0 = discard the partial
                        "crc32": 0,
                        "source_data_node": "",
                        "mount": False,
                    },
                    timeout=SHIP_TIMEOUT,
                )
            except Exception:  # noqa: BLE001 — orphan .inp on a dead peer
                pass  # is invisible to discovery and tiny; best-effort


def local_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc
