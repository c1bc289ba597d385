"""EcVolume: the serving-side view of one EC volume's shard set, the
read path of upstream's weed/storage/erasure_coding/ec_volume.go and
weed/storage/store_ec.go (ReadEcShardNeedle, readEcShardIntervals,
recoverOneRemoteEcShardInterval).

Needle lookup is a binary search of the sorted .ecx, loaded once into a
numpy structured array. Interval reads are delegated to the volume's
ReadPlanner (`read_planner.py`), which owns the per-interval decision
tree: local shard files, the decoded-interval cache, the injected remote
reader (capped, hedged, suspicion-laddered), and reconstruction from >= k
surviving shards on the volume's Encoder: the degraded read. This module
keeps the storage-shaped state: index, shard handles, quarantine registry,
geometry, and the deletion journal.

The default encoder is the factory's (`new_encoder()`): it runs on the
card and raises without one. Pass `Encoder(10, 4, device="cpu")` for the
plain version.
"""

from __future__ import annotations

import os
import threading
import zlib
from typing import Callable, Optional

import numpy as np

from seaweedfs_tpu_torch.ec import convert as convert_mod
from seaweedfs_tpu_torch.ec import locate as locate_mod
from seaweedfs_tpu_torch.ec import read_planner as read_planner_mod
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.ec import suspicion as suspicion_mod
from seaweedfs_tpu_torch.ec.constants import (
    ERASURE_CODING_LARGE_BLOCK_SIZE,
    ERASURE_CODING_SMALL_BLOCK_SIZE,
)

# the typed read errors and the coalesce slot live in read_planner with the
# decision tree; re-exported here, where callers import them from
from seaweedfs_tpu_torch.ec.read_planner import (  # noqa: F401 — re-exports
    EcDegradedReadError,
    EcDegradedReadTimeout,
    EcNoViableHolders,
    EcShardCorrupt,
    _CoalesceSlot,
)
from seaweedfs_tpu_torch.obs import trace as trace_mod
from seaweedfs_tpu_torch.ops.rs_codec import Encoder, new_encoder
from seaweedfs_tpu_torch.storage import idx as idx_mod
from seaweedfs_tpu_torch.storage import types

# remote_reader(shard_id, offset, size) -> bytes | None
RemoteReader = Callable[[int, int, int], Optional[bytes]]


class NeedleNotFound(KeyError):
    pass


class NeedleDeleted(Exception):
    pass


class EcGeometryError(ValueError):
    """The on-disk shard set contradicts the .eci-recorded geometry —
    shard ids past the recorded total, or a shard file longer than the
    layout allows. Mounting anyway would silently mis-map every interval
    (before geometry validation, a wrong-geometry shard set was only
    caught by CRC luck on the first degraded read). Typed so the volume
    server can refuse the mount loudly and discovery can skip the volume
    instead of serving garbage."""

    def __init__(self, msg: str, base: str = "", details: Optional[dict] = None):
        super().__init__(msg)
        self.base = base
        #: machine-readable mismatch description (shard ids / sizes)
        self.details = dict(details or {})


class EcVolume:
    def __init__(
        self,
        base_file_name: str,
        encoder: Optional[Encoder] = None,
        large_block_size: int = ERASURE_CODING_LARGE_BLOCK_SIZE,
        small_block_size: int = ERASURE_CODING_SMALL_BLOCK_SIZE,
        remote_reader: Optional[RemoteReader] = None,
        version: int = 3,
        shard_size: Optional[int] = None,
        warm_on_mount: bool = True,
        ecj_compact_threshold: int = 1 << 20,
        recover_fetch_parallelism: int = 8,
        recover_fetch_deadline: float = 30.0,
        recover_holder_timeout: float = 30.0,
        recover_holder_backoff: float = 30.0,
        recover_suspect_after: float = 5.0,
        suspicion: Optional[suspicion_mod.HolderSuspicion] = None,
    ):
        self.base = base_file_name
        self.encoder = encoder or new_encoder()
        self.remote_reader = remote_reader
        self.version = version
        # degraded-read survivor fan-out (lazily built: most volumes never
        # take a reconstructing read, and a pool per mount would leak threads)
        self.recover_fetch_parallelism = recover_fetch_parallelism
        self.recover_fetch_deadline = recover_fetch_deadline
        # per-HOLDER cap + suspicion window: a WEDGED holder (SIGSTOPped
        # process, dead NIC — it neither answers nor errors) is cut at
        # `recover_holder_timeout` per attempt, then skipped entirely for
        # `recover_holder_backoff` seconds, so one wedged peer costs the
        # ladder ONE capped attempt — not a per-read stall — and the
        # serving p50 returns to healthy levels until the window expires.
        # The cap default (30 s) deliberately exceeds the volume server's
        # remote_reader internals (per-holder 10 s transport timeout x a
        # couple of replica holders): a reader mid-failover to a healthy
        # replica must never be aborted and suspected by this layer. The
        # cap's hard cut matters for readers WITHOUT internal timeouts.
        # `recover_suspect_after` is the complementary soft signal: a
        # remote fetch that runs at least this long and still yields
        # NOTHING (the shape of a reader whose internal timeout swallowed
        # a wedged peer) marks the shard suspect — a genuine miss (shard
        # simply absent) answers None fast and is never suspected.
        self.recover_holder_timeout = recover_holder_timeout
        self.recover_holder_backoff = recover_holder_backoff
        self.recover_suspect_after = recover_suspect_after
        # suspicion state lives in a PROCESS-WIDE registry keyed by peer
        # identity when the reader can name peers (see _holder_key): a
        # wedged peer serving many volumes costs one capped attempt
        # process-wide, not one per volume
        self._suspicion = suspicion if suspicion is not None else suspicion_mod.GLOBAL
        # the planner owns the per-interval decision tree (read ladder,
        # coalescing, hedging, fetch pool, decoded-interval cache rung);
        # it reads this volume's mutable collaborators live
        self.planner = read_planner_mod.ReadPlanner(self)
        # recorded stripe geometry (.eci) wins over constructor defaults —
        # opening shards with the wrong geometry would mis-map every interval
        info = stripe.read_ec_info(base_file_name)
        if info is not None:
            self.large = int(info["large_block_size"])
            self.small = int(info["small_block_size"])
        else:
            self.large = large_block_size
            self.small = small_block_size
        # code geometry: recorded in the .eci for geometry-flexible volumes
        # (ec.convert targets), implied legacy 10+4 otherwise. The serving
        # encoder must MATCH it — a caller-supplied encoder of a different
        # geometry is replaced by a same-backend sibling, never trusted to
        # decode a layout it does not describe.
        self.geometry = stripe.geometry_from_info(info)
        self.data_shards = self.geometry.data_shards
        self.total_shards = self.geometry.total_shards
        self.encoder = stripe.encoder_for_info(info, self.encoder)

        # mount-time journal compaction: a delete-heavy volume's .ecj is
        # folded into .ecx tombstones once it crosses the threshold, so the
        # journal (and its replay cost) stays bounded over the volume's life
        ecj_path = base_file_name + ".ecj"
        if (
            ecj_compact_threshold
            and os.path.exists(ecj_path)
            and os.path.getsize(ecj_path) >= ecj_compact_threshold
        ):
            stripe.compact_ecj(base_file_name)

        with open(base_file_name + ".ecx", "rb") as f:
            self._index = idx_mod.index_entries_array(f.read())
        self._keys = self._index["key"]
        self._deleted = set(stripe.read_ecj(base_file_name))

        self._shard_files = {}
        # shards pulled out of serving by failed integrity verification:
        # {shard_id: reason} ("corrupt" | "truncated" | "missing"). The
        # serving handle is closed (reads route local -> remote ->
        # reconstruct around it) and VolumeStatus surfaces the entry so
        # rebuilding peers and operators see WHY the shard is gone.
        self.quarantined: dict[int, str] = {}
        self.shard_size = shard_size or 0
        try:
            self._validate_geometry(info)
            for s in range(self.total_shards):
                p = stripe.shard_file_name(base_file_name, s)
                if os.path.exists(p):
                    # serving handles owned by the volume, closed in close()
                    self._shard_files[s] = open(p, "rb")
                    self.shard_size = max(self.shard_size, os.path.getsize(p))
        except BaseException:
            for f in self._shard_files.values():
                f.close()
            self._shard_files.clear()
            raise
        if self.shard_size == 0 and remote_reader is not None and len(self._index):
            # No local shard to size the volume from: large-vs-small row math
            # would silently mis-map offsets, so demand an explicit size.
            raise ValueError(
                "EcVolume with no local shards needs an explicit shard_size "
                "to locate blocks correctly"
            )
        # The locate math only needs the large-row count; shard_size * D is a
        # consistent stand-in for the true .dat size (ev.DatFileSize analog);
        # the recorded exact size wins when available.
        if info is not None:
            self.dat_file_size = int(info["dat_size"])
        else:
            self.dat_file_size = self.shard_size * self.data_shards

        # resident hot path: build the serving path's decode matrices and
        # launch the bucketed reconstruct shapes once in the background, so
        # the first degraded client read is warm; join `warm_thread` to
        # wait for it (tests, chip_smoke.py)
        self.warm_thread: Optional[threading.Thread] = None
        if warm_on_mount:
            self.warm_thread = threading.Thread(target=self._warm, daemon=True)
            self.warm_thread.start()

    def _validate_geometry(self, info: Optional[dict]) -> None:
        """Mount-time shard-count/geometry consistency gate: the local
        shard set must FIT the .eci-recorded (or legacy-implied) geometry.
        Stray shard ids past the recorded total, or a shard file longer
        than the recorded layout allows, mean the files and the sidecar
        describe different codes — reading on would silently mis-map
        intervals (previously only caught by CRC luck), so the mount
        raises typed EcGeometryError instead."""
        # a journaled-but-unfinished conversion cut-over means `.eci` and
        # the shard files may describe DIFFERENT geometries (the .eci
        # swaps first; the journal is unlinked last) — and when the two
        # layouts' shard sizes coincide, neither the stray-id nor the
        # over-length check below can tell. Refuse until the convert
        # resume path finishes the swap.
        if convert_mod.pending_cutover(self.base):
            raise EcGeometryError(
                f"{self.base}: conversion cut-over in progress (journaled "
                "intent, swap unfinished) — resume `ec.convert` to finish "
                "the swap before mounting",
                base=self.base,
                details={"pending_cutover": True},
            )
        stray = [
            s
            for s in stripe.find_local_shards(self.base)
            if s >= self.total_shards
        ]
        if stray:
            raise EcGeometryError(
                f"{self.base}: shard files {stray} exceed the recorded "
                f"{self.geometry.family} geometry "
                f"({self.data_shards}+{self.geometry.parity_shards}) — "
                "wrong-geometry shard set?",
                base=self.base,
                details={"stray_shards": stray, "family": self.geometry.family},
            )
        if info is None:
            return  # legacy sidecar-less set: sizes are unvouchable
        n_large, n_small = stripe.stripe_layout(
            int(info["dat_size"]), self.large, self.small, self.data_shards
        )
        expected = n_large * self.large + n_small * self.small
        over = {
            s: os.path.getsize(stripe.shard_file_name(self.base, s))
            for s in stripe.find_local_shards(self.base, self.total_shards)
            if os.path.getsize(stripe.shard_file_name(self.base, s)) > expected
        }
        if over:
            # over-length is a GEOMETRY contradiction (a truncated shard is
            # bit-rot/crash damage and stays the scrub ladder's business)
            raise EcGeometryError(
                f"{self.base}: shard files longer than the recorded layout "
                f"allows ({over} > {expected} bytes for "
                f"{self.geometry.family}) — wrong-geometry shard set?",
                base=self.base,
                details={"over_length": over, "expected_size": expected},
            )

    def _warm(self) -> None:
        # warm-up must never break a mount; a build or launch failure still
        # raises out of the first read that launches, which has no fallback
        try:
            self.encoder.warm_decode_matrices(local_shards=self.shard_ids)
            self.encoder.warm_reconstruct()
        except Exception:  # noqa: BLE001
            pass

    def close(self) -> None:
        for f in self._shard_files.values():
            f.close()
        self._shard_files.clear()
        # unmount forgets this volume's (volume, shard)-scoped suspicion —
        # a remount must not inherit stale windows (peer-scoped windows
        # persist: they describe the peer, not this volume)
        self._suspicion.forget_volume(self.base)
        # close() is THE cut-over seam: Store.mount_ec_volume (remount)
        # and unmount_ec_volume (ec.convert cut-over, shard moves) both
        # route through it, so the next mount of this base can never see
        # decoded intervals from the previous file set
        read_planner_mod.CACHE.invalidate_volume(self.base)
        self.planner.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def shard_ids(self) -> list[int]:
        return sorted(self._shard_files)

    def verify_local_shards(self) -> Optional[dict]:
        """Check every locally-held shard file against the CRC32s the
        streaming encode recorded in the .eci sidecar (and rebuilds verify
        on write) — the fsck-style integrity pass for a mounted EC volume.
        Returns {shard_id: ok} or None when the volume predates CRC
        recording (no shard_crc32 in the sidecar)."""
        info = stripe.read_ec_info(self.base)
        recorded = (info or {}).get("shard_crc32")
        if not isinstance(recorded, list) or len(recorded) != self.total_shards:
            return None
        out = {}
        for s in sorted(self._shard_files):
            # private handle per shard: the serving handles in
            # self._shard_files are seek/read'd by concurrent interval
            # reads, and an fsck pass sharing them would race both sides
            with open(stripe.shard_file_name(self.base, s), "rb") as f:
                crc = 0
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    crc = zlib.crc32(chunk, crc)
            out[s] = crc == recorded[s]
        return out

    def drop_local_shard(self, shard_id: int) -> bool:
        """Stop serving a shard from local disk (single-shard unmount /
        shard-file loss): closes the handle so reads fall through to the
        remote -> reconstruct ladder."""
        f = self._shard_files.pop(shard_id, None)
        if f is None:
            return False
        f.close()
        return True

    def quarantine_shard(self, shard_id: int, reason: str = "corrupt") -> bool:
        """Pull a shard that failed integrity verification out of serving:
        the handle closes (degraded reads route around it instead of
        decoding garbage into a client response) and the reason is
        remembered for VolumeStatus / the typed EcShardCorrupt error.
        Returns whether a serving handle was actually dropped."""
        self.quarantined[shard_id] = str(reason)
        # a quarantined shard means bytes this volume served (and decodes
        # derived from them) may have been corrupt: flush the WHOLE
        # volume's cached intervals, not just this shard's — survivor
        # sets that included the bad local copy produced the others
        read_planner_mod.CACHE.invalidate_volume(self.base)
        return self.drop_local_shard(shard_id)

    def mount_local_shard(self, shard_id: int) -> bool:
        """(Re)open one shard file for serving — the repair path's remount
        after a quarantined shard was rebuilt and re-verified. Clears the
        quarantine entry. False when the file does not exist."""
        p = stripe.shard_file_name(self.base, shard_id)
        try:
            # serving handle owned by the volume, closed in close()
            f = open(p, "rb")
        except OSError:
            return False
        old = self._shard_files.pop(shard_id, None)
        if old is not None:
            old.close()
        self._shard_files[shard_id] = f
        self.shard_size = max(self.shard_size, os.path.getsize(p))
        self.quarantined.pop(shard_id, None)
        # the freshly-(re)mounted file is now authoritative for this
        # shard: decoded intervals cached before the rebuild landed must
        # not outlive it
        read_planner_mod.CACHE.invalidate_shard(self.base, shard_id)
        return True

    # -- index ---------------------------------------------------------------

    def find_needle_from_ecx(self, needle_id: int) -> tuple[int, int]:
        """-> (actual_byte_offset, size). Raises NeedleNotFound/NeedleDeleted."""
        pos = int(np.searchsorted(self._keys, np.uint64(needle_id)))
        if pos >= len(self._keys) or int(self._keys[pos]) != needle_id:
            raise NeedleNotFound(needle_id)
        entry = self._index[pos]
        size = int(entry["size"])
        if types.is_deleted(size) or needle_id in self._deleted:
            raise NeedleDeleted(needle_id)
        return types.offset_to_actual(int(entry["offset"])), size

    def locate_needle(self, needle_id: int) -> tuple[int, int, list[locate_mod.Interval]]:
        """LocateEcShardNeedle: -> (offset, size, intervals covering the full
        on-disk record: header + body + checksum [+ts] + padding)."""
        offset, size = self.find_needle_from_ecx(needle_id)
        whole = types.actual_size(size, self.version)
        intervals = locate_mod.locate_data(
            self.large, self.small, self.dat_file_size, offset, whole,
            self.data_shards,
        )
        return offset, size, intervals

    # -- interval reads ------------------------------------------------------

    def _read_local(self, shard_id: int, offset: int, size: int) -> Optional[np.ndarray]:
        f = self._shard_files.get(shard_id)
        if f is None:
            return None
        # a positional read: concurrent readers share this handle, and a
        # seek followed by a read lets another thread's seek land between
        # the two (the reference's seek + read served the wrong bytes that
        # way to reads from several threads)
        out = np.empty(size, dtype=np.uint8)
        got = 0
        try:
            fd = f.fileno()
            while got < size:
                n = os.preadv(fd, [memoryview(out)[got:]], offset + got)
                if n == 0:
                    break
                got += n
        except (ValueError, OSError):
            # handle closed underneath us (concurrent quarantine/unmount)
            # or the disk faulted mid-read: both mean "this local copy is
            # unavailable", and the remote/reconstruct ladder owns it
            return None
        if got != size:
            # Truncated shard: serving zeros would hand clients corrupt data.
            # Treat as unavailable so the remote/reconstruct fallback kicks in.
            return None
        return out

    # -- planner delegation ----------------------------------------------------
    # The decision tree (suspicion ladder, capped/hedged fetches,
    # coalescing, batched reconstruction, the decoded-interval cache rung)
    # lives on self.planner; these shims keep the long-standing EcVolume
    # surface that the volume server, shell, and tests call.

    def _holder_suspected(self, shard_id: int) -> bool:
        return self.planner.holder_suspected(shard_id)

    def _mark_holder_suspect(self, shard_id: int) -> None:
        self.planner.mark_holder_suspect(shard_id)

    def _remote_fetch_capped(
        self, shard_id: int, offset: int, size: int
    ) -> Optional[np.ndarray]:
        return self.planner._remote_fetch_capped(shard_id, offset, size)

    def _read_present(self, shard_id: int, offset: int, size: int) -> Optional[np.ndarray]:
        return self.planner.read_present(shard_id, offset, size)

    def _read_shard_interval(self, shard_id: int, offset: int, size: int) -> np.ndarray:
        """One interval: local -> cache -> remote -> reconstruct."""
        return self.planner.read_interval(shard_id, offset, size)

    def _recover_interval(self, shard_id: int, offset: int, size: int) -> np.ndarray:
        return self.planner.recover_interval(shard_id, offset, size)

    def _gather_survivors(
        self, shard_id: int, offset: int, size: int
    ) -> list[Optional[np.ndarray]]:
        return self.planner._gather_survivors(shard_id, offset, size)

    def _hedge_delay(self, shard_id: int) -> float:
        return self.planner.hedge_delay(shard_id)

    def _recover_intervals_batch(
        self, shard_id: int, items: list[tuple[int, int]]
    ) -> list[np.ndarray]:
        return self.planner.recover_intervals_batch(shard_id, items)

    def read_intervals(self, intervals: list[locate_mod.Interval]) -> bytes:
        """Read every interval, batching the ones that need reconstruction:
        intervals that miss the same shard become ONE bucketed device call
        instead of a blocking reconstruct each (a multi-interval needle on
        a degraded volume previously paid the full decode ladder per
        interval)."""
        parts: list[Optional[bytes]] = [None] * len(intervals)
        recover: dict[int, list[tuple[int, int, int]]] = {}  # sid -> [(i, off, size)]
        for i, iv in enumerate(intervals):
            shard_id, off = iv.to_shard_id_and_offset(self.large, self.small)
            data = self.planner.read_present(shard_id, off, iv.size)
            if data is not None:
                parts[i] = data.tobytes()
            else:
                recover.setdefault(shard_id, []).append((i, off, iv.size))
        for shard_id, missed in recover.items():
            recs = self.planner.recover_intervals_batch(
                shard_id, [(off, size) for _, off, size in missed]
            )
            for (i, _, _), arr in zip(missed, recs):
                parts[i] = arr.tobytes()
        return b"".join(parts)

    def read_needle_blob(self, needle_id: int) -> bytes:
        """The raw on-disk needle record (ReadEcShardNeedle minus parsing)."""
        _, _, intervals = self.locate_needle(needle_id)
        # an EC-volume read starts as intact; a reconstructing interval
        # upgrades the trace class to "degraded" inside the recover path
        if trace_mod.current_class() == "healthy":
            trace_mod.set_class("ec_intact")
        return self.read_intervals(intervals)

    # -- deletes -------------------------------------------------------------

    def delete_needle(self, needle_id: int) -> bool:
        """Append to the deletion journal (VolumeEcBlobDelete semantics).
        Returns False (and journals nothing) when the needle is absent or
        already deleted, matching Volume.delete_needle."""
        try:
            self.find_needle_from_ecx(needle_id)
        except (NeedleNotFound, NeedleDeleted):
            return False
        stripe.append_ecj(self.base, needle_id)
        self._deleted.add(needle_id)
        return True
