"""Chunk I/O against the volume tier — mirror of weed/filer/filechunks.go,
filechunk_manifest.go and weed/operation upload helpers.

Files larger than the chunk size are split into fixed-size chunks, each a
needle on the volume tier (assign + HTTP POST). Reads resolve the chunk
list into a visible-interval view (later mtime wins where chunks overlap
— the random-write case) and fetch the needed ranges. A chunk list past
`MANIFEST_BATCH` is folded into manifest chunks so entries stay small,
like the reference's chunk manifests.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from seaweedfs_tpu_torch.cluster.client import MasterClient
from seaweedfs_tpu_torch.filer.entry import FileChunk

DEFAULT_CHUNK_SIZE = 4 * 1024 * 1024
MANIFEST_BATCH = 1000  # fold chunk lists longer than this into manifests


class ChunkIO:
    """Upload/read/delete chunks through a MasterClient. An optional
    ChunkCache (weed/util/chunk_cache analog) front-ends reads: fids are
    immutable, so a hit never needs validation; deletes evict."""

    def __init__(self, master: MasterClient, chunk_size: int = DEFAULT_CHUNK_SIZE, cache=None):
        self.master = master
        self.chunk_size = chunk_size
        self.cache = cache

    def _read_chunk(self, fid: str) -> bytes:
        if self.cache is not None:
            hit = self.cache.get(fid)
            if hit is not None:
                return hit
        data = self.master.read(fid)
        if self.cache is not None:
            self.cache.put(fid, data)
        return data

    # -- write ----------------------------------------------------------------

    def upload_stream(
        self,
        reader,
        collection: str = "",
        replication: str = "",
        ttl: str = "",
    ) -> tuple[list[FileChunk], int, str]:
        """Split `reader` (a file-like) into chunks; returns
        (chunks, total_size, md5_hex)."""
        chunks: list[FileChunk] = []
        offset = 0
        whole = hashlib.md5()
        while True:
            data = reader.read(self.chunk_size)
            if not data:
                break
            chunks.append(
                self.upload_chunk(
                    data, offset, collection=collection, replication=replication, ttl=ttl
                )
            )
            whole.update(data)
            offset += len(data)
        return chunks, offset, whole.hexdigest()

    def upload_chunk(
        self,
        data: bytes,
        offset: int,
        collection: str = "",
        replication: str = "",
        ttl: str = "",
    ) -> FileChunk:
        a = self.master.assign(collection=collection, replication=replication, ttl=ttl)
        self.master.upload(a.fid, data, auth=a.auth)
        return FileChunk(
            fid=a.fid,
            offset=offset,
            size=len(data),
            mtime_ns=time.time_ns(),
            etag=hashlib.md5(data).hexdigest(),
        )

    # -- read -----------------------------------------------------------------

    def read_all(self, chunks: list[FileChunk]) -> bytes:
        """Materialize the whole file (visible-interval resolution)."""
        chunks = self.resolve_manifests(chunks)
        size = 0
        for c in chunks:
            size = max(size, c.offset + c.size)
        buf = bytearray(size)
        # chunks sorted by mtime: later writes overwrite earlier bytes,
        # the same winner rule as the reference's visible-interval list
        for c in sorted(chunks, key=lambda c: c.mtime_ns):
            data = self._read_chunk(c.fid)
            buf[c.offset : c.offset + c.size] = data[: c.size]
        return bytes(buf)

    def read_range(self, chunks: list[FileChunk], offset: int, size: int) -> bytes:
        """Read [offset, offset+size) fetching only overlapping chunks."""
        chunks = self.resolve_manifests(chunks)
        end = offset + size
        buf = bytearray(size)
        for c in sorted(chunks, key=lambda c: c.mtime_ns):
            lo = max(offset, c.offset)
            hi = min(end, c.offset + c.size)
            if lo >= hi:
                continue
            data = self._read_chunk(c.fid)
            buf[lo - offset : hi - offset] = data[lo - c.offset : hi - c.offset]
        return bytes(buf)

    def stream_all(self, chunks: list[FileChunk]) -> Iterator[bytes]:
        """Yield file bytes chunk by chunk (fast path: non-overlapping,
        sorted chunk lists — the common append-only upload shape)."""
        chunks = self.resolve_manifests(chunks)
        in_order = sorted(chunks, key=lambda c: c.offset)
        pos = 0
        overlapping = any(
            c.offset < (in_order[i - 1].offset + in_order[i - 1].size)
            for i, c in enumerate(in_order)
            if i > 0
        )
        if overlapping:
            yield self.read_all(chunks)
            return
        for c in in_order:
            if c.offset > pos:  # hole: sparse file, zero-fill
                yield bytes(c.offset - pos)
            yield self._read_chunk(c.fid)[: c.size]
            pos = c.offset + c.size

    # -- delete ---------------------------------------------------------------

    def delete_chunks(self, chunks: list[FileChunk]) -> None:
        for c in chunks:
            manifest = None
            if c.is_chunk_manifest:
                try:
                    manifest = self._load_manifest(c)
                except Exception:  # noqa: BLE001 — still delete the manifest needle
                    manifest = None
            if manifest:
                self.delete_chunks(manifest)
            if self.cache is not None:
                self.cache.delete(c.fid)
            try:
                self.master.delete(c.fid)
            except Exception:  # noqa: BLE001 — best-effort, orphans vacuumed later
                continue

    # -- manifests ------------------------------------------------------------

    def maybe_manifestize(
        self,
        chunks: list[FileChunk],
        collection: str = "",
        replication: str = "",
        ttl: str = "",
    ) -> list[FileChunk]:
        """Fold long chunk lists into manifest chunks (entry stays small).
        Manifest needles carry the file's storage options — same
        collection/replication/ttl fate as the data they index."""
        if len(chunks) <= MANIFEST_BATCH:
            return chunks
        out: list[FileChunk] = []
        for i in range(0, len(chunks), MANIFEST_BATCH):
            batch = chunks[i : i + MANIFEST_BATCH]
            if len(batch) == 1:
                out.append(batch[0])
                continue
            payload = json.dumps([c.to_dict() for c in batch]).encode()
            lo = min(c.offset for c in batch)
            hi = max(c.offset + c.size for c in batch)
            m = self.upload_chunk(
                payload, lo, collection=collection, replication=replication, ttl=ttl
            )
            m.size = hi - lo
            m.is_chunk_manifest = True
            out.append(m)
        return out

    def _load_manifest(self, c: FileChunk) -> list[FileChunk]:
        payload = self._read_chunk(c.fid)
        return [FileChunk.from_dict(d) for d in json.loads(payload.decode())]

    def resolve_manifests(self, chunks: list[FileChunk]) -> list[FileChunk]:
        out: list[FileChunk] = []
        for c in chunks:
            if c.is_chunk_manifest:
                out.extend(self.resolve_manifests(self._load_manifest(c)))
            else:
                out.append(c)
        return out


def etag_of(chunks: list[FileChunk], md5hex: str = "") -> str:
    """S3-style ETag: whole-file md5 when known, else multipart-style
    md5-of-chunk-md5s with a part count suffix."""
    if md5hex:
        return md5hex
    if not chunks:
        return hashlib.md5(b"").hexdigest()
    if len(chunks) == 1:
        return chunks[0].etag
    h = hashlib.md5()
    for c in sorted(chunks, key=lambda c: c.offset):
        h.update(bytes.fromhex(c.etag) if c.etag else b"")
    return f"{h.hexdigest()}-{len(chunks)}"
