"""Entry model — mirror of weed/filer/entry.go + filechunks.go and the
Entry/FuseAttributes/FileChunk messages in weed/pb/filer.proto.

An Entry is one node of the namespace: a directory, or a file whose bytes
live in `chunks` on the volume tier. `extended` carries opaque user
metadata (the S3 gateway stores x-amz-* headers there, as the reference
does in Entry.Extended).
"""

from __future__ import annotations

import posixpath
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class FileChunk:
    """One contiguous run of file bytes stored as a needle (fid) on the
    volume tier. `offset` is the logical position in the file."""

    fid: str
    offset: int
    size: int
    mtime_ns: int = 0
    etag: str = ""
    is_chunk_manifest: bool = False

    def to_dict(self) -> dict:
        return {
            "fid": self.fid,
            "offset": self.offset,
            "size": self.size,
            "mtime_ns": self.mtime_ns,
            "etag": self.etag,
            "is_chunk_manifest": self.is_chunk_manifest,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FileChunk":
        return cls(
            fid=d["fid"],
            offset=int(d["offset"]),
            size=int(d["size"]),
            mtime_ns=int(d.get("mtime_ns", 0)),
            etag=d.get("etag", ""),
            is_chunk_manifest=bool(d.get("is_chunk_manifest", False)),
        )


@dataclass
class Attributes:
    """FuseAttributes analog: POSIX-ish metadata + storage options."""

    mtime: float = 0.0
    crtime: float = 0.0
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    replication: str = ""
    collection: str = ""
    ttl_sec: int = 0
    md5: str = ""  # hex digest of the whole file (etag source)
    file_size: int = 0

    def to_dict(self) -> dict:
        return {
            "mtime": self.mtime,
            "crtime": self.crtime,
            "mode": self.mode,
            "uid": self.uid,
            "gid": self.gid,
            "mime": self.mime,
            "replication": self.replication,
            "collection": self.collection,
            "ttl_sec": self.ttl_sec,
            "md5": self.md5,
            "file_size": self.file_size,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Attributes":
        return cls(
            mtime=float(d.get("mtime", 0.0)),
            crtime=float(d.get("crtime", 0.0)),
            mode=int(d.get("mode", 0o660)),
            uid=int(d.get("uid", 0)),
            gid=int(d.get("gid", 0)),
            mime=d.get("mime", ""),
            replication=d.get("replication", ""),
            collection=d.get("collection", ""),
            ttl_sec=int(d.get("ttl_sec", 0)),
            md5=d.get("md5", ""),
            file_size=int(d.get("file_size", 0)),
        )


@dataclass
class Entry:
    """One namespace node at absolute posix `path`."""

    path: str
    is_directory: bool = False
    attributes: Attributes = field(default_factory=Attributes)
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        self.path = normalize_path(self.path)
        if self.attributes.crtime == 0.0:
            self.attributes.crtime = self.attributes.mtime or time.time()
        if self.attributes.mtime == 0.0:
            self.attributes.mtime = self.attributes.crtime

    @property
    def dir(self) -> str:
        return posixpath.dirname(self.path) or "/"

    @property
    def name(self) -> str:
        return posixpath.basename(self.path)

    @property
    def size(self) -> int:
        if self.is_directory:
            return 0
        if self.attributes.file_size:
            return self.attributes.file_size
        return total_size(self.chunks)

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "is_directory": self.is_directory,
            "attributes": self.attributes.to_dict(),
            "chunks": [c.to_dict() for c in self.chunks],
            "extended": dict(self.extended),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Entry":
        return cls(
            path=d["path"],
            is_directory=bool(d.get("is_directory", False)),
            attributes=Attributes.from_dict(d.get("attributes", {})),
            chunks=[FileChunk.from_dict(c) for c in d.get("chunks", [])],
            extended=dict(d.get("extended", {})),
        )


def normalize_path(path: str) -> str:
    """Absolute, no trailing slash (except root), collapsed."""
    if not path.startswith("/"):
        path = "/" + path
    path = posixpath.normpath(path)
    return path


def total_size(chunks: list[FileChunk]) -> int:
    """Logical file size = max chunk extent (chunks may overlap after
    random writes; later mtime wins on read, see chunks.read_all)."""
    end = 0
    for c in chunks:
        end = max(end, c.offset + c.size)
    return end
