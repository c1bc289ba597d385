"""Remote storage, after upstream's weed/remote_storage/ (the vendor wall:
s3, gcs, azure, ...).

`RemoteStorageClient` is the vendor interface. Two vendors: a local
directory (upstream ships one for development and tests too) and an S3
endpoint, signed with the package's own SigV4 client (s3api/auth.py).

Volume tiering (remote_storage.tier) moves a cold volume's .dat here and
reads it back through `read_range`. Neither vendor imports grpc.
"""

from __future__ import annotations

import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional


_STREAM_CHUNK = 16 * 1024 * 1024


class RemoteStorageClient:
    vendor = "abstract"

    def write_file(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def write_stream(self, key: str, reader, size: int) -> None:
        """Upload from a file-like without materializing it when the
        vendor can stream; the base impl buffers (single-PUT vendors)."""
        self.write_file(key, reader.read(size))

    def read_to_file(self, key: str, path: str, size: int) -> None:
        """Ranged download in chunks — never holds the object in RAM."""
        with open(path, "wb") as f:
            pos = 0
            while pos < size:
                n = min(_STREAM_CHUNK, size - pos)
                data = self.read_range(key, pos, n)
                if not data:
                    raise IOError(f"short remote read of {key} at {pos}")
                f.write(data)
                pos += len(data)

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def location(self) -> dict:
        """Serializable description; make_remote_client(location) must
        reconstruct an equivalent client (stored in .tierinfo files)."""
        raise NotImplementedError


class LocalRemoteStorage(RemoteStorageClient):
    """Directory-backed vendor (the reference's remote_storage local dev
    vendor): key -> file under root."""

    vendor = "local"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.abspath(os.path.join(self.root, key.lstrip("/")))
        # separator-anchored check: '/srv/tier2' must not pass for root
        # '/srv/tier'
        if not (p == self.root or p.startswith(self.root + os.sep)):
            raise ValueError(f"key {key!r} escapes the vendor root")
        return p

    def write_file(self, key: str, data: bytes) -> None:
        import io

        self.write_stream(key, io.BytesIO(data), len(data))

    def write_stream(self, key: str, reader, size: int) -> None:
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".part"
        with open(tmp, "wb") as f:
            remaining = size
            while remaining > 0:
                chunk = reader.read(min(_STREAM_CHUNK, remaining))
                if not chunk:
                    raise IOError(f"short reader for {key}")
                f.write(chunk)
                remaining -= len(chunk)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        with open(self._path(key), "rb") as f:
            f.seek(offset)
            return f.read(size)

    def size(self, key: str) -> int:
        return os.path.getsize(self._path(key))

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def location(self) -> dict:
        return {"vendor": "local", "root": self.root}


class S3RemoteStorage(RemoteStorageClient):
    """S3-endpoint vendor using the in-tree SigV4 signer."""

    vendor = "s3"

    def __init__(self, endpoint: str, bucket: str, access_key: str = "", secret_key: str = ""):
        self.endpoint = endpoint
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key

    def _request(
        self, method: str, key: str, data: bytes = b"", headers: Optional[dict] = None
    ):
        from seaweedfs_tpu_torch.s3api.auth import sign_request

        url = f"http://{self.endpoint}/{self.bucket}/{urllib.parse.quote(key.lstrip('/'))}"
        signed = sign_request(
            self.access_key, self.secret_key, method, url, data,
            extra_headers=headers or {},
        )
        req = urllib.request.Request(
            url, data=data if data else None, method=method, headers=signed
        )
        return urllib.request.urlopen(req, timeout=60)

    def write_file(self, key: str, data: bytes) -> None:
        with self._request("PUT", key, data) as r:
            r.read()

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        # Range is not part of the SigV4 signed headers set we emit, so
        # sign normally and add Range after
        from seaweedfs_tpu_torch.s3api.auth import sign_request

        url = f"http://{self.endpoint}/{self.bucket}/{urllib.parse.quote(key.lstrip('/'))}"
        signed = sign_request(self.access_key, self.secret_key, "GET", url, b"")
        signed["Range"] = f"bytes={offset}-{offset + size - 1}"
        req = urllib.request.Request(url, headers=signed)
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    def size(self, key: str) -> int:
        with self._request("HEAD", key) as r:
            return int(r.headers.get("Content-Length", 0))

    def delete(self, key: str) -> None:
        try:
            with self._request("DELETE", key) as r:
                r.read()
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def location(self) -> dict:
        return {
            "vendor": "s3",
            "endpoint": self.endpoint,
            "bucket": self.bucket,
            "access_key": self.access_key,
            "secret_key": self.secret_key,
        }


def make_remote_client(location: dict) -> RemoteStorageClient:
    vendor = location.get("vendor", "")
    if vendor == "local":
        return LocalRemoteStorage(location["root"])
    if vendor == "s3":
        return S3RemoteStorage(
            location["endpoint"],
            location["bucket"],
            location.get("access_key", ""),
            location.get("secret_key", ""),
        )
    raise ValueError(f"unknown remote storage vendor {vendor!r} (local|s3)")
