"""Replication sinks, after upstream's weed/replication/sink/{localsink,
filersink,s3sink}. A sink applies one entry mutation; the Replicator decides which.
"""

from __future__ import annotations

import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from seaweedfs_tpu_torch.s3api.auth import sign_request
from seaweedfs_tpu_torch.security import tls


class ReplicationSink:
    """Keys are source-filer paths relative to the replication prefix
    (no leading slash)."""

    name = "abstract"

    def create(self, key: str, data: bytes, mime: str = "", is_dir: bool = False) -> None:
        raise NotImplementedError

    def delete(self, key: str, is_dir: bool = False) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LocalSink(ReplicationSink):
    """Mirror into a local directory tree (sink/localsink)."""

    name = "local"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.abspath(os.path.join(self.root, key))
        if not p.startswith(self.root + os.sep) and p != self.root:
            raise ValueError(f"key {key!r} escapes the sink root")
        return p

    def create(self, key: str, data: bytes, mime: str = "", is_dir: bool = False) -> None:
        p = self._path(key)
        if is_dir:
            os.makedirs(p, exist_ok=True)
            return
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".repl"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def delete(self, key: str, is_dir: bool = False) -> None:
        p = self._path(key)
        try:
            if is_dir:
                import shutil

                shutil.rmtree(p, ignore_errors=True)
            else:
                os.remove(p)
        except FileNotFoundError:
            pass


class FilerSink(ReplicationSink):
    """Replicate into another filer over its HTTP API (sink/filersink)."""

    name = "filer"

    def __init__(self, filer_http_address: str, target_root: str = "/"):
        self.filer_http = filer_http_address
        self.root = "/" + target_root.strip("/")

    def _url(self, key: str, query: str = "") -> str:
        path = (self.root.rstrip("/") + "/" + key).replace("//", "/")
        return f"{tls.scheme()}://{self.filer_http}{urllib.parse.quote(path)}" + (
            f"?{query}" if query else ""
        )

    def create(self, key: str, data: bytes, mime: str = "", is_dir: bool = False) -> None:
        if is_dir:
            req = urllib.request.Request(
                self._url(key) + "/?op=mkdir", data=b"", method="PUT"
            )
        else:
            req = urllib.request.Request(
                self._url(key),
                data=data,
                method="PUT",
                headers={"Content-Type": mime or "application/octet-stream"},
            )
        with tls.urlopen(req, timeout=60) as r:
            r.read()

    def delete(self, key: str, is_dir: bool = False) -> None:
        try:
            req = urllib.request.Request(
                self._url(key, "recursive=true"), method="DELETE"
            )
            with tls.urlopen(req, timeout=60) as r:
                r.read()
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise


class S3Sink(ReplicationSink):
    """Replicate into any S3 endpoint (sink/s3sink) — works against this
    framework's own gateway or an external one."""

    name = "s3"

    def __init__(
        self,
        endpoint: str,  # host:port
        bucket: str,
        access_key: str = "",
        secret_key: str = "",
        directory: str = "",
    ):
        self.endpoint = endpoint
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.prefix = directory.strip("/")

    def _key(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def _request(self, method: str, key: str, data: bytes = b"", mime: str = ""):
        url = f"http://{self.endpoint}/{self.bucket}/{urllib.parse.quote(self._key(key))}"
        extra = {"Content-Type": mime} if mime else {}
        headers = sign_request(
            self.access_key, self.secret_key, method, url, data, extra_headers=extra
        )
        req = urllib.request.Request(
            url, data=data if data else None, method=method, headers=headers
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    def create(self, key: str, data: bytes, mime: str = "", is_dir: bool = False) -> None:
        if is_dir:
            return  # S3 has no directories
        self._request("PUT", key, data, mime)

    def delete(self, key: str, is_dir: bool = False) -> None:
        if is_dir:
            return
        try:
            self._request("DELETE", key)
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
