"""S3ApiServer — bucket/object/multipart REST handlers over the filer,
mirror of weed/s3api/s3api_server.go, s3api_bucket_handlers.go,
s3api_object_handlers.go, s3api_object_handlers_multipart.go,
filer_multipart.go.

Wire layout matches the reference: buckets are filer directories under
/buckets/<name>; multipart uploads stage parts under
/buckets/.uploads/<bucket>/<uploadId>/ and Complete splices the parts'
chunk lists into the final entry WITHOUT copying data (the reference
does the same chunk-list surgery in filer_multipart.go).

Data plane: proxied through the filer HTTP API (chunking to the volume
tier happens there). Metadata plane: filer RPC.

Supported: ListBuckets, Create/Delete/HeadBucket, ListObjectsV1/V2
(prefix, delimiter, marker/continuation, max-keys), Put/Get/Head/Delete
Object (+Range), CopyObject, DeleteObjects (bulk XML), multipart
lifecycle (initiate/uploadPart/complete/abort/listParts), SigV4 auth.

Listing order note: keys stream in directory-DFS order (names sorted per
directory), which differs from strict full-key lexicographic order only
when a sibling name extends a directory name with a byte < '/'.
"""

from __future__ import annotations

import hashlib
import io
import json
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
import xml.etree.ElementTree as ET
from typing import Iterator, Optional

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.s3api import policy as policy_mod
from seaweedfs_tpu_torch.s3api.auth import (
    ACTION_LIST,
    ACTION_READ,
    ACTION_WRITE,
    ACTION_ADMIN,
    Iam,
    Identity,
    load_identities,
    save_identities,
)
from seaweedfs_tpu_torch.utils import httpd
from seaweedfs_tpu_torch.security import tls

BUCKETS_ROOT = "/buckets"
UPLOADS_ROOT = "/buckets/.uploads"
_XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"

# uploadIds are minted as uuid4().hex by _initiate_multipart; anything
# else in the query string is attacker-controlled path material (an
# unvalidated id containing '..' walks out of the staging area and can
# delete a victim bucket via AbortMultipartUpload)
_UPLOAD_ID_RE = re.compile(r"^[0-9a-f]{32}$")


VERSIONS_SUFFIX = ".s3versions"
# ids this gateway mints (hex time_ns + random) or AWS's pre-versioning
# "null" — anything else in ?versionId is attacker-controlled path
# material (a '..' would normalize out of the version archive and read or
# delete entries in other buckets)
_VERSION_ID_RE = re.compile(r"^(?:[0-9a-f]{24}|null)$")


def _valid_path(bucket: str, key: str) -> bool:
    """Reject bucket/key pairs whose filer path would normalize outside
    /buckets/<bucket>/ — '.'/'..'/empty segments and dot-prefixed bucket
    names (which would collide with the .uploads staging area). Segments
    ending in the reserved .s3versions suffix are refused on every
    surface: they are the per-key version archives."""
    if bucket.startswith("."):
        return False
    segs = key.split("/") if key else []
    if any(s in ("", ".", "..") for s in segs[:-1]):
        return False
    if any(s.endswith(VERSIONS_SUFFIX) for s in segs):
        return False
    # a single trailing "" segment is a folder-marker key ("a/b/")
    return not (segs and segs[-1] in (".", ".."))


class S3ApiServer:
    def __init__(
        self,
        filer_http_address: str,
        filer_grpc_address: str,
        port: int = 0,
        host: str = "127.0.0.1",
        iam: Optional[Iam] = None,
        extra_hosts: Optional[set[str]] = None,
    ):
        self.filer_http = filer_http_address
        self.filer = FilerClient(filer_grpc_address)
        self.iam = iam or Iam()
        # additional advertised host:port names (LB/proxy fronts) accepted
        # as the signed `host` header besides this server's own url;
        # pre-lowercased here so the per-request compare is a set lookup
        self.extra_hosts = {h.lower() for h in (extra_hosts or ())}
        self._iam_checked_at = 0.0
        self._policy_cache: dict[str, tuple[float, Optional[dict]]] = {}
        self._versioning_cache: dict[str, tuple[float, str]] = {}
        self.host = host
        self._http = _ThreadingHTTPServer((host, port), _Handler)
        tls.maybe_wrap_https(self._http)  # data-path HTTPS when configured
        self._http.s3_server = self
        self.port = self._http.server_address[1]
        self.extra_hosts |= {f"{h}:{self.port}" for h in httpd.loopback_aliases(host)}
        self._thread = threading.Thread(target=self._http.serve_forever, daemon=True)

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        # ensure the buckets root exists
        from seaweedfs_tpu_torch.filer.entry import Entry as _E

        if self.filer.lookup(BUCKETS_ROOT) is None:
            self.filer.create(_E(path=BUCKETS_ROOT, is_directory=True))
        # seed the filer KV (the cluster-wide identity root the IAM API
        # serves) with the file-configured identities: otherwise the IAM
        # API sees an empty KV, stays in its open bootstrap window, and
        # an unauthenticated caller can mint an admin this gateway would
        # honor on its next KV reload
        if not self.iam.open:
            existing = load_identities(self.filer)
            if existing is None or not any(
                i.access_key for i in existing.identities
            ):
                save_identities(self.filer, self.iam)
        self._thread.start()

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        self.filer.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- bucket policies ------------------------------------------------------

    POLICY_KEY = "s3_policy"
    _POLICY_TTL = 5.0  # s; policies are read per request, entries are not
    _CACHE_MAX = 4096  # hard cap on cached bucket names (real buckets only)
    #: guards every structural mutation of _policy_cache/_versioning_cache:
    #: the HTTP server is threaded, and an unlocked eviction scan racing a
    #: concurrent insert/pop would raise 'dict changed size during iteration'
    _cache_lock = threading.Lock()

    @classmethod
    def _cache_put(cls, cache: dict, bucket: str, value, now: float) -> None:
        """Bounded insert shared by the policy and versioning caches: evict
        every expired entry first (the TTL previously only gated reuse, so
        dead entries lived forever), then cap the size — a flood past the
        cap resets the cache rather than growing it (entries rebuild on
        demand at one filer lookup each)."""
        with cls._cache_lock:
            for k in [k for k, v in cache.items() if v[0] <= now]:
                cache.pop(k, None)
            if len(cache) >= cls._CACHE_MAX:
                cache.clear()
            cache[bucket] = (now + cls._POLICY_TTL, value)

    @classmethod
    def _cache_drop(cls, cache: dict, bucket: str) -> None:
        with cls._cache_lock:
            cache.pop(bucket, None)

    def get_bucket_policy(self, bucket: str) -> Optional[dict]:
        """The bucket's policy document, or None — cached briefly so the
        per-request evaluation doesn't pay a filer lookup per call.
        Nonexistent buckets are NOT cached: unauthenticated probes naming
        random buckets must not grow server state."""
        now = time.monotonic()
        cached = self._policy_cache.get(bucket)
        if cached is not None and cached[0] > now:
            return cached[1]
        entry = self.filer.lookup(self.bucket_path(bucket))
        if entry is None:
            self._cache_drop(self._policy_cache, bucket)
            return None
        doc = None
        raw = entry.extended.get(self.POLICY_KEY)
        if raw:
            try:
                doc = json.loads(raw)
            except ValueError:
                doc = None  # unreadable stored policy must not 500 reads
        self._cache_put(self._policy_cache, bucket, doc, now)
        return doc

    def put_bucket_policy(self, bucket: str, doc: dict) -> bool:
        entry = self.filer.lookup(self.bucket_path(bucket))
        if entry is None or not entry.is_directory:
            return False
        entry.extended[self.POLICY_KEY] = json.dumps(doc)
        self.filer.update(entry)
        self._cache_drop(self._policy_cache, bucket)
        return True

    def delete_bucket_policy(self, bucket: str) -> bool:
        entry = self.filer.lookup(self.bucket_path(bucket))
        if entry is None or not entry.is_directory:
            return False
        if self.POLICY_KEY in entry.extended:
            del entry.extended[self.POLICY_KEY]
            self.filer.update(entry)
        self._cache_drop(self._policy_cache, bucket)
        return True

    # -- object versioning ----------------------------------------------------
    #
    # Layout (upstream's weed/s3api keeps a hidden .versions folder per
    # key): the PLAIN path always holds the latest real version; every
    # older version — and every delete marker — lives in a sibling
    # directory `<key>.s3versions/` keyed by version id. A marker as
    # "latest" therefore shows as: plain path absent, marker entry newest
    # in the archive. Version ids are zero-padded hex time_ns + random, so
    # lexical order is creation order.

    VERSIONING_KEY = "s3_versioning"
    MARKER_KEY = "s3_delete_marker"
    VID_KEY = "x-amz-version-id"

    def get_bucket_versioning(self, bucket: str) -> str:
        """'' | 'Enabled' | 'Suspended' (briefly cached like policies;
        nonexistent buckets are not cached, matching get_bucket_policy)."""
        now = time.monotonic()
        cached = self._versioning_cache.get(bucket)
        if cached is not None and cached[0] > now:
            return cached[1]
        entry = self.filer.lookup(self.bucket_path(bucket))
        if entry is None:
            self._cache_drop(self._versioning_cache, bucket)
            return ""
        status = entry.extended.get(self.VERSIONING_KEY, "")
        self._cache_put(self._versioning_cache, bucket, status, now)
        return status

    def set_bucket_versioning(self, bucket: str, status: str) -> bool:
        entry = self.filer.lookup(self.bucket_path(bucket))
        if entry is None or not entry.is_directory:
            return False
        entry.extended[self.VERSIONING_KEY] = status
        self.filer.update(entry)
        self._cache_drop(self._versioning_cache, bucket)
        return True

    def versions_dir(self, bucket: str, key: str) -> str:
        return self.object_path(bucket, key) + VERSIONS_SUFFIX

    @staticmethod
    def new_version_id() -> str:
        return f"{time.time_ns():016x}{uuid.uuid4().hex[:8]}"

    # -- filer helpers --------------------------------------------------------

    def bucket_path(self, bucket: str) -> str:
        return f"{BUCKETS_ROOT}/{bucket}"

    def object_path(self, bucket: str, key: str) -> str:
        return f"{BUCKETS_ROOT}/{bucket}/{key}"

    def filer_url(self, path: str, query: str = "") -> str:
        enc = urllib.parse.quote(path)
        return f"{tls.scheme()}://{self.filer_http}{enc}" + (f"?{query}" if query else "")

    def walk_keys(
        self, bucket: str, prefix: str = "", after: str = ""
    ) -> Iterator[Entry]:
        """Yield file entries under the bucket whose key starts with
        `prefix` and sorts after `after`, in directory-DFS order. The
        `after` marker is pushed down into per-directory listings so a
        paginated walk costs O(depth × page), not a full re-walk."""
        root = self.bucket_path(bucket)

        def rec(dir_path: str, base: str) -> Iterator[Entry]:
            # base = key prefix of this directory ("" at the bucket root,
            # else "a/b/"). Resume the listing at the marker's component.
            start, include = "", False
            if after and after.startswith(base) and len(after) > len(base):
                start = after[len(base) :].split("/", 1)[0]
                include = True
            while True:
                batch = self.filer.list(
                    dir_path, start_from=start, include_start=include, limit=256
                )
                include = False
                if not batch:
                    return
                for e in batch:
                    key = e.path[len(root) + 1 :]
                    if e.is_directory and e.name.endswith(VERSIONS_SUFFIX):
                        continue  # per-key version archives are not keys
                    if e.is_directory:
                        probe = key + "/"
                        if after and after > probe and not after.startswith(probe):
                            continue  # whole subtree sorts before the marker
                        # descend only where the subtree can match prefix
                        if probe.startswith(prefix) or prefix.startswith(probe):
                            yield from rec(e.path, probe)
                    elif key.startswith(prefix) and (not after or key > after):
                        yield e
                start = batch[-1].name

        yield from rec(root, "")


# -- HTTP --------------------------------------------------------------------


class _ThreadingHTTPServer(httpd.ThreadingHTTPServer):
    s3_server: "S3ApiServer"


def _xml(tag: str, ns: bool = True) -> ET.Element:
    e = ET.Element(tag)
    if ns:
        e.set("xmlns", _XMLNS)
    return e


def _sub(parent: ET.Element, tag: str, text: Optional[str] = None) -> ET.Element:
    e = ET.SubElement(parent, tag)
    if text is not None:
        e.text = text
    return e


def _render(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>\n' + ET.tostring(root)


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


class _Handler(httpd.QuietHandler):
    # headers and body leave in two writes: with Nagle on, the body waits
    # for the client's delayed ACK (~40 ms per small reply on a keep-alive
    # connection), as on the filer's and the volume server's fronts
    disable_nagle_algorithm = True

    @property
    def s3(self) -> S3ApiServer:
        return self.server.s3_server

    # -- plumbing -------------------------------------------------------------

    def _parse(self) -> Optional[tuple[str, str, dict]]:
        """Parse /bucket/key?query. Returns None (after replying 400) for
        paths with '.'/'..'/empty segments — the filer normalizes paths,
        so an un-rejected '..' would let a bucket-scoped identity escape
        its bucket (the reference validates object names the same way)."""
        u = urllib.parse.urlparse(self.path)
        parts = urllib.parse.unquote(u.path).lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        if not _valid_path(bucket, key):
            self._error(400, "InvalidArgument", "invalid bucket or object name")
            return None
        q = {k: v[0] for k, v in urllib.parse.parse_qs(u.query, keep_blank_values=True).items()}
        return bucket, key, q

    def _body(self) -> Optional[bytes]:
        body = self.read_body()
        if body is None:
            self.reply_length_required()
        return body

    def _reply(self, code: int, body: bytes = b"", ctype="application/xml", headers=None):
        self.send_reply(code, body, ctype, headers=headers)

    def _error(self, code: int, s3_code: str, message: str = ""):
        root = _xml("Error", ns=False)
        _sub(root, "Code", s3_code)
        _sub(root, "Message", message or s3_code)
        self._reply(code, _render(root))

    def _s3_action_name(self, action: str, key: str, query: str) -> str:
        """Map this request's coarse action to the s3:* name bucket
        policies speak. Admin (bucket-management) operations return "" —
        they stay identity-only, which keeps Get/Put/DeleteBucketPolicy
        out of the policy's own reach (no AWS-style deny-yourself
        lockout). Bucket-level reads approximate to s3:ListBucket.

        Version-granular requests authorize under the separate
        s3:*Version action names, like AWS: a public-read policy granting
        s3:GetObject must NOT expose historical versions via ?versionId,
        and s3:DeleteObject must not permit permanent versionId deletes
        (nor may a Deny written against the *Version names silently never
        match)."""
        # FIRST-value-wins, exactly like _parse builds the q the handlers
        # serve from — authorization and serving must agree on which
        # versionId a request names, or a duplicated query key smuggles a
        # versioned read/delete past the base-action policy check
        q = {
            k: v[0]
            for k, v in urllib.parse.parse_qs(query, keep_blank_values=True).items()
        }
        # ?versions is a presence-flagged subresource, but versionId only
        # selects a version when its VALUE is non-empty — the handlers
        # treat a blank ?versionId= as "current object", so the action
        # name must agree or a base-action Deny would be bypassed
        versioned = bool(q.get("versionId", "").strip())
        if action == ACTION_LIST:
            return "s3:ListBucketVersions" if "versions" in q else "s3:ListBucket"
        if action == ACTION_READ:
            if not key:
                return "s3:ListBucketVersions" if "versions" in q else "s3:ListBucket"
            return "s3:GetObjectVersion" if versioned else "s3:GetObject"
        if action == ACTION_WRITE:
            if self.command == "DELETE" or (self.command == "POST" and "delete" in q):
                return (
                    "s3:DeleteObjectVersion" if versioned else "s3:DeleteObject"
                )
            return "s3:PutObject"
        return ""

    @staticmethod
    def _is_anonymous(identity) -> bool:
        return not identity.access_key and identity.name == "anonymous"

    def _policy_verdict(self, bucket, key, identity, s3_action):
        """Evaluate the bucket's policy for one (identity, action,
        resource): False = explicit deny, True = allow, None = no
        statement matched (or no policy)."""
        pol = self.s3.get_bucket_policy(bucket)
        if pol is None:
            return None
        resource = policy_mod.ARN_PREFIX + (f"{bucket}/{key}" if key else bucket)
        return policy_mod.evaluate(
            pol,
            identity_name=identity.name,
            access_key=identity.access_key,
            anonymous=self._is_anonymous(identity),
            action=s3_action,
            resource=resource,
        )

    def _auth(self, action: str, bucket: str, payload: bytes):
        """Authenticate + authorize; returns the resolved Identity (truthy)
        or None after replying 403/501 — callers needing a second
        authorization check (CopyObject's source-bucket Read) reuse the
        identity instead of re-verifying the signature.

        Authorization order (IAM semantics): bucket policy explicit Deny
        -> refuse, policy Allow -> grant (this is how anonymous access to
        a public-read bucket works), else identity grants."""
        u = urllib.parse.urlparse(self.path)
        headers = {k.lower(): v for k, v in self.headers.items()}
        path = urllib.parse.unquote(u.path) or "/"
        expect_hosts = {self.s3.url.lower()} | self.s3.extra_hosts
        if self.s3.iam.open:
            # an open gateway must notice identities minted via the IAM
            # API and start enforcing auth (throttled KV poll)
            now = time.monotonic()
            if now - self.s3._iam_checked_at > 5.0:
                self.s3._iam_checked_at = now
                fresh = load_identities(self.s3.filer)
                if fresh is not None and fresh.identities:
                    self.s3.iam.identities = fresh.identities
        identity, err = self.s3.iam.authenticate(
            self.command, path, u.query, headers, payload,
            expect_service="s3", expect_hosts=expect_hosts,
        )
        if identity is None and err == "NotImplemented":
            self._error(501, "NotImplemented", "aws-chunked (STREAMING-*) uploads not supported")
            return None
        if identity is None and err == "InvalidAccessKeyId":
            # the IAM API may have minted new credentials since start:
            # reload the persisted identity set once and retry
            fresh = load_identities(self.s3.filer)
            if fresh is not None and fresh.identities:
                self.s3.iam.identities = fresh.identities
                identity, err = self.s3.iam.authenticate(
                    self.command, path, u.query, headers, payload,
                    expect_service="s3", expect_hosts=expect_hosts,
                )
        anonymous = False
        if (
            identity is None
            and "authorization" not in headers
            and "X-Amz-Signature=" not in u.query
        ):
            # truly unsigned request (no auth material at all): not an auth
            # failure yet — a bucket policy may grant the anonymous
            # principal (public-read buckets). A SIGNED request missing a
            # required header keeps its original 403.
            identity = Identity("anonymous", "", "", [])
            anonymous = True
        if identity is None:
            self._error(403, err)
            return None
        # derive the object key from the path: policy resources are
        # key-granular while callers authorize at bucket granularity
        parts = path.lstrip("/").split("/", 1)
        req_key = parts[1] if len(parts) > 1 else ""
        s3_act = self._s3_action_name(action, req_key, u.query)
        if bucket and s3_act:
            verdict = self._policy_verdict(bucket, req_key, identity, s3_act)
            if verdict is False:
                self._error(403, "AccessDenied", "denied by bucket policy")
                return None
            if verdict is True:
                return identity
        if anonymous:
            self._error(403, "AccessDenied", "anonymous access not granted")
            return None
        if not identity.can_do(action, bucket):
            self._error(403, "AccessDenied", f"no {action} on {bucket}")
            return None
        return identity

    # -- dispatch -------------------------------------------------------------

    def do_GET(self):
        parsed = self._parse()
        if parsed is None:
            return
        bucket, key, q = parsed
        if not bucket:
            stats.S3RequestCounter.labels("ListBuckets").inc()
            if self._auth(ACTION_LIST, "", b""):
                self._list_buckets()
            return
        if not key:
            if "uploadId" in q:
                self._error(404, "NoSuchUpload")
                return
            if "location" in q:
                stats.S3RequestCounter.labels("GetBucketLocation").inc()
                if self._auth(ACTION_READ, bucket, b""):
                    if self.s3.filer.lookup(self.s3.bucket_path(bucket)) is None:
                        self._error(404, "NoSuchBucket")
                    else:  # single-region deployment: the us-east-1 form
                        self._reply(200, _render(_xml("LocationConstraint")))
                return
            if "acl" in q:
                stats.S3RequestCounter.labels("GetBucketAcl").inc()
                if self._auth(ACTION_READ, bucket, b""):
                    if self.s3.filer.lookup(self.s3.bucket_path(bucket)) is None:
                        self._error(404, "NoSuchBucket")
                    else:
                        self._get_acl()
                return
            if "policy" in q:
                stats.S3RequestCounter.labels("GetBucketPolicy").inc()
                if self._auth(ACTION_ADMIN, bucket, b""):
                    if self.s3.filer.lookup(self.s3.bucket_path(bucket)) is None:
                        self._error(404, "NoSuchBucket")
                    else:
                        pol = self.s3.get_bucket_policy(bucket)
                        if pol is None:
                            self._error(
                                404, "NoSuchBucketPolicy",
                                "the bucket policy does not exist",
                            )
                        else:
                            self._reply(
                                200, json.dumps(pol).encode(),
                                ctype="application/json",
                            )
                return
            if "versioning" in q:
                stats.S3RequestCounter.labels("GetBucketVersioning").inc()
                if self._auth(ACTION_READ, bucket, b""):
                    if self.s3.filer.lookup(self.s3.bucket_path(bucket)) is None:
                        self._error(404, "NoSuchBucket")
                    else:
                        root = _xml("VersioningConfiguration")
                        status = self.s3.get_bucket_versioning(bucket)
                        if status:
                            _sub(root, "Status", status)
                        self._reply(200, _render(root))
                return
            if "versions" in q:
                stats.S3RequestCounter.labels("ListObjectVersions").inc()
                if self._auth(ACTION_LIST, bucket, b""):
                    self._list_object_versions(bucket, q)
                return
            stats.S3RequestCounter.labels("ListObjects").inc()
            if self._auth(ACTION_LIST, bucket, b""):
                self._list_objects(bucket, q)
            return
        if "uploadId" in q:
            stats.S3RequestCounter.labels("ListParts").inc()
            if self._auth(ACTION_READ, bucket, b""):
                self._list_parts(bucket, key, q["uploadId"])
            return
        if "tagging" in q:
            stats.S3RequestCounter.labels("GetObjectTagging").inc()
            if self._auth(ACTION_READ, bucket, b""):
                self._get_tagging(bucket, key)
            return
        if "acl" in q:
            stats.S3RequestCounter.labels("GetObjectAcl").inc()
            if self._auth(ACTION_READ, bucket, b""):
                if self._lookup_object(bucket, key) is not None:
                    self._get_acl()
            return
        stats.S3RequestCounter.labels("GetObject").inc()
        if self._auth(ACTION_READ, bucket, b""):
            self._get_object(bucket, key, head=False, version_id=q.get("versionId", ""))

    def do_HEAD(self):
        parsed = self._parse()
        if parsed is None:
            return
        bucket, key, q = parsed
        if not key:
            if self._auth(ACTION_READ, bucket, b""):
                if self.s3.filer.lookup(self.s3.bucket_path(bucket)) is None:
                    self._reply(404)
                else:
                    self._reply(200)
            return
        if self._auth(ACTION_READ, bucket, b""):
            self._get_object(bucket, key, head=True, version_id=q.get("versionId", ""))

    def do_PUT(self):
        parsed = self._parse()
        if parsed is None:
            return
        bucket, key, q = parsed
        body = self._body()
        if body is None:
            return
        if "acl" in q:
            # PutBucketAcl/PutObjectAcl: accepted and ignored — access
            # control is identity-based here; SDKs setting canned ACLs
            # must not fail their whole upload flow on a 501. Existence is
            # still checked so a failed-upload + put_object_acl sequence
            # 404s like AWS instead of reporting false success.
            stats.S3RequestCounter.labels("PutAcl").inc()
            if self._auth(ACTION_WRITE, bucket, body):
                if self.s3.filer.lookup(self.s3.bucket_path(bucket)) is None:
                    self._error(404, "NoSuchBucket")
                elif key and self.s3.filer.lookup(
                    self.s3.object_path(bucket, key)
                ) is None:
                    self._error(404, "NoSuchKey", key)
                else:
                    self._reply(200)
            return
        if not key and "versioning" in q:
            stats.S3RequestCounter.labels("PutBucketVersioning").inc()
            if self._auth(ACTION_ADMIN, bucket, body):
                try:
                    tree = ET.fromstring(body)
                except ET.ParseError:
                    self._error(400, "MalformedXML")
                    return
                ns = tree.tag[: tree.tag.index("}") + 1] if tree.tag.startswith("{") else ""
                el = tree.find(f"{ns}Status")
                status = (el.text or "").strip() if el is not None else ""
                if status not in ("Enabled", "Suspended"):
                    self._error(400, "MalformedXML", "Status must be Enabled|Suspended")
                    return
                if not self.s3.set_bucket_versioning(bucket, status):
                    self._error(404, "NoSuchBucket")
                else:
                    self._reply(200)
            return
        if not key and "policy" in q:
            stats.S3RequestCounter.labels("PutBucketPolicy").inc()
            if self._auth(ACTION_ADMIN, bucket, body):
                try:
                    doc = policy_mod.parse_policy(body, bucket)
                except policy_mod.PolicyError as e:
                    self._error(400, "MalformedPolicy", str(e))
                    return
                if not self.s3.put_bucket_policy(bucket, doc):
                    self._error(404, "NoSuchBucket")
                else:
                    self._reply(204)
            return
        if not key:
            stats.S3RequestCounter.labels("CreateBucket").inc()
            if self._auth(ACTION_ADMIN, bucket, body):
                self._create_bucket(bucket)
            return
        if "partNumber" in q and "uploadId" in q:
            stats.S3RequestCounter.labels("UploadPart").inc()
            identity = self._auth(ACTION_WRITE, bucket, body)
            if identity:
                self._upload_part(bucket, key, q, body, identity)
            return
        if "tagging" in q:
            stats.S3RequestCounter.labels("PutObjectTagging").inc()
            if self._auth(ACTION_WRITE, bucket, body):
                self._put_tagging(bucket, key, body)
            return
        stats.S3RequestCounter.labels("PutObject").inc()
        identity = self._auth(ACTION_WRITE, bucket, body)
        if identity is None:
            return
        src = self.headers.get("x-amz-copy-source", "")
        if src:
            self._copy_object(bucket, key, src, identity)
        else:
            self._put_object(bucket, key, body)

    def do_POST(self):
        parsed = self._parse()
        if parsed is None:
            return
        bucket, key, q = parsed
        body = self._body()
        if body is None:
            return
        if not key and "delete" in q:
            stats.S3RequestCounter.labels("DeleteObjects").inc()
            identity = self._auth(ACTION_WRITE, bucket, body)
            if identity:
                self._delete_objects(bucket, body, identity)
            return
        if key and "uploads" in q:
            stats.S3RequestCounter.labels("CreateMultipartUpload").inc()
            if self._auth(ACTION_WRITE, bucket, body):
                self._initiate_multipart(bucket, key)
            return
        if key and "uploadId" in q:
            stats.S3RequestCounter.labels("CompleteMultipartUpload").inc()
            if self._auth(ACTION_WRITE, bucket, body):
                self._complete_multipart(bucket, key, q["uploadId"], body)
            return
        self._error(400, "InvalidRequest")

    def do_DELETE(self):
        parsed = self._parse()
        if parsed is None:
            return
        bucket, key, q = parsed
        if not key and "policy" in q:
            stats.S3RequestCounter.labels("DeleteBucketPolicy").inc()
            if self._auth(ACTION_ADMIN, bucket, b""):
                if not self.s3.delete_bucket_policy(bucket):
                    self._error(404, "NoSuchBucket")
                else:
                    self._reply(204)
            return
        if not key:
            stats.S3RequestCounter.labels("DeleteBucket").inc()
            if self._auth(ACTION_ADMIN, bucket, b""):
                self._delete_bucket(bucket)
            return
        if "uploadId" in q:
            stats.S3RequestCounter.labels("AbortMultipartUpload").inc()
            if self._auth(ACTION_WRITE, bucket, b""):
                self._abort_multipart(bucket, key, q["uploadId"])
            return
        if "tagging" in q:
            stats.S3RequestCounter.labels("DeleteObjectTagging").inc()
            if self._auth(ACTION_WRITE, bucket, b""):
                self._delete_tagging(bucket, key)
            return
        stats.S3RequestCounter.labels("DeleteObject").inc()
        if self._auth(ACTION_WRITE, bucket, b""):
            self._delete_object(bucket, key, q.get("versionId", ""))

    # -- buckets --------------------------------------------------------------

    def _list_buckets(self):
        root = _xml("ListAllMyBucketsResult")
        owner = _sub(root, "Owner")
        _sub(owner, "ID", "weedtpu")
        buckets = _sub(root, "Buckets")
        for e in self.s3.filer.list(BUCKETS_ROOT, limit=10000):
            if not e.is_directory or e.name.startswith("."):
                continue
            b = _sub(buckets, "Bucket")
            _sub(b, "Name", e.name)
            _sub(b, "CreationDate", _iso(e.attributes.crtime))
        self._reply(200, _render(root))

    def _create_bucket(self, bucket):
        from seaweedfs_tpu_torch.filer.entry import Entry as _E

        if self.s3.filer.lookup(self.s3.bucket_path(bucket)) is not None:
            self._error(409, "BucketAlreadyExists")
            return
        self.s3.filer.create(_E(path=self.s3.bucket_path(bucket), is_directory=True))
        self._reply(200, headers={"Location": f"/{bucket}"})

    def _delete_bucket(self, bucket):
        path = self.s3.bucket_path(bucket)
        if self.s3.filer.lookup(path) is None:
            self._error(404, "NoSuchBucket")
            return
        if self.s3.filer.list(path, limit=1):
            self._error(409, "BucketNotEmpty")
            return
        self.s3.filer.delete(path, recursive=True)
        # a same-named bucket created within the cache TTL must not
        # inherit the dead bucket's policy or versioning state
        self.s3._cache_drop(self.s3._policy_cache, bucket)
        self.s3._cache_drop(self.s3._versioning_cache, bucket)
        try:
            # in-flight multipart staging references needles in this
            # bucket's collection; dropping the collection without it
            # would leave staged entries pointing at dead volumes
            self.s3.filer.delete(f"{UPLOADS_ROOT}/{bucket}", recursive=True)
        except Exception:  # noqa: BLE001 — no staged uploads
            pass
        try:
            # per-bucket collections: drop the bucket's volumes so the
            # space (incl. tombstoned needles) comes back immediately
            self.s3.filer.delete_collection(bucket)
        except Exception:  # noqa: BLE001 — reclamation is best-effort;
            pass  # auto-vacuum collects stragglers later
        self._reply(204)

    # -- listing --------------------------------------------------------------

    def _list_objects(self, bucket, q):
        if self.s3.filer.lookup(self.s3.bucket_path(bucket)) is None:
            self._error(404, "NoSuchBucket")
            return
        v2 = q.get("list-type") == "2"
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = httpd.safe_int(q.get("max-keys"), 1000)
        after = q.get("start-after", "") or q.get("marker", "")
        token = q.get("continuation-token", "")
        if token:
            after = token

        contents: list[Entry] = []
        common: list[str] = []
        seen_common = set()
        truncated = False
        next_after = ""
        # a continuation token can point INSIDE a prefix group already
        # emitted on the previous page — skip the rest of that group or
        # the CommonPrefix would repeat across pages
        skip_group = ""
        if after and delimiter and after.startswith(prefix):
            rest = after[len(prefix) :]
            d = rest.find(delimiter)
            if d >= 0:
                skip_group = prefix + rest[: d + len(delimiter)]
        for e in self.s3.walk_keys(bucket, prefix, after=after):
            key = e.path[len(self.s3.bucket_path(bucket)) + 1 :]
            if skip_group and key.startswith(skip_group):
                continue
            if delimiter:
                rest = key[len(prefix) :]
                d = rest.find(delimiter)
                if d >= 0:
                    cp = prefix + rest[: d + len(delimiter)]
                    if cp not in seen_common:
                        if len(contents) + len(seen_common) >= max_keys:
                            truncated = True
                            break
                        seen_common.add(cp)
                        common.append(cp)
                        next_after = key
                    continue
            if len(contents) + len(seen_common) >= max_keys:
                truncated = True
                break
            contents.append(e)
            next_after = key

        root = _xml("ListBucketResult")
        _sub(root, "Name", bucket)
        _sub(root, "Prefix", prefix)
        _sub(root, "MaxKeys", str(max_keys))
        _sub(root, "IsTruncated", "true" if truncated else "false")
        if delimiter:
            _sub(root, "Delimiter", delimiter)
        if v2:
            _sub(root, "KeyCount", str(len(contents) + len(common)))
            if truncated:
                _sub(root, "NextContinuationToken", next_after)
        elif truncated:
            _sub(root, "NextMarker", next_after)
        for e in contents:
            key = e.path[len(self.s3.bucket_path(bucket)) + 1 :]
            c = _sub(root, "Contents")
            _sub(c, "Key", key)
            _sub(c, "LastModified", _iso(e.attributes.mtime))
            _sub(c, "ETag", f'"{e.attributes.md5 or ""}"')
            _sub(c, "Size", str(e.size))
            _sub(c, "StorageClass", "STANDARD")
        for cp in common:
            p = _sub(root, "CommonPrefixes")
            _sub(p, "Prefix", cp)
        self._reply(200, _render(root))

    def _walk_version_rows(self, bucket, prefix):
        """Yield (key, [(vid, is_marker, entry)] newest-first) in key order
        per directory — both live keys AND keys whose only remains are
        archived versions/markers (those have no plain entry, so
        walk_keys alone would never surface them)."""
        root = self.s3.bucket_path(bucket)

        def rec(dir_path, base):
            per_key: dict[str, dict] = {}
            subdirs: dict[str, object] = {}
            start = ""
            while True:
                batch = self.s3.filer.list(dir_path, start_from=start, limit=256)
                if not batch:
                    break
                for e in batch:
                    if e.is_directory and e.name.endswith(VERSIONS_SUFFIX):
                        per_key.setdefault(
                            base + e.name[: -len(VERSIONS_SUFFIX)], {}
                        )["vdir"] = e
                    elif e.is_directory:
                        subdirs[base + e.name + "/"] = e
                    else:
                        per_key.setdefault(base + e.name, {})["plain"] = e
                start = batch[-1].name
                if len(batch) < 256:
                    break
            for name in sorted(set(per_key) | set(subdirs)):
                if name in subdirs:
                    if name.startswith(prefix) or prefix.startswith(name):
                        yield from rec(subdirs[name].path, name)
                    continue
                if not name.startswith(prefix):
                    continue
                recs = []
                plain = per_key[name].get("plain")
                if plain is not None:
                    recs.append((self._entry_vid(plain), False, plain))
                if "vdir" in per_key[name]:
                    # the shared newest-first (and paginated) archive walk
                    recs.extend(self._archived_records(per_key[name]["vdir"].path))
                if recs:
                    yield name, recs

        yield from rec(root, "")

    def _list_object_versions(self, bucket, q):
        """ListObjectVersions: every version and delete marker, newest
        first per key. Honors prefix, max-keys, and key-marker; truncation
        cuts at KEY boundaries and names NextKeyMarker, so SDK paginators
        make progress (version-id-marker sub-pagination is not
        implemented — a single key's versions always ship whole)."""
        if self.s3.filer.lookup(self.s3.bucket_path(bucket)) is None:
            self._error(404, "NoSuchBucket")
            return
        prefix = q.get("prefix", "")
        max_keys = httpd.safe_int(q.get("max-keys"), 1000)
        key_marker = q.get("key-marker", "")
        root = _xml("ListVersionsResult")
        _sub(root, "Name", bucket)
        _sub(root, "Prefix", prefix)
        _sub(root, "MaxKeys", str(max_keys))
        if key_marker:
            _sub(root, "KeyMarker", key_marker)
        emitted = 0
        truncated = False
        last_key = ""
        for key, recs in self._walk_version_rows(bucket, prefix):
            if key_marker and key <= key_marker:
                continue
            if emitted and emitted + len(recs) > max_keys:
                truncated = True
                break
            for i, (vid, is_marker, entry) in enumerate(recs):
                el = _sub(root, "DeleteMarker" if is_marker else "Version")
                _sub(el, "Key", key)
                _sub(el, "VersionId", vid)
                _sub(el, "IsLatest", "true" if i == 0 else "false")
                _sub(el, "LastModified", _iso(entry.attributes.mtime))
                if not is_marker:
                    _sub(el, "ETag", f'"{entry.attributes.md5 or ""}"')
                    _sub(el, "Size", str(entry.size))
                    _sub(el, "StorageClass", "STANDARD")
                emitted += 1
            last_key = key
            if emitted >= max_keys:
                # stop scanning; whether anything follows decides truncation
                truncated = True
                break
        if truncated and last_key:
            _sub(root, "NextKeyMarker", last_key)
        _sub(root, "IsTruncated", "true" if truncated else "false")
        self._reply(200, _render(root))

    # -- objects --------------------------------------------------------------

    def _put_object(self, bucket, key, body):
        if self.s3.filer.lookup(self.s3.bucket_path(bucket)) is None:
            self._error(404, "NoSuchBucket")
            return
        headers = {
            "Content-Type": self.headers.get("Content-Type", "application/octet-stream")
        }
        for k, v in self.headers.items():
            if k.lower().startswith("x-amz-meta-"):
                headers[k] = v
        tagging = self.headers.get(self.TAGS_KEY, "")
        if tagging:
            pairs = urllib.parse.parse_qsl(tagging, keep_blank_values=True)
            if len(pairs) > self.MAX_TAGS:
                self._error(400, "BadRequest", f"up to {self.MAX_TAGS} tags allowed")
                return
            headers[self.TAGS_KEY] = tagging  # filer stores x-amz-* in extended
        meta: dict = {}

        def write(filer_path, vid_headers):
            req = urllib.request.Request(
                self.s3.filer_url(filer_path),
                data=body,
                method="PUT",
                headers={**headers, **vid_headers},  # x-amz-* land in extended
            )
            with tls.urlopen(req, timeout=60) as r:
                meta.update(json.loads(r.read()))

        try:
            vid_headers = self._versioned_commit(bucket, key, write)
        except urllib.error.URLError as e:
            self._error(500, "InternalError", str(e))
            return
        self._reply(
            200, headers={"ETag": f'"{meta.get("etag", "")}"', **vid_headers}
        )

    def _get_object(self, bucket, key, head: bool, version_id: str = ""):
        if version_id and not _VERSION_ID_RE.fullmatch(version_id):
            self._reply(400) if head else self._error(
                400, "InvalidArgument", "invalid versionId"
            )
            return
        if version_id:
            filer_path, entry = self._locate_version(bucket, key, version_id)
            if entry is None or entry.is_directory:
                self._reply(404) if head else self._error(
                    404, "NoSuchVersion", version_id
                )
                return
            if self._is_marker(entry):
                # AWS: GET on a delete-marker version is 405
                self._reply(
                    405, headers={"x-amz-delete-marker": "true", "Allow": "DELETE"}
                ) if head else self._error(405, "MethodNotAllowed", "delete marker")
                return
        else:
            filer_path = self.s3.object_path(bucket, key)
            entry = self.s3.filer.lookup(filer_path)
        if entry is None or entry.is_directory:
            marker_headers = {}
            if self.s3.get_bucket_versioning(bucket):
                # latest may be a delete marker: 404, but say so
                versions = self._key_versions(bucket, key)
                if versions and versions[0][1]:
                    marker_headers = {
                        "x-amz-delete-marker": "true",
                        self.s3.VID_KEY: versions[0][0],
                    }
            if head:
                self._reply(404, headers=marker_headers)
            else:
                root = _xml("Error", ns=False)
                _sub(root, "Code", "NoSuchKey")
                _sub(root, "Message", key)
                self._reply(404, _render(root), headers=marker_headers)
            return
        # conditional requests (RFC 9110 semantics S3 clients cache with)
        from seaweedfs_tpu_torch.filer.chunks import etag_of as _etag_of

        etag = _etag_of(entry.chunks, entry.attributes.md5)
        inm = self.headers.get("If-None-Match", "")
        if inm:
            # RFC 9110: when If-None-Match is present, If-Modified-Since
            # MUST be ignored — a failed ETag match means the client's copy
            # is stale even if the 1s-granular Last-Modified looks current
            if inm.strip('"') in (etag, "*"):
                self._reply(304, headers={"ETag": f'"{etag}"'})
                return
        else:
            ims = self.headers.get("If-Modified-Since", "")
            if ims:
                import email.utils as _eut

                try:
                    since = _eut.parsedate_to_datetime(ims).timestamp()
                    if int(entry.attributes.mtime) <= int(since):
                        self._reply(304, headers={"ETag": f'"{etag}"'})
                        return
                except (TypeError, ValueError):
                    pass  # unparseable date: ignore the condition
        fwd = {}
        rng = self.headers.get("Range", "")
        if rng and not head:
            fwd["Range"] = rng
        req = urllib.request.Request(
            self.s3.filer_url(filer_path),
            headers=fwd,
            method="HEAD" if head else "GET",
        )
        try:
            with tls.urlopen(req, timeout=60) as r:
                body = b"" if head else r.read()
                out_headers = {
                    "ETag": r.headers.get("ETag", ""),
                    "Last-Modified": r.headers.get("Last-Modified", ""),
                    "Accept-Ranges": "bytes",
                }
                for k, v in r.headers.items():
                    if k.lower().startswith("x-amz-meta-") or (
                        k.lower() == self.s3.VID_KEY
                    ):
                        out_headers[k] = v
                tagging = r.headers.get(self.TAGS_KEY, "")
                if tagging:  # S3 exposes only the count, not the tags
                    out_headers["x-amz-tagging-count"] = str(
                        len(urllib.parse.parse_qsl(tagging, keep_blank_values=True))
                    )
                if r.headers.get("Content-Range"):
                    out_headers["Content-Range"] = r.headers["Content-Range"]
                if head:
                    out_headers["Content-Length"] = r.headers.get("Content-Length", "0")
                    self.send_response(r.status)
                    self.send_header(
                        "Content-Type", r.headers.get("Content-Type", "application/octet-stream")
                    )
                    for k, v in out_headers.items():
                        self.send_header(k, v)
                    self.end_headers()
                    return
                self._reply(
                    r.status,
                    body,
                    r.headers.get("Content-Type", "application/octet-stream"),
                    headers=out_headers,
                )
        except urllib.error.HTTPError as e:
            if e.code == 416:
                self._error(416, "InvalidRange")
            else:
                self._error(404, "NoSuchKey", key)

    def _resolve_copy_source(self, src: str, identity):
        """Shared x-amz-copy-source resolution for CopyObject and
        UploadPartCopy: parse, validate the path, check the caller's Read
        grant on the SOURCE bucket (the signature only proved Write on the
        destination), and confirm the source exists and is an object —
        a directory source would otherwise serve the filer's JSON listing
        as object bytes. Replies the error itself; returns
        (s_bucket, s_key, s_filer_path, version_id) or None."""
        # AWS appends ?versionId AFTER the percent-encoded key, so split
        # BEFORE unquoting — decoding first would truncate a key that
        # legitimately contains an encoded '?' (%3F)
        src_enc, _, src_q = src.partition("?")
        src_path = urllib.parse.unquote(src_enc)
        if src_path.startswith("/"):
            src_path = src_path[1:]
        version_id = ""
        if src_q:
            qd = dict(urllib.parse.parse_qsl(src_q, keep_blank_values=True))
            version_id = qd.get("versionId", "")
        s_bucket, _, s_key = src_path.partition("/")
        if not s_key or not _valid_path(s_bucket, s_key):
            self._error(400, "InvalidArgument", "invalid copy source")
            return None
        if version_id and not _VERSION_ID_RE.fullmatch(version_id):
            self._error(400, "InvalidArgument", "invalid copy source versionId")
            return None
        # the SOURCE bucket's policy binds here too: a denied direct GET
        # must not be readable by copying it into a bucket the caller can
        # write (IAM evaluation order).
        # A versioned source reads under s3:GetObjectVersion, like AWS.
        verdict = self._policy_verdict(
            s_bucket, s_key, identity,
            "s3:GetObjectVersion" if version_id else "s3:GetObject",
        )
        if verdict is False:
            self._error(403, "AccessDenied", "denied by source bucket policy")
            return None
        if verdict is not True and not identity.can_do(ACTION_READ, s_bucket):
            self._error(403, "AccessDenied", f"no Read on {s_bucket}")
            return None
        if version_id:
            s_path, s_entry = self._locate_version(s_bucket, s_key, version_id)
            if s_entry is not None and self._is_marker(s_entry):
                # AWS: a copy source may not name a delete marker by id
                self._error(400, "InvalidRequest", "source version is a delete marker")
                return None
        else:
            s_path = self.s3.object_path(s_bucket, s_key)
            s_entry = self.s3.filer.lookup(s_path)
        if s_entry is None or s_entry.is_directory:
            self._error(
                404, "NoSuchVersion" if version_id else "NoSuchKey", src
            )
            return None
        return s_bucket, s_key, s_path, version_id

    def _copy_object(self, bucket, key, src, identity):
        resolved = self._resolve_copy_source(src, identity)
        if resolved is None:
            return
        _s_bucket, _s_key, s_path, src_vid = resolved
        # stream through the filer: read source, write dest (fresh needles,
        # so source delete can never orphan the copy)
        try:
            with tls.urlopen(self.s3.filer_url(s_path), timeout=60) as r:
                data = r.read()
                ctype = r.headers.get("Content-Type", "application/octet-stream")
        except urllib.error.URLError as e:
            self._error(500, "InternalError", str(e))
            return
        meta: dict = {}

        def write(filer_path, vid_headers):
            req = urllib.request.Request(
                self.s3.filer_url(filer_path),
                data=data,
                method="PUT",
                headers={"Content-Type": ctype, **vid_headers},
            )
            with tls.urlopen(req, timeout=60) as r:
                meta.update(json.loads(r.read()))

        vid_headers = self._versioned_commit(bucket, key, write)
        if src_vid:
            vid_headers = {**vid_headers, "x-amz-copy-source-version-id": src_vid}
        root = _xml("CopyObjectResult")
        _sub(root, "ETag", f'"{meta.get("etag", "")}"')
        _sub(root, "LastModified", _iso(time.time()))
        self._reply(200, _render(root), headers=vid_headers)

    # -- versioning plumbing ---------------------------------------------------

    def _entry_vid(self, entry) -> str:
        """The stored version id of an entry; 'null' for objects written
        while versioning was off/suspended (AWS's pre-versioning id)."""
        for k, v in entry.extended.items():
            if k.lower() == self.s3.VID_KEY:
                return v
        return "null"

    def _is_marker(self, entry) -> bool:
        return self.s3.MARKER_KEY in entry.extended

    def _locate_version(self, bucket, key, version_id):
        """-> (filer_path, entry|None) for one version id: the plain path
        when the current latest carries that id, else the archive slot —
        the ONE resolution shared by GET, DELETE, and copy-source (a
        caller-local copy of this branch would drift on marker/latest
        semantics)."""
        plain = self.s3.object_path(bucket, key)
        cur = self.s3.filer.lookup(plain)
        if (
            cur is not None
            and not cur.is_directory
            and self._entry_vid(cur) == version_id
        ):
            return plain, cur
        vpath = f"{self.s3.versions_dir(bucket, key)}/{version_id}"
        return vpath, self.s3.filer.lookup(vpath)

    def _archive_current(self, bucket, key, status, drop_null: bool = False) -> None:
        """Move the plain-path entry (the latest version) into the version
        archive under its own id, clearing the way for a new latest.
        Under Suspended, the 'null' version is overwritten in place (AWS
        semantics), so only real-id versions are archived — unless
        drop_null asks for the delete-path behavior, where the null
        version is permanently removed."""
        plain = self.s3.object_path(bucket, key)
        cur = self.s3.filer.lookup(plain)
        if cur is None or cur.is_directory:
            return
        vid = self._entry_vid(cur)
        if status == "Suspended" and vid == "null":
            if drop_null:
                self.s3.filer.delete(plain)
            return
        self.s3.filer.rename(plain, f"{self.s3.versions_dir(bucket, key)}/{vid}")

    def _versioned_commit(self, bucket, key, write_fn) -> dict[str, str]:
        """Orchestrate any write that replaces the plain path (PutObject,
        CopyObject, CompleteMultipartUpload). write_fn(filer_path,
        vid_headers) performs the actual write at the path it is given.

        Versioned buckets stage the new object INSIDE the archive first,
        then move the old latest aside, then rename the staged write into
        place — so a failed write leaves the previous latest untouched
        instead of already-archived (a plain-path-first ordering would
        turn a 500 into a 404 for readers). Returns the version headers
        the caller's reply must carry."""
        status = self.s3.get_bucket_versioning(bucket)
        plain = self.s3.object_path(bucket, key)
        if status not in ("Enabled", "Suspended"):
            write_fn(plain, {})
            return {}
        vid = self.s3.new_version_id() if status == "Enabled" else "null"
        vid_headers = {self.s3.VID_KEY: vid}
        staging = f"{self.s3.versions_dir(bucket, key)}/{vid}"
        write_fn(staging, vid_headers)
        self._archive_current(bucket, key, status)
        self.s3.filer.rename(staging, plain)
        return vid_headers

    #: filer page size for version-archive listings (class attr so tests
    #: can shrink it to exercise pagination without 1000+ versions)
    _VERSION_PAGE = 1000

    def _archived_records(self, vdir_path) -> list[tuple[str, bool, object]]:
        """[(vid, is_marker, entry)] of the version archive, newest first —
        the ONE ordering shared by listings, promotion, and marker
        detection (ties break on the time-ordered hex id). Paginated: a
        one-shot limited list would silently drop the NEWEST versions of a
        key with more versions than the limit (ids are time-ordered and
        the filer lists ascending), letting _promote_newest resurrect a
        stale version after a delete."""
        archived = []
        start = ""
        while True:
            batch = self.s3.filer.list(
                vdir_path, start_from=start, limit=self._VERSION_PAGE
            )
            if not batch:
                break
            archived.extend(e for e in batch if not e.is_directory)
            start = batch[-1].name
            if len(batch) < self._VERSION_PAGE:
                break
        archived.sort(key=lambda e: (e.attributes.mtime, e.name), reverse=True)
        return [(e.name, self._is_marker(e), e) for e in archived]

    def _key_versions(self, bucket, key) -> list[tuple[str, bool, object]]:
        """[(vid, is_marker, entry)] newest first. The plain entry (when
        present) is always the newest real version by the layout
        invariant; archived entries order by mtime."""
        out = []
        plain = self.s3.filer.lookup(self.s3.object_path(bucket, key))
        if plain is not None and not plain.is_directory:
            out.append((self._entry_vid(plain), False, plain))
        out.extend(self._archived_records(self.s3.versions_dir(bucket, key)))
        return out

    def _promote_newest(self, bucket, key) -> None:
        """After the current latest was permanently deleted: if the newest
        archived record is a REAL version, rename it back to the plain
        path so reads keep working (a marker stays archived — the key
        reads as deleted)."""
        vdir = self.s3.versions_dir(bucket, key)
        records = self._archived_records(vdir)
        if records and not records[0][1]:
            self.s3.filer.rename(
                f"{vdir}/{records[0][0]}", self.s3.object_path(bucket, key)
            )

    def _delete_object_versioned(self, bucket, key, version_id: str) -> dict:
        """Shared by DeleteObject and DeleteObjects. Returns the reply
        headers (version id / delete-marker) — S3 deletes are idempotent,
        so missing things succeed quietly."""
        from seaweedfs_tpu_torch.filer.entry import Attributes as _A
        from seaweedfs_tpu_torch.filer.entry import Entry as _E

        status = self.s3.get_bucket_versioning(bucket)
        plain = self.s3.object_path(bucket, key)
        if version_id and not _VERSION_ID_RE.fullmatch(version_id):
            raise ValueError("invalid versionId")
        if version_id:
            # permanent delete of one version
            vpath, ventry = self._locate_version(bucket, key, version_id)
            if vpath == plain:
                self.s3.filer.delete(plain)
                self._promote_newest(bucket, key)
                self._prune_versioned_remains(bucket, key)
                return {self.s3.VID_KEY: version_id}
            headers = {self.s3.VID_KEY: version_id}
            if ventry is not None:
                if self._is_marker(ventry):
                    headers["x-amz-delete-marker"] = "true"
                self.s3.filer.delete(vpath)
                if self._is_marker(ventry) and self.s3.filer.lookup(plain) is None:
                    # removing the masking marker can re-expose a version
                    self._promote_newest(bucket, key)
            self._prune_versioned_remains(bucket, key)
            return headers
        if status in ("Enabled", "Suspended"):
            # logical delete: archive the latest, leave a marker. Under
            # Suspended the 'null' version is REMOVED (AWS: the null
            # marker replaces it) — archiving-by-overwrite alone would
            # leave the plain path serving the supposedly deleted bytes.
            self._archive_current(bucket, key, status, drop_null=True)
            vid = self.s3.new_version_id() if status == "Enabled" else "null"
            marker = _E(
                path=f"{self.s3.versions_dir(bucket, key)}/{vid}",
                attributes=_A(mtime=time.time()),
                extended={self.s3.VID_KEY: vid, self.s3.MARKER_KEY: "1"},
            )
            self.s3.filer.create(marker)  # replaces a prior 'null' marker
            return {self.s3.VID_KEY: vid, "x-amz-delete-marker": "true"}
        try:
            self.s3.filer.delete(plain)
        except Exception:  # noqa: BLE001 — S3 delete is idempotent
            pass
        self._prune_empty_parents(bucket, key)
        return {}

    def _prune_versioned_remains(self, bucket, key) -> None:
        """After a permanent version delete: when the last version of a
        key is gone (plain path absent, archive empty), drop the empty
        archive dir and the folder husks — otherwise DeleteBucket on a
        fully-emptied versioned bucket reports BucketNotEmpty forever."""
        if self.s3.filer.lookup(self.s3.object_path(bucket, key)) is not None:
            return
        vdir = self.s3.versions_dir(bucket, key)
        try:
            if self.s3.filer.lookup(vdir) is not None:
                if self.s3.filer.list(vdir, limit=1):
                    return  # versions remain: the key still exists
                self.s3.filer.delete(vdir)
        except Exception:  # noqa: BLE001 — raced; husks are best-effort
            return
        self._prune_empty_parents(bucket, key)

    def _prune_empty_parents(self, bucket, key) -> None:
        """Remove now-empty ancestor DIRECTORIES of a deleted key, up to
        (never including) the bucket root — S3 has no real folders, and
        leaving husks behind blocks DeleteBucket's emptiness check
        (upstream's weed/s3api doDeleteEmptyDirectories)."""
        # a folder-marker key ("a/b/") normalizes to the directory itself:
        # its first ancestor is a/  — probing the just-deleted path would
        # abort the walk on NOT_FOUND
        parts = key.rstrip("/").split("/")[:-1]
        while parts:
            d = self.s3.object_path(bucket, "/".join(parts))
            try:
                if self.s3.filer.list(d, limit=1):
                    return  # first non-empty ancestor ends the walk
                self.s3.filer.delete(d)
            except Exception:  # noqa: BLE001 — raced or already gone
                return
            parts.pop()

    def _delete_object(self, bucket, key, version_id: str = ""):
        try:
            headers = self._delete_object_versioned(bucket, key, version_id)
        except ValueError:
            self._error(400, "InvalidArgument", "invalid versionId")
            return
        self._reply(204, headers=headers)

    # -- object tagging (Get/Put/DeleteObjectTagging) --------------------------
    #
    # Tags live in the entry's extended attributes under TAGS_KEY as the
    # same urlencoded k=v&k=v form the x-amz-tagging PUT header uses, so a
    # tagged upload and a PutObjectTagging produce identical state.

    TAGS_KEY = "x-amz-tagging"
    MAX_TAGS = 10  # AWS object-tagging limit

    def _lookup_object(self, bucket, key):
        entry = self.s3.filer.lookup(self.s3.object_path(bucket, key))
        if entry is None or entry.is_directory:
            self._error(404, "NoSuchKey", key)
            return None
        return entry

    def _entry_tags(self, entry) -> str:
        """The stored tag string, tolerant of HTTP header-name case (the
        filer keeps upload headers verbatim, e.g. 'X-amz-tagging')."""
        for k, v in entry.extended.items():
            if k.lower() == self.TAGS_KEY:
                return v
        return ""

    def _drop_entry_tags(self, entry) -> bool:
        victims = [k for k in entry.extended if k.lower() == self.TAGS_KEY]
        for k in victims:
            del entry.extended[k]
        return bool(victims)

    def _get_acl(self):
        """Canned private/FULL_CONTROL ACL (Get{Bucket,Object}Acl): access
        control here is identity-based (SigV4 + IAM actions), not ACLs, but
        SDK flows probe these endpoints and must not get a 4xx/501."""
        root = _xml("AccessControlPolicy")
        owner = _sub(root, "Owner")
        _sub(owner, "ID", "weedtpu")
        _sub(owner, "DisplayName", "weedtpu")
        grants = _sub(root, "AccessControlList")
        grant = _sub(grants, "Grant")
        grantee = _sub(grant, "Grantee")
        grantee.set("xmlns:xsi", "http://www.w3.org/2001/XMLSchema-instance")
        grantee.set("xsi:type", "CanonicalUser")
        _sub(grantee, "ID", "weedtpu")
        _sub(grant, "Permission", "FULL_CONTROL")
        self._reply(200, _render(root))

    def _get_tagging(self, bucket, key):
        entry = self._lookup_object(bucket, key)
        if entry is None:
            return
        root = _xml("Tagging")
        tagset = _sub(root, "TagSet")
        for k, v in urllib.parse.parse_qsl(
            self._entry_tags(entry), keep_blank_values=True
        ):
            t = _sub(tagset, "Tag")
            _sub(t, "Key", k)
            _sub(t, "Value", v)
        self._reply(200, _render(root))

    def _put_tagging(self, bucket, key, body):
        entry = self._lookup_object(bucket, key)
        if entry is None:
            return
        try:
            tree = ET.fromstring(body)
        except ET.ParseError:
            self._error(400, "MalformedXML")
            return
        ns = tree.tag[: tree.tag.index("}") + 1] if tree.tag.startswith("{") else ""
        tags: list[tuple[str, str]] = []
        for t in tree.findall(f"{ns}TagSet/{ns}Tag"):
            k_el, v_el = t.find(f"{ns}Key"), t.find(f"{ns}Value")
            k = (k_el.text or "") if k_el is not None else ""
            v = (v_el.text or "") if v_el is not None else ""
            if not k or len(k) > 128 or len(v) > 256:
                self._error(400, "InvalidTag", k)
                return
            tags.append((k, v))
        if len(tags) > self.MAX_TAGS:
            self._error(400, "BadRequest", f"up to {self.MAX_TAGS} tags allowed")
            return
        if len({k for k, _ in tags}) != len(tags):
            self._error(400, "InvalidTag", "duplicate tag keys")
            return
        self._drop_entry_tags(entry)
        entry.extended[self.TAGS_KEY] = urllib.parse.urlencode(tags)
        self.s3.filer.update(entry)
        self._reply(200)

    def _delete_tagging(self, bucket, key):
        entry = self._lookup_object(bucket, key)
        if entry is None:
            return
        if self._drop_entry_tags(entry):
            self.s3.filer.update(entry)
        self._reply(204)

    def _delete_objects(self, bucket, body, identity):
        try:
            tree = ET.fromstring(body)
        except ET.ParseError:
            self._error(400, "MalformedXML")
            return
        ns = ""
        if tree.tag.startswith("{"):
            ns = tree.tag[: tree.tag.index("}") + 1]
        root = _xml("DeleteResult")
        for obj in tree.findall(f"{ns}Object"):
            key_el = obj.find(f"{ns}Key")
            if key_el is None or not key_el.text:
                continue
            if not _valid_path(bucket, key_el.text):
                err = _sub(root, "Error")
                _sub(err, "Key", key_el.text)
                _sub(err, "Code", "InvalidArgument")
                continue
            vid_el = obj.find(f"{ns}VersionId")
            vid = (vid_el.text or "").strip() if vid_el is not None else ""
            # the bucket-level _auth saw resource arn:...:bucket; per-key
            # denies (s3:DeleteObject on a prefix) must still bind here —
            # and an entry naming a VersionId is a permanent versioned
            # delete, which authorizes under s3:DeleteObjectVersion
            verdict = self._policy_verdict(
                bucket, key_el.text, identity,
                "s3:DeleteObjectVersion" if vid else "s3:DeleteObject",
            )
            if verdict is False or (
                self._is_anonymous(identity) and verdict is not True
            ):
                err = _sub(root, "Error")
                _sub(err, "Key", key_el.text)
                _sub(err, "Code", "AccessDenied")
                continue
            try:
                headers = self._delete_object_versioned(bucket, key_el.text, vid)
            except ValueError:
                err = _sub(root, "Error")
                _sub(err, "Key", key_el.text)
                _sub(err, "Code", "InvalidArgument")
                continue
            except Exception:  # noqa: BLE001
                headers = {}
            d = _sub(root, "Deleted")
            _sub(d, "Key", key_el.text)
            if headers.get("x-amz-delete-marker"):
                _sub(d, "DeleteMarker", "true")
                _sub(d, "DeleteMarkerVersionId", headers.get(self.s3.VID_KEY, ""))
            elif vid:
                _sub(d, "VersionId", vid)
        self._reply(200, _render(root))

    # -- multipart ------------------------------------------------------------

    def _upload_dir(self, bucket, upload_id):
        return f"{UPLOADS_ROOT}/{bucket}/{upload_id}"

    def _valid_upload(self, upload_id) -> bool:
        """Reject any uploadId that is not a uuid4().hex we could have
        minted — 404 NoSuchUpload, same as an unknown id."""
        if _UPLOAD_ID_RE.fullmatch(upload_id or ""):
            return True
        self._error(404, "NoSuchUpload")
        return False

    def _initiate_multipart(self, bucket, key):
        from seaweedfs_tpu_torch.filer.entry import Entry as _E

        upload_id = uuid.uuid4().hex
        meta = {
            "key": key,
            "content_type": self.headers.get("Content-Type", "application/octet-stream"),
            **{
                k.lower(): v
                for k, v in self.headers.items()
                if k.lower().startswith("x-amz-meta-")
            },
        }
        e = _E(path=self._upload_dir(bucket, upload_id), is_directory=True)
        e.extended = {"s3": json.dumps(meta)}
        self.s3.filer.create(e)
        root = _xml("InitiateMultipartUploadResult")
        _sub(root, "Bucket", bucket)
        _sub(root, "Key", key)
        _sub(root, "UploadId", upload_id)
        self._reply(200, _render(root))

    def _upload_part(self, bucket, key, q, body, identity):
        part = httpd.safe_int(q.get("partNumber"), -1)
        if not 1 <= part <= 10000:
            self._error(400, "InvalidArgument", "bad partNumber")
            return
        upload_id = q["uploadId"]
        if not self._valid_upload(upload_id):
            return
        if self.s3.filer.lookup(self._upload_dir(bucket, upload_id)) is None:
            self._error(404, "NoSuchUpload")
            return
        # UploadPartCopy: the part's bytes come from an existing object
        # (optionally a range) instead of the request body
        copy_src = self.headers.get("x-amz-copy-source", "")
        was_copy = bool(copy_src)
        src_resp = None
        put_headers: dict[str, str] = {}
        if was_copy:
            opened = self._open_copy_source(copy_src, identity)
            if opened is None:
                return  # error already replied
            # stream the source straight through to the staging path: parts
            # can be up to 5 GiB and buffering one in gateway memory is an
            # OOM (r4 advisor finding) — urllib takes a file-like body when
            # the length is pinned by an explicit Content-Length
            src_resp, length, src_vid = opened
            body = src_resp
            put_headers["Content-Length"] = str(length)
        path = f"{self._upload_dir(bucket, upload_id)}/part{part:05d}"
        try:
            req = urllib.request.Request(
                self.s3.filer_url(path), data=body, headers=put_headers, method="PUT"
            )
            with tls.urlopen(req, timeout=600 if was_copy else 60) as r:
                meta = json.loads(r.read())
        finally:
            if src_resp is not None:
                src_resp.close()
        etag = meta.get("etag", "")
        if was_copy:  # CopyPartResult body, per the API shape
            root = _xml("CopyPartResult")
            _sub(root, "ETag", f'"{etag}"')
            _sub(root, "LastModified", _iso(time.time()))
            out_h = {"ETag": f'"{etag}"'}
            if src_vid:
                out_h["x-amz-copy-source-version-id"] = src_vid
            self._reply(200, _render(root), headers=out_h)
        else:
            self._reply(200, headers={"ETag": f'"{etag}"'})

    def _open_copy_source(self, src: str, identity):
        """Resolve x-amz-copy-source [+ x-amz-copy-source-range] to an OPEN
        streaming response for UploadPartCopy (shared parse/auth/existence
        via _resolve_copy_source) -> (file-like, length, source version
        id). The caller owns closing it. Replies the error itself; None
        on failure."""
        resolved = self._resolve_copy_source(src, identity)
        if resolved is None:
            return None
        _s_bucket, _s_key, s_path, _src_vid = resolved
        headers = {}
        rng = self.headers.get("x-amz-copy-source-range", "")
        if rng:
            headers["Range"] = rng
        try:
            r = tls.urlopen(
                urllib.request.Request(
                    self.s3.filer_url(s_path),
                    headers=headers,
                ),
                timeout=600,
            )
            length = r.headers.get("Content-Length")
            if length is None:
                # a filer that doesn't pin the length forces a buffered
                # fallback — urllib needs Content-Length for file-like data
                buf = r.read()
                r.close()
                return io.BytesIO(buf), len(buf), _src_vid
            return r, int(length), _src_vid
        except urllib.error.HTTPError as e:
            if e.code == 416:
                self._error(416, "InvalidRange")
            elif e.code == 404:  # raced a delete since the lookup
                self._error(404, "NoSuchKey", src)
            else:  # a filer 5xx is OUR failure, not a missing source
                self._error(500, "InternalError", f"filer returned {e.code}")
            return None
        except urllib.error.URLError as e:
            self._error(500, "InternalError", str(e))
            return None

    def _list_parts(self, bucket, key, upload_id):
        if not self._valid_upload(upload_id):
            return
        d = self._upload_dir(bucket, upload_id)
        if self.s3.filer.lookup(d) is None:
            self._error(404, "NoSuchUpload")
            return
        root = _xml("ListPartsResult")
        _sub(root, "Bucket", bucket)
        _sub(root, "Key", key)
        _sub(root, "UploadId", upload_id)
        for e in self.s3.filer.list(d, limit=10000):
            num = httpd.safe_int(e.name[4:], -1) if e.name.startswith("part") else -1
            if num < 0:  # stray entry, not one of our staged parts
                continue
            p = _sub(root, "Part")
            _sub(p, "PartNumber", str(num))
            _sub(p, "ETag", f'"{e.attributes.md5}"')
            _sub(p, "Size", str(e.size))
            _sub(p, "LastModified", _iso(e.attributes.mtime))
        self._reply(200, _render(root))

    def _complete_multipart(self, bucket, key, upload_id, body):
        from seaweedfs_tpu_torch.filer.entry import Attributes, Entry as _E, FileChunk

        if not self._valid_upload(upload_id):
            return
        d = self._upload_dir(bucket, upload_id)
        dir_entry = self.s3.filer.lookup(d)
        if dir_entry is None:
            self._error(404, "NoSuchUpload")
            return
        staged = {}
        for e in self.s3.filer.list(d, limit=10000):
            num = httpd.safe_int(e.name[4:], -1) if e.name.startswith("part") else -1
            if num >= 0:
                staged[num] = e
        # S3 commits exactly the parts the client lists, validating
        # ETags and ascending order — never just "everything staged"
        try:
            tree = ET.fromstring(body)
        except ET.ParseError:
            self._error(400, "MalformedXML")
            return
        ns = tree.tag[: tree.tag.index("}") + 1] if tree.tag.startswith("{") else ""
        req_parts: list[tuple[int, str]] = []
        for pe in tree.findall(f"{ns}Part"):
            num_el, etag_el = pe.find(f"{ns}PartNumber"), pe.find(f"{ns}ETag")
            num = httpd.safe_int(num_el.text if num_el is not None else None, -1)
            etag = (etag_el.text or "").strip().strip('"') if etag_el is not None else ""
            req_parts.append((num, etag))
        if not req_parts:
            self._error(400, "InvalidPart")
            return
        nums = [n for n, _ in req_parts]
        if nums != sorted(nums) or len(set(nums)) != len(nums):
            self._error(400, "InvalidPartOrder")
            return
        for num, etag in req_parts:
            e = staged.get(num)
            if e is None or (etag and etag != e.attributes.md5):
                self._error(400, "InvalidPart", f"part {num}")
                return
        parts = [staged[n] for n in nums]
        # splice part chunk lists; no data copy (filer_multipart.go pattern)
        chunks: list[FileChunk] = []
        offset = 0
        etag_md5 = hashlib.md5()
        for p in parts:
            for c in sorted(p.chunks, key=lambda c: c.offset):
                chunks.append(
                    FileChunk(
                        fid=c.fid,
                        offset=offset + c.offset,
                        size=c.size,
                        mtime_ns=c.mtime_ns,
                        etag=c.etag,
                        is_chunk_manifest=c.is_chunk_manifest,
                    )
                )
            offset += p.size
            etag_md5.update(bytes.fromhex(p.attributes.md5))
        meta = json.loads(dir_entry.extended.get("s3", "{}"))
        etag = f"{etag_md5.hexdigest()}-{len(parts)}"

        def write(filer_path, vid_headers):
            self.s3.filer.create(
                _E(
                    path=filer_path,
                    attributes=Attributes(
                        mtime=time.time(),
                        mime=meta.get("content_type", "application/octet-stream"),
                        md5=etag,
                        file_size=offset,
                    ),
                    chunks=chunks,
                    extended={
                        **{
                            k: v
                            for k, v in meta.items()
                            if k.startswith("x-amz-meta-")
                        },
                        **vid_headers,
                    },
                )
            )

        vid_headers = self._versioned_commit(bucket, key, write)
        # drop the staging entries but keep the needles (now owned by the
        # final object)
        self.s3.filer.delete(d, recursive=True, delete_data=False)
        root = _xml("CompleteMultipartUploadResult")
        _sub(root, "Location", f"{tls.scheme()}://{self.s3.url}/{bucket}/{key}")
        _sub(root, "Bucket", bucket)
        _sub(root, "Key", key)
        _sub(root, "ETag", f'"{etag}"')
        self._reply(200, _render(root), headers=vid_headers)

    def _abort_multipart(self, bucket, key, upload_id):
        if not self._valid_upload(upload_id):
            return
        d = self._upload_dir(bucket, upload_id)
        if self.s3.filer.lookup(d) is not None:
            self.s3.filer.delete(d, recursive=True)
        self._reply(204)
