"""AWS Signature V4 + identity access control, after upstream's
weed/s3api/auth_signature_v4.go and auth_credentials.go.

Identities come from the s3 config (the reference's `-s3.config` JSON /
filer-stored identities): each has credentials and a list of actions,
optionally bucket-scoped ("Read:bucketname"). With no identities
configured the gateway is open (anonymous Admin), matching the
reference's default dev behavior.

`sign_request` and `presign_url` are the client half (used by tests, the
load harness and the S3 remote-storage vendor), so signatures are
verified against an independent implementation of the same spec.
"""

from __future__ import annotations

import calendar
import hashlib
import hmac
import json
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Optional

_MAX_SKEW_S = 15 * 60  # SigV4 replay window

ACTION_ADMIN = "Admin"
ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_LIST = "List"

_ALGO = "AWS4-HMAC-SHA256"


@dataclass
class Identity:
    name: str
    access_key: str
    secret_key: str
    actions: list[str] = field(default_factory=lambda: [ACTION_ADMIN])

    def can_do(self, action: str, bucket: str = "") -> bool:
        for a in self.actions:
            if a == ACTION_ADMIN:
                return True
            base, _, scope = a.partition(":")
            if base != action:
                continue
            if not scope or scope == bucket:
                return True
        return False


class Iam:
    """Identity set + SigV4 verifier."""

    def __init__(self, identities: Optional[list[Identity]] = None):
        self.identities = list(identities or [])

    @classmethod
    def from_config(cls, conf: dict) -> "Iam":
        """Parse the reference's s3 config shape:
        {"identities": [{"name": ..., "credentials": [{"accessKey": ...,
        "secretKey": ...}], "actions": ["Read", "Write:bucket"]}]}"""
        ids = []
        for d in conf.get("identities", []):
            for cred in d.get("credentials", []):
                ids.append(
                    Identity(
                        name=d.get("name", cred.get("accessKey", "")),
                        access_key=cred.get("accessKey", ""),
                        secret_key=cred.get("secretKey", ""),
                        actions=list(d.get("actions", [ACTION_ADMIN])),
                    )
                )
        return cls(ids)

    @property
    def open(self) -> bool:
        return not self.identities

    def lookup(self, access_key: str) -> Optional[Identity]:
        if not access_key:  # credential-less users (revoked keys) never match
            return None
        for i in self.identities:
            if i.access_key == access_key:
                return i
        return None

    def add(self, identity: Identity) -> None:
        self.identities = [
            i for i in self.identities if i.access_key != identity.access_key
        ] + [identity]

    def remove(self, access_key: str) -> None:
        self.identities = [i for i in self.identities if i.access_key != access_key]

    # -- verification ---------------------------------------------------------

    def authenticate(
        self,
        method: str,
        path: str,
        query: str,
        headers: dict[str, str],
        payload: bytes,
        expect_service: Optional[str] = None,
        expect_hosts: Optional[set[str]] = None,
    ) -> tuple[Optional[Identity], str]:
        """Returns (identity, "") on success or (None, error_code).
        Error codes follow S3: AccessDenied / InvalidAccessKeyId /
        SignatureDoesNotMatch / MissingSecurityHeader.

        expect_service pins the credential scope's service field (s3/iam)
        so a request signed for one endpoint class cannot be replayed
        verbatim against another within the skew window; expect_hosts pins
        the signed `host` header to the server's own advertised names."""
        payload_decl = headers.get("x-amz-content-sha256", "")
        if payload_decl.startswith("STREAMING-"):
            # aws-chunked framing is never decoded — reject on open
            # gateways too, or the framing bytes get stored as data
            return None, "NotImplemented"
        if self.open:
            return Identity("anonymous", "", "", [ACTION_ADMIN]), ""
        qparams = dict(urllib.parse.parse_qsl(query, keep_blank_values=True))
        if "X-Amz-Signature" in qparams:
            # presigned URL: SigV4 in the query string, not the headers
            return self._authenticate_presigned(
                method, path, query, headers, qparams, expect_service, expect_hosts
            )
        auth = headers.get("authorization", "")
        if not auth.startswith(_ALGO):
            return None, "MissingSecurityHeader"
        try:
            fields = dict(
                kv.strip().split("=", 1)
                for kv in auth[len(_ALGO) :].strip().split(",")
            )
            cred = fields["Credential"]
            signed_headers = fields["SignedHeaders"].split(";")
            got_sig = fields["Signature"]
            access_key, date, region, service, _ = cred.split("/", 4)
        except (KeyError, ValueError):
            return None, "AuthorizationHeaderMalformed"
        if expect_service is not None and service != expect_service:
            # scope mismatch: signed for a different endpoint class
            return None, "AccessDenied"
        # the signature must bind the target endpoint or a captured
        # request verifies verbatim against any other server sharing the
        # identity set
        if "host" not in signed_headers:
            return None, "InvalidRequest"
        # Host is case-insensitive per RFC 9110 §4.2.3; expect_hosts is
        # pre-lowercased by the servers at construction
        if expect_hosts is not None and headers.get("host", "").lower() not in expect_hosts:
            return None, "AccessDenied"
        identity = self.lookup(access_key)
        if identity is None:
            return None, "InvalidAccessKeyId"
        amz_date = headers.get("x-amz-date", "")
        try:
            req_ts = calendar.timegm(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
        except ValueError:
            return None, "AccessDenied"
        if abs(time.time() - req_ts) > _MAX_SKEW_S:  # replayed/stale request
            return None, "RequestTimeTooSkewed"
        payload_hash = payload_decl
        # AWS requires x-amz-content-sha256 on every signed S3 request,
        # and it must itself be signed: an absent or unsigned header lets
        # a captured signature be replayed with a substituted body
        if not payload_hash:
            return None, "MissingSecurityHeader"
        if "x-amz-content-sha256" not in signed_headers:
            return None, "InvalidRequest"
        if payload_hash != "UNSIGNED-PAYLOAD":
            if hashlib.sha256(payload).hexdigest() != payload_hash:
                return None, "XAmzContentSHA256Mismatch"
        want = _signature(
            identity.secret_key,
            method,
            path,
            query,
            headers,
            signed_headers,
            payload_hash,
            amz_date,
            region,
            service,
        )
        if not hmac.compare_digest(want, got_sig):
            return None, "SignatureDoesNotMatch"
        return identity, ""


    _PRESIGN_MAX_EXPIRES = 7 * 24 * 3600  # AWS's 7-day ceiling

    def _authenticate_presigned(
        self,
        method: str,
        path: str,
        query: str,
        headers: dict[str, str],
        qparams: dict[str, str],
        expect_service: Optional[str],
        expect_hosts: Optional[set[str]],
    ) -> tuple[Optional[Identity], str]:
        """Query-string SigV4 (presigned URLs): the payload is always
        UNSIGNED-PAYLOAD and X-Amz-Signature is excluded from the canonical
        query. Expiry comes from X-Amz-Date + X-Amz-Expires."""
        if qparams.get("X-Amz-Algorithm") != _ALGO:
            return None, "AuthorizationQueryParametersError"
        try:
            cred = qparams["X-Amz-Credential"]
            amz_date = qparams["X-Amz-Date"]
            expires = int(qparams["X-Amz-Expires"])
            signed_headers = qparams["X-Amz-SignedHeaders"].split(";")
            got_sig = qparams["X-Amz-Signature"]
            access_key, date, region, service, _ = cred.split("/", 4)
        except (KeyError, ValueError):
            return None, "AuthorizationQueryParametersError"
        if not 1 <= expires <= self._PRESIGN_MAX_EXPIRES:
            return None, "AuthorizationQueryParametersError"
        if expect_service is not None and service != expect_service:
            return None, "AccessDenied"
        if "host" not in signed_headers:
            return None, "InvalidRequest"
        if expect_hosts is not None and headers.get("host", "").lower() not in expect_hosts:
            return None, "AccessDenied"
        identity = self.lookup(access_key)
        if identity is None:
            return None, "InvalidAccessKeyId"
        try:
            req_ts = calendar.timegm(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
        except ValueError:
            return None, "AccessDenied"
        now = time.time()
        if now < req_ts - _MAX_SKEW_S:
            return None, "AccessDenied"  # from the future beyond clock skew
        if now > req_ts + expires:
            return None, "AccessDenied"  # expired link
        # canonical query = every parameter EXCEPT the signature itself
        filtered = "&".join(
            part
            for part in query.split("&")
            if part and not part.startswith("X-Amz-Signature=")
        )
        want = _signature(
            identity.secret_key,
            method,
            path,
            filtered,
            headers,
            signed_headers,
            "UNSIGNED-PAYLOAD",
            amz_date,
            region,
            service,
        )
        if not hmac.compare_digest(want, got_sig):
            return None, "SignatureDoesNotMatch"
        return identity, ""


# -- SigV4 math (shared by verifier and client signer) ------------------------


def _canonical_query(query: str) -> str:
    if not query:
        return ""
    pairs = []
    for part in query.split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        pairs.append((urllib.parse.quote(urllib.parse.unquote_plus(k), safe="-_.~"),
                      urllib.parse.quote(urllib.parse.unquote_plus(v), safe="-_.~")))
    return "&".join(f"{k}={v}" for k, v in sorted(pairs))


def _signature(
    secret: str,
    method: str,
    path: str,
    query: str,
    headers: dict[str, str],
    signed_headers: list[str],
    payload_hash: str,
    amz_date: str,
    region: str,
    service: str,
) -> str:
    canonical_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n" for h in signed_headers
    )
    canonical = "\n".join(
        [
            method,
            urllib.parse.quote(path, safe="/-_.~"),
            _canonical_query(query),
            canonical_headers,
            ";".join(signed_headers),
            payload_hash,
        ]
    )
    scope = f"{amz_date[:8]}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [_ALGO, amz_date, scope, hashlib.sha256(canonical.encode()).hexdigest()]
    )
    k = f"AWS4{secret}".encode()
    for part in (amz_date[:8], region, service, "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()


def sign_request(
    access_key: str,
    secret_key: str,
    method: str,
    url: str,
    payload: bytes = b"",
    region: str = "us-east-1",
    service: str = "s3",
    extra_headers: Optional[dict[str, str]] = None,
) -> dict[str, str]:
    """Build signed headers for an S3 request (client side)."""
    u = urllib.parse.urlparse(url)
    # the verifier canonicalizes the DECODED path; sign the same view or
    # any percent-encoded key double-encodes and never matches
    path = urllib.parse.unquote(u.path or "/")
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    payload_hash = hashlib.sha256(payload).hexdigest()
    headers = {
        "host": u.netloc,
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        **{k.lower(): v for k, v in (extra_headers or {}).items()},
    }
    signed = sorted(headers)
    sig = _signature(
        secret_key,
        method,
        path,
        u.query,
        headers,
        signed,
        payload_hash,
        amz_date,
        region,
        service,
    )
    scope = f"{amz_date[:8]}/{region}/{service}/aws4_request"
    headers["authorization"] = (
        f"{_ALGO} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}"
    )
    return headers


def presign_url(
    access_key: str,
    secret_key: str,
    method: str,
    url: str,
    expires: int = 3600,
    region: str = "us-east-1",
    service: str = "s3",
) -> str:
    """Client half of presigned URLs: returns `url` with the SigV4 query
    parameters appended. The holder of the link can perform `method` on
    the object until expiry, with no credentials of their own."""
    u = urllib.parse.urlparse(url)
    path = urllib.parse.unquote(u.path or "/")
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    scope = f"{amz_date[:8]}/{region}/{service}/aws4_request"
    params = [
        ("X-Amz-Algorithm", _ALGO),
        ("X-Amz-Credential", f"{access_key}/{scope}"),
        ("X-Amz-Date", amz_date),
        ("X-Amz-Expires", str(int(expires))),
        ("X-Amz-SignedHeaders", "host"),
    ]
    base_q = [p for p in (u.query or "").split("&") if p]
    query = "&".join(
        base_q + [f"{k}={urllib.parse.quote(v, safe='-_.~')}" for k, v in params]
    )
    sig = _signature(
        secret_key,
        method,
        path,
        query,
        {"host": u.netloc},
        ["host"],
        "UNSIGNED-PAYLOAD",
        amz_date,
        region,
        service,
    )
    return u._replace(query=query + f"&X-Amz-Signature={sig}").geturl()


# -- identity persistence (filer KV) ------------------------------------------

_KV_KEY = "s3_identities"


def save_identities(kv, iam: Iam) -> None:
    """Persist the identity set through any object with kv_put (a
    FilerClient) — the seam the IAM API writes and the S3 gateway reads."""
    conf = {
        "identities": [
            {
                "name": i.name,
                "credentials": [{"accessKey": i.access_key, "secretKey": i.secret_key}],
                "actions": i.actions,
            }
            for i in iam.identities
        ]
    }
    kv.kv_put(_KV_KEY, json.dumps(conf).encode())


def load_identities(kv) -> Optional[Iam]:
    raw = kv.kv_get(_KV_KEY)
    if not raw:
        return None
    try:
        return Iam.from_config(json.loads(raw.decode()))
    except ValueError:  # malformed KV must not kill auth plumbing
        return None
