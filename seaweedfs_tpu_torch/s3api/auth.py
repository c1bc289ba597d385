"""AWS Signature V4, the client half, after upstream's
weed/s3api/auth_signature_v4.go: `sign_request` builds the signed headers
of one S3 request, which the S3 remote-storage vendor
(remote_storage.S3RemoteStorage) sends. The verifier, the identities and
their actions (auth_credentials.go), IAM and `presign_url` belong to the
S3 gateway, which is not ported yet (ROADMAP Queue 1 item 3(d)).
"""

from __future__ import annotations

import hashlib
import hmac
import time
import urllib.parse
from typing import Optional

_ALGO = "AWS4-HMAC-SHA256"


# -- SigV4 math (shared by the verifier and the client signer) ----------------


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
