"""Minimal HS256 JWT — the only JWT shape the reference uses for its
volume-write tokens (SeaweedFileIdClaims: exp + fid; upstream's
weed/security/jwt.go). Stdlib only: hmac + sha256 + base64url."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Optional


class JwtError(Exception):
    pass


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _unb64url(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def encode_jwt(key: bytes, claims: dict, expires_seconds: int = 10) -> str:
    """Sign claims (adding exp) with HS256."""
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = dict(claims)
    if expires_seconds:
        body["exp"] = int(time.time()) + expires_seconds
    payload = _b64url(json.dumps(body, separators=(",", ":")).encode())
    signing_input = header + b"." + payload
    sig = _b64url(hmac.new(key, signing_input, hashlib.sha256).digest())
    return (signing_input + b"." + sig).decode()


def decode_jwt(key: bytes, token: str) -> dict:
    """Verify signature + expiry; returns the claims. Raises JwtError."""
    try:
        header_s, payload_s, sig_s = token.split(".")
    except ValueError:
        raise JwtError("malformed token") from None
    signing_input = (header_s + "." + payload_s).encode()
    expect = _b64url(hmac.new(key, signing_input, hashlib.sha256).digest()).decode()
    if not hmac.compare_digest(expect, sig_s):
        raise JwtError("bad signature")
    try:
        header = json.loads(_unb64url(header_s))
        claims = json.loads(_unb64url(payload_s))
    except (ValueError, json.JSONDecodeError):
        raise JwtError("malformed payload") from None
    if header.get("alg") != "HS256":
        raise JwtError(f"unsupported alg {header.get('alg')!r}")
    exp = claims.get("exp")
    if exp is not None and time.time() > float(exp):
        raise JwtError("token expired")
    return claims


def mint_file_token(key: Optional[bytes], fid: str, expires_seconds: int = 10) -> str:
    """Token authorizing one write/delete of `fid` (SeaweedFileIdClaims
    analog). Empty string when no key is configured (auth disabled)."""
    if not key:
        return ""
    return encode_jwt(key, {"fid": fid}, expires_seconds=expires_seconds)


def check_file_token(key: Optional[bytes], token: str, fid: str) -> bool:
    """True iff auth is disabled, or `token` validly authorizes `fid`."""
    if not key:
        return True
    if not token:
        return False
    try:
        claims = decode_jwt(key, token)
    except JwtError:
        return False
    return claims.get("fid") == fid
