"""Guard, upstream's weed/security/guard.go: gate
HTTP handlers by IP white-list and/or JWT. The volume server wraps its
write/delete path with `guard.check_write(fid, auth_header)`; reads use a
separate optional key (the reference's jwt.signing.read)."""

from __future__ import annotations

from typing import Optional

from seaweedfs_tpu_torch.security.jwt import check_file_token


def _parse_bearer(auth_header: str) -> str:
    if not auth_header:
        return ""
    parts = auth_header.split()
    if len(parts) == 2 and parts[0].lower() in ("bearer", "bear"):
        return parts[1]
    return auth_header.strip()


class Guard:
    def __init__(
        self,
        signing_key: Optional[bytes] = None,
        read_signing_key: Optional[bytes] = None,
        white_list: Optional[list[str]] = None,
        expires_seconds: int = 10,
    ):
        self.signing_key = signing_key or None
        self.read_signing_key = read_signing_key or None
        self.white_list = set(white_list or [])
        self.expires_seconds = expires_seconds

    @property
    def secured(self) -> bool:
        return bool(self.signing_key or self.white_list)

    def white_listed(self, remote_ip: str) -> bool:
        return bool(self.white_list) and remote_ip in self.white_list

    def check_write(self, fid: str, auth_header: str, remote_ip: str = "") -> bool:
        if self.white_listed(remote_ip):
            return True
        if self.signing_key:
            return check_file_token(self.signing_key, _parse_bearer(auth_header), fid)
        # whitelist-only mode: membership is the ONLY credential — a
        # non-member must be denied, not fall through to auth-disabled
        return not self.white_list

    def check_read(self, fid: str, auth_header: str, remote_ip: str = "") -> bool:
        if self.read_signing_key is None:
            return True
        if self.white_listed(remote_ip):
            return True
        return check_file_token(self.read_signing_key, _parse_bearer(auth_header), fid)
