"""File ids of upstream SeaweedFS: "<volumeId>,<keyHex><cookieHex8>", e.g.
"3,163737d6f2a4": the last 8 hex digits are the cookie, the rest the
needle id."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FileId:
    volume_id: int
    key: int
    cookie: int

    def __str__(self) -> str:
        return f"{self.volume_id},{self.key:x}{self.cookie:08x}"

    @classmethod
    def parse(cls, fid: str) -> "FileId":
        fid = fid.strip()
        if "," not in fid:
            raise ValueError(f"bad file id {fid!r}: missing comma")
        vid_s, rest = fid.split(",", 1)
        rest = rest.split("_", 1)[0]  # the _altKey suffix some clients append
        if len(rest) <= 8:
            raise ValueError(f"bad file id {fid!r}: key_cookie too short")
        return cls(volume_id=int(vid_s), key=int(rest[:-8], 16), cookie=int(rest[-8:], 16))
