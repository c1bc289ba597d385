"""The one piece of geometry conversion (`ec.convert`) the read path needs:
whether a journaled cut-over is unfinished, in which case `.eci` and the
shard files may describe different geometries and a mount must refuse.
The conversion itself is not ported yet."""

from __future__ import annotations

import json

#: the conversion journal: `<base>.ecc`, fsync'd JSON lines
JOURNAL_EXT = ".ecc"


def journal_path(base: str) -> str:
    return base + JOURNAL_EXT


def read_prefix(path: str) -> tuple[list[dict], int]:
    """Records of the journal's valid prefix and its byte length. A torn
    tail (a crash mid-append) is excluded, including a parseable last
    record with no terminating newline."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return [], 0
    out: list[dict] = []
    pos = valid = 0
    for line in raw.split(b"\n"):
        end = pos + len(line) + 1  # + the newline split() removed
        if end > len(raw):
            break  # unterminated tail
        if line.strip():
            try:
                rec = json.loads(line)
            except ValueError:
                break
            if isinstance(rec, dict):
                out.append(rec)
        pos = valid = end
    return out, valid


def _journal_state(base_file_name: str) -> list[dict]:
    return read_prefix(journal_path(base_file_name))[0]


def pending_cutover(base_file_name: str) -> bool:
    """True while a journaled cut-over intent is unfinished: between the
    intent record and the journal's final unlink, `.eci` and the shard
    files may describe different geometries."""
    return any(r.get("type") == "cutover" for r in _journal_state(base_file_name))
