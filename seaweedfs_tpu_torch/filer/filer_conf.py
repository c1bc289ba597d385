"""Per-path filer configuration — mirror of weed/filer/filer_conf.go and
the fs.configure shell command. A set of longest-prefix rules that pin storage policy
(collection, replication, TTL, read-only) to namespace subtrees, so e.g.
/buckets/logs/ lands in a TTL'd collection while /buckets/assets/ is
replicated 001 — without every client having to know.

Persisted as JSON in the filer KV facet under CONF_KEY (the reference
stores /etc/seaweedfs/filer.conf as a filer entry; the KV facet is this
framework's equivalent durable, store-backed slot) and applied by
FilerServer.write_file at upload time.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional

CONF_KEY = "filer.conf"


def path_prefix_match(path: str, prefix: str) -> bool:
    """Path-boundary prefix match: '/data' matches '/data' and '/data/x'
    but not '/database' — the ONE spelling of this rule shared by rule
    matching, read-only enforcement, and meta-event subscriptions."""
    if prefix == "/":
        return True
    prefix = prefix.rstrip("/")
    return path == prefix or path.startswith(prefix + "/")


@dataclass
class PathConf:
    location_prefix: str
    collection: str = ""
    replication: str = ""
    ttl: str = ""
    read_only: bool = False

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PathConf":
        return cls(
            location_prefix=d["location_prefix"],
            collection=d.get("collection", ""),
            replication=d.get("replication", ""),
            ttl=d.get("ttl", ""),
            read_only=bool(d.get("read_only", False)),
        )


@dataclass
class FilerConf:
    rules: list[PathConf] = field(default_factory=list)

    def match(self, path: str) -> Optional[PathConf]:
        """Longest matching location_prefix wins (filer_conf.go semantics).

        Prefixes match on path-segment boundaries: a rule stored as
        /buckets/logs (the shell keeps the trailing slash only if the
        operator typed one) governs /buckets/logs and /buckets/logs/x but
        never the sibling /buckets/logs2/x — raw startswith would apply
        collection/TTL/read-only policy to the wrong subtree."""
        best: Optional[PathConf] = None
        for r in self.rules:
            if path_prefix_match(path, r.location_prefix or "/") and (
                best is None or len(r.location_prefix) > len(best.location_prefix)
            ):
                best = r
        return best

    def upsert(self, rule: PathConf) -> None:
        # single atomic rebind: request threads iterate self.rules without a
        # lock, and a delete-then-append window would let a mutation slip
        # past an updated read-only rule
        self.rules = [
            r for r in self.rules if r.location_prefix != rule.location_prefix
        ] + [rule]

    def delete(self, location_prefix: str) -> bool:
        before = len(self.rules)
        self.rules = [r for r in self.rules if r.location_prefix != location_prefix]
        return len(self.rules) != before

    def to_json(self) -> bytes:
        return json.dumps({"rules": [r.to_dict() for r in self.rules]}).encode()

    @classmethod
    def from_json(cls, raw: Optional[bytes]) -> "FilerConf":
        if not raw:
            return cls()
        d = json.loads(raw)
        return cls(rules=[PathConf.from_dict(r) for r in d.get("rules", [])])
