"""S3 bucket policy engine — resource-based access policies evaluated
before identity grants, after upstream's weed/s3api bucket policy
checks.

A policy is the standard AWS JSON document:

    {"Version": "2012-10-17",
     "Statement": [{"Sid": "...", "Effect": "Allow"|"Deny",
                    "Principal": "*" | {"AWS": "*"|name|[names]},
                    "Action": "s3:GetObject" | ["s3:*", ...],
                    "Resource": "arn:aws:s3:::bucket/prefix*" | [...]}]}

Evaluation follows IAM's order: an explicit Deny in any matching
statement wins over everything; otherwise a matching Allow grants
(including to anonymous principals — this is how public-read buckets
work); otherwise the decision falls through to identity grants.

Principal values accept "*" (everyone, including anonymous), a bare
identity name or access key, or an IAM-user ARN whose trailing
``user/<name>`` names the identity. Anonymous callers match ONLY "*".
Action and Resource match with case-preserving ``*``/``?`` wildcards
(actions compare case-insensitively, per AWS).

Version-granular requests are evaluated under the separate AWS action
names — ``s3:GetObjectVersion`` for ?versionId reads,
``s3:DeleteObjectVersion`` for permanent versionId deletes, and
``s3:ListBucketVersions`` for ?versions listings — never under the base
``s3:GetObject``/``s3:DeleteObject``/``s3:ListBucket`` names, so a
public-read grant cannot expose historical versions and a Deny written
against the *Version names actually matches (the server derives the
action name in ``_s3_action_name``).
"""

from __future__ import annotations

import fnmatch
import json
import re
from typing import Optional, Union

ARN_PREFIX = "arn:aws:s3:::"

_EFFECTS = ("Allow", "Deny")


class PolicyError(ValueError):
    """Malformed policy document (maps to S3's MalformedPolicy)."""


def _as_list(v: Union[str, list, None]) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def parse_policy(raw: bytes, bucket: str) -> dict:
    """Validate and normalize a policy document for `bucket`.

    Every Resource must target this bucket — accepting a statement about
    another bucket would silently never match and hide operator typos
    (AWS rejects cross-bucket resources in PutBucketPolicy the same way).
    """
    try:
        doc = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise PolicyError(f"not valid JSON: {e}") from e
    if not isinstance(doc, dict):
        raise PolicyError("policy must be a JSON object")
    stmts = doc.get("Statement")
    if not isinstance(stmts, list) or not stmts:
        raise PolicyError("policy needs a non-empty Statement array")
    supported = {"Sid", "Effect", "Principal", "Action", "Resource"}
    for s in stmts:
        if not isinstance(s, dict):
            raise PolicyError("each Statement must be an object")
        # silently ignoring a Condition / NotAction / NotPrincipal /
        # NotResource would turn a conditional Allow into an unconditional
        # grant — reject what evaluate() does not implement, like AWS
        # rejects malformed restrictions, instead of widening access
        unknown = set(s) - supported
        if unknown:
            raise PolicyError(
                f"unsupported Statement field(s): {', '.join(sorted(unknown))}"
            )
        if s.get("Effect") not in _EFFECTS:
            raise PolicyError("Statement.Effect must be Allow or Deny")
        if "Principal" not in s:
            raise PolicyError("Statement.Principal is required")
        if not _as_list(s.get("Action")):
            raise PolicyError("Statement.Action is required")
        resources = _as_list(s.get("Resource"))
        if not resources:
            raise PolicyError("Statement.Resource is required")
        for r in resources:
            if not isinstance(r, str) or not r.startswith(ARN_PREFIX):
                raise PolicyError(f"Resource must start with {ARN_PREFIX}")
            target = r[len(ARN_PREFIX) :]
            b = target.split("/", 1)[0]
            if b != bucket:
                raise PolicyError(
                    f"Resource {r!r} does not target bucket {bucket!r}"
                )
    return doc


def _wild(pattern: str, value: str, casefold: bool = False) -> bool:
    if casefold:
        pattern, value = pattern.lower(), value.lower()
    # fnmatch.translate handles * and ? but also [seq] — escape brackets so
    # policy patterns stay the documented two-metacharacter language
    pattern = pattern.replace("[", "[[]")
    return re.fullmatch(fnmatch.translate(pattern), value) is not None


def _principal_matches(principal, identity_name: str, access_key: str, anonymous: bool) -> bool:
    values: list[str] = []
    if principal == "*":
        return True
    if isinstance(principal, dict):
        values = _as_list(principal.get("AWS"))
    elif isinstance(principal, (str, list)):
        values = _as_list(principal)
    for v in values:
        if not isinstance(v, str):
            continue
        if v == "*":
            return True
        if anonymous:
            continue  # anonymous matches only the universal principal
        name = v.rsplit("user/", 1)[-1] if v.startswith("arn:") else v
        if name in (identity_name, access_key):
            return True
    return False


def evaluate(
    policy: Optional[dict],
    *,
    identity_name: str,
    access_key: str,
    anonymous: bool,
    action: str,
    resource: str,
) -> Optional[bool]:
    """-> False on an explicit Deny match, True on an Allow match, None
    when no statement matches (caller falls back to identity grants).

    `action` is an s3:* action name; `resource` is the full ARN of the
    bucket or object being touched."""
    if not policy:
        return None
    decision: Optional[bool] = None
    for s in policy.get("Statement", []):
        if not _principal_matches(
            s.get("Principal"), identity_name, access_key, anonymous
        ):
            continue
        if not any(_wild(a, action, casefold=True) for a in _as_list(s.get("Action"))):
            continue
        if not any(_wild(r, resource) for r in _as_list(s.get("Resource"))):
            continue
        if s.get("Effect") == "Deny":
            return False  # explicit deny: nothing can override it
        decision = True
    return decision
