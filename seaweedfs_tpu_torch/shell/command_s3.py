"""S3 bucket shell commands — s3.bucket.list / create / delete, mirroring
weed/shell/command_s3_bucket_*.go. Buckets are filer directories under
/buckets (the same layout the S3 gateway serves), so these commands work
through the filer discovered via the master's cluster-node list.
"""

from __future__ import annotations

from typing import TextIO

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.shell import (
    CommandEnv,
    ShellCommand,
    ShellError,
    iter_entries,
    parse_flags,
    register,
)

from seaweedfs_tpu_torch.s3api.server import BUCKETS_ROOT, UPLOADS_ROOT  # one layout source


def _valid_bucket(name: str) -> bool:
    return (
        bool(name)
        and "/" not in name
        and not name.startswith(".")
        and name not in (".", "..")
    )


def do_s3_bucket_list(args: list[str], env: CommandEnv, w: TextIO) -> None:
    fc = env.filer_client()
    count = 0
    for e in iter_entries(fc, BUCKETS_ROOT):
        if e.is_directory and not e.name.startswith("."):
            w.write(f"{e.name}\n")
            count += 1
    w.write(f"total {count} buckets\n")


register(
    ShellCommand(
        "s3.bucket.list",
        "s3.bucket.list\n\tlist S3 buckets (filer directories under /buckets)",
        do_s3_bucket_list,
    )
)


def do_s3_bucket_create(args: list[str], env: CommandEnv, w: TextIO) -> None:
    fl = parse_flags(args, name="")
    if not _valid_bucket(fl.name):
        raise ShellError("s3.bucket.create -name <bucket>")
    fc = env.filer_client()
    path = f"{BUCKETS_ROOT}/{fl.name}"
    if fc.lookup(path) is not None:
        raise ShellError(f"bucket {fl.name!r} already exists")
    fc.create(Entry(path=path, is_directory=True))
    w.write(f"created bucket {fl.name}\n")


register(
    ShellCommand(
        "s3.bucket.create",
        "s3.bucket.create -name <bucket>\n\tcreate an S3 bucket",
        do_s3_bucket_create,
    )
)


def do_s3_bucket_delete(args: list[str], env: CommandEnv, w: TextIO) -> None:
    fl = parse_flags(args, name="", force=False)
    if not _valid_bucket(fl.name):
        raise ShellError("s3.bucket.delete -name <bucket> [-force]")
    fc = env.filer_client()
    path = f"{BUCKETS_ROOT}/{fl.name}"
    if fc.lookup(path) is None:
        raise ShellError(f"bucket {fl.name!r} not found")
    if not fl.force and fc.list(path, limit=1):
        raise ShellError(f"bucket {fl.name!r} is not empty; use -force")
    fc.delete(path, recursive=True)
    try:  # staged multipart parts reference this collection's needles
        fc.delete(f"{UPLOADS_ROOT}/{fl.name}", recursive=True)
    except Exception:  # noqa: BLE001 — no staged uploads
        pass
    try:
        dropped = fc.delete_collection(fl.name)
        if dropped:
            w.write(f"dropped {dropped} volumes of collection {fl.name!r}\n")
    except Exception:  # noqa: BLE001 — reclamation best-effort
        pass
    w.write(f"deleted bucket {fl.name}\n")


register(
    ShellCommand(
        "s3.bucket.delete",
        "s3.bucket.delete -name <bucket> [-force]\n\tdelete an S3 bucket "
        "(-force removes a non-empty bucket)",
        do_s3_bucket_delete,
    )
)


def do_s3_clean_uploads(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Abort multipart uploads older than -timeAgo (s3.clean.uploads
    analog): a crashed client's staged parts otherwise hold needle space
    forever. Age is the NEWEST activity under the staging dir (latest
    part mtime), so an upload still receiving parts is never aborted."""
    import time as _time

    fl = parse_flags(args, timeAgoSeconds=24 * 3600)
    env.confirm_locked()
    fc = env.filer_client()
    cutoff = _time.time() - fl.timeAgoSeconds
    cleaned = kept = 0
    for b in iter_entries(fc, UPLOADS_ROOT):
        if not b.is_directory:
            continue
        for up in iter_entries(fc, b.path):
            if not up.is_directory:
                continue
            newest = up.attributes.mtime
            for part in iter_entries(fc, up.path):
                newest = max(newest, part.attributes.mtime)
            if newest >= cutoff:
                kept += 1
                continue
            fc.delete(up.path, recursive=True)
            w.write(f"aborted stale upload {b.name}/{up.name}\n")
            cleaned += 1
    w.write(f"s3.clean.uploads: {cleaned} aborted, {kept} kept\n")


register(
    ShellCommand(
        "s3.clean.uploads",
        "s3.clean.uploads [-timeAgoSeconds 86400]\n\tabort multipart uploads "
        "staged longer ago than the cutoff",
        do_s3_clean_uploads,
    )
)
