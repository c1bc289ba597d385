"""Local-file commands on a volume base path (`/dir/[collection_]<vid>`,
no extension): the EC commands encode | rebuild | decode | verify, each on
the card unless given `--device cpu` and printing one JSON line, and the
maintenance commands fix | compact | export (upstream's weed fix, compact
and export), which launch no kernel."""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
from contextlib import ExitStack
from typing import Iterator, Optional

from seaweedfs_tpu_torch.command import Command, register
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.ec.constants import (
    DATA_SHARDS_COUNT,
    ERASURE_CODING_LARGE_BLOCK_SIZE,
    ERASURE_CODING_SMALL_BLOCK_SIZE,
    TOTAL_SHARDS_COUNT,
)
from seaweedfs_tpu_torch.ops.rs_codec import Encoder, new_encoder
from seaweedfs_tpu_torch.storage import scan as scan_mod
from seaweedfs_tpu_torch.storage import types
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import parse_base_name
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
from seaweedfs_tpu_torch.storage.volume import Volume

#: shard bytes per verify dispatch
VERIFY_CHUNK = 4 * 1024 * 1024


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default=None,
        help="torch device to run on (default: cuda; cpu runs the plain version)",
    )


def _add_geometry(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--large-block", type=int, default=ERASURE_CODING_LARGE_BLOCK_SIZE,
        help="large stripe block size in bytes (default 1 GiB)",
    )
    p.add_argument(
        "--small-block", type=int, default=ERASURE_CODING_SMALL_BLOCK_SIZE,
        help="small stripe block size in bytes (default 1 MiB)",
    )


def encode(base: str, device=None, large_block: int = ERASURE_CODING_LARGE_BLOCK_SIZE,
           small_block: int = ERASURE_CODING_SMALL_BLOCK_SIZE,
           encoder: Optional[Encoder] = None) -> dict:
    """<base>.dat [+ .idx] -> .ec00..13 + .eci [+ .ecx]. `encoder` (default:
    `new_encoder(device=device)`) fixes the device and kernel variant, as in
    the other commands."""
    stripe.write_ec_files(
        base, large_block_size=large_block, small_block_size=small_block,
        encoder=encoder or new_encoder(device=device),
    )
    if os.path.exists(base + ".idx"):
        stripe.write_sorted_file_from_idx(base)
    else:
        print(f"note: {base}.idx missing — wrote shards only, no .ecx", file=sys.stderr)
    return {
        "encoded": base,
        "dat_bytes": os.path.getsize(base + ".dat"),
        "shard_bytes": os.path.getsize(stripe.shard_file_name(base, 0)),
        "shards": TOTAL_SHARDS_COUNT,
    }


def rebuild(base: str, device=None, encoder: Optional[Encoder] = None) -> dict:
    """Reconstruct missing .ecNN shards from the survivors."""
    enc = stripe.encoder_for_base(base, encoder or new_encoder(device=device))
    return {"rebuilt_shards": stripe.rebuild_ec_files(base, encoder=enc)}


def decode(base: str, device=None, dat_size=None) -> dict:
    """Shards -> <base>.dat (+ .idx from .ecx/.ecj), rebuilding missing data
    shards first. Raises ValueError when too few shards survive."""
    present = stripe.find_local_shards(base)
    missing_data = [s for s in range(DATA_SHARDS_COUNT) if s not in present]
    if missing_data:
        if len(present) < DATA_SHARDS_COUNT:
            raise ValueError(
                f"cannot decode: shards {missing_data} missing and only "
                f"{len(present)} survivors"
            )
        rebuild(base, device)
    stripe.write_dat_file(base, dat_file_size=dat_size)
    if os.path.exists(base + ".ecx"):
        stripe.write_idx_file_from_ec_index(base)
    return {"decoded": base + ".dat", "bytes": os.path.getsize(base + ".dat")}


def verify(base: str, device=None, encoder: Optional[Encoder] = None) -> dict:
    """Re-encode the data shards chunkwise and compare the stored parity."""
    present = stripe.find_local_shards(base)
    if len(present) != TOTAL_SHARDS_COUNT:
        raise ValueError(f"verify needs all {TOTAL_SHARDS_COUNT} shards, found {sorted(present)}")
    enc = encoder or new_encoder(device=device)
    shard_size = os.path.getsize(stripe.shard_file_name(base, 0))
    with ExitStack() as stack:
        files = [
            stack.enter_context(open(stripe.shard_file_name(base, s), "rb"))
            for s in range(TOTAL_SHARDS_COUNT)
        ]
        for off in range(0, shard_size, VERIFY_CHUNK):
            n = min(VERIFY_CHUNK, shard_size - off)
            if not enc.verify([stripe.read_padded(f, off, n) for f in files]):
                return {"verified": False, "bad_chunk_offset": off}
    return {"verified": True, "shard_bytes": shard_size}


def fix(base: str) -> dict:
    """Rebuild <base>.idx by scanning <base>.dat."""
    return {"fixed": base + ".idx", "records": scan_mod.rebuild_idx(base)}


def compact(base: str) -> dict:
    """Vacuum a volume: rewrite its live needles, drop the deleted."""
    d, name = os.path.split(base)
    parsed = parse_base_name(name)
    if parsed is None:
        raise ValueError(f"cannot parse volume id from {name!r}")
    collection, vid = parsed
    with Volume(d or ".", vid, collection) as v:
        before, after = v.compact()
    return {"compacted": base, "bytes_before": before, "bytes_after": after}


def export(base: str, data: bool = False) -> Iterator[dict]:
    """One record per live needle, ascending by id (with its data in base64
    when `data`). Two passes, so memory stays O(index): the live (offset,
    size) by a scan first, then one needle read at a time."""
    dat_path = base + ".dat"
    live: dict[int, tuple[int, int]] = {}
    for offset, n in scan_mod.scan_volume_file(dat_path, verify_crc=False):
        if n.size > 0:
            live[n.id] = (offset, n.size)
        else:
            live.pop(n.id, None)
    with open(dat_path, "rb") as f:
        version = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE)).version
        for nid, (offset, size) in sorted(live.items()):
            f.seek(offset)
            n = Needle.from_bytes(f.read(types.actual_size(size, version)), version)
            rec = {
                "id": f"{nid:x}",
                "cookie": f"{n.cookie:08x}",
                "offset": offset,
                "size": n.size,
                "name": n.name.decode("utf-8", "replace"),
                "mime": n.mime.decode("utf-8", "replace"),
                "data_size": len(n.data),
            }
            if data:
                rec["data"] = base64.b64encode(n.data).decode()
            yield rec


def _run_encode(args: argparse.Namespace) -> int:
    if not os.path.exists(args.base + ".dat"):
        print(f"no such file: {args.base}.dat", file=sys.stderr)
        return 1
    print(json.dumps(encode(args.base, args.device, args.large_block, args.small_block)))
    return 0


def _run_rebuild(args: argparse.Namespace) -> int:
    print(json.dumps(rebuild(args.base, args.device)))
    return 0


def _run_decode(args: argparse.Namespace) -> int:
    print(json.dumps(decode(args.base, args.device, args.dat_size)))
    return 0


def _run_verify(args: argparse.Namespace) -> int:
    out = verify(args.base, args.device)
    print(json.dumps(out))
    return 0 if out["verified"] else 1


def _run_fix(args: argparse.Namespace) -> int:
    print(json.dumps(fix(args.base)))
    return 0


def _run_compact(args: argparse.Namespace) -> int:
    print(json.dumps(compact(args.base)))
    return 0


def _run_export(args: argparse.Namespace) -> int:
    for rec in export(args.base, args.data):
        print(json.dumps(rec))
    return 0


def _simple(name: str, help_: str, run, *confs) -> None:
    def conf(p: argparse.ArgumentParser) -> None:
        p.add_argument("base", help="volume base path: /dir/[collection_]<vid> (no extension)")
        for c in confs:
            c(p)

    register(Command(name, help_, conf, run))


_simple(
    "encode", "EC-encode a volume: <base>.dat [+.idx] -> .ec00..13 + .ecx",
    _run_encode, _add_device, _add_geometry,
)
_simple("rebuild", "reconstruct missing .ecNN shards from >=10 survivors", _run_rebuild,
        _add_device)
_simple(
    "decode", "shards -> <base>.dat (+.idx from .ecx/.ecj)", _run_decode, _add_device,
    lambda p: p.add_argument("--dat-size", type=int, default=None),
)
_simple("verify", "re-encode data shards and compare stored parity", _run_verify, _add_device)
_simple("fix", "rebuild <base>.idx by scanning <base>.dat", _run_fix)
_simple("compact", "vacuum a volume: rewrite live needles, drop deleted", _run_compact)
_simple(
    "export", "dump live needles as JSON lines", _run_export,
    lambda p: p.add_argument("--data", action="store_true", help="include base64 data"),
)
