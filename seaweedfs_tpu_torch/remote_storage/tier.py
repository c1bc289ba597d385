"""Volume tiering, after upstream's volume.tier.move / volume.tier.upload /
download shell commands and weed/storage/backend/s3_backend.

`tier_move` uploads a volume's .dat to a remote vendor and replaces it
with `<base>.tierinfo` (JSON: vendor location + key + size, the same bytes
as the JAX package writes). The volume engine (storage/volume.py) detects
the tierinfo file on load and serves needle reads through a RemoteDatFile.
`tier_fetch` brings the .dat back and removes the tierinfo.
"""

from __future__ import annotations

import json
import os

from seaweedfs_tpu_torch.remote_storage import RemoteStorageClient, make_remote_client

TIER_EXT = ".tierinfo"


def tier_info_path(base_path: str) -> str:
    return base_path + TIER_EXT


def read_tier_info(base_path: str) -> dict:
    with open(tier_info_path(base_path), encoding="utf-8") as f:
        return json.load(f)


def tier_move(
    base_path: str,
    client: RemoteStorageClient,
    key_prefix: str = "volumes/",
    keep_local: bool = False,
) -> dict:
    """Upload <base>.dat to the vendor, write <base>.tierinfo, drop the
    local .dat (unless keep_local). Returns the tier info dict."""
    dat = base_path + ".dat"
    if os.path.exists(tier_info_path(base_path)):
        raise IOError(f"{base_path} is already tiered")
    size = os.path.getsize(dat)
    key = key_prefix + os.path.basename(dat)
    with open(dat, "rb") as f:
        client.write_stream(key, f, size)  # chunked: volumes are multi-GB
    # verify before dropping the only local copy
    if client.size(key) != size:
        client.delete(key)
        raise IOError(f"tier upload size mismatch for {dat}")
    info = {"location": client.location(), "key": key, "size": size}
    tmp = tier_info_path(base_path) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(info, f)
        f.flush()
        # the tierinfo is about to be the ONLY pointer to the moved volume
        # (local .dat removed below) — it must be durable first
        os.fsync(f.fileno())
    os.replace(tmp, tier_info_path(base_path))
    if not keep_local:
        os.remove(dat)
    return info


def tier_fetch(base_path: str) -> None:
    """Download the tiered .dat back (chunked) and remove the tierinfo."""
    info = read_tier_info(base_path)
    client = make_remote_client(info["location"])
    tmp = base_path + ".dat.fetch"
    client.read_to_file(info["key"], tmp, info["size"])
    if os.path.getsize(tmp) != info["size"]:
        os.remove(tmp)
        raise IOError(f"tier fetch size mismatch for {base_path}")
    os.replace(tmp, base_path + ".dat")
    os.remove(tier_info_path(base_path))


def open_tiered_dat(base_path: str):
    """RemoteDatFile for a tiered volume (used by Volume on load)."""
    from seaweedfs_tpu_torch.storage.backend import RemoteDatFile

    info = read_tier_info(base_path)
    client = make_remote_client(info["location"])
    return RemoteDatFile(client, info["key"], size=info["size"])
