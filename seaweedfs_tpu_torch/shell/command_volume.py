"""Volume & collection shell commands — volume.list / volume.delete /
volume.mark / volume.vacuum / volume.fix.replication / collection.list,
mirroring weed/shell/command_volume_*.go and command_collection_list.go."""

from __future__ import annotations

import time
from typing import TextIO

from seaweedfs_tpu_torch.ec.shard_bits import ShardBits
from seaweedfs_tpu_torch.shell import (
    CommandEnv,
    ShellCommand,
    ShellError,
    grpc_addr,
    parse_flags,
    register,
)
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement




def do_volume_list(args: list[str], env: CommandEnv, w: TextIO) -> None:
    topo = env.volume_list()
    w.write(f"volume size limit: {topo.get('volume_size_limit')}\n")
    for dc, racks in sorted(topo.get("data_centers", {}).items()):
        w.write(f"DataCenter {dc}\n")
        for rack, nodes in sorted(racks.items()):
            w.write(f"  Rack {rack}\n")
            for n in nodes:
                w.write(
                    f"    Node {n['url']} (grpc :{n['grpc_port']}) "
                    f"slots {len(n.get('volumes', []))}/{n.get('max_volume_count')}\n"
                )
                for v in sorted(n.get("volumes", []), key=lambda v: int(v["id"])):
                    w.write(
                        f"      volume {v['id']} collection={v.get('collection', '')!r} "
                        f"size={v.get('size', 0)} files={v.get('file_count', 0)} "
                        f"del={v.get('delete_count', 0)} "
                        f"ro={v.get('read_only', False)} rp={v.get('replica_placement')}\n"
                    )
                for e in sorted(n.get("ec_shards", []), key=lambda e: int(e["volume_id"])):
                    sids = ShardBits(e.get("shard_bits", 0)).shard_ids()
                    w.write(f"      ec volume {e['volume_id']} shards {sids}\n")


register(
    ShellCommand(
        "volume.list",
        "volume.list\n\tprint the cluster topology: dc/rack/node/volumes/ec shards",
        do_volume_list,
    )
)


def _locations_of(env: CommandEnv, vid: int) -> list[dict]:
    return [
        n
        for n in env.topology_nodes()
        if any(int(v["id"]) == vid for v in n.get("volumes", []))
    ]


def do_volume_delete(args: list[str], env: CommandEnv, w: TextIO) -> None:
    fl = parse_flags(args, volumeId=0)
    env.confirm_locked()
    if not fl.volumeId:
        raise ShellError("volume.delete -volumeId <id>")
    locs = _locations_of(env, fl.volumeId)
    if not locs:
        raise ShellError(f"volume {fl.volumeId} not found")
    for n in locs:
        env.vs_call(grpc_addr(n), "VolumeDelete", {"volume_id": fl.volumeId})
    w.write(f"volume.delete {fl.volumeId}: removed from {[n['url'] for n in locs]}\n")


register(
    ShellCommand(
        "volume.delete",
        "volume.delete -volumeId <id>\n\tdelete a volume from every replica holder",
        do_volume_delete,
    )
)


def do_volume_mark(args: list[str], env: CommandEnv, w: TextIO) -> None:
    fl = parse_flags(args, volumeId=0, readonly=False, writable=False)
    env.confirm_locked()
    if not fl.volumeId or fl.readonly == fl.writable:
        raise ShellError("volume.mark -volumeId <id> (-readonly | -writable)")
    method = "VolumeMarkReadonly" if fl.readonly else "VolumeMarkWritable"
    locs = _locations_of(env, fl.volumeId)
    if not locs:
        raise ShellError(f"volume {fl.volumeId} not found")
    for n in locs:
        env.vs_call(grpc_addr(n), method, {"volume_id": fl.volumeId})
    w.write(f"volume.mark {fl.volumeId}: {'readonly' if fl.readonly else 'writable'}\n")


register(
    ShellCommand(
        "volume.mark",
        "volume.mark -volumeId <id> (-readonly | -writable)\n\tflip a volume's "
        "write protection on all replicas",
        do_volume_mark,
    )
)


def do_volume_vacuum(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Compact volumes to reclaim deleted-needle space
    (topology_vacuum.go analog, operator-driven)."""
    fl = parse_flags(args, volumeId=0, garbageThreshold=0.3)
    env.confirm_locked()
    nodes = env.topology_nodes()
    done = 0
    for n in nodes:
        for v in n.get("volumes", []):
            vid = int(v["id"])
            if fl.volumeId and vid != fl.volumeId:
                continue
            if v.get("read_only"):  # frozen volumes refuse compaction
                continue
            if not fl.volumeId and float(v.get("garbage_ratio", 0.0)) < fl.garbageThreshold:
                continue
            resp = env.vs_call(grpc_addr(n), "VolumeCompact", {"volume_id": vid})
            w.write(
                f"volume.vacuum {vid} on {n['url']}: "
                f"{resp.get('bytes_before')} -> {resp.get('bytes_after')} bytes\n"
            )
            done += 1
    if not done:
        w.write("volume.vacuum: nothing to do\n")


register(
    ShellCommand(
        "volume.vacuum",
        "volume.vacuum [-volumeId <id>] [-garbageThreshold 0.3]\n\tcompact volumes "
        "whose deleted fraction exceeds the threshold",
        do_volume_vacuum,
    )
)


def _placement_candidates(
    nodes: list[dict], holders: list[dict], rp: ReplicaPlacement
) -> list[dict]:
    """Candidate targets ordered so the xyz placement deficits are restored
    first (same placement predicate as Topology.place_replicas): count the
    surviving holders per category relative to the primary, then prefer
    nodes that fill an unmet category."""
    primary = holders[0]
    held = {h["url"] for h in holders}

    def category(node: dict) -> str:
        if node["data_center"] != primary["data_center"]:
            return "diff_dc"
        if node["rack"] != primary["rack"]:
            return "diff_rack"
        return "same_rack"

    have = {"same_rack": 0, "diff_rack": 0, "diff_dc": 0}
    for h in holders[1:]:
        have[category(h)] += 1
    deficit = {
        "same_rack": rp.same_rack - have["same_rack"],
        "diff_rack": rp.diff_rack - have["diff_rack"],
        "diff_dc": rp.diff_dc - have["diff_dc"],
    }
    out = [m for m in nodes if m["url"] not in held]
    out.sort(
        key=lambda m: (
            -min(deficit[category(m)], 1),  # nodes filling an unmet slot first
            len(m.get("volumes", [])) + len(m.get("ec_shards", [])),
        )
    )
    return out


def do_volume_fix_replication(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Re-replicate under-replicated volumes (command_volume_fix_replication.go
    analog): VolumeCopy the .dat/.idx onto a fresh node."""
    fl = parse_flags(args, noFix=False)
    if not fl.noFix:
        env.confirm_locked()
    nodes = env.topology_nodes()
    fixed = checked = 0
    seen: set[int] = set()
    for n in nodes:
        for v in n.get("volumes", []):
            vid = int(v["id"])
            if vid in seen:
                continue
            seen.add(vid)
            rp = ReplicaPlacement.parse(v.get("replica_placement", "000"))
            want = rp.copy_count
            holders = [
                m
                for m in nodes
                if any(int(x["id"]) == vid for x in m.get("volumes", []))
            ]
            checked += 1
            if len(holders) >= want:
                continue
            w.write(
                f"volume {vid}: {len(holders)}/{want} replicas "
                f"({[h['url'] for h in holders]})\n"
            )
            if fl.noFix:
                continue
            candidates = _placement_candidates(nodes, holders, rp)
            src = holders[0]
            was_writable = not v.get("read_only", False)
            # freeze the survivors during the copy — writes landing mid-copy
            # would be missing from the new replica (same rule as ec.encode)
            if was_writable:
                for h in holders:
                    env.vs_call(grpc_addr(h), "VolumeMarkReadonly", {"volume_id": vid})
            try:
                for dst in candidates[: want - len(holders)]:
                    env.vs_call(
                        grpc_addr(dst),
                        "VolumeCopy",
                        {
                            "volume_id": vid,
                            "collection": v.get("collection", ""),
                            "source_data_node": grpc_addr(src),
                            # lands frozen; thawed with the others below
                            "read_only": True,
                        },
                    )
                    w.write(f"volume {vid}: copied {src['url']} -> {dst['url']}\n")
                    fixed += 1
                    holders.append(dst)
            finally:
                if was_writable:
                    for h in holders:
                        try:
                            env.vs_call(
                                grpc_addr(h), "VolumeMarkWritable", {"volume_id": vid}
                            )
                        except Exception:  # noqa: BLE001 — best-effort thaw
                            pass
    w.write(f"volume.fix.replication: checked {checked}, fixed {fixed}\n")


register(
    ShellCommand(
        "volume.fix.replication",
        "volume.fix.replication [-noFix]\n\tdetect under-replicated volumes and "
        "copy them to fresh nodes",
        do_volume_fix_replication,
    )
)


def _move_volume(env: CommandEnv, by_url: dict, holders: list[str],
                 vid: int, v: dict, src_url: str, dst_url: str) -> None:
    """Freeze/copy/delete/thaw one volume move — shared by volume.balance
    and volume.move. Freezing consults the LIVE VolumeStatus (the
    heartbeat-stale topology flag could let a write land mid-copy and be
    lost with the source delete); failure paths thaw exactly what was
    frozen, source included."""
    status = env.vs_call(grpc_addr(by_url[src_url]), "VolumeStatus", {"volume_id": vid})
    was_writable = not status.get("read_only", False)
    frozen: list[str] = []
    moved = False
    try:
        if was_writable:
            for u in holders:  # inside try: a failed freeze still thaws
                env.vs_call(grpc_addr(by_url[u]), "VolumeMarkReadonly", {"volume_id": vid})
                frozen.append(u)
        env.vs_call(
            grpc_addr(by_url[dst_url]),
            "VolumeCopy",
            {
                "volume_id": vid,
                "collection": v.get("collection", ""),
                "source_data_node": grpc_addr(by_url[src_url]),
                "read_only": True,
            },
        )
        env.vs_call(grpc_addr(by_url[src_url]), "VolumeDelete", {"volume_id": vid})
        moved = True
    finally:
        if was_writable:
            # success: thaw survivors + destination (source copy is gone).
            # Failure: thaw EXACTLY what was frozen, source included — a
            # failed move must never leave the volume read-only until an
            # operator notices.
            thaw = (
                [u for u in holders if u != src_url] + [dst_url]
                if moved
                else frozen
            )
            for u in thaw:
                try:
                    env.vs_call(
                        grpc_addr(by_url[u]), "VolumeMarkWritable", {"volume_id": vid}
                    )
                except Exception:  # noqa: BLE001 — best-effort thaw
                    pass


def do_volume_balance(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Even volume counts across nodes (command_volume_balance.go analog):
    move whole volumes (VolumeCopy .dat/.idx, then delete the source copy)
    from the fullest node to the emptiest until counts differ by <=1,
    never co-locating two replicas of one volume. Writable volumes are
    frozen on every holder for the move (a write landing mid-copy would
    be missing from the destination) and thawed after."""
    fl = parse_flags(args, collection="", noApply=False)
    env.confirm_locked()
    nodes = env.topology_nodes()
    if len(nodes) < 2:
        w.write("volume.balance: need >=2 nodes\n")
        return
    by_url = {n["url"]: n for n in nodes}
    placement: dict[str, dict[int, dict]] = {
        n["url"]: {int(v["id"]): v for v in n.get("volumes", [])} for n in nodes
    }
    moves = 0
    while True:
        urls = sorted(placement, key=lambda u: len(placement[u]))
        lightest, heaviest = urls[0], urls[-1]
        if len(placement[heaviest]) - len(placement[lightest]) <= 1:
            break
        candidate = None
        for vid, v in sorted(placement[heaviest].items()):
            if fl.collection and v.get("collection", "") != fl.collection:
                continue
            if vid in placement[lightest]:  # replica already there
                continue
            if v.get("disk_type") == "remote":
                continue  # tiered: no local .dat to stream
            candidate = (vid, v)
            break
        if candidate is None:
            break
        vid, v = candidate
        if fl.noApply:
            w.write(f"volume.balance (dry): would move {vid} {heaviest} -> {lightest}\n")
            placement[lightest][vid] = v
            del placement[heaviest][vid]
            moves += 1
            continue
        holders = [u for u in placement if vid in placement[u]]
        _move_volume(env, by_url, holders, vid, v, heaviest, lightest)
        placement[lightest][vid] = v
        del placement[heaviest][vid]
        w.write(f"volume.balance: moved {vid} {heaviest} -> {lightest}\n")
        moves += 1
    w.write(f"volume.balance: {moves} moves\n")


def do_volume_move(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Move one volume to a named node (command_volume_move.go analog):
    the targeted form of volume.balance's move, same freeze/copy/delete/
    thaw discipline."""
    fl = parse_flags(args, volumeId=0, target="")
    env.confirm_locked()
    if not fl.volumeId or not fl.target:
        raise ShellError("volume.move needs -volumeId and -target <url>")
    nodes = env.topology_nodes()
    by_url = {n["url"]: n for n in nodes}
    dst = by_url.get(fl.target)
    if dst is None:
        raise ShellError(f"unknown node {fl.target!r} ({sorted(by_url)})")
    src = next(
        (
            n
            for n in nodes
            if any(int(v["id"]) == fl.volumeId for v in n.get("volumes", []))
        ),
        None,
    )
    if src is None:
        raise ShellError(f"volume {fl.volumeId} not found on any node")
    if src["url"] == fl.target:
        w.write(f"volume.move: {fl.volumeId} already on {fl.target}\n")
        return
    if any(int(v["id"]) == fl.volumeId for v in dst.get("volumes", [])):
        raise ShellError(f"node {fl.target} already holds a replica of {fl.volumeId}")
    v = next(v for v in src["volumes"] if int(v["id"]) == fl.volumeId)
    if v.get("disk_type") == "remote":
        raise ShellError(f"volume {fl.volumeId} is tiered — no local .dat to move")
    holders = [
        n["url"]
        for n in nodes
        if any(int(x["id"]) == fl.volumeId for x in n.get("volumes", []))
    ]
    _move_volume(env, by_url, holders, fl.volumeId, v, src["url"], fl.target)
    w.write(f"volume.move: {fl.volumeId} {src['url']} -> {fl.target}\n")


register(
    ShellCommand(
        "volume.move",
        "volume.move -volumeId <id> -target <url>\n\tmove a volume to a "
        "specific node",
        do_volume_move,
    )
)


register(
    ShellCommand(
        "volume.balance",
        "volume.balance [-collection c] [-noApply]\n\teven volume counts across "
        "nodes by moving whole volumes",
        do_volume_balance,
    )
)


def do_collection_list(args: list[str], env: CommandEnv, w: TextIO) -> None:
    topo = env.volume_list()
    names = set(topo.get("ec_collections", {}).values())
    for racks in topo.get("data_centers", {}).values():
        for nodes in racks.values():
            for n in nodes:
                for v in n.get("volumes", []):
                    names.add(v.get("collection", ""))
    for name in sorted(names):
        w.write(f"collection: {name!r}\n")


register(
    ShellCommand(
        "collection.list",
        "collection.list\n\tlist all collections present in the cluster",
        do_collection_list,
    )
)


def _parse_dest(dest: str) -> dict:
    """Parse a tier destination: 'local:/path' or
    's3:endpoint/bucket[:accessKey:secretKey]'."""
    vendor, _, rest = dest.partition(":")
    if vendor == "local":
        return {"vendor": "local", "root": rest}
    if vendor == "s3":
        parts = rest.split(":")
        endpoint_bucket = parts[0]
        endpoint, _, bucket = endpoint_bucket.rpartition("/")
        out = {"vendor": "s3", "endpoint": endpoint, "bucket": bucket}
        if len(parts) >= 3:
            out["access_key"], out["secret_key"] = parts[1], parts[2]
        return out
    raise ShellError(f"bad -dest {dest!r} (local:/path | s3:host:port/bucket[:ak:sk])")


def do_volume_tier_move(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Move cold volumes' .dat files to remote storage
    (command_volume_tier_move.go analog)."""
    fl = parse_flags(args, volumeId=0, dest="", keyPrefix="volumes/")
    if not fl.volumeId or not fl.dest:
        raise ShellError("volume.tier.move needs -volumeId and -dest")
    env.confirm_locked()
    destination = _parse_dest(fl.dest)
    for n in env.topology_nodes():
        for v in n.get("volumes", []):
            if int(v["id"]) != fl.volumeId:
                continue
            resp = env.vs_call(
                grpc_addr(n),
                "VolumeTierMove",
                {
                    "volume_id": fl.volumeId,
                    "destination": destination,
                    "key_prefix": fl.keyPrefix,
                },
            )
            w.write(
                f"volume.tier.move {fl.volumeId} on {n['url']}: "
                f"{resp.get('size')} bytes -> {resp.get('key')}\n"
            )
            return
    raise ShellError(f"volume {fl.volumeId} not found in the topology")


register(
    ShellCommand(
        "volume.tier.move",
        "volume.tier.move -volumeId <id> -dest local:/path|s3:host:port/bucket[:ak:sk] "
        "[-keyPrefix volumes/]\n\tmove a volume's .dat to remote storage (reads keep working)",
        do_volume_tier_move,
    )
)


def do_volume_tier_fetch(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Bring a tiered volume's .dat back to local disk."""
    fl = parse_flags(args, volumeId=0)
    if not fl.volumeId:
        raise ShellError("volume.tier.fetch needs -volumeId")
    env.confirm_locked()
    for n in env.topology_nodes():
        for v in n.get("volumes", []):
            if int(v["id"]) != fl.volumeId:
                continue
            resp = env.vs_call(
                grpc_addr(n), "VolumeTierFetch", {"volume_id": fl.volumeId}
            )
            w.write(
                f"volume.tier.fetch {fl.volumeId} on {n['url']}: "
                f"{resp.get('size')} bytes local again\n"
            )
            return
    raise ShellError(f"volume {fl.volumeId} not found in the topology")


register(
    ShellCommand(
        "volume.tier.fetch",
        "volume.tier.fetch -volumeId <id>\n\tdownload a tiered volume's .dat back to local disk",
        do_volume_tier_fetch,
    )
)


def _mount_dispatch(cmd_name: str, method: str):
    """volume.mount / volume.unmount (command_volume_mount.go analog):
    fence a volume off a node (files kept) or bring it back."""

    def do(args: list[str], env: CommandEnv, w: TextIO) -> None:
        fl = parse_flags(args, volumeId=0, node="")
        env.confirm_locked()
        if not fl.volumeId or not fl.node:
            raise ShellError(f"{cmd_name} needs -volumeId and -node <url>")
        by_url = {n["url"]: n for n in env.topology_nodes()}
        n = by_url.get(fl.node)
        if n is None:
            raise ShellError(f"unknown node {fl.node!r} ({sorted(by_url)})")
        env.vs_call(grpc_addr(n), method, {"volume_id": fl.volumeId})
        w.write(f"{cmd_name}: volume {fl.volumeId} on {fl.node}\n")

    return do


register(
    ShellCommand(
        "volume.mount",
        "volume.mount -volumeId <id> -node <url>\n\tre-mount an unmounted volume "
        "from its on-disk files",
        _mount_dispatch("volume.mount", "VolumeMount"),
    )
)
register(
    ShellCommand(
        "volume.unmount",
        "volume.unmount -volumeId <id> -node <url>\n\tstop serving a volume but "
        "keep its files on disk",
        _mount_dispatch("volume.unmount", "VolumeUnmount"),
    )
)


def do_volume_grow(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Pre-allocate volumes for a layout without waiting for writes to
    trip automatic growth (command_volume_grow.go analog)."""
    fl = parse_flags(args, collection="", replication="", ttl="", count=1)
    env.confirm_locked()
    resp = env.master_call(
        "VolumeGrow",
        {
            "collection": fl.collection,
            "replication": fl.replication,
            "ttl": fl.ttl,
            "count": fl.count,
        },
    )
    w.write(f"volume.grow: {resp.get('grown', 0)} volumes created\n")


register(
    ShellCommand(
        "volume.grow",
        "volume.grow [-collection c] [-replication xyz] [-ttl 7d] [-count N]\n"
        "\tpre-allocate writable volumes for a layout",
        do_volume_grow,
    )
)


def do_collection_delete(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Delete every volume and EC volume of a collection
    (command_collection_delete.go analog). Requires -force to actually
    destroy data."""
    fl = parse_flags(args, collection="", force=False)
    env.confirm_locked()
    if not fl.collection:
        raise ShellError("collection.delete -collection <name> -force")
    from seaweedfs_tpu_torch.shell.command_ec import _ec_collections

    nodes = env.topology_nodes()
    colls = _ec_collections(env)
    victims_normal: list[tuple[dict, int]] = []
    victims_ec: list[tuple[dict, int]] = []
    for n in nodes:
        for v in n.get("volumes", []):
            if v.get("collection", "") == fl.collection:
                victims_normal.append((n, int(v["id"])))
        for e in n.get("ec_shards", []):
            if colls.get(int(e["volume_id"]), "") == fl.collection:
                victims_ec.append((n, int(e["volume_id"])))
    if not victims_normal and not victims_ec:
        w.write(f"collection.delete: no volumes in {fl.collection!r}\n")
        return
    if not fl.force:
        w.write(
            f"collection.delete (dry): would delete {len(victims_normal)} volume "
            f"replicas and {len(victims_ec)} EC shard sets in {fl.collection!r}; "
            "re-run with -force\n"
        )
        return
    for n, vid in victims_normal:
        env.vs_call(grpc_addr(n), "VolumeDelete", {"volume_id": vid})
    for n, vid in victims_ec:
        env.vs_call(
            grpc_addr(n),
            "VolumeEcShardsDelete",
            {"volume_id": vid, "collection": fl.collection, "shard_ids": []},
        )
    w.write(
        f"collection.delete {fl.collection!r}: removed {len(victims_normal)} volume "
        f"replicas, {len(victims_ec)} EC shard sets\n"
    )


register(
    ShellCommand(
        "collection.delete",
        "collection.delete -collection <name> -force\n\tdelete every volume of a collection",
        do_collection_delete,
    )
)


def do_volume_configure_replication(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Rewrite a volume's replica placement on every holder
    (command_volume_configure_replication.go analog)."""
    fl = parse_flags(args, volumeId=0, collection="", replication="")
    env.confirm_locked()
    if not fl.replication or (not fl.volumeId and not fl.collection):
        raise ShellError(
            "volume.configure.replication (-volumeId <id> | -collection <c>) "
            "-replication xyz"
        )
    ReplicaPlacement.parse(fl.replication)  # validate before touching disks
    changed = 0
    for n in env.topology_nodes():
        for v in n.get("volumes", []):
            vid = int(v["id"])
            if fl.volumeId and vid != fl.volumeId:
                continue
            if fl.collection and v.get("collection", "") != fl.collection:
                continue
            if v.get("disk_type") == "remote":
                w.write(f"volume {vid} on {n['url']}: tiered, skipped "
                        f"(volume.tier.fetch first)\n")
                continue
            env.vs_call(
                grpc_addr(n),
                "VolumeConfigure",
                {"volume_id": vid, "replication": fl.replication},
            )
            w.write(f"volume {vid} on {n['url']}: replication -> {fl.replication}\n")
            changed += 1
    if not changed:
        raise ShellError("volume.configure.replication: no matching volumes")


register(
    ShellCommand(
        "volume.configure.replication",
        "volume.configure.replication (-volumeId <id> | -collection <c>) -replication xyz\n"
        "\tchange replica placement in the volume superblock on every holder",
        do_volume_configure_replication,
    )
)


def do_volume_delete_empty(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Delete volumes holding no live needles (command_volume_delete_empty.go
    analog). -force applies; default is a dry run."""
    fl = parse_flags(args, force=False)
    env.confirm_locked()
    nodes = env.topology_nodes()
    seen: set[int] = set()
    deleted = 0
    for n in nodes:
        for v in n.get("volumes", []):
            vid = int(v["id"])
            if vid in seen:
                continue
            seen.add(vid)
            live = int(v.get("file_count", 0)) - int(v.get("delete_count", 0))
            if live > 0:
                continue
            holders = [
                m
                for m in nodes
                if any(int(x["id"]) == vid for x in m.get("volumes", []))
            ]
            if not fl.force:
                w.write(f"volume.deleteEmpty (dry): volume {vid} is empty "
                        f"on {[h['url'] for h in holders]}\n")
                continue
            # the topology counts are heartbeat-stale: freeze every holder
            # (recording the LIVE read_only state, as _move_volume does),
            # then re-check LIVE emptiness — a write acked since the last
            # beat must abort the delete, not be destroyed with the volume
            frozen: list[dict] = []  # holders WE froze (live status said writable)
            still_empty = True
            try:
                for h in holders:
                    st = env.vs_call(grpc_addr(h), "VolumeStatus", {"volume_id": vid})
                    if int(st.get("file_count", 0)) > 0:
                        still_empty = False
                        break
                    if not st.get("read_only", False):
                        env.vs_call(grpc_addr(h), "VolumeMarkReadonly", {"volume_id": vid})
                        frozen.append(h)
                if still_empty:
                    # re-check after the freeze closed the write window
                    for h in holders:
                        st = env.vs_call(grpc_addr(h), "VolumeStatus", {"volume_id": vid})
                        if int(st.get("file_count", 0)) > 0:
                            still_empty = False
                            break
            except Exception:  # noqa: BLE001 — unreachable holder: keep the volume
                still_empty = False
            if not still_empty:
                for h in frozen:  # thaw exactly what we froze, nothing else
                    try:
                        env.vs_call(grpc_addr(h), "VolumeMarkWritable", {"volume_id": vid})
                    except Exception:  # noqa: BLE001 — best-effort thaw
                        pass
                w.write(f"volume.deleteEmpty: {vid} no longer empty, skipped\n")
                continue
            removed: list[dict] = []
            try:
                for h in holders:
                    env.vs_call(grpc_addr(h), "VolumeDelete", {"volume_id": vid})
                    removed.append(h)
            except Exception as e:  # noqa: BLE001 — partial delete: thaw survivors
                survivors = [h for h in frozen if h not in removed]
                for h in survivors:
                    try:
                        env.vs_call(grpc_addr(h), "VolumeMarkWritable", {"volume_id": vid})
                    except Exception:  # noqa: BLE001 — best-effort thaw
                        pass
                w.write(
                    f"volume.deleteEmpty: {vid} partially removed "
                    f"({len(removed)}/{len(holders)}), survivors thawed: {e}\n"
                )
                continue
            w.write(f"volume.deleteEmpty: removed {vid} from {len(holders)} nodes\n")
            deleted += 1
    w.write(f"volume.deleteEmpty: {deleted} volumes removed\n")


register(
    ShellCommand(
        "volume.deleteEmpty",
        "volume.deleteEmpty [-force]\n\tdelete volumes with zero live files from all replicas",
        do_volume_delete_empty,
    )
)


def _needle_ids_of(env: CommandEnv, node: dict, vid: int) -> tuple[dict[int, int], dict[int, int]]:
    """(live id -> size, tombstone-history id -> final_dead) of one replica,
    both fully paged — a dropped tombstone page would misread 'processed
    the delete' as 'missed the write' and resurrect deleted data."""
    out: dict[int, int] = {}
    start = 0
    while True:
        resp = env.vs_call(
            grpc_addr(node),
            "VolumeNeedleIds",
            {"volume_id": vid, "start_from": start, "limit": 65536},
        )
        for row in resp.get("entries", []):
            out[int(row["id"])] = int(row["size"])
        if not resp.get("truncated"):
            break
        start = max(out) + 1
    tombs: dict[int, int] = {}
    start = 0
    while True:
        resp = env.vs_call(
            grpc_addr(node),
            "VolumeNeedleIds",
            {"volume_id": vid, "tombstones": True, "deleted_start_from": start,
             "limit": 65536},
        )
        page = [
            (int(r["id"]), int(r["final_dead"])) for r in resp.get("deleted", [])
        ]
        tombs.update(page)
        if not resp.get("deleted_truncated") or not page:
            return out, tombs
        start = max(k for k, _ in page) + 1


def do_volume_check_disk(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Compare the replicas of each volume needle-by-needle and copy
    missing needles from the replica that has them
    (command_volume_check_disk.go analog). -fix applies repairs."""
    fl = parse_flags(args, volumeId=0, fix=False)
    env.confirm_locked()
    nodes = env.topology_nodes()
    seen: set[int] = set()
    synced = mismatched = 0
    for n in nodes:
        for v in n.get("volumes", []):
            vid = int(v["id"])
            if vid in seen or (fl.volumeId and vid != fl.volumeId):
                continue
            seen.add(vid)
            holders = [
                m
                for m in nodes
                if any(int(x["id"]) == vid for x in m.get("volumes", []))
            ]
            if len(holders) < 2:
                continue
            state = {h["url"]: _needle_ids_of(env, h, vid) for h in holders}
            live = {u: s[0] for u, s in state.items()}
            tombs = {u: s[1] for u, s in state.items()}
            union: set[int] = set()
            for m in live.values():
                union |= set(m)
            # A FINAL tombstone anywhere means the needle was deleted — the
            # replica still serving it missed the delete, so propagate the
            # delete rather than resurrecting from the lagging replica.
            # EXCEPT when some live holder's own history shows a tombstone
            # followed by a re-write (final state live): that write postdates
            # the delete, so the write wins and is copied out instead.
            final_dead = {
                nid
                for t in tombs.values()
                for nid, dead in t.items()
                if dead
            }
            rewritten = {
                nid
                for u, t in tombs.items()
                for nid, dead in t.items()
                if not dead and nid in live[u]
            }
            delete_these = (union & final_dead) - rewritten
            by_url = {h["url"]: h for h in holders}
            for nid in sorted(delete_these):
                for url, have in sorted(live.items()):
                    if nid not in have:
                        continue
                    mismatched += 1
                    w.write(
                        f"volume {vid} on {url}: needle {nid:x} outlived its "
                        f"delete\n"
                    )
                    if fl.fix:
                        env.vs_call(
                            grpc_addr(by_url[url]),
                            "DeleteNeedle",
                            {"fid": f"{vid},{nid:x}00000000"},
                        )
                        synced += 1
            for url, have in sorted(live.items()):
                missing = union - set(have) - delete_these
                if not missing:
                    continue
                mismatched += 1
                w.write(
                    f"volume {vid} on {url}: missing {len(missing)} needles\n"
                )
                if not fl.fix:
                    continue
                for nid in sorted(missing):
                    # prefer a donor whose history proves its copy postdates
                    # the delete (rewrite evidence); else any live holder
                    donor_url = next(
                        (
                            u
                            for u, t in tombs.items()
                            if nid in live[u] and t.get(nid) == 0
                        ),
                        next(u for u, m in live.items() if nid in m),
                    )
                    blob = env.vs_call(
                        grpc_addr(by_url[donor_url]),
                        "ReadNeedle",
                        {"volume_id": vid, "needle_id": nid},
                    )
                    fid = f"{vid},{nid:x}{int(blob['cookie']):08x}"
                    req = {"fid": fid, "data": blob["data"]}
                    # pass name/mime as b64 so non-UTF-8 bytes survive intact
                    if blob.get("name_b64"):
                        req["name_b64"] = blob["name_b64"]
                    if blob.get("mime_b64"):
                        req["mime_b64"] = blob["mime_b64"]
                    env.vs_call(grpc_addr(by_url[url]), "WriteNeedle", req)
                    synced += 1
    w.write(
        f"volume.check.disk: {mismatched} divergent replicas, "
        f"{synced} needles synced\n"
    )


register(
    ShellCommand(
        "volume.check.disk",
        "volume.check.disk [-volumeId <id>] [-fix]\n\tdiff replica needle sets and "
        "copy missing needles from healthy replicas",
        do_volume_check_disk,
    )
)


def do_volume_server_leave(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Ask one volume server to stop heartbeating and leave the topology
    (command_volume_server_leave.go analog)."""
    fl = parse_flags(args, node="")
    env.confirm_locked()
    if not fl.node:
        raise ShellError("volumeServer.leave -node <url>")
    by_url = {n["url"]: n for n in env.topology_nodes()}
    n = by_url.get(fl.node)
    if n is None:
        raise ShellError(f"unknown node {fl.node!r} ({sorted(by_url)})")
    env.vs_call(grpc_addr(n), "VolumeServerLeave", {})
    w.write(f"volumeServer.leave: {fl.node} left the cluster\n")


register(
    ShellCommand(
        "volumeServer.leave",
        "volumeServer.leave -node <url>\n\task a volume server to stop heartbeating "
        "and depart the topology (it keeps serving until stopped)",
        do_volume_server_leave,
    )
)


def do_volume_server_evacuate(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Move every volume and EC shard off one node so it can be retired
    (command_volume_server_evacuate.go analog)."""
    fl = parse_flags(args, node="", noApply=False)
    env.confirm_locked()
    if not fl.node:
        raise ShellError("volumeServer.evacuate -node <url> [-noApply]")
    nodes = env.topology_nodes()
    by_url = {n["url"]: n for n in nodes}
    src = by_url.get(fl.node)
    if src is None:
        raise ShellError(f"unknown node {fl.node!r} ({sorted(by_url)})")
    others = [n for n in nodes if n["url"] != fl.node]
    if not others:
        raise ShellError("volumeServer.evacuate: no other nodes to receive data")

    moved = 0
    # normal volumes: least-loaded target without a replica of the volume
    for v in sorted(src.get("volumes", []), key=lambda v: int(v["id"])):
        vid = int(v["id"])
        if v.get("disk_type") == "remote":
            w.write(f"evacuate: skipping tiered volume {vid} (no local .dat)\n")
            continue
        holders = [
            n["url"]
            for n in nodes
            if any(int(x["id"]) == vid for x in n.get("volumes", []))
        ]
        targets = sorted(
            (n for n in others if n["url"] not in holders),
            key=lambda n: len(n.get("volumes", [])) + len(n.get("ec_shards", [])),
        )
        if not targets:
            raise ShellError(f"evacuate: no replica-free target for volume {vid}")
        dst = targets[0]
        if fl.noApply:
            w.write(f"evacuate (dry): volume {vid} {fl.node} -> {dst['url']}\n")
        else:
            _move_volume(env, by_url, holders, vid, v, fl.node, dst["url"])
            w.write(f"evacuate: volume {vid} {fl.node} -> {dst['url']}\n")
            dst.setdefault("volumes", []).append(v)
        moved += 1

    # EC shards: spread to nodes not already holding shards of that volume
    from seaweedfs_tpu_torch.shell.command_ec import _ec_collections

    colls = _ec_collections(env)
    for e in sorted(src.get("ec_shards", []), key=lambda e: int(e["volume_id"])):
        vid = int(e["volume_id"])
        sids = ShardBits(e.get("shard_bits", 0)).shard_ids()
        collection = colls.get(vid, "")
        for sid in sids:
            targets = sorted(
                others,
                key=lambda n: sum(
                    len(ShardBits(x.get("shard_bits", 0)).shard_ids())
                    for x in n.get("ec_shards", [])
                ),
            )
            # prefer a target without any shard of this volume (spread), else
            # least-loaded (correct but reduces failure independence)
            spread = [
                n
                for n in targets
                if not any(
                    int(x["volume_id"]) == vid for x in n.get("ec_shards", [])
                )
            ]
            dst = (spread or targets)[0]
            if fl.noApply:
                w.write(f"evacuate (dry): ec {vid}.{sid} {fl.node} -> {dst['url']}\n")
                moved += 1
                continue
            has_vid = any(
                int(x["volume_id"]) == vid for x in dst.get("ec_shards", [])
            )
            env.vs_call(
                grpc_addr(dst),
                "VolumeEcShardsCopy",
                {
                    "volume_id": vid,
                    "collection": collection,
                    "shard_ids": [sid],
                    "source_data_node": grpc_addr(src),
                    "copy_ecx_file": not has_vid,
                },
            )
            env.vs_call(
                grpc_addr(dst),
                "VolumeEcShardsMount",
                {"volume_id": vid, "collection": collection, "shard_ids": [sid]},
            )
            env.vs_call(
                grpc_addr(src),
                "VolumeEcShardsDelete",
                {"volume_id": vid, "collection": collection, "shard_ids": [sid]},
            )
            dst.setdefault("ec_shards", []).append(
                {"volume_id": vid, "shard_bits": int(ShardBits.from_ids([sid]))}
            )
            w.write(f"evacuate: ec {vid}.{sid} {fl.node} -> {dst['url']}\n")
            moved += 1
    w.write(f"volumeServer.evacuate: {moved} moves\n")


def _referenced_needles(env: CommandEnv, w: TextIO) -> dict[int, set[int]]:
    """vid -> needle ids referenced by the filer namespace, with chunk
    manifests resolved (filechunk_manifest.go analog: a manifest needle
    indexes further chunk needles, all of which are live references)."""
    import json as _json

    from seaweedfs_tpu_torch.storage.file_id import FileId

    fc = env.filer_client()
    refs: dict[int, set[int]] = {}

    def note(fid: str) -> None:
        try:
            f = FileId.parse(fid)
        except ValueError:
            return
        refs.setdefault(f.volume_id, set()).add(f.key)

    def resolve_manifest(fid: str) -> None:
        note(fid)
        try:
            payload = env.client.read(fid)
            for d in _json.loads(payload.decode()):
                if d.get("is_chunk_manifest"):
                    resolve_manifest(d["fid"])
                else:
                    note(d["fid"])
        except Exception as e:  # noqa: BLE001 — unreadable manifest: report, keep going
            w.write(f"volume.fsck: unreadable manifest {fid}: {e}\n")

    def walk(path: str) -> None:
        start = ""
        while True:
            batch = fc.list(path, start_from=start, limit=1024)
            if not batch:
                return
            for e in batch:
                if e.is_directory:
                    walk(e.path)
                    continue
                for c in e.chunks:
                    if c.is_chunk_manifest:
                        resolve_manifest(c.fid)
                    else:
                        note(c.fid)
            start = batch[-1].name

    walk("/")
    return refs


#: orphan ids per VolumeNeedleTs call (matches VolumeNeedleIds paging) — a
#: very large orphan set in one JSON request can exceed gRPC's default 4 MB
#: message cap, making every holder "fail" and sparing all orphans with a
#: misleading in-flight-upload report
_NEEDLE_TS_CHUNK = 65536


def _orphans_after_cutoff(
    env: CommandEnv, holders: list[dict], vid: int, nids: list[int], cutoff_ns: int
) -> tuple[set[int], set[int]]:
    """-> (dated after the cutoff, undatable). A post-cutoff copy on ANY
    replica is enough to spare the needle everywhere (the delete loop hits
    every holder). Needles NO reachable holder could date — every RPC
    covering them failed — are returned separately so the report says
    'holder unreachable' instead of claiming an upload in flight.
    Chunked VolumeNeedleTs calls per holder; pre-ts (v2) needles report 0
    and stay deletable: the cutoff protects in-flight uploads, which land
    on current-version volumes."""
    newest: dict[int, int] = {}
    covered: set[int] = set()
    for h in holders:
        for i in range(0, len(nids), _NEEDLE_TS_CHUNK):
            chunk = nids[i : i + _NEEDLE_TS_CHUNK]
            try:
                resp = env.vs_call(
                    grpc_addr(h),
                    "VolumeNeedleTs",
                    {"volume_id": vid, "needle_ids": chunk},
                )
            except Exception:  # noqa: BLE001 — holder down: others may answer.
                # Fast-fail the holder's REMAINING chunks: a dead holder
                # would otherwise cost one full RPC timeout per chunk
                # (hours on a multi-million orphan set)
                break
            covered.update(chunk)
            for k, ts in resp.get("ts", {}).items():
                nid = int(k)
                newest[nid] = max(newest.get(nid, 0), int(ts or 0))
    fresh = {nid for nid in covered if newest.get(nid, 0) > cutoff_ns}
    return fresh, set(nids) - covered


def do_volume_fsck(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Cross-check filer chunk references against volume contents
    (command_volume_fsck.go analog): needles no entry references are
    orphans (reclaimable), references with no needle are data loss.
    Report-only unless -reallyDeleteFromVolume. EC volumes are skipped
    (their needles are audited via the .ecx path at ec.encode time)."""
    fl = parse_flags(args, volumeId=0, reallyDeleteFromVolume=False, cutoffTimeAgo=300)
    env.confirm_locked()
    # An upload racing the run (chunks written before the volume scan, filer
    # entry created after the walk) looks exactly like an orphan; the
    # reference guards this with -cutoffTimeAgo (weed/shell/
    # command_volume_fsck.go). Record the cutoff
    # BEFORE the scan so every needle appended after it is spared.
    cutoff_ns = int((time.time() - max(fl.cutoffTimeAgo, 0)) * 1e9)
    nodes = env.topology_nodes()
    # Scan the volumes BEFORE walking the filer: a file uploaded mid-run
    # then has its needles absent from `stored` (never an orphan, so never
    # purged) and present in `refs` (at worst a false MISSING report).
    # The reverse order would let -reallyDeleteFromVolume destroy a file
    # written between the walk and the scan. Divergent replicas are
    # merged (union) so a needle on ANY holder is never called missing.
    stored: dict[int, dict[int, int]] = {}  # vid -> id -> size
    holders_of: dict[int, list[dict]] = {}
    for n in nodes:
        for v in n.get("volumes", []):
            vid = int(v["id"])
            if fl.volumeId and vid != fl.volumeId:
                continue
            holders_of.setdefault(vid, []).append(n)
            live, _tombs = _needle_ids_of(env, n, vid)
            stored.setdefault(vid, {}).update(live)
    refs = _referenced_needles(env, w)
    # volumes the filer references that the topology no longer serves at
    # all (every holder dead/lost) — the loudest data-loss signal; EC
    # volumes still serve reads through the shard path, so they're present,
    # just unaudited here
    ec_vids = {
        int(e["volume_id"]) for n in nodes for e in n.get("ec_shards", [])
    }
    orphan_count = orphan_bytes = missing_count = 0
    for vid in sorted(set(refs) - set(stored) - ec_vids):
        if fl.volumeId and vid != fl.volumeId:
            continue
        missing_count += len(refs[vid])
        w.write(
            f"volume {vid}: ABSENT from the topology but {len(refs[vid])} "
            f"needles referenced (data loss)\n"
        )
    for vid in sorted(stored):
        have = stored[vid]
        want = refs.get(vid, set())
        orphans = set(have) - want
        missing = want - set(have)
        if orphans:
            # date candidates in BOTH modes so the report an operator sizes
            # a cleanup from agrees with what a purge would actually delete
            fresh, undatable = _orphans_after_cutoff(
                env, holders_of[vid], vid, sorted(orphans), cutoff_ns
            )
            for nid in sorted(fresh):
                w.write(
                    f"volume {vid}: needle {nid:x} appended after the "
                    f"cutoff — spared (likely an upload in flight)\n"
                )
            for nid in sorted(undatable):
                w.write(
                    f"volume {vid}: needle {nid:x} could not be dated "
                    f"(holder unreachable) — spared\n"
                )
            orphans -= fresh | undatable
        if orphans:
            size = sum(have[i] for i in orphans)
            orphan_count += len(orphans)
            orphan_bytes += size
            w.write(
                f"volume {vid}: {len(orphans)} orphan needles ({size} bytes) "
                f"not referenced by any filer entry\n"
            )
            if fl.reallyDeleteFromVolume:
                for nid in sorted(orphans):
                    for h in holders_of[vid]:
                        env.vs_call(
                            grpc_addr(h),
                            "DeleteNeedle",
                            {"fid": f"{vid},{nid:x}00000000"},
                        )
        for nid in sorted(missing):
            missing_count += 1
            w.write(f"volume {vid}: needle {nid:x} referenced but MISSING (data loss)\n")
    verb = "deleted" if fl.reallyDeleteFromVolume else "found"
    w.write(
        f"volume.fsck: {verb} {orphan_count} orphan needles "
        f"({orphan_bytes} bytes), {missing_count} missing references\n"
    )


register(
    ShellCommand(
        "volume.fsck",
        "volume.fsck [-volumeId <id>] [-reallyDeleteFromVolume] "
        "[-cutoffTimeAgo <secs>]\n\tcross-check filer chunk references against "
        "volume needles; report (or purge) orphans older than the cutoff",
        do_volume_fsck,
    )
)


register(
    ShellCommand(
        "volumeServer.evacuate",
        "volumeServer.evacuate -node <url> [-noApply]\n\tmove every volume and EC "
        "shard off a node so it can be retired",
        do_volume_server_evacuate,
    )
)
