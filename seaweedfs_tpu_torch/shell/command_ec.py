"""EC lifecycle shell commands — ec.encode / ec.rebuild / ec.decode /
ec.balance, mirroring weed/shell/command_ec_encode.go, command_ec_rebuild.go,
command_ec_decode.go, command_ec_balance.go + command_ec_common.go.
Fan-out over nodes uses a thread pool (errgroup analog)."""

from __future__ import annotations

import json
import os
from concurrent import futures
from typing import Optional, TextIO

from seaweedfs_tpu_torch.ec.constants import DATA_SHARDS_COUNT, TOTAL_SHARDS_COUNT
from seaweedfs_tpu_torch.ec.shard_bits import ShardBits
from seaweedfs_tpu_torch.shell import (
    CommandEnv,
    ShellCommand,
    ShellError,
    grpc_addr,
    parse_flags,
    register,
)

_POOL = 8


class EncodeCheckpoint:
    """Persisted ec.encode work-list ("encode of 10k volumes resumes"): a
    batch over many volumes survives interruption — the rerun
    skips completed vids. One JSON file, fsync'd after every finished
    volume, keyed by the volume-selection criteria so a checkpoint from a
    different selection is never misapplied (upstream's
    weed/shell/command_ec_encode.go restarts from scratch)."""

    def __init__(self, path: str, selector: dict):
        self.path = path
        self.selector = selector

    def load_done(self) -> set[int]:
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return set()
        if data.get("selector") != self.selector:
            return set()  # different batch criteria: ignore, will overwrite
        return {int(v) for v in data.get("done", [])}

    def mark_done(self, done: set[int]) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"selector": self.selector, "done": sorted(done)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def finish(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass


def _node_ec_load(node: dict) -> int:
    """Total EC shards currently on the node."""
    return sum(
        ShardBits(e.get("shard_bits", 0)).shard_id_count()
        for e in node.get("ec_shards", [])
    )


def _node_shards_of(node: dict, vid: int) -> list[int]:
    for e in node.get("ec_shards", []):
        if int(e.get("volume_id", -1)) == vid:
            return ShardBits(e.get("shard_bits", 0)).shard_ids()
    return []


def _volume_locations(nodes: list[dict], vid: int) -> list[dict]:
    return [n for n in nodes if any(int(v["id"]) == vid for v in n.get("volumes", []))]


def allocate_shards(
    nodes: list[dict],
    total: int = TOTAL_SHARDS_COUNT,
    data_shards: int = DATA_SHARDS_COUNT,
) -> dict[str, list[int]]:
    """Balanced, FAILURE-DOMAIN-CAPPED spread of `total` shard ids over
    nodes — the shared `ec/placement.py` planner: each shard goes to the
    least-loaded node whose rack still has headroom under the
    no-domain-holds-more-than-m cap (the invariant that makes a whole-
    rack loss survivable by construction); on topologies with too few
    racks the cap relaxes minimally instead of failing."""
    if not nodes:
        raise ShellError("no volume servers available")
    from seaweedfs_tpu_torch.ec import placement
    from seaweedfs_tpu_torch.utils import config as _config

    return placement.plan_spread(
        nodes,
        total,
        max(1, total - data_shards),
        cap_override=int(_config.env("WEEDTPU_PLACEMENT_MAX_PER_DOMAIN")),
        load_of=_node_ec_load,
    )


def _parallel(work: list) -> None:
    """Run thunks concurrently, re-raising the first failure."""
    if not work:
        return
    with futures.ThreadPoolExecutor(max_workers=_POOL) as pool:
        for f in [pool.submit(t) for t in work]:
            f.result()


# -- ec.encode ---------------------------------------------------------------


def _do_ec_encode(
    env: CommandEnv,
    nodes: list[dict],
    vid: int,
    collection: str,
    w: TextIO,
    large_block_size: int = 0,
    small_block_size: int = 0,
    inline: bool = False,
) -> None:
    locations = _volume_locations(nodes, vid)
    if not locations:
        raise ShellError(f"volume {vid} not found on any node")
    # 1. freeze writes on every replica; roll the freeze
    # back if anything later fails, or the volume is stuck readonly forever
    for loc in locations:
        env.vs_call(grpc_addr(loc), "VolumeMarkReadonly", {"volume_id": vid})
    try:
        _encode_spread_cutover(
            env, nodes, locations, vid, collection, w, large_block_size,
            small_block_size, inline,
        )
    except Exception:
        for loc in locations:
            try:
                env.vs_call(grpc_addr(loc), "VolumeMarkWritable", {"volume_id": vid})
            except Exception:  # noqa: BLE001 — best-effort rollback
                pass
        raise


def _encode_spread_cutover(
    env: CommandEnv,
    nodes: list[dict],
    locations: list[dict],
    vid: int,
    collection: str,
    w: TextIO,
    large_block_size: int,
    small_block_size: int,
    inline: bool = False,
) -> None:
    # 2. generate all 14 shards + .ecx on the first replica holder
    # (-inline: finalize from the server's encode-on-write stripe state —
    # byte-identical shards, the encode already amortized into ingest;
    # the server falls back to the warm conversion when no usable inline
    # state exists and reports which path ran)
    source = locations[0]
    src_addr = grpc_addr(source)
    gen_req = {"volume_id": vid, "collection": collection}
    if large_block_size:
        gen_req["large_block_size"] = large_block_size
    if small_block_size:
        gen_req["small_block_size"] = small_block_size
    if inline:
        gen_req["inline"] = True
    gen_resp = env.vs_call(src_addr, "VolumeEcShardsGenerate", gen_req)
    gen_mode = gen_resp.get("mode") if inline else None
    # 3. spread: balanced, rack-aware allocation; targets pull from source
    alloc = allocate_shards(nodes)

    def copy_and_mount(node: dict, sids: list[int]):
        def run():
            addr = grpc_addr(node)
            if node["url"] != source["url"]:
                env.vs_call(
                    addr,
                    "VolumeEcShardsCopy",
                    {
                        "volume_id": vid,
                        "collection": collection,
                        "shard_ids": sids,
                        "source_data_node": src_addr,
                        "copy_ecx_file": True,
                    },
                )
                env.vs_call(
                    addr,
                    "VolumeEcShardsMount",
                    {"volume_id": vid, "collection": collection, "shard_ids": sids},
                )
            return None

        return run

    _parallel([copy_and_mount(n, sids) for url, sids in alloc.items()
               for n in nodes if n["url"] == url])
    # 4. source keeps only its allocated shards (delete remounts the rest).
    # Single-node clusters keep everything: an empty shard_ids list means
    # "delete ALL" to the RPC, so it must not be sent at all.
    kept = alloc.get(source["url"], [])
    moved = [s for s in range(TOTAL_SHARDS_COUNT) if s not in kept]
    if moved:
        env.vs_call(
            src_addr,
            "VolumeEcShardsDelete",
            {"volume_id": vid, "collection": collection, "shard_ids": moved},
        )
    if kept:
        env.vs_call(
            src_addr,
            "VolumeEcShardsMount",
            {"volume_id": vid, "collection": collection, "shard_ids": kept},
        )
    # 5. drop the original volume + replicas — cut-over complete
    for loc in locations:
        env.vs_call(grpc_addr(loc), "VolumeDelete", {"volume_id": vid})
    mode_note = f" ({gen_mode} encode)" if gen_mode else ""
    w.write(f"ec.encode volume {vid}: spread {_fmt_alloc(alloc)}{mode_note}\n")


def _fmt_alloc(alloc: dict[str, list[int]]) -> str:
    return " ".join(f"{u}={','.join(map(str, s))}" for u, s in sorted(alloc.items()))


def do_ec_encode(args: list[str], env: CommandEnv, w: TextIO) -> None:
    fl = parse_flags(
        args,
        volumeId=0,
        collection="",
        fullPercent=95.0,
        quietFor=0,  # seconds since the last write; 0 disables the filter
        force=False,
        largeBlockSize=0,
        smallBlockSize=0,
        inline=False,  # finalize from encode-on-write state (WEEDTPU_INLINE_EC)
        checkpoint=".ec_encode.checkpoint",
    )
    env.confirm_locked()
    topo = env.volume_list()
    nodes = env.topology_nodes()
    limit = int(topo.get("volume_size_limit", 0)) or 1
    # each volume's real collection comes from the topology, not the flag —
    # the flag only SELECTS volumes
    coll_of: dict[int, str] = {}
    for n in nodes:
        for v in n.get("volumes", []):
            coll_of[int(v["id"])] = v.get("collection", "")
    vids: list[int] = []
    if fl.volumeId:
        if fl.volumeId not in coll_of:
            raise ShellError(f"volume {fl.volumeId} not found on any node")
        vids = [fl.volumeId]
    else:
        import time as _time

        now = _time.time()
        # aggregate across replicas FIRST: the quiet check must see the
        # NEWEST write on any replica — a stale replica's old mtime would
        # otherwise select a volume that is actively taking writes
        sizes: dict[int, int] = {}
        newest: dict[int, int] = {}
        for n in nodes:
            for v in n.get("volumes", []):
                vid = int(v["id"])
                if v.get("collection", "") != fl.collection:
                    continue
                sizes[vid] = max(sizes.get(vid, 0), int(v.get("size", 0)))
                newest[vid] = max(newest.get(vid, 0), int(v.get("last_modified", 0)))
        vids = sorted(
            vid
            for vid, size in sizes.items()
            if (fl.force or size >= limit * fl.fullPercent / 100.0)
            # -quietFor: a volume still taking writes must not be EC-frozen
            # (the reference's default encode safety filter)
            and not (fl.quietFor and now - newest[vid] < fl.quietFor)
        )
    if not vids:
        w.write("ec.encode: no matching volumes\n")
        return
    # batch resume: single -volumeId runs don't checkpoint (nothing to skip)
    ckpt = None
    done: set[int] = set()
    if not fl.volumeId and fl.checkpoint:
        ckpt = EncodeCheckpoint(
            fl.checkpoint,
            {
                "collection": fl.collection,
                "fullPercent": fl.fullPercent,
                "quietFor": fl.quietFor,
                "force": bool(fl.force),
            },
        )
        # no intersection with the current selection: a volume whose
        # cut-over completed may still linger in a stale topology view —
        # skipping it is exactly the point
        done = ckpt.load_done()
        if done:
            w.write(f"ec.encode: resuming, {len(done)} volume(s) already done\n")
    for vid in vids:
        if vid in done:
            w.write(f"ec.encode volume {vid}: skip (checkpointed)\n")
            continue
        _do_ec_encode(
            env,
            nodes,
            vid,
            coll_of[vid],
            w,
            large_block_size=fl.largeBlockSize,
            small_block_size=fl.smallBlockSize,
            inline=bool(fl.inline),
        )
        if ckpt is not None:
            done.add(vid)
            ckpt.mark_done(done)
    if ckpt is not None:
        ckpt.finish()  # batch complete: a future batch starts fresh


register(
    ShellCommand(
        "ec.encode",
        "ec.encode -volumeId <id> | -collection <name> [-fullPercent 95] "
        "[-quietFor <secs>] [-force] [-inline] [-checkpoint <file>]\n"
        "\tencode a volume into 14 EC shards, spread them, delete the original;\n"
        "\tbatch runs checkpoint per-volume progress and resume on rerun;\n"
        "\t-inline finalizes from the server's encode-on-write stripe state\n"
        "\t(WEEDTPU_INLINE_EC=on) instead of re-encoding the sealed .dat —\n"
        "\tbyte-identical shards, warm fallback when no usable inline state",
        do_ec_encode,
    )
)


# -- ec.rebuild --------------------------------------------------------------


def _shard_holders(nodes: list[dict], vid: int) -> dict[int, list[dict]]:
    out: dict[int, list[dict]] = {}
    for n in nodes:
        for sid in _node_shards_of(n, vid):
            out.setdefault(sid, []).append(n)
    return out


def _copy_missing_to(env: CommandEnv, node: dict, vid: int, collection: str,
                     holders: dict[int, list[dict]],
                     only: Optional[set] = None) -> list[int]:
    """Pull every survivor shard `node` lacks onto it (restricted to the
    `only` set when given); returns the shard ids temporarily copied (for
    cleanup)."""
    local = set(_node_shards_of(node, vid))
    by_source: dict[str, list[int]] = {}
    for sid, hs in holders.items():
        if sid in local or (only is not None and sid not in only):
            continue
        src = next((h for h in hs if h["url"] != node["url"]), None)
        if src is None:
            continue
        by_source.setdefault(grpc_addr(src), []).append(sid)
    copied: list[int] = []
    first = not local  # no local shards: also pull the index files
    # Pull from every source in parallel (command_ec_rebuild.go's
    # prepareDataToRecover analog): each source writes disjoint .ecNN files
    # on the rebuilder, and the .ecx/.ecj pull rides exactly one call, so
    # the copies are independent. Wall time = slowest source, not the sum.
    jobs = []
    for src_addr, sids in sorted(by_source.items()):
        jobs.append((src_addr, sids, first))
        first = False
    errs: list[str] = []
    with futures.ThreadPoolExecutor(max_workers=min(_POOL, max(1, len(jobs)))) as pool:
        futs = {
            pool.submit(
                env.vs_call,
                grpc_addr(node),
                "VolumeEcShardsCopy",
                {
                    "volume_id": vid,
                    "collection": collection,
                    "shard_ids": sids,
                    "source_data_node": src_addr,
                    "copy_ecx_file": with_ecx,
                },
            ): (src_addr, sids)
            for src_addr, sids, with_ecx in jobs
        }
        for fut in futures.as_completed(futs):
            src_addr, sids = futs[fut]
            try:
                fut.result()
                copied.extend(sids)
            except Exception as e:  # noqa: BLE001
                errs.append(f"{src_addr}: {e}")
    if errs:
        raise ShellError(f"shard copies failed: {'; '.join(errs)}")
    return copied


def _ec_collections(env: CommandEnv) -> dict[int, str]:
    """vid -> collection, from the master's EC registry."""
    return {
        int(vid): coll
        for vid, coll in env.volume_list().get("ec_collections", {}).items()
    }


def do_ec_rebuild(args: list[str], env: CommandEnv, w: TextIO) -> None:
    fl = parse_flags(args, collection="", remote=False, trace="auto")
    trace_mode = str(fl.trace).strip().lower()
    if trace_mode not in ("on", "off", "auto"):
        raise ShellError(f"-trace must be on|off|auto, got {fl.trace!r}")
    env.confirm_locked()
    nodes = env.topology_nodes()
    colls = _ec_collections(env)
    ec_vids = sorted(
        {int(e["volume_id"]) for n in nodes for e in n.get("ec_shards", [])}
    )
    if fl.collection:
        ec_vids = [v for v in ec_vids if colls.get(v, "") == fl.collection]
    for vid in ec_vids:
        collection = colls.get(vid, "")
        holders = _shard_holders(nodes, vid)
        # rebuilder = node already holding the most shards (fewest copies —
        # or, in -remote mode, the fewest slabs streamed over the network)
        rebuilder = max(nodes, key=lambda n: len(_node_shards_of(n, vid)))
        addr = grpc_addr(rebuilder)
        # geometry-flexible volumes (ec.convert targets) record their own
        # (k, k+m): missing-shard detection over the legacy 14 would never
        # see a lost shard id >= 14 of a 20+4 volume, and the survivor
        # gate would mis-assess 12+3. Old servers report 0 -> legacy.
        k, total = DATA_SHARDS_COUNT, TOTAL_SHARDS_COUNT
        try:
            st = env.vs_call(addr, "VolumeStatus", {"volume_id": vid}, timeout=10)
            k = int(st.get("data_shards") or 0) or k
            total = int(st.get("total_shards") or 0) or total
        except Exception:  # noqa: BLE001 — unknown geometry: legacy bounds
            pass
        missing = [s for s in range(total) if s not in holders]
        if not missing:
            continue
        if len(holders) < k:
            w.write(
                f"ec.rebuild volume {vid}: only {len(holders)} shards survive, "
                f"need {k} — data LOST\n"
            )
            continue
        if fl.remote:
            # distributed path: NO bulk survivor pre-copy. The rebuilder
            # streams survivor input from peer holders while decoding —
            # trace-repair projections when the holders speak them
            # (-trace auto/on), full slabs otherwise — writes +
            # CRC-verifies the missing .ecNN files, and mounts only those.
            resp = env.vs_call(
                addr,
                "VolumeEcShardsRebuild",
                {
                    "volume_id": vid,
                    "collection": collection,
                    "remote": True,
                    "trace_mode": trace_mode,
                },
                timeout=600,
            )
            rebuilt = resp.get("rebuilt_shard_ids", [])
            if rebuilt:
                env.vs_call(
                    addr,
                    "VolumeEcShardsMount",
                    {"volume_id": vid, "collection": collection, "shard_ids": rebuilt},
                )
            detail = ""
            if resp.get("remote_survivors"):
                detail = f" (remote survivors {resp['remote_survivors']}"
                if resp.get("failed_over"):
                    detail += f", failed over {resp['failed_over']}"
                if resp.get("mode"):
                    detail += f", {resp['mode']} mode"
                    if resp.get("wire_bytes") is not None:
                        detail += f" moved {resp['wire_bytes']} bytes"
                    if resp.get("trace_fallback"):
                        detail += f", trace fell back: {resp['trace_fallback']}"
                detail += ")"
            w.write(
                f"ec.rebuild volume {vid}: rebuilt {rebuilt} on "
                f"{rebuilder['url']}{detail}\n"
            )
            continue
        copied = _copy_missing_to(env, rebuilder, vid, collection, holders)
        resp = env.vs_call(
            addr, "VolumeEcShardsRebuild", {"volume_id": vid, "collection": collection}
        )
        rebuilt = resp.get("rebuilt_shard_ids", [])
        # drop the temp survivor copies; delete remounts local = original+rebuilt
        if copied:
            env.vs_call(
                addr,
                "VolumeEcShardsDelete",
                {"volume_id": vid, "collection": collection, "shard_ids": copied},
            )
        else:
            env.vs_call(
                addr,
                "VolumeEcShardsMount",
                {"volume_id": vid, "collection": collection, "shard_ids": rebuilt},
            )
        w.write(f"ec.rebuild volume {vid}: rebuilt {rebuilt} on {rebuilder['url']}\n")


register(
    ShellCommand(
        "ec.rebuild",
        "ec.rebuild [-collection <name>] [-remote] [-trace on|off|auto]\n\tfind "
        "EC volumes with lost shards and reconstruct them on a rebuilder node;\n"
        "\t-remote streams survivors from their holders through the network-\n"
        "\toverlapped rebuild pipeline instead of bulk-copying shard files "
        "first;\n\t-trace (with -remote) controls repair-bandwidth projections: "
        "holders ship\n\tGF-projected rows instead of full slabs (on = wherever "
        "holders support\n\tit, auto = only when it also moves fewer bytes; any "
        "failure falls back\n\tto slabs)",
        do_ec_rebuild,
    )
)


# -- ec.convert --------------------------------------------------------------


def do_ec_convert(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Re-encode an aging EC volume into a different registered code
    family (geometry) without a decode->re-encode round trip: data blocks
    regroup, new parity is a GF projection of surviving shards, progress
    is journaled crash-resumable, and the old geometry serves reads until
    the verified cut-over. The converting node needs the source data
    shards locally, so missing survivors are pulled first (the ec.decode
    pre-copy discipline); stale old-geometry shards on OTHER nodes are
    deleted after cut-over, leaving the converted volume whole on the
    converter — ec.balance re-spreads it."""
    fl = parse_flags(
        args,
        volumeId=0,
        collection="",
        family="",
        nocutover=False,
    )
    if not fl.family:
        raise ShellError("ec.convert needs -family <registered code family>")
    env.confirm_locked()
    nodes = env.topology_nodes()
    colls = _ec_collections(env)
    ec_vids = sorted(
        {int(e["volume_id"]) for n in nodes for e in n.get("ec_shards", [])}
    )
    if fl.volumeId:
        if fl.volumeId not in ec_vids:
            raise ShellError(f"ec volume {fl.volumeId} not found")
        ec_vids = [fl.volumeId]
    elif fl.collection:
        ec_vids = [v for v in ec_vids if colls.get(v, "") == fl.collection]
    if not ec_vids:
        w.write("ec.convert: no matching EC volumes\n")
        return
    for vid in ec_vids:
        collection = colls.get(vid, "")
        holders = _shard_holders(nodes, vid)
        # converter = the node already holding the most shards (fewest
        # survivor copies before the conversion can read the full stripe)
        converter = max(nodes, key=lambda n: len(_node_shards_of(n, vid)))
        addr = grpc_addr(converter)
        # the conversion reads at most k source shards (all data when
        # healthy; parity only stands in for data shards missing
        # everywhere) — pre-copy exactly that set, not every survivor
        only: Optional[set] = None
        try:
            st = env.vs_call(addr, "VolumeStatus", {"volume_id": vid}, timeout=10)
            k = int(st.get("data_shards") or 0)
        except Exception:  # noqa: BLE001 — unknown geometry: copy all
            k = 0
        if k > 0:
            everywhere = set(holders) | set(_node_shards_of(converter, vid))
            data_have = sorted(s for s in everywhere if s < k)[:k]
            only = set(data_have) | set(
                sorted(s for s in everywhere if s >= k)[
                    : max(0, k - len(data_have))
                ]
            )
        copied = _copy_missing_to(
            env, converter, vid, collection, holders, only=only
        )
        resp = env.vs_call(
            addr,
            "VolumeEcShardsConvert",
            {
                "volume_id": vid,
                "collection": collection,
                "target_family": fl.family,
                "cutover": not fl.nocutover,
            },
            timeout=600,
        )
        if not fl.nocutover and resp.get("mode") != "noop":
            # old-geometry shards elsewhere are stale after cut-over —
            # drop them so lookups stop routing reads at dead layouts
            for n in nodes:
                sids = _node_shards_of(n, vid)
                if n["url"] == converter["url"] or not sids:
                    continue
                env.vs_call(
                    grpc_addr(n),
                    "VolumeEcShardsDelete",
                    {
                        "volume_id": vid,
                        "collection": collection,
                        "shard_ids": sids,
                    },
                )
        elif resp.get("mode") == "noop":
            # a noop where the converter already holds the COMPLETE target
            # set while other nodes still hold shards is the signature of
            # a previous ec.convert dying between its cut-over RPC and
            # this cleanup loop: those leftovers are old-GEOMETRY shards a
            # new-geometry locate must never route a read to. Deleting is
            # not safe to automate from here (a healthy resident volume
            # plus deliberate replica copies looks the same), so surface
            # it loudly with the exact remedy.
            held = set(_node_shards_of(converter, vid)) | set(copied)
            tgt_ids = {int(s) for s in resp.get("shard_ids") or []}
            leftovers = [
                (n["url"], _node_shards_of(n, vid))
                for n in nodes
                if n["url"] != converter["url"] and _node_shards_of(n, vid)
            ]
            if tgt_ids and tgt_ids <= held and leftovers:
                for url, sids in leftovers:
                    w.write(
                        f"ec.convert volume {vid}: WARNING possible stale "
                        f"old-geometry shards {sids} on {url} (interrupted "
                        "post-cutover cleanup?) — verify and remove with "
                        "ec.verify / VolumeEcShardsDelete, then ec.balance\n"
                    )
        w.write(
            f"ec.convert volume {vid}: {resp.get('src_family')} -> "
            f"{resp.get('target_family')} ({resp.get('mode')}) on "
            f"{converter['url']}: read {resp.get('bytes_read')} wrote "
            f"{resp.get('bytes_written')} bytes"
            + (
                f", reconstructed {resp['reconstructed_bytes']} degraded"
                if resp.get("reconstructed_bytes")
                else ""
            )
            + ("" if fl.nocutover else ", cut over")
            + "\n"
        )


register(
    ShellCommand(
        "ec.convert",
        "ec.convert -volumeId <id> | -collection <name> -family <name> "
        "[-nocutover]\n"
        "\tre-encode an EC volume into another registered code family "
        "(geometry)\n\twithout decoding: data blocks regroup, new parity "
        "is a GF projection of\n\tsurviving shards, progress journals "
        "crash-resumable (.ecc), and the old\n\tgeometry keeps serving "
        "until the verified cut-over; -nocutover stages the\n\tconverted "
        "set (<base>.cv.*) and leaves retirement to a later call",
        do_ec_convert,
    )
)


# -- ec.verify ---------------------------------------------------------------


def do_ec_verify(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """CRC-verify EC shards against their .eci records on every holder —
    the control-plane face of the scrubber's math (VolumeEcShardsVerify).
    Read-only by default; -quarantine pulls failing shards from serving
    and hands them to the holders' automatic-repair queues."""
    fl = parse_flags(args, volumeId=0, collection="", quarantine=False)
    if fl.quarantine:
        env.confirm_locked()  # mutates serving state on the holders
    nodes = env.topology_nodes()
    colls = _ec_collections(env)
    ec_vids = sorted(
        {int(e["volume_id"]) for n in nodes for e in n.get("ec_shards", [])}
    )
    if fl.volumeId:
        if fl.volumeId not in ec_vids:
            raise ShellError(f"ec volume {fl.volumeId} not found")
        ec_vids = [fl.volumeId]
    elif fl.collection:
        ec_vids = [v for v in ec_vids if colls.get(v, "") == fl.collection]
    bad_total = 0
    for vid in ec_vids:
        collection = colls.get(vid, "")
        for n in nodes:
            if not _node_shards_of(n, vid):
                continue
            try:
                resp = env.vs_call(
                    grpc_addr(n),
                    "VolumeEcShardsVerify",
                    {
                        "volume_id": vid,
                        "collection": collection,
                        "quarantine": bool(fl.quarantine),
                    },
                    timeout=600,  # a full-volume CRC pass, not a ping
                )
            except Exception as e:  # noqa: BLE001 — report, keep verifying
                w.write(f"ec.verify volume {vid} @{n['url']}: ERROR {e}\n")
                bad_total += 1
                continue
            verdicts = {
                int(s): v for s, v in (resp.get("verdicts") or {}).items()
            }
            bad = {s: v for s, v in verdicts.items() if v != "ok"}
            bad_total += len(bad)
            line = " ".join(
                f"{s}={verdicts[s]}" for s in sorted(verdicts)
            ) or "(no local shards)"
            if not resp.get("has_crcs"):
                line += " [no .eci CRC record — unverifiable]"
            if resp.get("quarantined"):
                line += f" [quarantined {sorted(resp['quarantined'])} for repair]"
            w.write(f"ec.verify volume {vid} @{n['url']}: {line}\n")
    w.write(
        f"ec.verify: {bad_total} shard(s) failed verification\n"
        if bad_total
        else "ec.verify: all shards verified clean\n"
    )


register(
    ShellCommand(
        "ec.verify",
        "ec.verify [-volumeId <id>] [-collection <name>] [-quarantine]\n"
        "\tCRC-verify every holder's EC shards against the .eci record "
        "(the scrub\n\tmath, on demand) and print per-shard verdicts; "
        "-quarantine also pulls\n\tfailing shards from serving and queues "
        "their automatic trace-repair",
        do_ec_verify,
    )
)


# -- ec.decode ---------------------------------------------------------------


def do_ec_decode(args: list[str], env: CommandEnv, w: TextIO) -> None:
    fl = parse_flags(args, volumeId=0, collection="")
    env.confirm_locked()
    nodes = env.topology_nodes()
    colls = _ec_collections(env)
    ec_vids = sorted(
        {int(e["volume_id"]) for n in nodes for e in n.get("ec_shards", [])}
    )
    if fl.volumeId:
        if fl.volumeId not in ec_vids:
            raise ShellError(f"ec volume {fl.volumeId} not found")
        ec_vids = [fl.volumeId]
    elif fl.collection:
        ec_vids = [v for v in ec_vids if colls.get(v, "") == fl.collection]
    for vid in ec_vids:
        collection = colls.get(vid, "")
        holders = _shard_holders(nodes, vid)
        target = max(nodes, key=lambda n: len(_node_shards_of(n, vid)))
        addr = grpc_addr(target)
        # the volume's recorded geometry, not the legacy 10/14: a
        # converted (12+3, 20+4) volume has a different survivor gate and
        # remnant-shard range (old servers report 0 -> legacy bounds)
        k, total = DATA_SHARDS_COUNT, TOTAL_SHARDS_COUNT
        try:
            st = env.vs_call(addr, "VolumeStatus", {"volume_id": vid}, timeout=10)
            k = int(st.get("data_shards") or 0) or k
            total = int(st.get("total_shards") or 0) or total
        except Exception:  # noqa: BLE001 — unknown geometry: legacy bounds
            pass
        if len(holders) < k:
            w.write(f"ec.decode volume {vid}: insufficient shards — data LOST\n")
            continue
        _copy_missing_to(env, target, vid, collection, holders)
        env.vs_call(
            addr, "VolumeEcShardsToVolume", {"volume_id": vid, "collection": collection}
        )
        # remove EC remnants everywhere (the .dat volume now lives on target)
        for n in nodes:
            if _node_shards_of(n, vid) or n["url"] == target["url"]:
                env.vs_call(
                    grpc_addr(n),
                    "VolumeEcShardsDelete",
                    {
                        "volume_id": vid,
                        "collection": collection,
                        "shard_ids": list(range(total)),
                    },
                )
        w.write(f"ec.decode volume {vid}: restored as normal volume on {target['url']}\n")


register(
    ShellCommand(
        "ec.decode",
        "ec.decode [-volumeId <id>] [-collection <name>]\n\tconvert EC shard sets "
        "back into normal volumes",
        do_ec_decode,
    )
)


# -- ec.balance --------------------------------------------------------------


def pick_balance_move(
    placement: dict[str, dict[int, set]],
    by_url: dict[str, dict],
    heaviest: str,
    lightest: str,
    colls: dict[int, str],
    collection_filter: str,
):
    """Choose which (vid, shard) to move heaviest -> lightest. Among the
    volumes with a movable shard, prefer the one whose shards are most
    CONCENTRATED in the heavy node's rack relative to the light node's —
    the move then also improves rack spread (command_ec_balance.go
    balances racks before nodes). Pure so the ordering is unit-testable.
    Returns (vid, sid) or None."""

    def rack_shards(vid: int, rack: str) -> int:
        return sum(
            len(placement[u].get(vid, ()))
            for u in placement
            if by_url[u]["rack"] == rack
        )

    src_rack = by_url[heaviest]["rack"]
    dst_rack = by_url[lightest]["rack"]
    candidates = []
    for vid, sids in placement[heaviest].items():
        if collection_filter and colls.get(vid, "") != collection_filter:
            continue
        movable = sids - placement[lightest].get(vid, set())
        if not movable:
            continue
        spread_gain = rack_shards(vid, src_rack) - rack_shards(vid, dst_rack)
        candidates.append((-spread_gain, vid, min(movable)))
    if not candidates:
        return None
    _key, vid, sid = min(candidates)
    return vid, sid


def _move_shard(
    env: CommandEnv, src: dict, dst: dict, vid: int, collection: str,
    sid: int, dst_has_vid: bool,
) -> None:
    """One shard migration dst <- src via the copy/mount/delete RPC
    discipline (the shard-copy machinery)."""
    env.vs_call(
        grpc_addr(dst),
        "VolumeEcShardsCopy",
        {
            "volume_id": vid,
            "collection": collection,
            "shard_ids": [sid],
            "source_data_node": grpc_addr(src),
            "copy_ecx_file": not dst_has_vid,
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


def fix_placement_moves(
    placement_map: dict[str, dict[int, set]],
    by_url: dict[str, dict],
    parity_of,
    cap_override: int = 0,
    only_vids=None,
):
    """Plan the migrations that restore the failure-domain invariant:
    for every (stripe, domain) holding more than m shards, move the
    excess (highest shard ids first) to nodes in domains with headroom,
    least-loaded first. Pure: yields (vid, sid, src_url, dst_url); the
    caller executes every planned move — `placement_map` is mutated AS
    the plan is built, so a caller-side skip would desynchronize the
    map from the cluster (filter with `only_vids` instead)."""
    from seaweedfs_tpu_torch.ec import placement as pl

    moves: list[tuple[int, int, str, str]] = []
    domains = {u: pl.domain_of(n) for u, n in by_url.items()}
    vids = sorted({vid for per in placement_map.values() for vid in per})
    if only_vids is not None:
        vids = [v for v in vids if v in set(only_vids)]
    for vid in vids:
        parity = parity_of(vid)
        cap = pl.max_per_domain(parity, cap_override)
        holders = {}
        for u, per in placement_map.items():
            for s in per.get(vid, ()):
                holders.setdefault(s, []).append(u)
        for dom, sids in pl.stripe_violations(
            holders, domains, parity, cap_override
        ):
            excess = sids[cap:]
            for sid in excess:
                src_url = next(
                    u for u in holders.get(sid, []) if domains[u] == dom
                )

                def dom_count(d: tuple) -> int:
                    return len(
                        {
                            s
                            for u, per in placement_map.items()
                            if domains[u] == d
                            for s in per.get(vid, ())
                        }
                    )

                candidates = [
                    u
                    for u in placement_map
                    if domains[u] != dom
                    and sid not in placement_map[u].get(vid, ())
                    and dom_count(domains[u]) < cap
                ]
                if not candidates:
                    continue  # nowhere legal: reported, not worsened
                dst_url = min(
                    candidates,
                    key=lambda u: (
                        sum(len(s) for s in placement_map[u].values()),
                        u,
                    ),
                )
                moves.append((vid, sid, src_url, dst_url))
                placement_map[src_url][vid].discard(sid)
                placement_map[dst_url].setdefault(vid, set()).add(sid)
    return moves


def do_ec_balance(args: list[str], env: CommandEnv, w: TextIO) -> None:
    fl = parse_flags(args, collection="", fixPlacement=False)
    env.confirm_locked()
    nodes = env.topology_nodes()
    colls = _ec_collections(env)
    if not nodes:
        raise ShellError("no volume servers")
    # live shard map: url -> {vid -> set(sids)}
    placement: dict[str, dict[int, set]] = {
        n["url"]: {
            int(e["volume_id"]): set(ShardBits(e.get("shard_bits", 0)).shard_ids())
            for e in n.get("ec_shards", [])
        }
        for n in nodes
    }
    by_url = {n["url"]: n for n in nodes}

    def load(url: str) -> int:
        return sum(len(s) for s in placement[url].values())

    moves = 0
    if fl.fixPlacement:
        # restore the failure-domain invariant FIRST (a rack holding >m
        # shards of one stripe): correctness moves beat load moves
        def parity_of(vid: int) -> int:
            holders = [
                u for u, per in placement.items() if per.get(vid)
            ]
            for u in holders:
                try:
                    st = env.vs_call(
                        grpc_addr(by_url[u]), "VolumeStatus",
                        {"volume_id": vid}, timeout=10,
                    )
                    total = int(st.get("total_shards") or 0)
                    data = int(st.get("data_shards") or 0)
                    if total and data:
                        return max(1, total - data)
                except Exception:  # noqa: BLE001 — next holder
                    continue
            return TOTAL_SHARDS_COUNT - DATA_SHARDS_COUNT
        from seaweedfs_tpu_torch.utils import config as _config

        planned = fix_placement_moves(
            placement, by_url, parity_of,
            cap_override=int(_config.env("WEEDTPU_PLACEMENT_MAX_PER_DOMAIN")),
            # filter BEFORE planning: the planner mutates `placement` as
            # it plans, so every planned move must actually execute
            only_vids=(
                [v for v in colls if colls.get(v, "") == fl.collection]
                if fl.collection
                else None
            ),
        )
        for vid, sid, src_url, dst_url in planned:
            _move_shard(
                env, by_url[src_url], by_url[dst_url], vid,
                colls.get(vid, ""), sid,
                # placement was already mutated by the planner: "had the
                # volume before this move" = any shard besides sid
                bool(placement[dst_url].get(vid, set()) - {sid}),
            )
            moves += 1
        if planned:
            w.write(
                f"ec.balance: fixed placement with {len(planned)} "
                "domain-cap move(s)\n"
            )
    while True:
        urls = sorted(placement, key=load)
        lightest, heaviest = urls[0], urls[-1]
        if load(heaviest) - load(lightest) <= 1:
            break
        picked = pick_balance_move(
            placement, by_url, heaviest, lightest, colls, fl.collection
        )
        if picked is None:
            break
        vid, sid = picked
        if fl.fixPlacement:
            # the load loop must not re-break the invariant the fix
            # phase just restored: refuse a move that would push the
            # destination's rack past the domain cap (stop balancing —
            # pick would re-propose the same move forever)
            from seaweedfs_tpu_torch.ec import placement as _pl

            domains = {u: _pl.domain_of(n) for u, n in by_url.items()}
            holders: dict[int, list[str]] = {}
            for u, per in placement.items():
                for s in per.get(vid, ()):
                    holders.setdefault(s, []).append(u)
            # model the move: sid leaves heaviest, lands on lightest
            holders[sid] = [
                u for u in holders.get(sid, []) if u != heaviest
            ] + [lightest]
            if _pl.stripe_violations(
                holders, domains, parity_of(vid),
                int(_config.env("WEEDTPU_PLACEMENT_MAX_PER_DOMAIN")),
            ):
                w.write(
                    "ec.balance: stopping — the next load move would "
                    "violate the domain cap\n"
                )
                break
        collection = colls.get(vid, "")
        src, dst = by_url[heaviest], by_url[lightest]
        env.vs_call(
            grpc_addr(dst),
            "VolumeEcShardsCopy",
            {
                "volume_id": vid,
                "collection": collection,
                "shard_ids": [sid],
                "source_data_node": grpc_addr(src),
                "copy_ecx_file": not placement[lightest].get(vid),
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
        placement[heaviest][vid].discard(sid)
        if not placement[heaviest][vid]:
            del placement[heaviest][vid]
        placement[lightest].setdefault(vid, set()).add(sid)
        moves += 1
    w.write(f"ec.balance: moved {moves} shards\n")


register(
    ShellCommand(
        "ec.balance",
        "ec.balance [-collection <name>] [-fixPlacement]\n\teven out EC "
        "shard counts across volume servers; -fixPlacement first migrates "
        "shards\n\tout of failure domains holding more than m shards of a "
        "stripe (the\n\tno-rack-holds->m invariant), via the copy/mount/"
        "delete shard machinery",
        do_ec_balance,
    )
)


# -- ec.trace ----------------------------------------------------------------


def _fetch_json(url: str, timeout: float = 10.0) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def do_ec_trace(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Pull retained weedtrace span trees from every volume server's
    `/debug/traces` ring and render them slowest-first — the operator
    answer to "WHY was that read slow": per-stage wall times (lookup vs
    fetch vs hedge vs coalesce wait vs decode) for the tail requests the
    ring always keeps. Read-only; no cluster lock."""
    fl = parse_flags(
        args,
        server="",      # substring filter on the node url
        klass="",       # healthy | ec_intact | degraded | put | ...
        kind="",        # http.read | http.write | rpc.server | ...
        minMs=0.0,      # only traces at least this slow
        limit=5,        # per server
        traceId="",     # one specific id (post-incident grep)
    )
    # the master's ring too (master.http roots, its rpc.server
    # continuations) — "cluster-wide" must include every process that
    # retains traces, not just the volume servers
    nodes = [{"url": env.master_address}] + env.topology_nodes()
    if fl.server:
        nodes = [n for n in nodes if fl.server in n["url"]]
    if not nodes:
        raise ShellError("no matching servers")
    from seaweedfs_tpu_torch.obs import trace as trace_obs

    shown = 0
    for n in sorted(nodes, key=lambda n: n["url"]):
        q = f"?limit={1000000 if fl.traceId else int(fl.limit)}"
        if fl.klass:
            q += f"&class={fl.klass}"
        if fl.kind:
            q += f"&kind={fl.kind}"
        if fl.minMs:
            q += f"&min_ms={fl.minMs}"
        try:
            payload = _fetch_json(f"http://{n['url']}/debug/traces{q}")
        except Exception as e:  # noqa: BLE001 — a dead node has no ring
            w.write(f"# {n['url']}: unreachable ({e})\n")
            continue
        traces = payload.get("traces", [])
        if fl.traceId:
            traces = [t for t in traces if t.get("trace_id") == fl.traceId]
        st = payload.get("stats", {})
        w.write(
            f"# {n['url']}: {len(traces)} shown "
            f"(ring kept {st.get('kept', '?')}/{st.get('offered', '?')} "
            f"offered; tracing "
            f"{'on' if payload.get('enabled') else 'OFF'})\n"
        )
        for t in traces:
            w.write(trace_obs.render_trace(t) + "\n")
            shown += 1
    if not shown:
        w.write("ec.trace: no retained traces matched\n")


register(
    ShellCommand(
        "ec.trace",
        "ec.trace [-server <url-substr>] [-klass <class>] [-kind <kind>] "
        "[-minMs <ms>] [-limit <n>] [-traceId <id>]\n"
        "\trender retained weedtrace span trees from the volume servers' "
        "/debug/traces\n\trings, slowest first — per-stage wall times "
        "(lookup/fetch/hedge/coalesce/\n\tdecode) for tail requests; "
        "-traceId finds one specific request cluster-wide",
        do_ec_trace,
    )
)


# -- ec.status ---------------------------------------------------------------


def _scrape_metrics(url: str, timeout: float = 5.0) -> list[tuple[str, dict, float]]:
    """Parse one node's Prometheus /metrics text into
    [(bare_name, labels, value)] — just enough of the exposition format
    for the health summary (no external client on this image)."""
    import re as _re
    import urllib.request

    out: list[tuple[str, dict, float]] = []
    with urllib.request.urlopen(f"http://{url}/metrics", timeout=timeout) as r:
        text = r.read().decode()
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name_part, _, value = line.rpartition(" ")
        m = _re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?$", name_part)
        if not m:
            continue
        labels = {}
        if m.group(2):
            for pair in _re.findall(r'(\w+)="([^"]*)"', m.group(2)):
                labels[pair[0]] = pair[1]
        try:
            out.append((m.group(1), labels, float(value)))
        except ValueError:
            continue
    return out


def _metric_sum(rows, name: str, **match) -> float:
    return sum(
        v for n, labels, v in rows
        if n == name and all(labels.get(k) == str(val) for k, val in match.items())
    )


def _fleet_risk_lines(env: CommandEnv) -> list[str]:
    """The fleet-risk section of ec.status: the master scheduler's
    redundancy histogram (stripes by shards lost — the "am I about to
    lose data" view), failure-domain violations, and repair queue depth
    / inflight / recent events."""
    try:
        st = env.master_call("RepairStatus", {})
    except Exception as e:  # noqa: BLE001 — old master: no fleet section
        return [f"fleet: unavailable ({e})"]
    hist = st.get("redundancy_histogram") or {}
    hist_s = " ".join(
        f"{k}-lost={hist[k]}" for k in sorted(hist, key=lambda x: int(x))
    ) or "-"
    lines = [
        "fleet: scheduler="
        + ("on" if st.get("enabled") else "off (WEEDTPU_REPAIR=off)")
        + f" queue={st.get('queue_depth', 0)} inflight={st.get('inflight', 0)}"
        + f" stripes[{hist_s}]"
    ]
    batches = st.get("batches") or []
    if batches:
        fused = st.get("fused_volumes_total", 0)
        last = batches[-1]
        lines.append(
            f"fleet: batches={len(batches)} fused_volumes={fused} last["
            f"volumes={last.get('volumes', 0)}"
            f" sigs={last.get('signature_groups', 0)}"
            f" dispatches={last.get('dispatch_groups', 0)}"
            f" wall={last.get('wall_s', 0.0):.2f}s]"
        )
    suspects = st.get("suspects") or []
    if suspects:
        lines.append(f"fleet: suspects={' '.join(suspects)}")
    for v in st.get("violations") or []:
        lines.append(f"fleet: VIOLATION {v}")
    events = st.get("events") or []
    for e in events[-5:]:
        lines.append(
            f"fleet: [{e['seq']}] vid={e['volume_id']} "
            f"missing={e['missing']} {e['state']}"
            + (f" -> {e['target']}" if e.get("target") else "")
            + (f" ({e['detail']})" if e.get("detail") else "")
        )
    return lines


def do_ec_status(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """One-screen cluster health summary: the master's fleet-risk view
    (redundancy histogram, placement violations, repair queue) plus
    per-server quarantined shards (with reasons, from VolumeStatus),
    scrub progress, rebuild/convert inflight (live weedtpu_rpc_inflight
    gauges), the decoded-interval read cache (hit/miss/hit-rate, bytes
    resident, evictions, invalidations), and the codec backend each
    server selected. Read-only; no cluster lock."""
    parse_flags(args)
    nodes = env.topology_nodes()
    if not nodes:
        raise ShellError("no volume servers")
    for line in _fleet_risk_lines(env):
        w.write(line + "\n")
    for n in sorted(nodes, key=lambda n: n["url"]):
        url = n["url"]
        ec_vids = sorted(
            int(e["volume_id"]) for e in n.get("ec_shards", [])
        )
        quarantined: list[str] = []
        for vid in ec_vids:
            try:
                st = env.vs_call(
                    grpc_addr(n), "VolumeStatus", {"volume_id": vid}, timeout=10
                )
            except Exception:  # noqa: BLE001 — racing unmount: skip
                continue
            for s, reason in sorted((st.get("quarantined") or {}).items()):
                quarantined.append(f"{vid}.{int(s):02d}={reason}")
        try:
            rows = _scrape_metrics(url)
        except Exception as e:  # noqa: BLE001 — node HTTP down
            w.write(f"{url}: UNREACHABLE ({e})\n")
            continue
        scrub_mb = _metric_sum(rows, "weedtpu_scrub_bytes_scanned_total") / 1e6
        cycles = int(_metric_sum(rows, "weedtpu_scrub_cycles_total"))
        found = int(_metric_sum(rows, "weedtpu_scrub_corruptions_found_total"))
        repairs_ok = int(_metric_sum(rows, "weedtpu_scrub_repairs_total", result="ok"))
        repairs_fail = int(
            _metric_sum(rows, "weedtpu_scrub_repairs_total", result="failed")
        )
        rebuild_inflight = int(
            _metric_sum(rows, "weedtpu_rpc_inflight", method="VolumeEcShardsRebuild")
        )
        convert_inflight = int(
            _metric_sum(rows, "weedtpu_rpc_inflight", method="VolumeEcShardsConvert")
        )
        rebuilds_done = int(_metric_sum(rows, "weedtpu_ec_rebuild_seconds_count"))
        converts_done = int(_metric_sum(rows, "weedtpu_ec_convert_seconds_count"))
        backends = sorted(
            f"{labels.get('backend')}({labels.get('source')})"
            for name, labels, v in rows
            if name == "weedtpu_ec_backend_selected" and v == 1.0
        )
        # xorsched schedule-cache state (only exported once the server has
        # dispatched through the xorsched path at least once)
        xs_hits = int(_metric_sum(rows, "weedtpu_xorsched_schedule_cache", event="hits"))
        xs_miss = int(_metric_sum(rows, "weedtpu_xorsched_schedule_cache", event="misses"))
        xs_size = int(_metric_sum(rows, "weedtpu_xorsched_schedule_cache", event="size"))
        xs_cap = int(_metric_sum(rows, "weedtpu_xorsched_schedule_cache", event="cap"))
        xs = (
            f" xorsched={xs_hits}hit/{xs_miss}miss({xs_size}/{xs_cap})"
            if xs_hits or xs_miss
            else ""
        )
        # decoded-interval cache: is degraded hot-set traffic actually
        # being served from cache, and is the budget churning (evictions)
        # or being flushed by topology events (invalidations)?
        cache_hits = int(_metric_sum(rows, "weedtpu_read_cache_hits_total"))
        cache_misses = int(_metric_sum(rows, "weedtpu_read_cache_misses_total"))
        cache_mb = _metric_sum(rows, "weedtpu_read_cache_bytes") / 1e6
        cache_evict = int(_metric_sum(rows, "weedtpu_read_cache_evictions_total"))
        cache_inval = int(
            _metric_sum(rows, "weedtpu_read_cache_invalidations_total")
        )
        cache_rate = (
            f"{cache_hits / (cache_hits + cache_misses):.0%}"
            if cache_hits + cache_misses
            else "-"
        )
        w.write(
            f"{url}: ec_volumes={len(ec_vids)} "
            f"quarantined=[{' '.join(quarantined) or '-'}] "
            f"scrub={scrub_mb:.1f}MB/{cycles}cyc found={found} "
            f"repairs={repairs_ok}ok/{repairs_fail}failed "
            f"rebuild={rebuild_inflight}inflight/{rebuilds_done}done "
            f"convert={convert_inflight}inflight/{converts_done}done "
            f"cache={cache_hits}hit/{cache_misses}miss({cache_rate}) "
            f"{cache_mb:.1f}MB evict={cache_evict} inval={cache_inval} "
            f"backend={','.join(backends) or '?'}{xs}\n"
        )


register(
    ShellCommand(
        "ec.status",
        "ec.status\n\tone-screen cluster health: the master's fleet-risk "
        "view (stripes by\n\tremaining redundancy, failure-domain "
        "violations, repair queue/events),\n\tplus per-server quarantined "
        "shards (+reasons), scrub progress, live\n\trebuild/convert "
        "inflight, repair outcomes, the decoded-interval\n\tread-cache "
        "hit rate / footprint / churn, and the selected codec\n\tbackend",
        do_ec_status,
    )
)


# -- ec.backend --------------------------------------------------------------


def do_ec_backend(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Operator view of the encoder factory's selection audit: which kernel
    variant and tile `new_encoder()` picks HERE for the shell's device and
    why — the evidence file/round behind a promotion, the mesh shape and
    rebuild formulation when the multi-card path is selected, and the reason
    string when the default holds. On the CPU it names the plain version,
    and for the CPU paths (torch, native, xorsched) it prints the
    reference's CPU-floor line: which one serves, the BENCH evidence round
    behind an xorsched promotion (- when the default held), the SIMD level
    of the XOR executor and this process's compiled-schedule LRU.
    Read-only; no cluster lock."""
    parse_flags(args)
    from seaweedfs_tpu_torch.ops.rs_codec import new_encoder

    enc = new_encoder(device=env.device)
    sel = dict(enc.selection)
    sel.pop("mesh", None)  # the nested decision dict is too noisy for a shell line
    w.write(
        "ec.backend: "
        + " ".join(f"{k}={sel[k]}" for k in sorted(sel) if sel[k] is not None)
        + "\n"
    )
    mesh_dec = enc.selection.get("mesh")
    if isinstance(mesh_dec, dict) and enc.backend != "mesh":
        w.write(f"ec.backend: mesh not promoted: {mesh_dec.get('reason', 'n/a')}\n")
    if enc.backend == "torch":
        w.write("ec.backend: cpu: path=rs_torch (the kernels' plain version)\n")
    if enc.backend in ("torch", "native", "xorsched"):
        from seaweedfs_tpu_torch.ops import xorsched

        ci = xorsched.schedule_cache_info()
        w.write(
            "ec.backend: cpu floor: "
            f"path={enc.backend} "
            f"evidence_round={enc.selection.get('evidence_round', '-')} "
            f"xor_simd={xorsched.native_level()} "
            f"sched_cache={ci['hits']}hit/{ci['misses']}miss "
            f"size={ci['size']}/{ci['cap']} evict={ci['evictions']}\n"
        )


register(
    ShellCommand(
        "ec.backend",
        "ec.backend\n\treport the encoder factory's selection audit (kernel "
        "variant, tile,\n\tevidence file and round when a variant is promoted, "
        "and the reason\n\tthe default held otherwise; on the CPU, the "
        "cpu-floor line)",
        do_ec_backend,
    )
)
