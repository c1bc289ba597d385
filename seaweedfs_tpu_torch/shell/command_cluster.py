"""Cluster-level shell commands — lock / unlock / cluster.check,
mirroring weed/shell/command_lock_unlock.go and command_cluster_check.go."""

from __future__ import annotations

from typing import TextIO

import grpc

from seaweedfs_tpu_torch.shell import CommandEnv, ShellCommand, register


def do_lock(args: list[str], env: CommandEnv, w: TextIO) -> None:
    env.lock()
    w.write("cluster locked\n")


def do_unlock(args: list[str], env: CommandEnv, w: TextIO) -> None:
    env.unlock()
    w.write("cluster unlocked\n")


register(
    ShellCommand(
        "lock",
        "lock\n\tlease the cluster-wide exclusive admin lock from the master",
        do_lock,
    )
)
register(
    ShellCommand(
        "unlock",
        "unlock\n\trelease the cluster-wide exclusive admin lock",
        do_unlock,
    )
)


def do_cluster_check(args: list[str], env: CommandEnv, w: TextIO) -> None:
    stats = env.master_call("Statistics", {})
    w.write(
        f"master {env.master_address}: {stats.get('node_count')} nodes, "
        f"{stats.get('volume_count')} volumes, "
        f"{stats.get('ec_volume_count')} ec volumes\n"
    )
    ok = bad = 0
    for n in env.topology_nodes():
        host = n["url"].rsplit(":", 1)[0]
        addr = f"{host}:{n['grpc_port']}"
        try:
            # unconditional probe: NOT_FOUND proves the server answered
            env.vs_call(addr, "VolumeStatus", {"volume_id": 0}, timeout=5)
            w.write(f"  node {n['url']}: ok\n")
            ok += 1
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.NOT_FOUND:
                w.write(f"  node {n['url']}: ok\n")
                ok += 1
            else:
                w.write(f"  node {n['url']}: UNREACHABLE ({e.code()})\n")
                bad += 1
        except Exception as e:  # noqa: BLE001 — health summary keeps going
            w.write(f"  node {n['url']}: UNREACHABLE ({e})\n")
            bad += 1
    w.write(f"cluster.check: {ok} healthy, {bad} unreachable\n")


register(
    ShellCommand(
        "cluster.check",
        "cluster.check\n\tverify master and volume-server connectivity",
        do_cluster_check,
    )
)


def do_cluster_raft_ps(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Show raft membership and leadership (cluster.raft.ps analog)."""
    st = env.master_call("RaftListClusterServers", {})
    if not st.get("enabled"):
        w.write(
            f"raft disabled (single master {st.get('leader')}); "
            "term 0, state leader\n"
        )
        return
    w.write(
        f"leader: {st.get('leader')}  term: {st.get('term')}  "
        f"(answered by {env.master_address}, state {st.get('state')})\n"
    )
    for s in st.get("servers", []):
        mark = "*" if s == st.get("leader") else " "
        w.write(f"  {mark} {s}\n")


register(
    ShellCommand(
        "cluster.raft.ps",
        "cluster.raft.ps\n\tshow raft master membership, leader, and term",
        do_cluster_raft_ps,
    )
)


def do_cluster_ps(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """List cluster processes known to the master: masters, volume
    servers, and announced filers (cluster.ps analog)."""
    st = env.master_call("RaftListClusterServers", {})
    for s in st.get("servers", []):
        mark = "*" if s == st.get("leader") else " "
        w.write(f"master {mark} {s}\n")
    for n in env.topology_nodes():
        w.write(
            f"volume server {n['url']} (grpc :{n['grpc_port']}) "
            f"dc={n.get('data_center')} rack={n.get('rack')} "
            f"volumes={len(n.get('volumes', []))} "
            f"ec={len(n.get('ec_shards', []))}\n"
        )
    filers = env.master_call("ListClusterNodes", {}).get("filers", [])
    for f in filers:
        w.write(f"filer {f.get('http_address')} (grpc {f.get('grpc_address')})\n")


register(
    ShellCommand(
        "cluster.ps",
        "cluster.ps\n\tlist masters, volume servers, and filers in the cluster",
        do_cluster_ps,
    )
)
