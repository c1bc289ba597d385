"""The port's master, placement planner, configuration and `server`
command against the reference's: twins of `tests/test_fleet.py`'s
placement cases, `test_security_stats.py`'s metrics case and
`test_proto_wire.py`'s cluster round trip; a mixed cluster (port volume
servers under a reference master, driven by the reference's client); the
servers' WEEDTPU_* knobs read against the reference's registry; every
branch the port leaves out raising loudly; and a subprocess smoke of
`python -m seaweedfs_tpu_torch server --device cpu`."""

import os
import random
import re
import signal
import subprocess
import sys
import time
import urllib.request

import grpc
import pytest
import torch

import seaweedfs_tpu.ec
from seaweedfs_tpu.shell.command_ec import fix_placement_moves
from seaweedfs_tpu.utils import config as ref_config
from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
from seaweedfs_tpu_torch.command import servers
from seaweedfs_tpu_torch.utils import config as port_config

from test_torch_cluster import (
    PORT, REF, blob, cluster, put, shard_shas, stop_all, strip, twin, vid_of, wait_for,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- tests/test_fleet.py placement twins ---------------------------------------------------


def _random_nodes(rng, n_nodes, n_racks, n_dcs=1):
    return [{"url": f"n{i}:80", "data_center": f"dc{rng.randrange(n_dcs)}",
             "rack": f"r{rng.randrange(n_racks)}"} for i in range(n_nodes)]


def _plan_spread_invariant(pkg, root):
    rng = random.Random(5)
    plans = []
    for trial in range(60):
        n_racks = rng.randrange(1, 8)
        nodes = _random_nodes(rng, rng.randrange(1, 12), n_racks)
        total, parity = rng.choice([(14, 4), (15, 3), (24, 4)])
        alloc = pkg.placement.plan_spread(nodes, total, parity)
        assert sorted(s for sids in alloc.values() for s in sids) == list(range(total))
        racks = {pkg.placement.domain_of(n) for n in nodes}
        by_url = {n["url"]: n for n in nodes}
        per_dom: dict = {}
        for url, sids in alloc.items():
            dom = pkg.placement.domain_of(by_url[url])
            per_dom[dom] = per_dom.get(dom, 0) + len(sids)
        assert max(per_dom.values()) <= max(parity, -(-total // len(racks)))
        if len(racks) * parity >= total:
            assert max(per_dom.values()) <= parity
        plans.append({u: sorted(s) for u, s in alloc.items()})
    return plans


def test_plan_spread_invariant_across_random_topologies(tmp_path, monkeypatch):
    twin(_plan_spread_invariant, tmp_path, monkeypatch)


def _stripe_violations(pkg, root):
    domains = {"a:1": ("dc", "r1"), "b:1": ("dc", "r1"), "c:1": ("dc", "r2")}
    holders = {s: ["a:1"] for s in range(5)}
    v = pkg.placement.stripe_violations(holders, domains, 4)
    assert len(v) == 1 and v[0][0] == ("dc", "r1") and len(v[0][1]) == 5
    holders[0] = ["a:1", "c:1"]
    cleared = pkg.placement.stripe_violations(holders, domains, 4)
    assert not cleared
    return {"violations": v, "cleared": cleared}


def test_stripe_violations_detects_and_clears(tmp_path, monkeypatch):
    twin(_stripe_violations, tmp_path, monkeypatch)


def _pick_rebuild_target(pkg, root):
    nodes = [{"url": f"n{i}:80", "data_center": "dc", "rack": f"r{i % 4}"} for i in range(8)]
    domains = {n["url"]: pkg.placement.domain_of(n) for n in nodes}
    holders = {0: ["n0:80"], 1: ["n4:80"], 2: ["n0:80"], 3: ["n0:80"]}
    target = pkg.placement.pick_rebuild_target(nodes, holders, domains, missing=[12, 13],
                                               parity=4)
    assert domains[target["url"]] != ("dc", "r0")
    return target


def test_pick_rebuild_target_respects_domain_cap(tmp_path, monkeypatch):
    twin(_pick_rebuild_target, tmp_path, monkeypatch)


def _plan_parity_targets(pkg, root):
    rng = random.Random(9)
    plans = []
    for _ in range(30):
        nodes = _random_nodes(rng, rng.randrange(2, 10), rng.randrange(1, 6))
        owner = nodes[0]["url"]
        targets = pkg.placement.plan_parity_targets(nodes, owner, 10, 14)
        assert all(n["url"] != owner for n in targets.values())
        assert set(targets) <= set(range(10, 14))
        per_dom: dict = {}
        for n in targets.values():
            d = pkg.placement.domain_of(n)
            per_dom[d] = per_dom.get(d, 0) + 1
        if per_dom:
            assert max(per_dom.values()) <= 4
        plans.append({s: n["url"] for s, n in targets.items()})
    return plans


def test_plan_parity_targets_excludes_owner_and_caps_domains(tmp_path, monkeypatch):
    twin(_plan_parity_targets, tmp_path, monkeypatch)


def _fix_placement_moves(pkg, root, mp):
    """The reference shell's `ec.balance -fixPlacement` planner, run over
    each package's placement module."""
    mp.setattr(seaweedfs_tpu.ec, "placement", pkg.placement)
    by_url = {u: {"url": u, "data_center": "dc", "rack": r}
              for u, r in (("a:1", "r0"), ("b:1", "r0"), ("c:1", "r1"), ("d:1", "r2"),
                           ("e:1", "r3"))}
    placement_map = {"a:1": {7: {0, 1, 2}}, "b:1": {7: {3, 4, 5}}, "c:1": {7: {6, 7, 8, 9}},
                     "d:1": {7: {10, 11, 12}}, "e:1": {7: {13}}}
    moves = fix_placement_moves(placement_map, by_url, lambda vid: 4)
    mp.undo()
    assert len(moves) == 2
    for vid, sid, src, dst in moves:
        assert by_url[src]["rack"] == "r0" and by_url[dst]["rack"] != "r0"
    domains = {u: pkg.placement.domain_of(n) for u, n in by_url.items()}
    holders: dict = {}
    for u, per in placement_map.items():
        for s in per.get(7, ()):
            holders.setdefault(s, []).append(u)
    assert not pkg.placement.stripe_violations(holders, domains, 4)
    return {"moves": moves, "map": placement_map}


def test_fix_placement_moves_restores_invariant(tmp_path, monkeypatch):
    twin(_fix_placement_moves, tmp_path, monkeypatch, mp=pytest.MonkeyPatch())


# -- tests/test_security_stats.py:149 and test_proto_wire.py:139 twins ----------------------


def _metrics_exposition_and_counters(pkg, root):
    with cluster(pkg, root, n=1, heartbeat=0.3) as (master, (vs,), client):
        hb_before = pkg.stats.MasterReceivedHeartbeatCounter.value
        vs.heartbeat_once()
        res = client.submit(b"metrics payload")
        got = client.read(res.fid)
        assert got == b"metrics payload"
        body = urllib.request.urlopen(f"http://{vs.url}/metrics", timeout=10).read().decode()
        lines = ("# TYPE weedtpu_volume_request_total counter",
                 'weedtpu_volume_request_total{type="post"}',
                 'weedtpu_volume_request_total{type="get"}',
                 "# TYPE weedtpu_ec_reconstruct_seconds histogram",
                 "weedtpu_ec_reconstruct_seconds_bucket")
        for line in lines:
            assert line in body
        assert pkg.stats.MasterReceivedHeartbeatCounter.value > hb_before
        assert pkg.stats.MasterAssignCounter.value >= 1
        families = sorted(ln.split()[2] for ln in body.splitlines() if ln.startswith("# TYPE "))
        return {"read": got, "families": families}


def test_metrics_exposition_and_counters(tmp_path, monkeypatch):
    twin(_metrics_exposition_and_counters, tmp_path, monkeypatch)


def _cluster_round_trip_over_binary_wire(pkg, root):
    from seaweedfs_tpu.filer import FilerServer
    from seaweedfs_tpu.filer.client import FilerClient
    from seaweedfs_tpu.filer.entry import Entry

    with cluster(pkg, root, n=1, heartbeat=0.3) as (master, (vs,), client):
        fid = client.submit(b"protobuf wire payload").fid
        read = client.read(fid)
        assert read == b"protobuf wire payload"
        fs = FilerServer(master.address)
        fs.start()
        try:
            rc = REF.client.MasterClient(master.address)
            assert rc.read(fid) == read  # the reference's client too
            rc.close()
            fc = FilerClient(fs.grpc_address)
            fc.create(Entry(path="/pw/dir", is_directory=True))
            fc.create(Entry(path="/pw/dir/a.txt"))
            listed = [e.name for e in fc.list("/pw/dir")]
            assert listed == ["a.txt"]
            fc.kv_put("wirekey", b"\x00bin\xff")
            kv = fc.kv_get("wirekey")
            assert kv == b"\x00bin\xff"
            fc.delete("/pw/dir", recursive=True)
            fc.close()
        finally:
            fs.stop()
        return {"read": read, "listed": listed, "kv": kv}


def test_cluster_round_trip_over_binary_wire(tmp_path, monkeypatch):
    """WEEDTPU_WIRE=proto: assign, upload and read on a master and volume
    server, then the reference's filer on that master creates, lists and
    deletes entries, every control RPC on protobuf frames; on a reference
    cluster and on a port one (so the reference's filer and client speak
    protobuf to the port's master and volume server)."""
    monkeypatch.setenv("WEEDTPU_WIRE", "proto")
    twin(_cluster_round_trip_over_binary_wire, tmp_path, monkeypatch)


# -- a mixed cluster: port volume servers under a reference master -----------------------


def test_port_volume_servers_under_a_reference_master(tmp_path, monkeypatch):
    """The reference's master and client drive three port volume servers:
    assign and upload, EC generate on the owner, spread by
    VolumeEcShardsCopy, degraded reads through the port's HTTP front and a
    remote rebuild; the shards equal a reference cluster's, byte for byte."""
    def scenario(vs_pkg, root):
        VS = vs_pkg.VOLUME_SERVICE
        master = REF.MasterServer(port=0, reap_interval=3600)
        master.start()
        servers = []
        try:
            for i in range(3):
                d = root / f"srv{i}"
                d.mkdir()
                vs = vs_pkg.VolumeServer([str(d)], master.address, heartbeat_interval=0.3,
                                         rack=f"rack{i % 2}", encoder=vs_pkg.encoder())
                vs.start()
                servers.append(vs)
            client = REF.MasterClient(master.address)
            vid = vid_of(client.assign().fid)
            payloads = {put(REF, client, vid, k, blob(300 + k, 7000 + 900 * k)): blob(
                300 + k, 7000 + 900 * k) for k in range(1, 7)}
            owner = next(s for s in servers if s.store.get_volume(vid) is not None)
            with REF.rpc.RpcClient(owner.grpc_address) as oc:
                oc.call(VS, "VolumeMarkReadonly", {"volume_id": vid})
                oc.call(VS, "VolumeEcShardsGenerate",
                        {"volume_id": vid, "large_block_size": 4096, "small_block_size": 512})
            base = owner._base_path_for(vid)
            generated = shard_shas(vs_pkg, base)
            others = [s for s in servers if s is not owner]
            for target, ids in ((others[0], [5, 6, 7, 8, 9]), (others[1], [10, 11, 12])):
                with REF.rpc.RpcClient(target.grpc_address) as tc:
                    tc.call(VS, "VolumeEcShardsCopy", {"volume_id": vid, "shard_ids": ids,
                                                       "source_data_node": owner.grpc_address})
            for s in range(5, 14):
                os.remove(vs_pkg.stripe.shard_file_name(base, s))
            with REF.rpc.RpcClient(owner.grpc_address) as oc:
                oc.call(VS, "VolumeDelete", {"volume_id": vid})
            for vs in servers:
                with REF.rpc.RpcClient(vs.grpc_address) as c:
                    c.call(VS, "VolumeEcShardsMount", {"volume_id": vid})
            wait_for(lambda: len(master.topology.lookup_ec_shards(vid)) == 13,
                     msg="13 shards registered with the reference master")
            reads = {fid: client.read(fid) for fid in payloads}
            assert reads == payloads
            with REF.rpc.RpcClient(others[1].grpc_address) as c:
                resp = c.call(VS, "VolumeEcShardsRebuild", {"volume_id": vid, "remote": True},
                              timeout=120)
            assert resp["rebuilt_shard_ids"] == [13]
            rebuilt = shard_shas(vs_pkg, others[1]._base_path_for(vid), [13])
            assert rebuilt == {13: generated[13]}
            client.close()
            rebuild = strip(resp)
            # one label per holder group, in the order of their (random) ports
            rebuild["trace_groups"] = sorted(rebuild.get("trace_groups", []))
            return {"generated": generated, "reads": reads, "rebuild": rebuild}
        finally:
            stop_all([*servers, master])

    twin(scenario, tmp_path, monkeypatch)


# -- the servers' knobs -----------------------------------------------------------------

KNOBS = ("WEEDTPU_INLINE_EC", "WEEDTPU_INLINE_EC_SPREAD", "WEEDTPU_LOOKUP_RETRIES",
         "WEEDTPU_PLACEMENT_MAX_PER_DOMAIN", "WEEDTPU_REBUILD_MAX_INFLIGHT",
         "WEEDTPU_REBUILD_YIELD_MS", "WEEDTPU_REPAIR", "WEEDTPU_REPAIR_REPORT_FAILURES",
         "WEEDTPU_SCRUB", "WEEDTPU_SCRUB_CHUNK", "WEEDTPU_SCRUB_CURSOR",
         "WEEDTPU_SCRUB_INTERVAL", "WEEDTPU_SCRUB_MAX_REPAIRS", "WEEDTPU_SCRUB_RATE_MB",
         "WEEDTPU_SCRUB_REPAIR_BACKOFF", "WEEDTPU_TRACE_REPAIR", "WEEDTPU_BENCH_RPC_DELAY_MS")
RAWS = (None, "", "0", "1", "-3", "7", "2.5", "on", "off", "ON", "auto", "yes", "junk",
        "100000", "/var/x.json")


def _read(config, name):
    try:
        return "value", config.env(name)
    except ValueError as e:
        return "error", type(e).__name__


@pytest.mark.parametrize("name", KNOBS)
def test_server_knob_reads_as_the_reference(monkeypatch, name):
    for raw in RAWS:
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
        assert _read(port_config, name) == _read(ref_config, name), (name, raw)


def test_security_toml_loads_as_the_reference(tmp_path, monkeypatch):
    (tmp_path / "security.toml").write_text(
        '[jwt.signing]\nkey = "k1"\nexpires_after_seconds = 7\n[guard]\nwhite_list = ["1.2.3.4"]\n')
    monkeypatch.chdir(tmp_path)
    conf = port_config.load_configuration("security")
    assert conf == ref_config.load_configuration("security")
    for path in ("jwt.signing.key", "jwt.signing.expires_after_seconds", "guard.white_list",
                 "jwt.signing.read.key", "missing.deep.key"):
        assert port_config.get_nested(conf, path, "d") == ref_config.get_nested(conf, path, "d")
    guard = servers._load_guard(conf)
    assert guard.signing_key == b"k1" and guard.expires_seconds == 7
    assert servers._load_guard({}) is None
    with pytest.raises(FileNotFoundError):
        port_config.load_configuration("nothing_here", required=True)


# -- what the port leaves out raises -------------------------------------------------------


def test_master_with_peers_raises():
    with pytest.raises(NotImplementedError, match="raft"):
        PORT.MasterServer(port=0, peers=["127.0.0.1:1", "127.0.0.1:2"], http_port=None)


@pytest.mark.parametrize("method", ["VolumeTierMove", "VolumeTierFetch"])
def test_tier_rpcs_answer_unimplemented(tmp_path, method):
    with cluster(PORT, tmp_path, n=1, heartbeat=0.3) as (master, (vs,), client):
        vid = vid_of(client.assign().fid)
        with PORT.rpc.RpcClient(vs.grpc_address) as c:
            with pytest.raises(grpc.RpcError, match="not ported") as ei:
                c.call(PORT.VOLUME_SERVICE, method,
                       {"volume_id": vid, "destination": "s3://bucket"})
        assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED


def test_volume_server_without_a_card_or_encoder_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VolumeServer([str(tmp_path)], "127.0.0.1:1")


@pytest.mark.parametrize("flag", ["-filer", "-s3", "-webdav"])
def test_server_command_front_end_flags_raise(tmp_path, flag):
    import argparse

    p = argparse.ArgumentParser()
    servers._server_conf(p)
    args = p.parse_args(["--device", "cpu", "-dir", str(tmp_path), flag])
    with pytest.raises(NotImplementedError, match="not ported yet .ROADMAP Queue 1 item 5"):
        servers._server_run(args)


# -- the command -------------------------------------------------------------------------


def test_server_command_writes_reads_and_stops(tmp_path):
    """`python -m seaweedfs_tpu_torch server --device cpu` starts a master
    and a volume server in one process; the port's client writes and reads
    through it, an EC generate runs on its CPU encoder, and SIGTERM stops it
    with exit code 0."""
    d = tmp_path / "data"
    d.mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "server", "--device", "cpu", "-dir",
         str(d), "-masterPort", "0", "-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        line = proc.stdout.readline()
        m = re.search(r"master (\S+) \(http :(\d+)\), volume http (\S+) grpc (\S+)", line)
        assert m, line + proc.stderr.read() if proc.poll() is not None else line
        master_addr, vs_grpc = m.group(1), m.group(4)
        client = PORT.MasterClient(master_addr)
        try:
            deadline = time.monotonic() + 30
            while True:
                try:
                    fid = client.submit(b"served by the server command").fid
                    break
                except PORT.ClusterError:
                    assert time.monotonic() < deadline, "the volume server never registered"
                    time.sleep(0.1)
            assert client.read(fid) == b"served by the server command"
            vid = vid_of(fid)
            with PORT.rpc.RpcClient(vs_grpc) as c:
                c.call(PORT.VOLUME_SERVICE, "VolumeMarkReadonly", {"volume_id": vid})
                gen = c.call(PORT.VOLUME_SERVICE, "VolumeEcShardsGenerate",
                             {"volume_id": vid, "large_block_size": 4096,
                              "small_block_size": 512}, timeout=120)
            assert gen["shard_ids"] == list(range(14))
        finally:
            client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
