"""weedlint over the port (`seaweedfs_tpu_torch.analysis`): the twins of
every `test_weedlint.py` case, on the same fixtures under
`tests/weedlint_fixtures/` (read, not copied), with the port's checkers,
registry and recorder; every fixture's findings equal to the reference's
rule for rule and line for line; the port's whole tree clean in strict
mode, in process and as `python -m seaweedfs_tpu_torch.analysis --strict`;
the port's README env table between its own markers; and the port's lock
recorder over its degraded read on the CPU."""

import _thread
import json
import os
import re
import subprocess
import sys
import threading
import time

import pytest

from seaweedfs_tpu.analysis import lockrec as ref_lockrec
from seaweedfs_tpu.analysis import run as ref_run
from seaweedfs_tpu.utils import config as ref_config
from seaweedfs_tpu_torch.analysis import PKG_ROOT, RULES, load_files, lockrec, run
from seaweedfs_tpu_torch.analysis import __main__ as cli
from seaweedfs_tpu_torch.analysis import graph as graph_mod
from seaweedfs_tpu_torch.analysis.wire_drift import parse_proto
from seaweedfs_tpu_torch.utils import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "weedlint_fixtures")
PORT = os.path.join(ROOT, "seaweedfs_tpu_torch")

#: the reference's recorder switches: only its tests/conftest.py reads
#: them, to install the reference's recorders; the port's tests install
#: the port's recorders directly, so no port code reads them
RECORDER_KNOBS = {"WEEDTPU_LOCK_OBSERVE", "WEEDTPU_LOCK_OBSERVE_OUT", "WEEDTPU_FS_OBSERVE",
                  "WEEDTPU_FS_OBSERVE_OUT"}
#: registered in the reference, not in the port: the recorder switches
LEFT_OUT_KNOBS = RECORDER_KNOBS


def fixture(name: str) -> str:
    return os.path.join(FIXTURES, name)


def rules_at(findings, path_suffix=None):
    return {
        (f.rule, f.line)
        for f in findings
        if path_suffix is None or f.path.endswith(path_suffix)
    }


def _fixture_cases():
    """(id, paths, root) for every fixture: each single-file fixture under
    the fixtures directory as root (so no package catalog is read), each
    fixture package under its own root."""
    cases = [(name, [fixture(name)], FIXTURES)
             for name in sorted(os.listdir(FIXTURES)) if name.endswith(".py")]
    for pkg in ("wiredrift_pkg", "obsdrift_pkg"):
        root = fixture(pkg)
        cases.append((pkg, [os.path.join(root, "cluster", "server.py")], root))
    return cases


FIXTURE_CASES = _fixture_cases()


def _keys(findings):
    return sorted((f.rule, f.path, f.line, f.message) for f in findings)


# -- every fixture: the port's findings are the reference's ---------------------


def test_fixture_cases_cover_every_fixture():
    names = {c[0] for c in FIXTURE_CASES}
    assert names == {n for n in os.listdir(FIXTURES)
                     if n.endswith(".py") or n.endswith("_pkg")}


@pytest.mark.parametrize("strict", [False, True], ids=["default", "strict"])
@pytest.mark.parametrize("case", FIXTURE_CASES, ids=[c[0] for c in FIXTURE_CASES])
def test_fixture_findings_equal_reference(case, strict, monkeypatch):
    """Under one registry (the reference's names) the two packages' checkers
    report the same findings, rule, path, line and message, on every
    fixture."""
    _, paths, root = case
    merged = dict(config.ENV_REGISTRY)
    for name in LEFT_OUT_KNOBS:
        merged[name] = ref_config.ENV_REGISTRY[name]
    monkeypatch.setattr(config, "ENV_REGISTRY", merged)
    port = run(paths=paths, root=root, strict=strict)
    ref = ref_run(paths=paths, root=root, strict=strict)
    assert _keys(port) == _keys(ref)
    assert port, "a fixture with no finding proves nothing"


def test_env_fixture_differs_only_by_left_out_knobs():
    """Under the port's own registry the env fixture's findings are the
    reference's: the xorsched knobs it reads are registered in both (the
    host codecs are ported), and only the recorder switches are left out."""
    port = set(_keys(run(paths=[fixture("env_raw.py")], root=FIXTURES)))
    ref = set(_keys(ref_run(paths=[fixture("env_raw.py")], root=FIXTURES)))
    assert port == ref and port
    assert set(ref_config.ENV_REGISTRY) - set(config.ENV_REGISTRY) == LEFT_OUT_KNOBS


def test_rule_catalog_is_the_reference_one():
    from seaweedfs_tpu.analysis import RULES as REF_RULES

    assert RULES == REF_RULES


# -- planted violations: every family must FIRE -------------------------------


def test_lock_order_cycle_fixture_fires():
    findings = run(paths=[fixture("lock_cycle.py")])
    cycles = [f for f in findings if f.rule == "lock-order-cycle"]
    assert len(cycles) >= 2, findings  # both edges of the a<->b cycle
    assert any("lock_a" in f.message and "lock_b" in f.message for f in cycles)


def test_lock_order_clean_when_consistent(tmp_path):
    src = (
        "import threading\n"
        "a = threading.Lock()\nb = threading.Lock()\n"
        "def one():\n    with a:\n        with b:\n            pass\n"
        "def two():\n    with a:\n        with b:\n            pass\n"
    )
    p = tmp_path / "consistent.py"
    p.write_text(src)
    findings = run(paths=[str(p)])
    assert not [f for f in findings if f.rule == "lock-order-cycle"]


def test_unlocked_global_write_fixture_fires():
    findings = run(paths=[fixture("unlocked_global.py")])
    hits = [f for f in findings if f.rule == "unlocked-global-write"]
    assert {f.line for f in hits} == {14, 15, 38}, hits


@pytest.mark.parametrize("name, sync_lines, donated_lines, rebound_from", [
    ("donation_bad.py", None, {20}, 24),
    ("donation_shardmap.py", {17}, {39, 45}, 49),
], ids=["jit", "shard_map"])
def test_donation_fixture_fires(name, sync_lines, donated_lines, rebound_from):
    """The JAX dispatch rules, kept as they are: they fire on the fixtures
    (the port's tree has no jitted code, so they find nothing there)."""
    findings = run(paths=[fixture(name)])
    sync = [f for f in findings if f.rule == "jit-host-sync"]
    donated = [f for f in findings if f.rule == "donated-buffer-read"]
    if sync_lines is None:
        assert len(sync) == 3, findings  # np.asarray, print, block_until_ready
    else:
        assert {f.line for f in sync} == sync_lines, findings
    assert {f.line for f in donated} == donated_lines, findings
    assert all(f.line < rebound_from for f in donated)


def test_donation_rules_find_nothing_in_the_port():
    findings = run(strict=True)
    assert not [f for f in findings if f.rule in ("jit-host-sync", "donated-buffer-read")]


def test_env_fixture_fires():
    findings = run(paths=[fixture("env_raw.py")])
    raw = [f for f in findings if f.rule == "env-raw-read"]
    unreg = [f for f in findings if f.rule == "env-unregistered"]
    assert len(raw) == 4, findings  # .get x2, getenv, subscript read
    assert all(f.line <= 14 for f in raw), raw
    names = " ".join(f.message for f in unreg)
    # the reference's two: the xorsched cache knob is registered in the port too
    assert len(unreg) == 2, findings
    for name in ("WEEDTPU_NO_SUCH_KNOB", "WEEDTPU_XORSCHED_LRU"):
        assert name in names
    assert "WEEDTPU_XORSCHED_CACHE" not in names


def test_resource_fixture_fires():
    findings = run(paths=[fixture("resource_bad.py")])
    opens = [f for f in findings if f.rule == "open-no-ctx"]
    tmps = [f for f in findings if f.rule == "tmpfile-no-unlink"]
    assert len(opens) == 1 and opens[0].line == 10, findings
    assert len(tmps) == 1 and tmps[0].line == 15, findings


def test_wire_drift_fixture_fires():
    pkg = fixture("wiredrift_pkg")
    findings = run(paths=[os.path.join(pkg, "cluster", "server.py")], root=pkg)
    drift = [f for f in findings if f.rule == "wire-drift"]
    msgs = " | ".join(f.message for f in drift)
    for bad in ("requester", "extra", "projection_row", "inlined", "rows_inline",
                "target_familly", "bytes_wrote", "'fused'", "blocks_order"):
        assert bad in msgs, (bad, findings)
    assert not any(f.line in (12, 17, 18, 31, 46, 47, 65) for f in drift), drift
    for good in ("mode", "bytes_read", "dispatch_groups", "signature_groups"):
        assert f"returns key '{good}'" not in msgs, drift


def test_parse_proto_oneof_fields_belong_to_message():
    messages, _, methods = parse_proto(
        fixture(os.path.join("wiredrift_pkg", "pb", "contracts.proto")))
    assert messages["DoThingResponse"] == {"ok", "detail", "code"}
    assert messages["DoThingRequest"] == {"volume_id", "collection"}
    assert methods["StreamThing"][0][2] is True
    assert messages["SlabThingRequest"] == {"volume_id", "projection", "projection_rows"}
    assert messages["ProjTerm"] == {"shard_id", "coeffs"}
    assert messages["GenThingRequest"] == {"volume_id", "large_block_size", "inline"}
    assert messages["GenThingResponse"] == {
        "shard_ids", "mode", "inline_rows", "delta_updates"}
    assert messages["BatchThingRequest"] == {"volume_ids", "fuse"}
    assert messages["BatchThingResponse"] == {
        "dispatch_groups", "signature_groups", "volumes_fused", "block_order"}


def test_parse_proto_reads_the_port_contracts_as_the_reference():
    from seaweedfs_tpu.analysis.wire_drift import parse_proto as ref_parse

    path = os.path.join(PORT, "pb", "contracts.proto")
    assert parse_proto(path) == ref_parse(path)


def test_obs_drift_fixture_fires():
    pkg = fixture("obsdrift_pkg")
    findings = run(paths=[os.path.join(pkg, "cluster", "server.py")], root=pkg)
    got = {(f.rule, os.path.basename(f.path), f.line) for f in findings}
    assert ("obs-metric-undeclared", "server.py", 9) in got, findings
    assert ("obs-span-undeclared", "server.py", 18) in got, findings
    assert any(
        f.rule == "obs-metric-unused" and "weedtpu_orphan_total" in f.message
        and f.path.endswith(os.path.join("stats", "__init__.py"))
        for f in findings
    ), findings
    assert any(f.rule == "obs-span-unused" and "stale.span" in f.message for f in findings)
    msgs = " | ".join(f.message for f in findings)
    for clean in ("weedtpu_good_total", "weedtpu_bound_seconds", "good.span",
                  "weedtpu_gf_native_symbol"):
        assert clean not in msgs
    assert {f.rule for f in findings if f.rule.startswith("obs-")} == {
        "obs-metric-undeclared", "obs-metric-unused", "obs-span-undeclared",
        "obs-span-unused"}


def test_obs_drift_real_tree_is_clean():
    findings = run()
    assert not [f for f in findings if f.rule.startswith("obs-")], [
        (f.path, f.line, f.message) for f in findings if f.rule.startswith("obs-")]


# -- suppression semantics ----------------------------------------------------


def test_suppression_with_reason_suppresses():
    opens = rules_at(run(paths=[fixture("suppressed.py")]), "suppressed.py")
    assert ("open-no-ctx", 6) not in opens
    assert ("open-no-ctx", 11) not in opens
    assert ("bad-suppression", 11) in opens
    assert ("bad-suppression", 16) in opens
    assert ("open-no-ctx", 16) in opens


def test_unused_suppression_flagged_in_strict_only():
    loose = run(paths=[fixture("suppressed.py")], strict=False)
    assert not [f for f in loose if f.rule == "unused-suppression"]
    strict = run(paths=[fixture("suppressed.py")], strict=True)
    unused = [f for f in strict if f.rule == "unused-suppression"]
    assert len(unused) == 1 and unused[0].line == 20, strict


def test_port_pragmas_all_give_a_reason():
    """Every pragma in the port names known rules, no `*`, and a reason;
    the scan covers the whole package, its scripts/ included."""
    ctxs, errors = load_files(
        [os.path.join(d, f) for d, _, fs in os.walk(PORT) if "__pycache__" not in d
         for f in fs if f.endswith(".py")])
    assert not errors
    rels = {c.rel for c in ctxs}
    assert "seaweedfs_tpu_torch/scripts/weedload.py" in rels
    pragmas = [(c.rel, s) for c in ctxs for s in c.suppressions
               if not c.rel.startswith("seaweedfs_tpu_torch/analysis/")]
    assert pragmas
    for rel, s in pragmas:
        assert s.reason and "*" not in s.rules and set(s.rules) <= set(RULES), (rel, s)


# -- the port's tree is clean (the gate) --------------------------------------


def test_weedlint_strict_clean_tree_in_process():
    t0 = time.monotonic()
    findings = run(strict=True)
    assert not findings, "\n".join(f.render() for f in findings)
    assert time.monotonic() - t0 < 30.0


def test_weedlint_strict_clean_tree_subprocess():
    """`python -m seaweedfs_tpu_torch.analysis --strict` exits 0 on the
    port within the 30 s budget."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.analysis", "--strict"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    wall = time.monotonic() - t0
    assert proc.returncode == 0, f"weedlint strict failed:\n{proc.stdout}\n{proc.stderr}"
    assert "0 finding(s)" in proc.stderr
    assert wall < 30.0, f"weedlint took {wall:.1f}s — over the 30 s budget"


def test_weedlint_changed_only_mode():
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.analysis", "--strict", "--changed-only"],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"


def test_weedlint_exits_nonzero_on_findings():
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.analysis", fixture("resource_bad.py")],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == 1
    assert "open-no-ctx" in proc.stdout


def test_list_rules_prints_the_catalog(capsys):
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule in out for rule in RULES)


def test_every_rule_documented():
    emitted = set()
    for name in os.listdir(FIXTURES):
        if name.endswith(".py"):
            emitted |= {f.rule for f in run(paths=[fixture(name)], strict=True)}
    assert emitted <= set(RULES)


# -- env registry -------------------------------------------------------------


def test_env_registry_types_and_clamps(monkeypatch):
    monkeypatch.delenv("WEEDTPU_PIPELINE_DEPTH", raising=False)
    assert config.env("WEEDTPU_PIPELINE_DEPTH") == 2
    monkeypatch.setenv("WEEDTPU_PIPELINE_DEPTH", "0")
    assert config.env("WEEDTPU_PIPELINE_DEPTH") == 1  # clamped
    monkeypatch.setenv("WEEDTPU_WIRE", "PROTO")
    assert config.env("WEEDTPU_WIRE") == "proto"
    monkeypatch.setenv("WEEDTPU_WIRE", "nonsense")
    assert config.env("WEEDTPU_WIRE") == "json"
    monkeypatch.setenv("WEEDTPU_COALESCE_READS", "no")
    assert config.env("WEEDTPU_COALESCE_READS") is False
    monkeypatch.setenv("WEEDTPU_COALESCE_READS", "yes")
    assert config.env("WEEDTPU_COALESCE_READS") is True
    with pytest.raises(KeyError):
        config.env("WEEDTPU_NOT_A_KNOB")


def test_analysis_knobs_are_the_reference_ones(monkeypatch):
    """The one analysis knob the port reads (the replay budget) parses as
    the reference's; the recorder switches, which no port code reads, are
    not registered."""
    assert not RECORDER_KNOBS & set(config.ENV_REGISTRY)
    for name in ("WEEDTPU_FSREPLAY_MAX_PREFIXES",):
        mine, ref = config.ENV_REGISTRY[name], ref_config.ENV_REGISTRY[name]
        assert (mine.type, mine.default) == (ref.type, ref.default), name
        for raw in (None, "", "0", "1", "yes", "7", "/tmp/x"):
            if raw is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, raw)
            try:
                want = ref_config.env(name)
            except ValueError:
                with pytest.raises(ValueError):
                    config.env(name)
                continue
            assert config.env(name) == want, (name, raw)


def test_setdefault_env_keeps_exported_values_and_refuses_unknown_knobs(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB", "off")
    # set first, so that the teardown removes what setdefault_env adds (a
    # delenv of an unset name records nothing to restore)
    monkeypatch.setenv("WEEDTPU_SCRUB_INTERVAL", "")
    monkeypatch.delenv("WEEDTPU_SCRUB_INTERVAL")
    config.setdefault_env({"WEEDTPU_SCRUB": "on", "WEEDTPU_SCRUB_INTERVAL": "0.5"})
    assert os.environ["WEEDTPU_SCRUB"] == "off"
    assert os.environ["WEEDTPU_SCRUB_INTERVAL"] == "0.5"
    monkeypatch.delenv("WEEDTPU_SCRUB_RATE_MB", raising=False)
    with pytest.raises(KeyError):
        config.setdefault_env({"WEEDTPU_SCRUB_RATE_MB": "0", "WEEDTPU_NOT_A_KNOB": "1"})
    assert "WEEDTPU_SCRUB_RATE_MB" not in os.environ  # nothing set before the refusal


def test_every_weedtpu_literal_in_package_is_registered():
    """Every WEEDTPU_* name in the port is registered, but for the two
    left-out knobs that the metric help texts name: those texts are the
    reference's, byte for byte, since the exposition is held equal."""
    where: dict[str, set] = {}
    for dirpath, dirnames, filenames in os.walk(PKG_ROOT):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build")]
        for fn in filenames:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path, encoding="utf-8") as f:
                    for name in re.findall(r"WEEDTPU_[A-Z][A-Z0-9_]*", f.read()):
                        where.setdefault(name, set()).add(os.path.relpath(path, PKG_ROOT))
    assert PKG_ROOT == PORT
    missing = {n: sorted(w) for n, w in where.items() if n not in config.ENV_REGISTRY}
    assert set(missing) <= LEFT_OUT_KNOBS, f"unregistered WEEDTPU_* names: {missing}"
    assert all(w == ["stats/__init__.py"] for w in missing.values()), missing


def test_readme_env_table_is_generated_and_current():
    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as f:
        text = f.read()
    begin, end = text.find(cli.ENV_TABLE_BEGIN), text.find(cli.ENV_TABLE_END)
    assert 0 <= begin < end, "the port's env-table markers are missing from README.md"
    table = config.env_table_markdown()
    assert text[begin + len(cli.ENV_TABLE_BEGIN): end] == "\n" + table, (
        "README's port env table is stale — run "
        "`python -m seaweedfs_tpu_torch.analysis --write-env-table`")
    for name in config.ENV_REGISTRY:
        assert f"`{name}`" in table
    # the port's table lies in the port's section, after the reference's
    ref_end = text.find("<!-- weedlint:env-table:end -->")
    assert text.find("## PyTorch/CUDA port") < begin and ref_end >= 0


def test_write_env_table_writes_only_the_port_markers(tmp_path):
    readme = tmp_path / "README.md"
    ref_block = ("<!-- weedlint:env-table:begin -->\n" + ref_config.env_table_markdown()
                 + "<!-- weedlint:env-table:end -->\n")
    readme.write_text("# x\n" + ref_block + "\n## port\n" + cli.ENV_TABLE_BEGIN
                      + "\nstale\n" + cli.ENV_TABLE_END + "\n")
    assert cli.main(["--write-env-table", str(readme)]) == 0
    text = readme.read_text()
    assert text.startswith("# x\n" + ref_block)
    assert (cli.ENV_TABLE_BEGIN + "\n" + config.env_table_markdown() + cli.ENV_TABLE_END
            in text)
    lone = tmp_path / "REF_ONLY.md"
    lone.write_text(ref_block)
    assert cli.main(["--write-env-table", str(lone)]) == 1
    assert lone.read_text() == ref_block


# -- dynamic lock-order recorder ----------------------------------------------


def _observed_pair(rec):
    # raw _thread locks: an instrumented session's recorder must not see
    # this test's deliberate orders
    return (lockrec._ObservedLock(_thread.allocate_lock(), "siteA", rec),
            lockrec._ObservedLock(_thread.allocate_lock(), "siteB", rec))


def test_recorder_detects_synthetic_deadlock():
    rec = lockrec.LockOrderRecorder()
    a, b = _observed_pair(rec)

    def order_ab():
        with a:
            with b:
                pass

    def order_ba():
        with b:
            with a:
                pass

    for fn in (order_ab, order_ba):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    assert rec.cycles() == [["siteA", "siteB"]], rec.edges()
    assert "CYCLE" in rec.report()


def test_recorder_acyclic_on_consistent_order():
    rec = lockrec.LockOrderRecorder()
    a, b = _observed_pair(rec)
    for _ in range(3):
        with a:
            with b:
                pass
    assert rec.cycles() == []
    assert rec.edges() == {("siteA", "siteB"): 3}


def test_recorder_reentrant_rlock_no_self_edge():
    rec = lockrec.LockOrderRecorder()
    r = lockrec._ObservedLock(threading.RLock(), "siteR", rec)
    with r:
        with r:
            pass
    assert rec.edges() == {}
    assert rec.cycles() == []


@pytest.mark.parametrize("factory", [threading.Lock, threading.RLock], ids=["Lock", "RLock"])
def test_recorder_condition_compat(factory):
    rec = lockrec.LockOrderRecorder()
    lock = lockrec._ObservedLock(factory(), f"site-{factory.__name__}", rec)
    cond = threading.Condition(lock)
    hits = []

    def waiter():
        with cond:
            while not hits:
                cond.wait(timeout=5.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        hits.append(1)
        cond.notify_all()
    t.join(timeout=5.0)
    assert not t.is_alive()


def test_observed_rlock_forwards_its_recursion_count():
    """Python 3.12's RLock has `_recursion_count`, which multiprocessing's
    resource tracker reads at exit: an observed RLock forwards it, and an
    observed Lock keeps raising AttributeError (the reference's wrapper
    raised for both)."""
    rec = lockrec.LockOrderRecorder()
    r = lockrec._ObservedLock(threading.RLock(), "siteR", rec)
    assert r._recursion_count() == 0
    with r:
        with r:
            assert r._recursion_count() == 2
    plain = lockrec._ObservedLock(threading.Lock(), "siteL", rec)
    with pytest.raises(AttributeError):
        plain._recursion_count()
    with pytest.raises(AttributeError):
        ref_lockrec._ObservedLock(threading.RLock(), "siteR", rec)._recursion_count()


def test_recorder_observes_real_degraded_read(tmp_path):
    """The port's recorder over the port's concurrent degraded reads on the
    CPU (an EcVolume given `Encoder(10, 4, device="cpu")`), in a fresh
    process that installs it before importing the port, as the card test
    does: the graph of the port's own locks is acyclic and not empty."""
    from test_torch_cuda import run_lock_probe

    out = run_lock_probe(tmp_path, "cpu")
    assert out["equal"] and not out["errors"], out
    assert out["launches"] == 0, out  # the plain version: no kernel
    assert out["edges"], out
    assert out["cycles"] == [], out


def test_two_recorders_see_the_same_sites():
    """The port's recorder installed over the reference's (as under the
    reference's instrumented session) wraps its factories; both record the
    same creation sites, and uninstalling restores the factories."""
    plain_lock = threading.Lock
    pre = ref_lockrec.active_recorder() is not None
    ref_rec = ref_lockrec.active_recorder() or ref_lockrec.LockOrderRecorder()
    if not pre:
        ref_lockrec.install(ref_rec)
    rec = lockrec.LockOrderRecorder()
    lockrec.install(rec)
    try:
        outer = threading.Lock()
        inner = threading.Lock()  # a site of its own: same-site locks order nothing
        with outer:
            with inner:
                pass
    finally:
        lockrec.uninstall()
        if not pre:
            ref_lockrec.uninstall()
    edge = next(iter(rec.edges()))
    assert all(__file__ in site for site in edge), edge
    assert edge in ref_rec.edges()
    if not pre:
        assert threading.Lock is plain_lock


def test_recorder_dump_roundtrip(tmp_path):
    rec = lockrec.LockOrderRecorder()
    rec.on_acquire("A")
    rec.on_acquire("B")
    rec.on_release("B")
    rec.on_release("A")
    out = tmp_path / "graph.json"
    rec.dump(str(out))
    payload = json.loads(out.read_text())
    assert payload["edges"] == [{"from": "A", "to": "B", "count": 1}]
    assert payload["cycles"] == []


def test_graph_cycle_detection():
    edges = graph_mod.edges_from_pairs([("a", "b"), ("b", "c"), ("c", "a"), ("c", "d")])
    assert graph_mod.cyclic_components(edges) == [["a", "b", "c"]]
    assert graph_mod.cyclic_components({"x": {"x"}}) == [["x"]]
    assert graph_mod.cyclic_components({"x": {"y"}}) == []


# -- durability family --------------------------------------------------------

DURABILITY_RULES = (
    "fsync-missing-before-rename",
    "record-before-fsync",
    "tmp-visible-name",
    "torn-tail-unhandled",
)


def test_durability_fixture_fires_each_rule_on_marked_line():
    findings = [f for f in run(paths=[fixture("durability_bad.py")])
                if f.rule in DURABILITY_RULES]
    with open(fixture("durability_bad.py"), encoding="utf-8") as f:
        lines = f.read().splitlines()
    expected = {(rule, i + 1) for i, line in enumerate(lines)
                for rule in DURABILITY_RULES if f"MARK {rule}" in line}
    assert len(expected) == len(DURABILITY_RULES)
    assert {(f.rule, f.line) for f in findings} == expected, findings


def test_durability_rules_in_catalog():
    for rule in DURABILITY_RULES:
        assert rule in RULES


# -- per-file parse cache -----------------------------------------------------


def test_parse_cache_reuses_context_and_invalidates(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import json\nx = 1\n")
    (a,), _ = load_files([str(p)])
    (b,), _ = load_files([str(p)])
    assert a is b
    p.write_text("import json\nxx = 22  # longer\n")
    (c,), _ = load_files([str(p)])
    assert c is not b


def test_parse_cache_resets_suppression_state():
    first = {(f.rule, f.line) for f in run(paths=[fixture("suppressed.py")], strict=True)}
    second = {(f.rule, f.line) for f in run(paths=[fixture("suppressed.py")], strict=True)}
    assert first == second


def test_parse_caches_are_each_package_own():
    from seaweedfs_tpu.analysis import _PARSE_CACHE as REF_CACHE
    from seaweedfs_tpu.analysis import load_files as ref_load
    from seaweedfs_tpu_torch.analysis import _PARSE_CACHE

    (mine,), _ = load_files([fixture("suppressed.py")])
    (theirs,), _ = ref_load([fixture("suppressed.py")])
    assert mine is not theirs and _PARSE_CACHE is not REF_CACHE
    assert type(mine).__module__ == "seaweedfs_tpu_torch.analysis"
