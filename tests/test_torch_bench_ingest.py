"""The harness's ingest and conversion modes (`_measure_ingest`,
`_measure_convert` in `seaweedfs_tpu_torch/bench.py`) against the reference
bench's, on the CPU, at the reference smokes' sizes (`test_inline_ec.py`,
`test_convert.py`): the port on the plain version, the reference on its
numpy encoder, each side held to the reference smoke's assertions, then to
each other on the byte counts (rows, delta bytes and ratio, bytes read and
written, the oracle's measured total, moved over re-encode) and on the
sha256 of every shard each one wrote."""

import hashlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench as ref_bench  # noqa: E402  (the reference's top-level harness)

from seaweedfs_tpu.ec import stripe as ref_stripe  # noqa: E402
from seaweedfs_tpu.ops.rs_codec import Encoder as RefEncoder  # noqa: E402
from seaweedfs_tpu_torch import bench  # noqa: E402

FAMILIES = ("cauchy_12_3", "merge_20_4")


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def shard_shas(base: str, total: int) -> list[str]:
    return [sha256(ref_stripe.shard_file_name(base, s)) for s in range(total)]


def test_ingest_smoke_equals_the_reference(tmp_path):
    ref = ref_bench._measure_ingest(str(tmp_path / "ref"), **bench.SMOKE_INGEST,
                                    encoder=RefEncoder(10, 4, backend="numpy"))
    port = bench._measure_ingest(str(tmp_path / "port"), **bench.SMOKE_INGEST, device="cpu")
    for out in (ref, port):  # the reference smoke's assertions, on each side
        assert out["ok"], out
        assert out["match"] and out["delta"]["match"]
        assert out["inline"]["rows_inline"] == out["inline"]["rows_total"] > 0
        assert out["delta"]["bytes_ratio"] < 0.5, out["delta"]
        assert out["delta"]["overwrite_fraction"] <= 0.011
    for key in ("dat_mib", "large_block", "small_block", "match", "ok", "protocol"):
        assert port[key] == ref[key], key
    for key in ("polls_with_work", "rows_inline", "rows_total"):
        assert port["inline"][key] == ref["inline"][key], key
    for key in ("overwrites", "overwrite_fraction", "changed_bytes", "delta_bytes",
                "reencode_bytes", "bytes_ratio", "match"):
        assert port["delta"][key] == ref["delta"][key], key
    assert port["sha256"] == shard_shas(str(tmp_path / "ref" / "inline" / "5"), 14)
    assert port["delta"]["sha256"] == shard_shas(str(tmp_path / "ref" / "delta" / "5"), 14)
    assert (port["device"], port["backend"], port["launches"]) == ("cpu", "torch", {})


def test_convert_smoke_equals_the_reference(tmp_path):
    ref = ref_bench._measure_convert(str(tmp_path / "ref"), **bench.SMOKE_CONVERT,
                                     encoder=RefEncoder(10, 4, backend="numpy"))
    port = bench._measure_convert(str(tmp_path / "port"), **bench.SMOKE_CONVERT, device="cpu")
    for out in (ref, port):  # the reference smoke's assertions, on each side
        assert out["ok"], out
        for fam in FAMILIES:
            pair = out["pairs"][fam]
            assert pair["match"] is True
            assert pair["moved_over_reencode"] <= 0.5
            assert pair["oracle_total_measured"] == pair["oracle_total_bytes"]
    for key in ("section", "dat_mib", "large_block", "small_block", "src_family", "gate", "ok",
                "protocol"):
        assert port[key] == ref[key], key
    assert sorted(port["pairs"]) == sorted(ref["pairs"]) == sorted(FAMILIES)
    for fam in FAMILIES:
        mine, theirs = port["pairs"][fam], ref["pairs"][fam]
        for key in ("target_shards", "bytes_read", "bytes_written", "reconstructed_bytes",
                    "oracle_total_bytes", "oracle_total_measured", "moved_over_reencode",
                    "convert_io_over_reencode", "match", "ok"):
            assert mine[key] == theirs[key], (fam, key)
        # the staged set equals the reference's oracle set, file by file
        oracle = str(tmp_path / "ref" / f"oracle_{fam}" / "7")
        assert mine["staged_sha256"] == shard_shas(oracle, mine["target_shards"]), fam
    assert (port["device"], port["backend"], port["launches"]) == ("cpu", "torch", {})
