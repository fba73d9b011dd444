"""The port's last measuring tools on the CPU: `roofline` (the work of
each hot region counted from its shapes), `collective_inventory` (the
mesh's traffic a step) and `scaling_2proc` (one sharded program run by
one process and by two, over gloo), at small sizes.
"""

import ast
import json
from pathlib import Path

import pytest

from openbts_ttsou_tpu_torch.tools import (collective_inventory, common,
                                           roofline, scaling_2proc)

ROOT = Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"
HBM, FP32 = roofline.PEAKS[H100]


def jax_row_keys() -> set:
    """The keys of the JAX tool's rows (`tools/roofline.py`, read as
    source: the JAX tool imports jax at its top)."""
    tree = ast.parse((ROOT / "tools" / "roofline.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "carriers"
                for k in node.keys):
            keys |= {k.value for k in node.keys}
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "update" and node.args
                and isinstance(node.args[0], ast.Dict)):
            keys |= {k.value for k in node.args[0].keys}
    return keys


@pytest.mark.parametrize("rows,t_in,want_ms", [
    (512, 24000, 0.0492),  # the uplink block (PERF.md §6)
    (512, 24192, 0.0496),  # the duplex uplink with its two halos
])
def test_k1_bound_is_perf_mds(rows, t_in, want_ms):
    from openbts_ttsou_tpu_torch.ops import fir

    w = roofline.k1_work(rows, t_in, 65, 96, fir.resampler_lpf(65, 96, 961))
    ms, by = roofline.bound_ms(w, HBM, FP32)
    assert by == "bytes" and ms == pytest.approx(want_ms, abs=5e-5)
    # the taps' multiply-adds: 0.007 ms at 67 TFLOP/s
    assert w.flops / FP32 * 1e3 == pytest.approx(0.0074, abs=1e-4)


def test_counts_are_linear_in_carriers_and_bursts():
    """Each region's flops are proportional to its carriers (so to its
    bursts and codewords); its bytes too, but for the inputs a call
    reads whatever its width (K7's frame numbers)."""
    shared = {"K7": roofline.FRAMES * 4}
    one, three = roofline.regions(1), roofline.regions(3)
    assert [r["name"] for r in one] == [r["name"] for r in three]
    for a, b in zip(one, three):
        c = shared.get(a["name"], 0)
        assert b["work"].flops == pytest.approx(3 * a["work"].flops)
        assert b["work"].bytes - c == pytest.approx(3 * (a["work"].bytes - c))
    for k in (roofline.k2_work, roofline.k3_work, roofline.k4_work,
              roofline.k5_work, roofline.k6_work):
        assert k(53248) == roofline.Work(*(53248 * x for x in k(1)))
    regions = {r["name"]: r for r in roofline.regions(512)}
    assert regions["K2"]["shape"] == [53248, 157]  # stage_bench's call


def test_k8_counts_each_add_compare_select():
    """K8 = rows × (K + 24) steps × 16 states × 2 branches × (2 adds + a
    compare); the resident window's four kinds at 512 carriers."""
    rows = {r["name"]: r for r in roofline.regions(512)}
    for kind, (n_rows, steps) in {"xcch": (10240, 252), "rach": (53248, 42),
                                  "tch": (8192, 213),
                                  "facch": (8192, 252)}.items():
        r = rows[f"K8 {kind}"]
        k = steps - 24
        assert r["shape"] == [n_rows, 2 * k]
        assert r["work"].flops == n_rows * steps * 16 * 2 * 3
        assert r["work"].bytes == n_rows * (2 * k * 4 + k)
        assert r["calls_per_block"] == 0  # the resident window's, not the
        # uplink block's


def test_unknown_card_raises():
    with pytest.raises(ValueError, match="no peaks known"):
        roofline.peaks("NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="no peaks known"):
        roofline.peaks(None)
    assert roofline.peaks("any card", 1e12, 2e13) == (1e12, 2e13)
    with pytest.raises(ValueError, match="no peaks known"):
        roofline.main(["--device", "cpu", "--carriers", "1",
                       "--block-carriers", "1"])  # no card, no peaks


def test_roofline_record(tmp_path, capsys):
    """The CPU run: every region with its count, bound and wall time (no
    device time on the CPU); the block rows carry the JAX tool's keys and
    equal the sum of their regions; the JSON goes where --out says."""
    out = tmp_path / "roofline.json"
    rec = roofline.main(["--device", "cpu", "--carriers", "2",
                         "--block-carriers", "1,2", "--hbm-bytes-per-s",
                         str(HBM), "--fp32-flops", str(FP32),
                         "--out", str(out)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == rec
    assert json.loads(out.read_text())["rows"] == rec["rows"]
    names = [r["name"] for r in rec["regions"]]
    assert names == ["K1 65/96", "K1 96/65", "K2", "K3", "K4", "K5", "K6",
                     "K7", "K8 xcch", "K8 rach", "K8 tch", "K8 facch"]
    for r in rec["regions"]:
        assert r["bound_ms"] > 0 and r["wall_ms"] > 0
        assert r["ms"] is None and r["share"] is None  # no card
        assert {"flops", "bytes", "calls_per_block", "busy_ms",
                "launches"} <= set(r)
    for row in rec["rows"]:
        assert jax_row_keys() <= set(row)
        assert row["measured_ms_per_block"] is None and row["Msps"] is None
        assert row["wall_ms_per_block"] > 0
    row = rec["rows"][1]
    assert row["carriers"] == 2 and row["mode"] == "exact"
    flops = sum(r["flops"] * r["calls_per_block"] for r in rec["regions"])
    mb = sum(r["bytes"] * r["calls_per_block"] for r in rec["regions"])
    assert row["gflop_per_block"] * 1e9 == pytest.approx(flops)
    assert row["mb_per_block"] * 1e6 == pytest.approx(mb)
    assert row["arith_intensity_flop_per_byte"] == pytest.approx(flops / mb)
    assert rec["device"] == "cpu" and rec["card"] is None
    assert (rec["hbm_bytes_per_s"], rec["fp32_flops"]) == (HBM, FP32)


def test_jax_row_keys_are_read():
    assert jax_row_keys() >= {"carriers", "mode", "gflop_per_block",
                              "mb_per_block", "measured_ms_per_block",
                              "Msps", "pct_hbm_peak", "pct_f32_peak"}


@pytest.mark.parametrize("shards", [2, 8])
def test_collective_inventory_equals_dryrun(shards):
    from openbts_ttsou_tpu_torch.parallel import dryrun

    inv = collective_inventory.inventory(shards, "cpu")
    dry = dryrun.run(shards, "cpu")
    assert inv["uplink"] == dry["uplink_traffic"]
    assert inv["duplex"] == dry["duplex_traffic"]
    assert inv["mesh"] == dry["mesh"]
    assert inv["n_chan_total"] == dry["carriers"]
    assert inv["local_input_bytes_per_step"] \
        == dry["local_input_bytes_per_step"]
    assert inv["frames_per_step"] == 13 * inv["mesh"]["time"]


def test_scaling_2proc_two_ranks_equal_one(tmp_path):
    """Two gloo ranks of 1 shard each against one process of 2 shards, at
    2 carriers and 1 step: every frame's soft bits and every shard's tx
    equal, both runs verified against the serial chain."""
    out = tmp_path / "s.json"
    rec = scaling_2proc.main(["--device", "cpu", "--carriers", "2",
                              "--steps", "1", "--timeout", "240",
                              "--out", str(out)])
    d = rec["detail"]
    assert d["results_equal"] is True
    assert d["soft_differ"] == 0 and d["soft_compared"] == 26
    assert d["tx_differ"] == 0 and d["tx_compared"] == 2
    assert [w["n_processes"] for w in d["workers_2proc"]] == [2, 2]
    assert all(w["verified"] and w["backend"] == "gloo"
               for w in d["workers_1proc"] + d["workers_2proc"])
    assert json.loads(out.read_text())["detail"] == d
    # the JAX record's keys, written under build/tools/ by default
    jax = json.loads((ROOT / "SCALING_2PROC.json").read_text())
    assert set(jax) <= set(rec) and set(jax["detail"]) <= set(d)
    assert common.out_path(None, "scaling_2proc.json").parent \
        == common.OUT_DIR


def test_scaling_2proc_compare_finds_a_difference():
    one = [{"soft_digests": ["a", "b", "c", "d"], "tx_digests": ["x", "y"]}]
    two = [{"soft_digests": ["a", "b"], "tx_digests": ["x"]},
           {"soft_digests": ["c", "e"], "tx_digests": ["z"]}]
    d = scaling_2proc.compare(one, two, steps=1)
    assert (d["soft_differ"], d["tx_differ"]) == (1, 1)
