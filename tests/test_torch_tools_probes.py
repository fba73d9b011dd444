"""The port's measuring tools on the CPU at 2 carriers, and their parity
with the JAX package's `tools/`: each probe prints one JSON record with
its fields; the exact bake-off's schedules agree; the mesh's bytes are
`Mesh.traffic`'s; `iq_tool` and `sweep_generator` give the JAX tools'
arrays, hits and bit errors.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from openbts_ttsou_tpu_torch.tools import (dfe_cost_probe,
                                           encode_stage_probe, exact_bakeoff,
                                           iq_tool, kernel_bakeoff,
                                           scaling_bench, stage_bench,
                                           sweep_generator)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def jax_tool(name: str):
    """The JAX package's `tools/<name>.py`, loaded from the repo's root."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_stage_bench_on_cpu(capsys):
    rec = stage_bench.main(["--device", "cpu", "--carriers", "2",
                            "--reps", "1"])
    assert last_json(capsys) == rec
    assert list(rec["stages"]) == [
        "resample", "slot_windows", "energy_detect", "analyze_traffic",
        "detect_rach", "demodulate", "design_dfe", "equalize"]
    for row in rec["stages"].values():
        assert row["wall_ms"] > 0 and row["k1_launches"] == 0
        assert "device_ms" not in row  # the CPU has wall times only
    assert rec["bursts"] == 2 * 13 * 8 and rec["card"] is None


def test_dfe_cost_probe_keeps_the_dfe_on(capsys):
    rec = dfe_cost_probe.main(["--device", "cpu", "--carriers", "2",
                               "--reps", "1"])
    assert last_json(capsys) == rec
    (row,) = rec["rows"]
    assert row["use_dfe_every_frame"] is True
    assert row["schedule"] == "batched"
    assert row["tax_wall_ms_per_frame"] == pytest.approx(
        (row["on"]["wall_ms"] - row["off"]["wall_ms"]) / 13)


def test_dfe_cost_probe_guard_catches_loud_noise():
    """The guard: noise near the energy gate would clear chan_valid and
    measure the off path while claiming on."""
    from openbts_ttsou_tpu_torch.utils import constants as C

    thr = C.INITIAL_ENERGY_THRESHOLD
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C, "INITIAL_ENERGY_THRESHOLD", thr / 2)
        with pytest.raises(AssertionError, match="energy gate"):
            dfe_cost_probe.legs(2, 13, CPU)


def test_encode_stage_probe_on_cpu(capsys):
    rec = encode_stage_probe.main(["--device", "cpu", "--carriers", "2",
                                   "--reps", "1"])
    assert last_json(capsys) == rec
    assert set(rec["stages"]) == {
        "xcch_encode", "tch_tx_window", "encode_dl_window", "radio_tx",
        "uplink_exact_rx", "uplink_rx_plus_decode", "duplex_decoded_full"}
    assert all(r["wall_ms"] > 0 for r in rec["stages"].values())


def test_exact_bakeoff_schedules_agree(capsys):
    rec = exact_bakeoff.main(["--device", "cpu", "--carriers", "2,4",
                              "--reps", "1"])
    assert last_json(capsys) == rec
    assert rec["results_equal"] and [r["carriers"] for r in rec["rows"]] \
        == [2, 4]
    assert all(r["detections"] == r["carriers"] * 13 for r in rec["rows"])
    faster = [r["carriers"] for r in rec["rows"] if r["batched_faster"]]
    assert rec["recommended_batch_max_chan"] == max(faster, default=0)


def test_exact_bakeoff_catches_a_difference():
    from openbts_ttsou_tpu_torch.models import transceiver as T

    cfg, st, sym = exact_bakeoff.block(2, 13, CPU)
    a = T.process_block_exact(cfg, 13, st, sym)
    b = T.process_block_frames(cfg, 13, st, sym)
    exact_bakeoff.assert_same(a, b, 2)
    bad = b[1]._replace(timing=b[1].timing + 1)
    with pytest.raises(AssertionError, match="timing"):
        exact_bakeoff.assert_same(a, (b[0], bad), 2)


@pytest.mark.parametrize("max_delay", [0, 5])
def test_exact_bakeoff_holds_the_float_state(max_delay):
    """Both schedules end in float states within the benchmark's 1e-6
    (relative to each field's largest value, at least 1), with the DFE
    off and on (max delay 5: the gated estimate and the equalizer); a
    gap past that limit in any float field is caught."""
    from openbts_ttsou_tpu_torch.models import transceiver as T

    cfg, st, sym = exact_bakeoff.block(2, 13, CPU, max_delay)
    a = T.process_block_exact(cfg, 13, st, sym)
    b = T.process_block_frames(cfg, 13, st, sym)
    exact_bakeoff.assert_same(a, b, 2)
    assert bool(b[0].chan_valid.any()) == (max_delay > 1)
    for name in ("energy_threshold", "chan_response", "chan_resp_offset",
                 "chan_amplitude", "snr", "dfe_forward", "dfe_feedback"):
        x = getattr(b[0], name)
        step = 3e-6 * max(1.0, float(torch.view_as_real(x).abs().max())
                          if x.is_complex() else float(x.abs().max()))
        near = b[0]._replace(**{name: x + step / 6})
        exact_bakeoff.assert_same(a, (near, b[1]), 2)
        far = b[0]._replace(**{name: x + step})
        with pytest.raises(AssertionError, match=name):
            exact_bakeoff.assert_same(a, (far, b[1]), 2)


def test_scaling_bench_bytes_are_mesh_traffic(capsys):
    from openbts_ttsou_tpu_torch.parallel.sharded import (
        sharded_uplink_pipeline)

    rec = scaling_bench.main(["--device", "cpu", "--shards", "1,2,4",
                              "--chan-per-shard", "2", "--reps", "1"])
    assert last_json(capsys) == rec
    assert rec["note"] == "cost on the CPU, not scaling"
    for row in rec["rows"]:
        mesh, cfg, spec, st, x = scaling_bench.setup(row["shards"], 2, 13,
                                                     CPU)
        for way, kw in scaling_bench.WAYS.items():
            mesh.reset_traffic()
            sharded_uplink_pipeline(mesh, cfg, spec, **kw)(st, x, 0)
            assert row[way]["traffic"] == {
                k: list(v) for k, v in mesh.traffic.items()}
            assert row[way]["bytes_per_step"] == sum(
                b for _, b in mesh.traffic.values())
        assert row["no_collectives"]["bytes_per_step"] == 0
    assert rec["rows"][2]["mesh"] == {"chan": 2, "time": 2}
    assert rec["rows"][2]["full"]["traffic"]["permute"][1] > 0  # the halos


def test_kernel_bakeoff_on_cpu_times_the_plain_forms(capsys):
    rec = kernel_bakeoff.main(["--device", "cpu", "--rows", "1",
                               "--reps", "1"])
    assert last_json(capsys) == rec
    assert len(rec["shapes"]) == len(kernel_bakeoff.K1_SHAPES)
    for row in rec["shapes"]:
        assert row["ms"] is None and row["plain_wall_ms"] > 0


@pytest.mark.parametrize("rows,p,q,taps,t_in", kernel_bakeoff.K1_SHAPES)
def test_kernel_bakeoff_library_call_is_k1(rows, p, q, taps, t_in):
    """The yardstick convolution computes K1's function (on a few rows)."""
    from openbts_ttsou_tpu_torch.ops import cuda_fir, fir

    g = torch.Generator().manual_seed(p)
    x = torch.randn((2, t_in), dtype=torch.complex64, generator=g)
    lpf = fir.resampler_lpf(p, q, taps)
    planes = kernel_bakeoff.library_call(x, p, q, lpf)()  # [4, p, M]
    n_out = fir.polyphase_output_len(t_in, p, q)
    y = planes.transpose(1, 2).reshape(4, -1)[:, :n_out]
    want = cuda_fir.polyphase_resample_plain(x, p, q, lpf)
    got = torch.complex(y[:2], y[2:])
    torch.testing.assert_close(got, want, rtol=2e-4,
                               atol=2e-4 * float(want.abs().max()))
    ms, by = kernel_bakeoff.bound_ms(rows, t_in, p, q, lpf)
    assert by == "bytes" and ms == pytest.approx(
        rows * (t_in + n_out) * 8 / 3.35e12 * 1e3)


def test_iq_record_equals_jax(tmp_path):
    jax_iq = jax_tool("iq_tool")
    jax_iq.record(str(tmp_path / "jax.npz"), frames=26, n_chan=2, seed=7,
                  snr_db=5.0)
    iq_tool.record(tmp_path / "port.npz", np.random.default_rng(7),
                   frames=26, n_chan=2, snr_db=5.0)
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_iq_replay_equals_jax(tmp_path):
    """1 carrier × 26 frames at 5 dB, where bits do flip: the same hits
    and bit errors through the JAX and the port's rx_step."""
    path = tmp_path / "cap.npz"
    iq_tool.record(path, np.random.default_rng(0), 26, 1, 5.0)
    hits, n_truth, errors, bits = jax_tool("iq_tool").replay(str(path))
    got = iq_tool.replay(path, CPU)
    assert (got["hits"], got["planted"], got["bit_errors"], got["bits"]) \
        == (hits, n_truth, errors, bits)
    assert errors > 0 and hits == n_truth == 18


def test_make_sweep_equals_jax():
    want = jax_tool("sweep_generator").make_sweep(1625e3 / 6.0, -100e3,
                                                  100e3, 41, 1250)
    got = sweep_generator.make_sweep(1625e3 / 6.0, -100e3, 100e3, 41, 1250)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
