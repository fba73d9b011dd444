"""The port's sharded pipelines across processes: `torch.distributed`
over gloo on the CPU (the counterpart of tests/test_distributed.py).

Two OS processes run `python -m openbts_ttsou_tpu_torch.parallel.worker`,
one a rank, joined by a `file://` rendezvous under tmp_path (so xdist
workers never share a port), with a (1 × 2·shards_per_rank) mesh: the
rx halo ring, the tx symbol ring and the state merge cross the process
boundary. Each rank checks its own shards against the port's serial
chain (detections exactly, tx within 2e-4 of the peak), the ranks sum
their mismatches, and each prints one JSON line.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(tmp_path, *args, world=2, timeout=240):
    rendezvous = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.parallel.worker",
         "--world-size", str(world), "--rank", str(r), "--init-method",
         rendezvous, "--device", "cpu", "--timeout", "120", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err[-3000:]}"
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


@pytest.mark.parametrize("shards_per_rank", [1, 2])
def test_two_rank_pipeline(tmp_path, shards_per_rank):
    results = run_ranks(tmp_path, "--shards-per-rank", str(shards_per_rank),
                        "--steps", "3")
    assert [r["process"] for r in results] == [0, 1]
    for r in results:
        assert r["n_processes"] == 2 and r["backend"] == "gloo"
        assert r["n_shards"] == 2 * shards_per_rank
        assert r["ok"], r
        assert r["mismatches"] == 0 and r["mismatches_all_ranks"] == 0
        assert r["local_hits"] > 0
        assert r["clock"] == 2 * shards_per_rank * 24000
        # 3 steps: 2 halo exchanges each; the merge's 3 all-reduces and
        # 9 all-gathers each
        assert r["traffic"]["permute"][0] == 6
        assert r["traffic"]["all-reduce"][0] == 9
        assert r["traffic"]["all-gather"][0] == 27


def test_two_rank_duplex_pipeline(tmp_path):
    """The full-duplex step across two processes: the tx symbol ring and
    the rx halos both cross the process boundary; each rank holds its tx
    to the serial `downlink_block` and its detections to the serial
    engine."""
    results = run_ranks(tmp_path, "--duplex", "--steps", "2")
    for r in results:
        assert r["duplex"] and r["ok"], r
        assert r["mismatches_all_ranks"] == 0
        assert r["tx_max_abs_diff"] == 0.0  # the overlap-save identity
        assert r["local_hits"] > 0
        assert r["traffic"]["permute"][0] == 8  # 4 exchanges a step


def test_worker_needs_every_rank(tmp_path):
    """A rank whose peer never arrives fails at its timeout instead of
    hanging."""
    out = subprocess.run(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.parallel.worker",
         "--world-size", "2", "--rank", "0", "--init-method",
         f"file://{tmp_path / 'alone'}", "--device", "cpu", "--timeout",
         "3"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
