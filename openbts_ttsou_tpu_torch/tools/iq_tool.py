"""IQ capture record and replay.

* `record`: synthesize a GSM uplink capture at the symbol rate (a
  normal burst on slot 1 of two frames in three, noise at `--snr` dB)
  into an .npz with the planted truth: the golden-vector source for
  regression runs. Numpy only; the same seed, frames, carriers and SNR
  give the same arrays as the JAX package's `tools/iq_tool.py`.
* `replay`: run a capture through the port's `rx_step` on the device,
  frame by frame, and report the planted bursts detected and the bit
  errors of those detected.

    python -m openbts_ttsou_tpu_torch.tools.iq_tool record [--out P] \\
        [--frames 26] [--chans 1] [--snr 20] [--seed 0]
    python -m openbts_ttsou_tpu_torch.tools.iq_tool replay [P]

P defaults to build/tools/iq_capture.npz.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from openbts_ttsou_tpu_torch.tools import common

TOOL = "iq_tool"
DEFAULT_CAPTURE = "iq_capture.npz"


def record(path, rng: np.random.Generator, frames: int = 26,
           n_chan: int = 1, snr_db: float = 20.0) -> dict:
    """Write the capture to `path`, drawing every random number from
    `rng` in the JAX tool's order; returns what was written."""
    from openbts_ttsou_tpu_torch.ops import gmsk
    from openbts_ttsou_tpu_torch.utils import constants as C

    sym = np.zeros((n_chan, frames * 1250), np.complex64)
    truth = []
    for c in range(n_chan):
        for f in range(frames):
            if f % 3 == 2:
                continue  # idle frame
            bits = np.concatenate(
                [[0, 0, 0], rng.integers(0, 2, 57), [1],
                 C.TRAINING_SEQUENCE[0], [1], rng.integers(0, 2, 57),
                 [0, 0, 0]]).astype(np.uint8)
            wave = gmsk.modulate_burst_np(bits[None], 1)[0]
            off = f * 1250 + 157  # slot 1
            sym[c, off: off + 148] += wave * 9000.0
            truth.append((c, f, 1, bits))
        noise = 9000.0 ** 2 / 10 ** (snr_db / 10)
        sym[c] += (rng.normal(0, np.sqrt(noise / 2), sym.shape[1])
                   + 1j * rng.normal(0, np.sqrt(noise / 2), sym.shape[1])
                   ).astype(np.complex64)
    arrays = {"iq": sym,
              "truth_chan": np.asarray([t[0] for t in truth]),
              "truth_fn": np.asarray([t[1] for t in truth]),
              "truth_tn": np.asarray([t[2] for t in truth]),
              "truth_bits": np.stack([t[3] for t in truth])}
    np.savez(path, **arrays)
    return arrays


def replay(path, device: torch.device) -> dict:
    """Hits and bit errors of the capture through `rx_step` on `device`."""
    from openbts_ttsou_tpu_torch.models.transceiver import _slot_windows
    from openbts_ttsou_tpu_torch.trx.engine import (ChanType, TrxConfig,
                                                    init_state, rx_step)

    data = np.load(path)
    iq = data["iq"]
    n_chan, total = iq.shape
    frames = total // 1250
    cfg = TrxConfig(n_chan=n_chan)
    ct = torch.zeros((n_chan, 8), dtype=torch.int32)
    ct[:, 1] = ChanType.I
    state = init_state(cfg, device)._replace(chan_type=ct.to(device))
    wins = _slot_windows(torch.from_numpy(iq).to(device), frames)
    detected = {}
    for f in range(frames):
        state, res = rx_step(cfg, state, wins[f])
        det = res.detected[:, 1].cpu().numpy()
        soft = res.soft_bits[:, 1].cpu().numpy()
        for c in np.flatnonzero(det):
            detected[(int(c), f)] = soft[c]
    hits = errors = total_bits = 0
    for c, f, bits in zip(data["truth_chan"], data["truth_fn"],
                          data["truth_bits"]):
        soft = detected.get((int(c), int(f)))
        if soft is None:
            continue
        hits += 1
        errors += int(((soft > 0.5).astype(np.uint8) != bits).sum())
        total_bits += len(bits)
    return {"hits": hits, "planted": len(data["truth_fn"]),
            "bit_errors": errors, "bits": total_bits,
            "ber": errors / max(total_bits, 1)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = common.add_device(sub.add_parser("record"))
    r.add_argument("--out", default=None)
    r.add_argument("--frames", type=int, default=26)
    r.add_argument("--chans", type=int, default=1)
    r.add_argument("--snr", type=float, default=20.0)
    r.add_argument("--seed", type=int, default=0)
    p = common.add_device(sub.add_parser("replay"))
    p.add_argument("path", nargs="?", default=None)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    if args.cmd == "record":
        path = common.out_path(args.out, DEFAULT_CAPTURE)
        arrays = record(path, np.random.default_rng(args.seed), args.frames,
                        args.chans, args.snr)
        print(f"wrote {path}: {args.chans} chan x {args.frames} frames, "
              f"{len(arrays['truth_fn'])} bursts at {args.snr:.0f} dB")
        rec = {"tool": TOOL, "cmd": "record", "path": str(path),
               "carriers": args.chans, "frames": args.frames,
               "bursts": len(arrays["truth_fn"]), "snr_db": args.snr}
    else:
        path = args.path or common.OUT_DIR / DEFAULT_CAPTURE
        out = replay(path, dev)
        print(f"detected {out['hits']}/{out['planted']} bursts; "
              f"BER {out['bit_errors']}/{out['bits']} = {out['ber']:.5f}")
        rec = {"tool": TOOL, "cmd": "replay", "path": str(path), **out}
    return common.emit({**rec, **common.card(dev)})


if __name__ == "__main__":
    main()
