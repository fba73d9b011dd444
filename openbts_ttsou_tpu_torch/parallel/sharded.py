"""The sharded full-duplex pipeline: data parallel over channels,
sequence parallel over time.

Port of `openbts_ttsou_tpu/parallel/sharded.py`. It maps the reference's
process layout (SURVEY.md §2.2) onto a (chan, time) `Mesh`:

- the `chan` axis shards ARFCN carriers (each carrier is independent,
  like the per-ARFCN `ARFCNManager`s);
- the `time` axis shards the sample stream into blocks: the polyphase
  front end (K1 on a CUDA tensor) gets its overlap-save boundary samples
  from its neighbours by `exchange_halo` (the reference's
  INHISTORY/OUTHISTORY buffers, Transceiver/radioInterface.cpp:123-260);
- the burst clock is index math (block index → FN), checked by a sum of
  the shards' sample counts over the time axis (the IND CLOCK plane,
  Transceiver.cpp:726-739).

Each time shard advances its own copy of the adaptive engine state over
its frames from the step's common start state. With `carry_state=True`
(the default) the step ends with a merge over the time axis so every
shard starts the next step from the stream-end state:

- `energy_threshold`: the shard deltas are summed onto the common start
  value. That is exact against the serial engine while each shard's
  window is shorter than the 50-frame adaptation horizon
  (frames_per_shard ≤ 50);
- `prev_false_detect_fn`: the latest event wins (maximum of the
  window-relative fn);
- per-slot channel/DFE estimates: the shard with the newest
  `chan_estimate_fn` supplies the [C, 8] slot's state (an all-gather and
  the first maximum of `argmax`, so ties go to the first shard).

Within one step the shards evolve independently from the common start,
so a sharded step equals the serial chain only on frames the shard-local
state does not reach (interior frames of a stream whose adaptation the
step's start state already holds); the merge makes the step-boundary
trajectory track the serial stream.

The step functions take and return the JAX steps' global layouts for the
part of the grid this process holds: in one process the whole grid
(`state_sh` leaves [T, C_total, ...], samples [C_total, T·block_in],
results [F_total, C_total, 8, ...]), and under `torch.distributed` each
rank's rectangle of it (`distributed.host_local_shard`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from openbts_ttsou_tpu_torch.ops import fir
from openbts_ttsou_tpu_torch.parallel.halo import (exchange_halo,
                                                   resample_block,
                                                   resample_halo)
from openbts_ttsou_tpu_torch.parallel.mesh import Mesh, Shard
from openbts_ttsou_tpu_torch.trx import engine as eng
from openbts_ttsou_tpu_torch.utils.gsm_time import (FRAME_SYMBOLS,
                                                    HYPERFRAME, fn_delta)

#: taps of the 96/65 downlink resampler (radioInterface.cpp:130-133)
TX_TAPS = 651


class ShardedPipelineSpec(NamedTuple):
    """Static geometry of one sharded step."""

    n_chan_total: int
    frames_per_shard: int
    p: int = 65  # device rate → symbol rate (the 64M USRP 400 kS/s path)
    q: int = 96
    taps: int = 961

    @property
    def block_symbols(self) -> int:
        return self.frames_per_shard * FRAME_SYMBOLS

    @property
    def block_in(self) -> int:
        """Device-rate samples per time shard (multiple of q)."""
        assert (self.block_symbols * self.q) % self.p == 0, (
            "frames_per_shard·1250·q must divide p — use multiples of 13 "
            "frames (1250·96/65 = 24000/13)")
        return self.block_symbols * self.q // self.p

    @property
    def halo_in(self) -> int:
        return resample_halo(self.p, self.q, self.taps)


def state_for_shards(state: eng.TrxState, n_time_shards: int) -> eng.TrxState:
    """Replicate engine state across time shards: every leaf gains a
    leading [time_shards] axis."""
    return eng.TrxState(*(x.unsqueeze(0).expand((n_time_shards,) + x.shape)
                          .clone() for x in state))


def state_partition_specs() -> eng.TrxState:
    """The mesh axes of the leading dimensions of each leaf of the
    [time_shards]-stacked TrxState: the pipeline's state in/out contract
    (the JAX package's PartitionSpecs)."""
    specs = {f: ("time", "chan") for f in eng.TrxState._fields}
    specs["fn"] = ("time",)
    return eng.TrxState(**specs)


# ---- the rank's rectangle ↔ its shards --------------------------------------

def _box_offsets(mesh: Mesh, s: Shard) -> tuple[int, int]:
    """(chan, time) offset of a shard inside this process's rectangle."""
    return s.chan - mesh.box[0].start, s.time - mesh.box[1].start


def _split(mesh: Mesh, x: torch.Tensor, chan_dim: int, time_dim: int,
           c_local: int, t_len: int) -> dict[Shard, torch.Tensor]:
    """Cut the rectangle's tensor into each local shard's piece, on the
    shard's device: rows of `c_local` carriers along `chan_dim`, blocks
    of `t_len` along `time_dim` (None: not time-sharded)."""
    out = {}
    for s in mesh.local:
        dc, dt = _box_offsets(mesh, s)
        v = x.narrow(chan_dim, dc * c_local, c_local)
        if time_dim is not None:
            v = v.narrow(time_dim, dt * t_len, t_len)
        out[s] = v.to(s.device).contiguous()
    return out


def _join(mesh: Mesh, parts: dict[Shard, torch.Tensor], chan_dim,
          time_dim: int, device: torch.device) -> torch.Tensor:
    """The inverse of `_split`: concatenate the shards' pieces over the
    rectangle, on `device`. With `chan_dim` None the pieces are equal
    over the chan axis and the first row's are kept."""
    rows = [torch.cat([parts[mesh.at(c, t)].to(device) for t in mesh.box[1]],
                      time_dim)
            for c in (mesh.box[0] if chan_dim is not None
                      else mesh.box[0][:1])]
    return rows[0] if chan_dim is None else torch.cat(rows, chan_dim)


def _split_state(mesh: Mesh, state_sh: eng.TrxState, c_local: int
                 ) -> dict[Shard, eng.TrxState]:
    out = {}
    for s in mesh.local:
        dc, dt = _box_offsets(mesh, s)
        out[s] = eng.TrxState(*(
            (x[dt] if spec == ("time",) else
             x[dt, dc * c_local: (dc + 1) * c_local]).to(s.device).contiguous()
            for spec, x in zip(state_partition_specs(), state_sh)))
    return out


def _join_state(mesh: Mesh, states: dict[Shard, eng.TrxState],
                device: torch.device) -> eng.TrxState:
    return eng.TrxState(*(
        _join(mesh, {s: st[i].unsqueeze(0) for s, st in states.items()},
              None if spec == ("time",) else 1, 0, device)
        for i, spec in enumerate(state_partition_specs())))


def _join_result(mesh: Mesh, results: dict[Shard, eng.RxResult],
                 device: torch.device) -> eng.RxResult:
    return eng.RxResult(*(
        _join(mesh, {s: r[i] for s, r in results.items()}, 1, 0, device)
        for i in range(len(eng.RxResult._fields))))


def _fn_at(fn0, device: torch.device) -> torch.Tensor:
    """fn0 (an int or a 0-d tensor) as an int32 0-d tensor on `device`."""
    if isinstance(fn0, torch.Tensor):
        return fn0.to(device=device, dtype=torch.int32)
    return torch.full((), int(fn0), dtype=torch.int32, device=device)


# ---- the steps' shared legs -------------------------------------------------

def _halo(mesh: Mesh, x: dict[Shard, torch.Tensor], h: int,
          collectives: bool) -> dict[Shard, torch.Tensor]:
    if collectives:
        return exchange_halo(mesh, x, h, h, "time")
    # benchmark isolation only: zero halos, WRONG at shard edges
    return {s: torch.nn.functional.pad(v, (h, h)) for s, v in x.items()}


def _rx_shards(mesh: Mesh, cfg_local: eng.TrxConfig,
               spec: ShardedPipelineSpec, states0: dict, samples: dict,
               fn0, collectives: bool) -> tuple[dict, dict]:
    """Halo exchange, then `resample_block` (K1 on a CUDA tensor), then
    the exact receiver over each shard's frames from the common start
    state."""
    from openbts_ttsou_tpu_torch.models.transceiver import _exact_rx

    lpf = fir.resampler_lpf(spec.p, spec.q, spec.taps)
    x = _halo(mesh, samples, spec.halo_in, collectives)
    states, results = {}, {}
    for s in mesh.local:
        sym = resample_block(x[s], spec.p, spec.q, lpf, spec.halo_in,
                             spec.block_in)
        fn_start = _fn_at(fn0, s.device) + s.time * spec.frames_per_shard
        states[s], results[s] = _exact_rx(
            cfg_local, spec.frames_per_shard,
            states0[s]._replace(fn=fn_start), sym)
    return states, results


def _merge_time_shards(mesh: Mesh, state0: dict, state: dict, fn0,
                       frames_total: int) -> dict:
    """Fold the per-time-shard end states into the stream-end state (the
    reference's single Transceiver walks these fields serially,
    Transceiver.cpp:294-356; the module docstring gives the merge and
    its exactness window). `state0` is the common step-start state."""
    fns = {s: _fn_at(fn0, s.device) for s in mesh.local}
    # cumulative scalar adaptation: sum the shard deltas
    d_thr = mesh.all_reduce(
        {s: state[s].energy_threshold - state0[s].energy_threshold
         for s in mesh.local}, "time", "sum")
    # event clock: the latest false-detect/quiet event in the window
    rel_false = mesh.all_reduce(
        {s: fn_delta(state[s].prev_false_detect_fn, fns[s])
         for s in mesh.local}, "time", "max")
    # per-slot channel/DFE state: the shard holding the newest estimate
    # wins (estimate fns are disjoint across shards; stale entries are
    # equal in every shard, so ties are value ties)
    rels = mesh.all_gather({s: fn_delta(state[s].chan_estimate_fn, fns[s])
                            for s in mesh.local}, "time")  # [T, C, 8]
    winner = {s: rels[s].argmax(0) for s in mesh.local}
    won = {}
    for name in ("chan_valid", "chan_response", "chan_resp_offset",
                 "chan_amplitude", "snr", "dfe_forward", "dfe_feedback",
                 "chan_estimate_fn"):
        g = mesh.all_gather({s: getattr(state[s], name)
                             for s in mesh.local}, "time")  # [T, C, 8, ...]
        for s in mesh.local:
            idx = winner[s].reshape((1,) + winner[s].shape
                                    + (1,) * (g[s].ndim - 3))
            idx = idx.expand((1,) + g[s].shape[1:])
            won.setdefault(s, {})[name] = g[s].gather(0, idx)[0]
    return {s: state[s]._replace(
        fn=((fns[s] + frames_total) % HYPERFRAME).to(torch.int32),
        energy_threshold=state0[s].energy_threshold + d_thr[s],
        prev_false_detect_fn=((fns[s] + rel_false[s]) % HYPERFRAME
                              ).to(torch.int32),
        **won[s]) for s in mesh.local}


def _clock(mesh: Mesh, block_in: int, collectives: bool,
           device: torch.device) -> torch.Tensor:
    """The clock plane: the samples the time shards consumed, summed over
    the time axis."""
    if not collectives:
        return torch.full((), block_in * mesh.shape["time"],
                          dtype=torch.int32, device=device)
    got = mesh.all_reduce(
        {s: torch.full((), block_in, dtype=torch.int32, device=s.device)
         for s in mesh.local}, "time", "sum")
    return got[mesh.local[0]].to(device)


def _downlink_shards(mesh: Mesh, cfg_local: eng.TrxConfig,
                     spec: ShardedPipelineSpec, states0: dict, bits: dict,
                     valid: dict, atten: dict, collectives: bool) -> dict:
    """Each time shard's downlink leg: modulate its frames, then resample
    96/65 to device rate with symbol halos from its neighbours (the tx
    mirror of the rx overlap-save; the reference carries sendHistory on
    this path, Transceiver/radioInterface.cpp:123-186). One
    [C_local, block_in] a shard."""
    from openbts_ttsou_tpu_torch.models.transceiver import _assemble_stream

    sym = {s: _assemble_stream(eng.tx_frames(cfg_local, states0[s], bits[s],
                                             valid[s], atten[s]))
           for s in mesh.local}
    h = resample_halo(spec.q, spec.p, TX_TAPS)  # symbols a side (65)
    x = _halo(mesh, sym, h, collectives)
    lpf = fir.resampler_lpf(spec.q, spec.p, TX_TAPS)
    return {s: resample_block(x[s], spec.q, spec.p, lpf, h,
                              spec.block_symbols) for s in mesh.local}


def _local_geometry(mesh: Mesh, cfg: eng.TrxConfig,
                    spec: ShardedPipelineSpec) -> tuple[int, eng.TrxConfig]:
    n_chan_dev = mesh.shape["chan"]
    if spec.n_chan_total % n_chan_dev:
        raise ValueError(f"{spec.n_chan_total} carriers do not split over "
                         f"{n_chan_dev} chan shards")
    c_local = spec.n_chan_total // n_chan_dev
    return c_local, cfg._replace(n_chan=c_local)


# ---- the steps --------------------------------------------------------------

def sharded_uplink_pipeline(mesh: Mesh, cfg: eng.TrxConfig,
                            spec: ShardedPipelineSpec,
                            mode: str = "exact",
                            carry_state: bool = True,
                            collectives: bool = True,
                            xcch_tns: tuple | None = None,
                            tch_tns: tuple | None = None):
    """Build the sharded uplink step.

    Returns ``step(state_sh, samples, fn0) -> (state_sh, result, clock)``
    with, for this process's rectangle of the grid:
      samples:  [C, T·block_in] complex64 device-rate stream (the
                halo-free blocks of the time shards side by side);
      state_sh: TrxState with a leading [T] axis (`state_for_shards`);
      fn0:      first frame number of the step's stream window (int or
                0-d tensor);
      result:   RxResult stacked [T·F, C, 8, ...];
      clock:    [] int32, the samples consumed, summed over time.
    The outputs live on the samples' device.

    mode="decoded" adds the streaming FEC decode: the signature becomes
    ``step(state_sh, samples, fn0, prev_soft, prev_valid) -> (state_sh,
    result, clock, DecodedBlocks)`` with prev_soft
    [1, DECODE_PRELUDE, C, 8, 148] (the previous step's final soft-bit
    tail, ``res.soft_bits[-DECODE_PRELUDE:][None]``; zeros and
    prev_valid False on the first step). Shard t's prelude is shard
    t−1's tail, one hop along the time axis; shard 0's is prev_soft.
    """
    if mode not in ("exact", "decoded"):
        raise ValueError(f"unknown mode {mode!r}")
    c_local, cfg_local = _local_geometry(mesh, cfg, spec)
    n_time = mesh.shape["time"]
    frames = spec.frames_per_shard

    def step(state_sh: eng.TrxState, samples: torch.Tensor, fn0,
             prev_soft: torch.Tensor | None = None,
             prev_valid: torch.Tensor | None = None):
        device = samples.device
        states0 = _split_state(mesh, state_sh, c_local)
        pieces = _split(mesh, samples, 0, 1, c_local, spec.block_in)
        states, results = _rx_shards(mesh, cfg_local, spec, states0, pieces,
                                     fn0, collectives)
        if carry_state and collectives:
            states = _merge_time_shards(mesh, states0, states, fn0,
                                        n_time * frames)
        clock = _clock(mesh, spec.block_in, collectives, device)
        out = (_join_state(mesh, states, state_sh.fn.device),
               _join_result(mesh, results, device), clock)
        if mode != "decoded":
            return out
        from openbts_ttsou_tpu_torch.models.transceiver import (
            DECODE_PRELUDE, DecodedBlocks, decode_block)

        tails = {s: results[s].soft_bits[-DECODE_PRELUDE:]
                 for s in mesh.local}
        if collectives:
            shifted = mesh.shift(tails, "time", +1)
        else:
            shifted = {s: torch.zeros_like(v) for s, v in tails.items()}
        prev = _split(mesh, prev_soft[0], 1, None, c_local, 0)
        decs = {}
        for s in mesh.local:
            first = s.time == 0
            decs[s] = decode_block(
                results[s], _fn_at(fn0, s.device) + s.time * frames, frames,
                prev_soft=prev[s] if first else shifted[s],
                prev_valid=(prev_valid.to(s.device) if first else
                            torch.ones((), dtype=torch.bool,
                                       device=s.device)),
                xcch_tns=xcch_tns, tch_tns=tch_tns,
                rach_tns=cfg_local.rach_slots)
        per_time = ("first_fn", "tch_end_fn", "tch_valid")
        dec = DecodedBlocks(*(
            _join(mesh, {s: d[i].reshape(-1) for s, d in decs.items()},
                  None, 0, device).reshape(-1) if name in per_time
            else _join(mesh, {s: d[i] for s, d in decs.items()}, 1, 0,
                       device)
            for i, name in enumerate(DecodedBlocks._fields)))
        return out + (dec,)

    return step


def sharded_duplex_pipeline(mesh: Mesh, cfg: eng.TrxConfig,
                            spec: ShardedPipelineSpec,
                            mode: str = "exact",
                            carry_state: bool = True,
                            collectives: bool = True):
    """The full-duplex sharded step: `sharded_uplink_pipeline`'s uplink
    plus a time-sharded downlink leg, each time shard modulating its own
    frames and resampling them 96/65 to device rate with symbol halos
    from its neighbours (the tx overlap-save the reference's sendHistory
    carries between chunks, Transceiver/radioInterface.cpp:123-186).
    `mode` is "exact", the only mode of this step.

    Returns ``step(state_sh, ul_samples, dl_bits, dl_valid, dl_atten,
    fn0) -> (state_sh, rx_result, tx_samples, clock)`` with:
      ul_samples: [C, T·block_in];
      dl_bits:    [T·F, C, 8, 148], the tx window over the same frames as
                  the rx window; dl_valid, dl_atten: [T·F, C, 8];
      tx_samples: [C, T·block_in] device-rate downlink, equal to a serial
                  full-stream modulate and resample.
    """
    if mode != "exact":
        raise ValueError(f"the duplex step has no mode {mode!r}")
    c_local, cfg_local = _local_geometry(mesh, cfg, spec)
    n_time = mesh.shape["time"]
    frames = spec.frames_per_shard

    def step(state_sh: eng.TrxState, samples: torch.Tensor,
             dl_bits: torch.Tensor, dl_valid: torch.Tensor,
             dl_atten: torch.Tensor, fn0):
        device = samples.device
        states0 = _split_state(mesh, state_sh, c_local)
        bits, valid, atten = (_split(mesh, t, 1, 0, c_local, frames)
                              for t in (dl_bits, dl_valid, dl_atten))
        tx = _downlink_shards(mesh, cfg_local, spec, states0, bits, valid,
                              atten, collectives)
        pieces = _split(mesh, samples, 0, 1, c_local, spec.block_in)
        states, results = _rx_shards(mesh, cfg_local, spec, states0, pieces,
                                     fn0, collectives)
        if carry_state and collectives:
            states = _merge_time_shards(mesh, states0, states, fn0,
                                        n_time * frames)
        clock = _clock(mesh, spec.block_in, collectives, device)
        return (_join_state(mesh, states, state_sh.fn.device),
                _join_result(mesh, results, device),
                _join(mesh, tx, 0, 1, device), clock)

    return step
