"""Entry adapter: the served path, `BlockTrxDaemon` behind OpenBTS's
three UDP planes (clock at the base port, control at base + 1 + 3i and
data at base + 2 + 3i for carrier i; Transceiver.cpp:42-44,
runTransceiver.cpp:68-74), with a BTS on the other end of localhost UDP.

The BTS is `BtsStub`, a copy of the port's `tools/daemon_soak.BtsStub`
on the port's native `UdpTransport` (a copy, so that edits to the tools
do not move the benchmark), which feeds each carrier its own content.
The radio is `ReplayBankRadio`, playing the traffic's periodic int16
uplink stream; the entry keeps a reference to the latest block written
to its DAC.

Set-up (`make_inputs`, since the radio's stream and the BTS's bursts
come from the seed): the daemon on the device, the control plane's
bring-up as the soak sends it (the configuration's `bring_up` verbs on
every carrier, then POWERON), and steps of the closed loop until the
clock lead has settled, the pipeline is full and the next call retires
a block of pool index 0.

One call is one turn of the loop: the stub follows the clock plane and
feeds one block of downlink bursts from its cursor, the daemon steps
once (dispatches block N, retires block N − depth: its DAC write and its
uplink datagrams), and the stub drains the datagrams the retire sent. A
call's outputs are those of the block it retires, dispatched `depth`
calls earlier: the datagrams the stub received and the DAC rows the
radio was given, tagged with the block's pool index and frame numbers.
`state()` is the daemon's carried state as of that block (the engine
state and the downlink's tail; a ring of depth + 1 references, no
copies), so the harness's states before and after a call pair with the
block its outputs belong to. The harness's pool item of a call is the
retired block's (checked).

Known answer, every call: each loaded uplink slot of every carrier in
every frame of the retired block arrives as exactly one datagram, and no
downlink burst was late (`underruns`) or dumped as stale in the call.
Reference (`trxbench/reference/wire.py`), for each sampled call: the
retired block's uplink window through the frozen receiver from the
state the daemon carried before it, with the fields the bring-up sets
(slot combinations, TSC, max delay, filler table) as the configuration
states them, serialized as the uplink datagrams; its downlink, rebuilt
from its tx frame number, through the frozen transmitter behind the
carried tail into DAC rows. Compared: `datagram_diffs` ((carrier, FN,
TN) where a datagram is on one side only, or twice, or differs in any
byte but the soft bits), `soft_byte_gap` (the widest soft-byte gap on
datagrams both sides sent), `tx_gap` (the widest DAC gap, LSB) and
`state_gap` (the carried state, as in the bank cells, the tail
included).
"""

from __future__ import annotations

import collections
import contextlib
import os
import random
import resource
import socket
import time
from typing import Iterator

import numpy as np
import torch

from trxbench import gaps
from trxbench.generators import wire as gen
from trxbench.reference import rx as ref
from trxbench.reference import tx as reftx
from trxbench.reference import wire as refwire

#: UDP ports the daemon and the stub may take: below the kernel's
#: ephemeral range and the ports the repository's tests and tools use
PORT_LO, PORT_HI = 12000, 24000
#: descriptors kept free beside the sockets (files, pipes, CUDA's own)
FD_SPARE = 64
DOWNLINK_LEN = 1 + 4 + 1 + 148
#: steps of the closed loop after the bring-up before giving up on the
#: clock lead settling
WARM_LIMIT = 200


# ---- the BTS side --------------------------------------------------------

class BtsStub:
    """The BTS side of the wire: n carriers' control and data sockets and
    the clock socket, bound `offset` above the daemon's ports. A copy of
    `tools/daemon_soak.BtsStub`, whose `feed` sends each carrier its own
    pre-built datagrams (`packets` [frames, C, 8, 154], keyed by frame
    number modulo its frames) with the same batch call."""

    def __init__(self, n: int, base: int, offset: int, packets: np.ndarray):
        from openbts_ttsou_tpu_torch.runtime import UdpTransport

        peer = base + offset
        self.n = n
        self.packets = packets
        self.clock = UdpTransport(peer, "127.0.0.1", base)
        self.ctrl = [UdpTransport(peer + 3 * i + 1, "127.0.0.1",
                                  base + 3 * i + 1) for i in range(n)]
        self.data = [UdpTransport(peer + 3 * i + 2, "127.0.0.1",
                                  base + 3 * i + 2) for i in range(n)]
        self.cursor: int | None = None  # next frame to feed
        self.fed = 0  # downlink datagrams sent
        self.received = 0  # uplink datagrams drained
        self.skipped = 0  # frames a beacon moved the cursor past, unfed

    def on_beacon(self, fn: int) -> None:
        """Follow IND CLOCK: move the feed cursor forward to a beacon
        ahead of it (modulo the hyperframe), never back."""
        if self.cursor is None:
            self.cursor = fn
            return
        ahead = (fn - self.cursor) % ref.HYPERFRAME
        if 0 < ahead < ref.HYPERFRAME // 2:
            self.skipped += ahead
            self.cursor = fn

    def follow_clock(self) -> None:
        while (d := self.clock.recv(64, timeout_ms=0)) is not None:
            parts = d.rstrip(b"\x00").split()
            if parts[:2] == [b"IND", b"CLOCK"]:
                self.on_beacon(int(parts[2]))

    def feed(self, frames: int) -> None:
        """Send every carrier its `frames` frames from the cursor."""
        if self.cursor is None:
            return
        fns = (self.cursor + np.arange(frames)) % ref.HYPERFRAME
        body = self.packets[fns % self.packets.shape[0]]  # [F, C, 8, 154]
        body[..., 1:5] = fns.astype(">u4")[:, None].view(np.uint8)[
            :, None, None, :]
        body = np.ascontiguousarray(body.transpose(1, 0, 2, 3))
        for i in range(self.n):
            self.data[i].send_batch(body[i].reshape(-1, DOWNLINK_LEN))
        self.fed += body.shape[1] * body.shape[2] * self.n
        self.cursor = int((self.cursor + frames) % ref.HYPERFRAME)

    def drain(self) -> tuple[np.ndarray, np.ndarray]:
        """The uplink datagrams queued on every carrier's data socket:
        (carriers [n], datagrams [n, 158])."""
        rows, chans = [], []
        for i in range(self.n):
            pkts = self.data[i].drain_fixed(refwire.UPLINK_LEN, 4096)
            if len(pkts):
                rows.append(pkts)
                chans.append(np.full(len(pkts), i, np.int64))
        got = (np.concatenate(chans) if chans else np.zeros(0, np.int64),
               np.concatenate(rows) if rows
               else np.zeros((0, refwire.UPLINK_LEN), np.uint8))
        self.received += len(got[0])
        return got

    def close(self) -> None:
        for s in (self.clock, *self.ctrl, *self.data):
            s.close()


def free_base(n: int, offset: int, tries: int = 64) -> int:
    """A daemon base port whose daemon ports (base, base + 1 + 3i,
    base + 2 + 3i) and stub ports (the same, `offset` above) are all free
    now: each bound once by a plain socket (without SO_REUSEADDR, so a
    port another process holds refuses it) and released."""
    ports = [0] + [3 * i + k for i in range(n) for k in (1, 2)]
    span = offset + ports[-1] + 1
    rng = random.Random(os.getpid() ^ time.perf_counter_ns())
    for _ in range(tries):
        base = rng.randrange(PORT_LO, PORT_HI - span)
        held = []
        try:
            for p in ports:
                for b in (base, base + offset):
                    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                    held.append(s)
                    s.bind(("", b + p))
        except OSError:
            continue
        finally:
            for s in held:
                s.close()
        return base
    raise OSError(f"no free range of {span} UDP ports in "
                  f"{PORT_LO}-{PORT_HI} after {tries} tries")


def raise_nofile(sockets: int) -> None:
    """Raise the soft RLIMIT_NOFILE as far as the hard limit allows, as
    `tools/daemon_soak._check_descriptors` does; raises where the hard
    limit cannot hold `sockets` more descriptors."""
    largest = max(int(fd) for fd in os.listdir("/proc/self/fd"))
    want = largest + 1 + sockets + FD_SPARE
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if hard != resource.RLIM_INFINITY and want > hard:
        raise ValueError(f"{sockets} sockets beside descriptor {largest}: "
                         f"more than the hard RLIMIT_NOFILE ({hard})")
    if soft != resource.RLIM_INFINITY and soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE, (
            hard if hard != resource.RLIM_INFINITY else want, hard))


# ---- the entry -----------------------------------------------------------

class Entry:
    """`BlockTrxDaemon` and its BTS over localhost UDP behind the
    harness's calls."""

    def __init__(self, config: dict, device: torch.device):
        self.config = config
        self.device = device
        self.n_chan = int(config["carriers"])
        self.frames = int(config["frames"])
        self.depth = int(config["depth"])
        self.block_in = gen.block_in(self.frames)
        self.samples_per_call = self.n_chan * self.block_in
        self.daemon = self.stub = None
        raise_nofile(2 * (2 * self.n_chan + 1))
        # the carried state and the dispatched blocks, newest last
        self._states: collections.deque = collections.deque(
            maxlen=self.depth + 1)
        self._blocks: collections.deque = collections.deque(
            maxlen=self.depth + 1)
        self._dac = None
        self.warm_steps = 0
        self._calls = 0
        self._stub_s = 0.0
        self._stale0 = self._late0 = 0
        self._fed0 = self._received0 = 0

    # ---- set-up ----------------------------------------------------------
    def make_inputs(self, generator, params: dict, seed: int) -> list:
        from openbts_ttsou_tpu_torch.trx.daemon import (BlockTrxDaemon,
                                                        TrxDaemonConfig)
        from openbts_ttsou_tpu_torch.trx.radio import ReplayBankRadio

        pool = generator.make(params, self.config, seed, self.device)
        items, expect = pool["items"], pool["expect"]
        self.pool_len = len(items)
        self.dl_bits = expect["dl_bits"]
        self.ul_slots = list(expect["ul_slots"])
        self.per_block = int(expect["per_block"])
        packets = np.zeros(tuple(self.dl_bits.shape[:3]) + (DOWNLINK_LEN,),
                           np.uint8)
        packets[..., 0] = np.arange(8, dtype=np.uint8)
        packets[..., 6:] = self.dl_bits.cpu().numpy()

        radio = ReplayBankRadio(expect["stream"])
        write_bank = radio.write_bank

        def keep(iq, ts):  # the latest DAC block, by reference
            self._dac = (ts, iq)
            return write_bank(iq, ts)

        radio.write_bank = keep
        n, c = self.n_chan, self.config
        offset = 3 * n + 3  # the stub's ports lie above every daemon port
        base = free_base(n, offset)
        self.daemon = BlockTrxDaemon(
            radio, TrxDaemonConfig(
                base_port=base, peer_port_offset=offset, n_arfcn=n,
                tx_latency_frames=int(c["tx_latency_frames"]),
                max_toa=c.get("max_toa"),
                rach_slots=None if c.get("rach_slots") is None
                else tuple(c["rach_slots"]),
                device=str(self.device)),
            block_frames=self.frames, pipeline_depth=self.depth,
            compact=bool(c["compact"]))
        self.stub = BtsStub(n, base, offset, packets)
        self._bring_up()
        self._warm()
        return items

    def _bring_up(self) -> None:
        """The control plane's bring-up, every carrier acknowledged."""
        stub, daemon = self.stub, self.daemon
        verbs = [tuple(v) for v in self.config["bring_up"]]
        for i in range(self.n_chan):
            for verb, *args in verbs:
                stub.ctrl[i].send(_command(verb, *args))
        self._step()  # services every queued command
        for i in range(self.n_chan):
            stub.ctrl[i].send(_command("POWERON"))
        self._step()  # powers on and dispatches block 0
        want = [v[0] for v in verbs] + ["POWERON"]
        for i in range(self.n_chan):
            got = []
            end = time.monotonic() + 10.0
            while len(got) < len(want) and time.monotonic() < end:
                msg = stub.ctrl[i].recv(128, timeout_ms=100)
                if msg:
                    got.append(msg.rstrip(b"\x00").decode().split()[:3])
            if got != [["RSP", v, "0"] for v in want]:
                raise RuntimeError(f"bring-up of carrier {i}: {got}")
        if not daemon.on:
            raise RuntimeError("bring-up failed: the daemon is off")

    def _turn(self) -> dict:
        """One turn of the loop: the stub's clock and feed, one daemon
        step, the stub's drain."""
        stub, daemon = self.stub, self.daemon
        stale, late, skipped = (daemon.stale_dumped, daemon.underruns,
                                stub.skipped)
        t0 = time.perf_counter()
        stub.follow_clock()
        stub.feed(self.frames)
        t1 = time.perf_counter()
        self._dac = None
        self._step()
        t2 = time.perf_counter()
        got = stub.drain()
        self._stub_s += (t1 - t0) + (time.perf_counter() - t2)
        return {"ul": got, "dac": self._dac,
                "stale": daemon.stale_dumped - stale,
                "late": daemon.underruns - late,
                "skipped": stub.skipped - skipped}

    def _step(self) -> None:
        """One daemon step; where it dispatches a block, its frame numbers
        and the state it leaves join the rings."""
        d = self.daemon
        block, fn0, tx_fn0 = d._rx_block, d.fn, d.tx_fn
        d.step()
        if d._rx_block != block:
            self._blocks.append({"block": block, "fn0": fn0,
                                 "tx_fn0": tx_fn0})
            self._states.append({"state": d.state, "tx_tail": d._tx_tail})

    def _warm(self) -> None:
        """Turns until the pipeline is full, `depth` + 3 turns in a row
        saw no late, stale or skipped burst (every window the compared
        blocks and their tails are built from was fed whole), the stub's
        cursor leads the daemon's transmit frame by the clock lead (so no
        beacon can move it again, and skip frames, unless a burst comes
        late), and the next turn retires a block of pool index 0.

        The daemon's 26-frame step outruns its initial clock lead of 20
        frames: the first blocks feed late until the lead has grown to
        the block, and the stub then feeds each block just before the
        step that sends it, until the first periodic beacon moves its
        cursor a block ahead, past one block's frames."""
        quiet = 0
        for k in range(WARM_LIMIT):
            t = self._turn()
            quiet = quiet + 1 if not (t["stale"] or t["late"]
                                      or t["skipped"]) else 0
            d, s = self.daemon, self.stub
            lead = (s.cursor - d.tx_fn) % ref.HYPERFRAME
            full = len(self._blocks) == self.depth + 1
            nxt = self._blocks[1]["block"] if full else -1
            if full and quiet >= self.depth + 3 and lead >= d.clock_lead \
                    and nxt % self.pool_len == 0:
                self.warm_steps = k + 1
                self._stale0, self._late0 = d.stale_dumped, d.underruns
                self._fed0, self._received0 = s.fed, s.received
                self._stub_s = 0.0
                return
        raise RuntimeError(f"the clock lead did not settle in "
                           f"{WARM_LIMIT} steps")

    # ---- the call ----------------------------------------------------------
    def state(self) -> dict:
        return self._states[0]

    def call(self, item: dict) -> dict:
        t = self._turn()
        self._calls += 1
        t["retired"] = self._blocks[0]
        if t["retired"]["block"] % self.pool_len != item["index"]:
            raise RuntimeError(f"call of pool item {item['index']} retired "
                               f"block {t['retired']['block']}")
        return t

    def to_host(self, out: dict) -> dict:
        r = out["retired"]
        if out["dac"] is None:
            raise RuntimeError(f"block {r['block']}: no DAC write")
        ts, tx = out["dac"]
        if ts != r["block"] * self.block_in - reftx.TX_DELAY_DEV:
            raise RuntimeError(f"block {r['block']}: DAC written at {ts}")
        carriers, datagrams = out["ul"]
        return {"block": r["block"], "item": r["block"] % self.pool_len,
                "fn0": r["fn0"], "tx_fn0": r["tx_fn0"],
                "carrier": carriers, "datagrams": datagrams, "tx": tx,
                "stale": out["stale"], "late": out["late"]}

    def known_misses(self, host: dict, item: int) -> int:
        """Loaded uplink slots of the retired block that arrived as no
        datagram or as more than one, and the downlink bursts late or
        dumped as stale in the call."""
        f, c = self.frames, self.n_chan
        d = host["datagrams"]
        fns = d[:, 1:5].copy().view(">u4").ravel().astype(np.int64)
        rel = (fns - host["fn0"]) % ref.HYPERFRAME
        inside = rel < f
        keys = (host["carrier"][inside] * f + rel[inside]) * 8 \
            + d[inside, 0].astype(np.int64)
        counts = np.bincount(keys, minlength=c * f * 8).reshape(c, f, 8)
        loaded = counts[:, :, self.ul_slots]
        return int((loaded != 1).sum()) + host["stale"] + host["late"]

    def describe(self) -> dict:
        d, s = self.daemon, self.stub
        calls = max(self._calls, 1)
        blocks = max(d._rx_block - len(d._pending), 1)  # retired
        return {"stub_ms_per_call": self._stub_s * 1e3 / calls,
                "downlink_datagrams_per_call": (s.fed - self._fed0) / calls,
                "uplink_datagrams_per_call":
                    (s.received - self._received0) / calls,
                "expected_uplink_per_call": self.per_block,
                "d2h_bytes_per_block": d.d2h_bytes / blocks,
                "d2h_bytes_per_block_dense": d.d2h_bytes_dense / blocks,
                "underruns_per_call": (d.underruns - self._late0) / calls,
                "stale_dumped_per_call":
                    (d.stale_dumped - self._stale0) / calls,
                "clock_lead": d.clock_lead, "warm_steps": self.warm_steps,
                "base_port": d.cfg.base_port}

    # ---- the comparison ----------------------------------------------------
    def _ref_config(self) -> ref.TrxConfig:
        rach = self.config.get("rach_slots")
        return ref.TrxConfig(n_chan=self.n_chan,
                             max_toa=self.config.get("max_toa"),
                             rach_slots=None if rach is None
                             else tuple(rach))

    def reference_state(self, carried) -> ref.TrxState:
        """The carried engine state with the fields the bring-up sets as
        the configuration states them."""
        c = self.config
        own = ref.configured_state(self._ref_config(), c["slots"],
                                   int(c["tsc"]), int(c["max_delay"]),
                                   self.device)
        st = ref.TrxState(*gaps.moved(tuple(carried), self.device))
        return st._replace(chan_type=own.chan_type, tsc=own.tsc,
                           max_expected_delay=own.max_expected_delay,
                           filler=own.filler)

    def reference(self, state_before: dict, item: dict, first: bool
                  ) -> tuple[dict, dict]:
        """The reference's (carried state after, outputs) for the call
        that retires a block of pool item `item`, from the state the
        daemon carried before it (`first` changes nothing: the bring-up
        and the warm blocks precede every compared block)."""
        del first
        st = self.reference_state(state_before["state"])
        fn0 = int(st.fn)
        tx_fn0 = (fn0 + int(self.config["tx_latency_frames"])) \
            % ref.HYPERFRAME
        st2, carriers, datagrams = refwire.uplink(
            self._ref_config(), st, item["ul"], self.frames)
        frames = (tx_fn0 + torch.arange(self.frames, device=self.device)) \
            % self.dl_bits.shape[0]
        tx, tail = refwire.downlink(
            self.dl_bits[frames], st.filler,
            state_before["tx_tail"].to(self.device), self.block_in)
        return ({"state": st2, "tx_tail": tail},
                {"item": item["index"], "fn0": fn0, "tx_fn0": tx_fn0,
                 "carrier": carriers, "datagrams": datagrams, "tx": tx})

    def gaps_of(self, out: dict, after: dict, ref_after: dict,
                ref_out: dict) -> dict:
        """The numbers compared for one call (see the module docstring)."""
        diffs, soft = datagram_gaps(out, ref_out)
        tx = np.abs(out["tx"].astype(np.int32)
                    - ref_out["tx"].astype(np.int32))
        r_dev = ref_after["tx_tail"].device
        state = gaps.state_gap(
            list(zip(ref.TrxState._fields, after["state"],
                     ref_after["state"]))
            + [("tx_tail", after["tx_tail"].to(r_dev),
                ref_after["tx_tail"])])
        return {"datagram_diffs": diffs, "soft_byte_gap": soft,
                "tx_gap": int(tx.max()) if tx.size else 0,
                "state_gap": state}

    def compare(self, kept: list, pool: list) -> dict:
        worst: dict = {}
        for k in kept:
            if k["out"]["item"] != k["item"]:
                raise ValueError(f"call of pool item {k['item']} kept "
                                 f"block of item {k['out']['item']}")
            ref_after, ref_out = self.reference(k["state_before"],
                                                pool[k["item"]], k["first"])
            g = self.gaps_of(k["out"], k["state_after"], ref_after, ref_out)
            for name, v in g.items():
                worst[name] = max(worst.get(name, 0.0), float(v))
            del ref_after, ref_out
        return worst

    def release(self) -> None:
        """Close the daemon's and the stub's sockets; drop the program's
        objects."""
        for o in (self.daemon, self.stub):
            if o is not None:
                o.close()
        self.daemon = self.stub = None
        self._states.clear()


def _command(verb: str, *args) -> bytes:
    """A control-plane command (driveControl's `CMD <verb> [args]`)."""
    return " ".join(["CMD", verb, *map(str, args)]).encode() + b"\x00"


def datagram_gaps(a: dict, b: dict) -> tuple[int, int]:
    """(datagram diffs, soft-byte gap) between two sides' datagrams of
    one block: keys (carrier, FN, TN) on one side only or more than once
    on either, or whose bytes but the soft bits differ; the widest soft
    byte gap on keys each side sent once."""
    def keyed(side):
        d = side["datagrams"]
        fn = d[:, 1:5].copy().view(">u4").ravel().astype(np.int64)
        keys = (side["carrier"].astype(np.int64) * ref.HYPERFRAME + fn) \
            * 8 + d[:, 0].astype(np.int64)
        u, first, count = np.unique(keys, return_index=True,
                                    return_counts=True)
        return u, d[first], count

    ka, da, ca = keyed(a)
    kb, db, cb = keyed(b)
    both, ia, ib = np.intersect1d(ka, kb, assume_unique=True,
                                  return_indices=True)
    once = (ca[ia] == 1) & (cb[ib] == 1)
    head = np.r_[0:8, 156:refwire.UPLINK_LEN]
    differ = (da[ia][:, head] != db[ib][:, head]).any(1)
    diffs = (len(ka) - len(both)) + (len(kb) - len(both)) \
        + int((~once | differ).sum())
    sa = da[ia][once][:, 8:156].astype(np.int32)
    sb = db[ib][once][:, 8:156].astype(np.int32)
    soft = int(np.abs(sa - sb).max()) if sa.size else 0
    return diffs, soft


# ---- faults planted in the timed path, for the check of the comparison ----

FAULTS = ("stale_state", "half_batch", "altered_answer", "dropped_carrier")


class _Nowhere:
    """A data socket that sends nothing."""

    @staticmethod
    def send_batch(pkts) -> int:
        return len(pkts)


@contextlib.contextmanager
def fault(name: str) -> Iterator[None]:
    """Break the served path while the run goes: `stale_state` returns
    the engine state and the tail the block was given
    (`duplex_block_compact`); `half_batch` has the retire send nothing
    for the upper half of the carriers; `altered_answer` alters one soft
    byte and the RSSI byte of the block's first datagram on the device;
    `dropped_carrier` has the retire send carrier 0's datagrams nowhere."""
    from openbts_ttsou_tpu_torch.models import transceiver as T
    from openbts_ttsou_tpu_torch.trx.daemon import BlockTrxDaemon

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    if name in ("half_batch", "dropped_carrier"):
        inner = BlockTrxDaemon._retire_compact

        def retire(self, pending):
            n = self.cfg.n_arfcn
            on, socks = self.carrier_on, self.data_socks
            if name == "half_batch":
                self.carrier_on = on[: n // 2] + [False] * (n - n // 2)
            else:
                self.data_socks = [_Nowhere()] + socks[1:]
            try:
                inner(self, pending)
            finally:
                self.carrier_on, self.data_socks = on, socks

        BlockTrxDaemon._retire_compact = retire
        try:
            yield
        finally:
            BlockTrxDaemon._retire_compact = inner
        return
    inner_block = T.duplex_block_compact

    def broken(cfg, spec, state, io_buf, tx_tail):
        st2, tail2, hdr, tx_buf, pkt_buf = inner_block(cfg, spec, state,
                                                       io_buf, tx_tail)
        if name == "stale_state":
            return state, tx_tail, hdr, tx_buf, pkt_buf
        pkt_buf = pkt_buf.clone()
        pkt_buf[0, 18] = 255 - pkt_buf[0, 18]  # soft byte 10
        pkt_buf[0, 5] += 1  # RSSI
        return st2, tail2, hdr, tx_buf, pkt_buf

    T.duplex_block_compact = broken
    try:
        yield
    finally:
        T.duplex_block_compact = inner_block
