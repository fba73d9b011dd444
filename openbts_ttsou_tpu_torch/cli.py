"""Table-driven command-line interface.

Reference behavior: `CLI/CLI.{h,cpp}` — `CommandLine::Parser` with the
command table at CLI.cpp:680-712 (loglevel, tmsis, sendsms, load,
cellid, calls, config, regperiod, alarms, page, testcall, endcall,
chans, power, …). Commands operate on an injected `BTSApp`-like context
so the CLI is testable without a live radio.
"""

from __future__ import annotations

import time as systime
from typing import Callable, Dict, List

from openbts_ttsou_tpu_torch import __version__
from openbts_ttsou_tpu_torch.utils.logger import gAlarms, set_level


class Parser:
    """Command registry + dispatcher (CommandLine::Parser)."""

    def __init__(self, context=None):
        self.ctx = context
        self._commands: Dict[str, tuple[Callable, str]] = {}
        self._start_time = systime.monotonic()
        self._install()

    def add_command(self, name: str, fn: Callable[[List[str]], str],
                    help_text: str) -> None:
        self._commands[name] = (fn, help_text)

    def process(self, line: str) -> str:
        """Run one command line; returns the output text."""
        parts = line.split()
        if not parts:
            return ""
        name, args = parts[0], parts[1:]
        entry = self._commands.get(name)
        if entry is None:
            return f"unknown command: {name} (try 'help')"
        try:
            return entry[0](args)
        except Exception as e:  # mirror the reference's fault tolerance
            return f"command failed: {type(e).__name__}: {e}"

    # ------------------------------------------------------------------
    def _install(self) -> None:
        add = self.add_command
        add("help", self._help,
            "[command] -- list commands or get help on one.")
        add("version", lambda a: f"openbts-ttsou-tpu {__version__}",
            "-- print the version string.")
        add("uptime", self._uptime,
            "-- show BTS uptime and frame number.")
        add("loglevel", self._loglevel,
            "[level] -- set the logging level.")
        add("alarms", lambda a: "\n".join(gAlarms.recent()) or "(none)",
            "-- show latest alarms.")
        add("tmsis", self._tmsis, "[clear] -- print/clear the TMSI table.")
        add("dumptmsis", self._dumptmsis, "<path> -- dump the TMSI table.")
        add("calls", self._calls, "-- print the transaction table.")
        add("load", self._load, "-- print the current activity loads.")
        add("cellid", self._cellid,
            "[MCC MNC LAC CI] -- get/set LAI and cell ID.")
        add("config", self._config,
            "[pattern | key value] -- inspect or set configuration.")
        add("configsave", self._configsave,
            "<path> -- write the configuration to a file.")
        add("regperiod", self._regperiod,
            "[minutes] -- get/set the T3212 registration period.")
        add("chans", self._chans, "-- report PHY status of channels.")
        add("power", self._power, "-- report/set power attenuation.")
        add("page", self._page, "IMSI [secs] -- page the given IMSI.")
        add("sendsms", self._sendsms,
            "IMSI src text... -- deliver an SMS to IMSI.")
        add("endcall", self._endcall,
            "trans# -- terminate the given transaction.")
        add("testcall", self._testcall,
            "IMSI [secs] -- initiate a test call to IMSI.")
        add("sendrrlp", self._sendrrlp,
            "IMSI hexstring -- send an RRLP APDU to IMSI.")
        add("setlogfile", self._setlogfile,
            "<path> -- set the logging file to <path>.")
        add("findimsi", self._findimsi,
            "[IMSIPrefix] -- print IMSIs prefixed by IMSIPrefix.")
        add("assignment", self._assignment,
            "[type] -- get/set assignment type (early, veryearly).")
        add("shortname", self._shortname,
            "[name] -- get/set the network short name.")
        add("rolllac", self._rolllac,
            "[LAC] -- increment the LAC or set a new value.")
        add("exit", lambda a: "exiting", "-- exit the application.")

    # -- command implementations ---------------------------------------
    def _testcall(self, args) -> str:
        if not args:
            return "usage: testcall IMSI [secs]"
        t = self.ctx.control.initiate_testcall(args[0])
        return f"test call transaction {t.id}; paging {args[0]}"

    def _sendrrlp(self, args) -> str:
        if len(args) < 2:
            return "usage: sendrrlp IMSI hexstring"
        try:
            apdu = bytes.fromhex(args[1])
        except ValueError:
            return "bad hexstring"
        ok = self.ctx.control.send_rrlp(args[0], apdu)
        return "RRLP sent" if ok else "no active channel for " + args[0]

    def _setlogfile(self, args) -> str:
        if not args:
            return "usage: setlogfile <path>"
        from openbts_ttsou_tpu_torch.utils.logger import set_logfile

        set_logfile(args[0])
        return f"logging to {args[0]}"

    def _findimsi(self, args) -> str:
        prefix = args[0] if args else ""
        rows = [f"{i} {t:08x}" for t, i in
                self.ctx.control.tmsis._by_tmsi.items()
                if i.startswith(prefix)]
        return "\n".join(rows) or "(no matches)"

    def _assignment(self, args) -> str:
        cfg = self.ctx.bts.config
        if args:
            if args[0] not in ("early", "veryearly"):
                return "usage: assignment [early|veryearly]"
            cfg.set("GSM.AssignmentType", args[0])
        return cfg.get_str("GSM.AssignmentType", "early")

    def _shortname(self, args) -> str:
        cfg = self.ctx.bts.config
        if args:
            cfg.set("GSM.ShortName", args[0])
        return cfg.get_str("GSM.ShortName", "")

    def _rolllac(self, args) -> str:
        b = self.ctx.bts
        b.lac = int(args[0]) if args else b.lac + 1
        b.config.set("GSM.LAC", str(b.lac))
        return f"LAC={b.lac}"

    def _help(self, args: List[str]) -> str:
        if args and args[0] in self._commands:
            return f"{args[0]} {self._commands[args[0]][1]}"
        return "\n".join(f"{n} {h}" for n, (_, h) in
                         sorted(self._commands.items()))

    def _uptime(self, args) -> str:
        up = systime.monotonic() - self._start_time
        fn = self.ctx.bts.clock.fn() if self.ctx else 0
        return f"up {up:.0f} s, frame number {fn}"

    def _loglevel(self, args) -> str:
        if not args:
            return "usage: loglevel <level>"
        set_level(args[0])
        return f"log level set to {args[0].upper()}"

    def _tmsis(self, args) -> str:
        ctl = self.ctx.control
        if args and args[0] == "clear":
            ctl.tmsis.__init__()
            return "TMSI table cleared"
        lines = [f"{t:08x} {i}" for t, i in
                 ctl.tmsis._by_tmsi.items()]
        return "\n".join(lines) or "(empty)"

    def _dumptmsis(self, args) -> str:
        path = args[0] if args else "tmsis.txt"
        self.ctx.control.tmsis.dump(path)
        return f"wrote {path}"

    def _calls(self, args) -> str:
        rows = [f"{t.id} {t.service.name} {t.imsi} {t.state.name}"
                for t in self.ctx.control.transactions.entries()]
        return "\n".join(rows) or "(no transactions)"

    def _load(self, args) -> str:
        b = self.ctx.bts
        return (f"SDCCH: {b.sdcch_total() - b.sdcch_available()}/"
                f"{b.sdcch_total()} TCH: "
                f"{b.tch_total() - b.tch_available()}/{b.tch_total()} "
                f"paging: {b.pager.size()} T3122: {b.t3122()}s "
                f"transactions: {self.ctx.control.transactions.size()}")

    def _cellid(self, args) -> str:
        b = self.ctx.bts
        if len(args) == 4:
            b.mcc, b.mnc = args[0], args[1]
            b.lac, b.cell_id = int(args[2]), int(args[3])
        return f"MCC={b.mcc} MNC={b.mnc} LAC={b.lac} CI={b.cell_id}"

    def _config(self, args) -> str:
        cfg = self.ctx.bts.config
        if len(args) >= 2:
            ok = cfg.set(args[0], " ".join(args[1:]))
            return "set" if ok else f"{args[0]} is static"
        pattern = args[0] if args else ""
        lines = [f"{k} {cfg.get_str(k)}" for k in cfg.keys()
                 if pattern in k]
        return "\n".join(lines) or "(no matching keys)"

    def _configsave(self, args) -> str:
        if not args:
            return "usage: configsave <path>"
        self.ctx.bts.config.save(args[0])
        return f"wrote {args[0]}"

    def _regperiod(self, args) -> str:
        cfg = self.ctx.bts.config
        if args:
            cfg.set("GSM.T3212", args[0])
        return f"T3212 = {cfg.get_str('GSM.T3212', '0')} minutes"

    def _chans(self, args) -> str:
        """Per-channel PHY report (CLI.cpp `chans`: type, state, FER,
        RSSI, timing error from the uplink decoder averages)."""
        rows = ["chan  TN  state   FER    good/bad  RSSI(dB)  TA(sym)"]
        for kind, pool in (("SDCCH", self.ctx.bts.sdcch_pool),
                           ("TCH", list(self.ctx.bts.tch_pool))):
            for i, ch in enumerate(pool):
                l1 = getattr(ch, "l1", ch)
                n = max(l1.phy_count, 1)
                rows.append(
                    f"{kind}{i:<2} TN{l1.tn}  "
                    f"{'open' if l1.active else 'idle':6} "
                    f"{l1.fer():5.3f}  {l1.good_frames}/{l1.bad_frames}"
                    f"  {l1.rssi_sum / n:8.1f}  "
                    f"{l1.timing_sum / n:6.2f}")
        return "\n".join(rows)

    def _power(self, args) -> str:
        return "power control: full scale"

    def _page(self, args) -> str:
        if not args:
            return "usage: page IMSI [secs]"
        from openbts_ttsou_tpu_torch.gsm.l3.common import MobileIdentity

        life = float(args[1]) if len(args) > 1 else 10.0
        self.ctx.bts.pager.add(MobileIdentity.imsi(args[0]), life)
        return f"paging {args[0]} for {life:.0f} s"

    def _sendsms(self, args) -> str:
        if len(args) < 3:
            return "usage: sendsms IMSI src text..."
        self.ctx.control.initiate_mtsms(args[0], args[1],
                                        " ".join(args[2:]))
        return f"queued SMS to {args[0]}"

    def _endcall(self, args) -> str:
        if not args:
            return "usage: endcall trans#"
        self.ctx.control.transactions.remove(int(args[0]))
        return f"removed transaction {args[0]}"
