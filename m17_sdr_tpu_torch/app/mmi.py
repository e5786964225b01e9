"""MMI: the command language, shared by interactive use and config files.

Reference: mmi.cpp.  The same tokenizing parser handles typed commands
and `config.txt` startup profiles (mmi_load_file, mmi.cpp:225-238) --
the reference's entire config system.  Command set (mmi.cpp:21-224):

  #            comment
  tg <0..1>    transmitter gain          rg <0..1>   receiver gain
  tf <hz>      transmit frequency        rf <hz>     receive frequency
  fc <factor>  frequency correction      afc on|off  AFC
  tx / rx / td / tc                      PTT on / off / duplex / carrier
  sa <call>    source address            ga <call> <suffix>  gateway addr
  da <call>    destination address       ba          broadcast destination
  mode loop|radio|gate|client            circuit type
  conn <refl> <module> / disc            reflector session
  w (clear), h (help), q (quit)

The port's own copy of ``m17_sdr_tpu.app.mmi``: the port imports nothing of the
JAX package, so it keeps copies of the modules it needs from it.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass, field
from typing import Callable

from .dbase import CircuitType, Dbase


@dataclass
class Mmi:
    db: Dbase = field(default_factory=Dbase)
    # action hooks the session layer installs (ptt control, reflector...)
    on_ptt: Callable[[str], None] | None = None       # "tx"|"rx"|"dp"|"ca"
    on_connect: Callable[[str, str], None] | None = None
    on_disconnect: Callable[[], None] | None = None
    on_quit: Callable[[], None] | None = None
    responses: list[str] = field(default_factory=list)

    def _ok(self) -> str:
        self.responses.append("OK")
        return "OK"

    def _bad(self) -> str:
        self.responses.append("Invalid command")
        return "Invalid command"

    def parse(self, line: str) -> str:
        """Parse one command line; returns the response string
        ("OK" / "Invalid command", mmi.cpp:217-222)."""
        tokens = line.split()
        if not tokens:
            return self._bad()
        cmd = tokens[0]

        if cmd.startswith("#"):
            return self._ok()

        if cmd.startswith("tg") and len(tokens) == 2:
            g = float(tokens[1])
            if 0.0 <= g <= 1.0:
                self.db.tx_gain = g
                return self._ok()
            return self._bad()
        if cmd.startswith("rg") and len(tokens) == 2:
            g = float(tokens[1])
            if 0.0 <= g <= 1.0:
                self.db.rx_gain = g
                return self._ok()
            return self._bad()
        if cmd.startswith("tf") and len(tokens) == 2:
            self.db.tx_freq = int(tokens[1])
            return self._ok()
        if cmd.startswith("rf") and len(tokens) == 2:
            self.db.rx_freq = int(tokens[1])
            return self._ok()
        if cmd.startswith("fc") and len(tokens) == 2:
            fac = float(tokens[1])
            if 0.9 < fac < 1.1:     # radio.cpp:188-192
                self.db.freq_correction = fac
            return self._ok()
        if cmd.startswith("afc") and len(tokens) == 2:
            if tokens[1].startswith("on"):
                self.db.afc = True
                return self._ok()
            if tokens[1].startswith("off"):
                self.db.afc = False
                return self._ok()
            return self._bad()
        if cmd == "q":
            if self.on_quit:
                self.on_quit()
            return self._ok()
        if cmd.startswith("tc"):
            self.db.ptt = True
            if self.on_ptt:
                self.on_ptt("ca")
            return self._ok()
        if cmd.startswith("tx"):
            self.db.ptt = True
            if self.on_ptt:
                self.on_ptt("tx")
            return self._ok()
        if cmd.startswith("td"):
            if self.on_ptt:
                self.on_ptt("dp")
            return self._ok()
        if cmd.startswith("rx"):
            self.db.ptt = False
            if self.on_ptt:
                self.on_ptt("rx")
            return self._ok()
        if cmd.startswith("sa") and len(tokens) >= 2:
            self.db.tx_src_call = tokens[1].upper()[:9]
            return self._ok()
        if cmd.startswith("ga") and len(tokens) >= 3:
            # gateway: callsign padded to 9, suffix char in position 9
            # (mmi.cpp:142-149)
            call = tokens[1].upper().ljust(9)[:8] + tokens[2][0].upper()
            self.db.tx_gate_call = call
            return self._ok()
        if cmd.startswith("da") and len(tokens) >= 2:
            self.db.tx_dest_call = tokens[1].upper()[:9]
            return self._ok()
        if cmd.startswith("ba"):
            self.db.tx_dest_call = "BROADCAST"
            return self._ok()
        if cmd == "mode" and len(tokens) >= 2:
            try:
                self.db.chan_type = CircuitType(tokens[1])
                return self._ok()
            except ValueError:
                return self._bad()
        if cmd == "conn" and len(tokens) == 3:
            if self.on_connect:
                self.on_connect(tokens[1], tokens[2][0])
            return self._ok()
        if cmd == "disc":
            if self.on_disconnect:
                self.on_disconnect()
            return self._ok()
        if cmd == "w":
            return self._ok()
        if cmd == "h":
            self.responses.append(HELP)
            return "OK"
        return self._bad()

    def load_file(self, path: str | pathlib.Path) -> None:
        """Run a file of commands -- the config system
        (mmi_load_file, mmi.cpp:225-238)."""
        p = pathlib.Path(path)
        if not p.exists():
            self.responses.append(f"Unable to open {path}")
            return
        for line in p.read_text().splitlines():
            if line.strip():
                self.parse(line)


HELP = """\
tg/rg <0..1>  tx/rx gain      tf/rf <hz>  tx/rx frequency
fc <factor>   freq correction afc on|off  automatic frequency control
tx rx td tc   ptt: on off duplex carrier
sa/da <call>  src/dest addr   ga <call> <sfx>  gateway  ba  broadcast
mode loop|radio|gate|client   circuit type
conn <reflector> <module> / disc   reflector session
w clear  h help  q quit"""
