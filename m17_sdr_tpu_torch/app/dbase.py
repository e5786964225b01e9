"""Session database: the shared state the reference keeps in M17_Dbase.

Reference: m17_dbase.cpp + m17defines.h:89-109.  One instance per
process (the control plane); the per-channel signal state lives in the
pipeline's RxSessionState pytree instead of globals.

The port's own copy of ``m17_sdr_tpu.app.dbase``: the port imports nothing of the
JAX package, so it keeps copies of the modules it needs from it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from ..spec import callsign as cs
from ..spec.constants import BROADCAST_ADDRESS


class CircuitType(Enum):
    """m17defines.h:77-84."""

    ASTOAS = "loop"     # audio loopback
    DRTOAS = "radio"    # M17 radio <-> local audio
    ASTODN = "client"   # local audio <-> internet reflector
    DRTODN = "gate"     # M17 radio <-> internet reflector (RF gateway)


@dataclass
class Dbase:
    tx_src_call: str = "NOCALL"
    tx_gate_call: str = "NOCALL G"
    tx_dest_call: str = "BROADCAST"
    rx_src: int = 0
    rx_dest: int = 0
    rx_freq: int = 434_000_000
    tx_freq: int = 434_000_000
    listen_all: bool = False
    in_frame: bool = False
    ptt: bool = False
    golay_errors: int = 0
    n_frames: int = 0
    rssi: float = 0.0           # smoothed signal level (radio.cpp:224-265)
    chan_type: CircuitType = CircuitType.DRTOAS
    afc: bool = False
    tx_gain: float = 0.5
    rx_gain: float = 0.5
    freq_correction: float = 1.0
    connected_reflector: str = ""
    reflector_module: str = ""
    meta: bytes = b""           # 14-byte LSF META payload (e.g. GPS position)
    extra: dict = field(default_factory=dict)

    @property
    def tx_src(self) -> int:
        return cs.encode_callsign(self.tx_src_call)

    @property
    def tx_dest(self) -> int:
        if self.tx_dest_call == "BROADCAST":
            return BROADCAST_ADDRESS
        return cs.encode_callsign(self.tx_dest_call)

    def is_for_me(self, address: int) -> bool:
        """Address filter incl. broadcast (m17_dbase.cpp:51-59)."""
        if self.listen_all or address == BROADCAST_ADDRESS:
            return True
        return address == self.tx_src

    def aos(self) -> None:
        """Acquisition of signal: reset counters (m17_dbase.cpp:60-75)."""
        self.in_frame = True
        self.golay_errors = 0
        self.n_frames = 0

    def los(self) -> None:
        self.in_frame = False
