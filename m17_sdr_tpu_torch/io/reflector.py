"""M17 internet reflector protocol (M17-over-UDP).

Reference: m17_net.cpp.  Wire formats:
  * voice datagram, 54 bytes: "M17 " + StreamID(2) + LICH(28: dst 6,
    src 6, type 2, meta 14) + FN(2) + payload(16) + CRC16(2)
    (m17_net.cpp:25-49)
  * control: CONN(4+call6+module1), ACKN, NACK, PING(4+call6),
    PONG(4+call6), DISC(4[+call6]) (m17_net.cpp:86-167)

Session behavior mirrors the reference client: connecting appends 'G'
to the 9th character of the callsign (m17_net.cpp:335-343), PING is
answered with PONG (m17_net.cpp:266-273), DISC with a short DISC.
Transport is the native runtime's UDP + background thread.

The port's own copy of ``m17_sdr_tpu.io.reflector``: the port imports nothing of the
JAX package, so it keeps copies of the modules it needs from it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from ..runtime import UdpTransport
from ..spec import bits as bitpack
from ..spec import callsign as cs
from ..spec import crc
from ..spec.constants import NET_FRAME_BYTES, NET_UDP_PORT

MAGIC_VOICE = b"M17 "


def _crc16_host(data: bytes) -> int:
    return crc._crc_numpy(np.frombuffer(data, dtype=np.uint8))


def pack_voice_frame(stream_id: int, lich28: bytes, fn: int,
                     payload16: bytes) -> bytes:
    """Build a 54-byte voice datagram (m17_net.cpp:53-74)."""
    assert len(lich28) == 28 and len(payload16) == 16
    body = MAGIC_VOICE + struct.pack(">H", stream_id & 0xFFFF) + lich28 \
        + struct.pack(">H", fn & 0xFFFF) + payload16
    return body + struct.pack(">H", _crc16_host(body))


@dataclass
class VoiceFrame:
    stream_id: int
    dst: int
    src: int
    type_word: int
    meta: bytes
    fn: int
    payload: bytes


def parse_voice_frame(dgram: bytes) -> VoiceFrame | None:
    """Parse + CRC-check a 54-byte voice datagram
    (m17_parse_m17_data, m17_net.cpp:203-238).  None if invalid."""
    if len(dgram) != NET_FRAME_BYTES or dgram[:4] != MAGIC_VOICE:
        return None
    if _crc16_host(dgram) != 0:
        return None
    return VoiceFrame(
        stream_id=struct.unpack(">H", dgram[4:6])[0],
        dst=int(bitpack.bytes_to_word_host(np.frombuffer(dgram[6:12], np.uint8))),
        src=int(bitpack.bytes_to_word_host(np.frombuffer(dgram[12:18], np.uint8))),
        type_word=struct.unpack(">H", dgram[18:20])[0],
        meta=dgram[20:34],
        fn=struct.unpack(">H", dgram[34:36])[0],
        payload=dgram[36:52],
    )


def _call6(address: int) -> bytes:
    return bytes(bitpack.word_to_bytes(address, 6))


def pack_conn(from_call: int, module: str) -> bytes:
    return b"CONN" + _call6(from_call) + module.encode()[:1]


def pack_ping(from_call: int) -> bytes:
    return b"PING" + _call6(from_call)


def pack_pong(from_call: int) -> bytes:
    return b"PONG" + _call6(from_call)


def pack_disc(from_call: int | None = None) -> bytes:
    return b"DISC" + (_call6(from_call) if from_call is not None else b"")


@dataclass
class ReflectorClient:
    """Reflector session state machine (m17_net.cpp session layer)."""

    host: str
    port: int = NET_UDP_PORT
    transport: UdpTransport | None = None
    active: bool = False         # ACKN received (m_ref_active)
    from_call: int = 0
    module: str = "A"
    last_stream_id: int = -1
    rx_voice: list = field(default_factory=list)

    def connect(self, my_callsign: str, module: str,
                bind_port: int = 0) -> None:
        """CONN handshake; the gateway suffix 'G' is placed in the 9th
        callsign character (m17_net.cpp:340-342)."""
        call = my_callsign.upper().ljust(9)[:8] + "G"
        self.from_call = cs.encode_callsign(call)
        self.module = module
        self.transport = UdpTransport(self.host, self.port, bind_port=bind_port)
        self.transport.start_rx()
        self.transport.send(pack_conn(self.from_call, module))

    def disconnect(self) -> None:
        if self.transport:
            self.transport.send(pack_disc(self.from_call))
            self.active = False

    def send_voice(self, stream_id: int, lich28: bytes, fn: int,
                   payload16: bytes) -> None:
        if self.transport and self.active:
            self.transport.send(
                pack_voice_frame(stream_id, lich28, fn, payload16))

    def poll(self) -> list[VoiceFrame]:
        """Drain the RX queue, run the control protocol, and return any
        voice frames (m17_net_parse_msg, m17_net.cpp:244-302)."""
        got: list[VoiceFrame] = []
        if not self.transport:
            return got
        while (dgram := self.transport.poll()) is not None:
            tag = dgram[:4]
            if tag == b"ACKN":
                self.active = True
            elif tag == b"NACK":
                self.active = False
            elif tag == b"PING":
                self.transport.send(pack_pong(self.from_call))
            elif tag == b"DISC":
                if len(dgram) > 4:    # server-initiated: answer DISC
                    self.transport.send(pack_disc())
                self.active = False
            elif tag == MAGIC_VOICE:
                vf = parse_voice_frame(dgram)
                if vf is not None:
                    if vf.stream_id != self.last_stream_id:
                        self.last_stream_id = vf.stream_id  # new PTT
                    got.append(vf)
        return got

    def close(self) -> None:
        if self.transport:
            self.transport.close()
            self.transport = None
