"""Sample sources and sinks: the radio-HAL contract without radios.

The reference HAL contract (radio.cpp): `radio_receive_samples` /
`radio_transmit_samples` move 48 kHz complex int16 IQ in 1920-sample
(40 ms) blocks (m17defines.h:17-18).  There is no SDR hardware on a
compute host, so the backends are files, loopback memory, and UDP
sample streams -- each preserving that contract, batched to B channels.

int16 wire format: interleaved re/im pairs, little endian, matching the
scmplx layout (m17defines.h:130-133).

The port's own copy of ``m17_sdr_tpu.io.sources``: the port imports nothing of the
JAX package, so it keeps copies of the modules it needs from it.
"""

from __future__ import annotations

import pathlib
from typing import Iterator

import numpy as np

from ..spec.constants import BLOCK_SAMPLES


def iq_to_wire(iq: np.ndarray) -> np.ndarray:
    """complex IQ [..., T] -> int16 interleaved [..., 2T] (0x3FFF scale,
    m17_modulate.cpp:25-26)."""
    out = np.empty((*iq.shape, 2), dtype=np.int16)
    out[..., 0] = np.round(np.real(iq) * 0x3FFF)
    out[..., 1] = np.round(np.imag(iq) * 0x3FFF)
    return out.reshape(*iq.shape[:-1], iq.shape[-1] * 2)


def wire_to_iq(raw: np.ndarray) -> np.ndarray:
    """int16 interleaved [..., 2T] -> complex64 [..., T] scaled by 3e-5
    (dsp_short_to_float, m17_dsp.cpp:136-141)."""
    pairs = raw.reshape(*raw.shape[:-1], raw.shape[-1] // 2, 2).astype(np.float32)
    return (pairs[..., 0] + 1j * pairs[..., 1]).astype(np.complex64) * 3.0e-5


class FileSource:
    """Reads int16 IQ blocks from a raw capture file, one channel.

    Implements the radio_receive_samples contract: each call yields
    [block] complex64 samples; None at end of file.
    """

    def __init__(self, path: str | pathlib.Path, block: int = BLOCK_SAMPLES):
        self._data = np.fromfile(str(path), dtype=np.int16)
        self._block = block
        self._pos = 0

    def receive_samples(self) -> np.ndarray | None:
        need = self._block * 2
        if self._pos + need > len(self._data):
            return None
        raw = self._data[self._pos: self._pos + need]
        self._pos += need
        return wire_to_iq(raw)

    def blocks(self) -> Iterator[np.ndarray]:
        while (b := self.receive_samples()) is not None:
            yield b


class FileSink:
    """Writes int16 IQ blocks to a raw capture file (transmit contract)."""

    def __init__(self, path: str | pathlib.Path):
        self._f = open(str(path), "wb")

    def transmit_samples(self, iq: np.ndarray) -> int:
        wire = iq_to_wire(iq)
        wire.astype("<i2").tofile(self._f)
        return iq.shape[-1]

    def close(self) -> None:
        self._f.close()


class LoopbackChannel:
    """In-memory TX->RX pipe (the digital loopback circuit, ASTOAS
    analog: m17_tx_rx.cpp:221-234), single process, per-channel."""

    def __init__(self, block: int = BLOCK_SAMPLES):
        self._buf = np.zeros(0, dtype=np.complex64)
        self._block = block

    def transmit_samples(self, iq: np.ndarray) -> int:
        self._buf = np.concatenate([self._buf, np.asarray(iq, np.complex64)])
        return iq.shape[-1]

    def receive_samples(self) -> np.ndarray | None:
        if len(self._buf) < self._block:
            return None
        out, self._buf = self._buf[: self._block], self._buf[self._block:]
        return out


class UdpSampleSink:
    """Transmit 48 kHz int16 IQ blocks over UDP -- the
    radio_transmit_samples contract (radio.cpp:171-177) with the
    network as the radio.

    Each datagram carries exactly one `block` of interleaved int16
    re/im pairs (1920 samples = 7680 bytes; IP fragmentation handles
    loopback/LAN MTUs -- the reference's own reflector voice datagrams
    assume the same single-datagram framing discipline).  Sub-block
    residue is held until the next call or flush().
    """

    def __init__(self, host: str, port: int,
                 block: int = BLOCK_SAMPLES, bind_port: int = 0):
        from ..runtime import UdpTransport

        self._t = UdpTransport(host, port, bind_port=bind_port)
        self._block = block
        self._residue = np.zeros(0, np.complex64)

    def transmit_samples(self, iq: np.ndarray) -> int:
        buf = np.concatenate([self._residue, np.asarray(iq, np.complex64)])
        nblk = len(buf) // self._block
        for i in range(nblk):
            wire = iq_to_wire(buf[i * self._block:(i + 1) * self._block])
            self._t.send(wire.astype("<i2").tobytes())
        self._residue = buf[nblk * self._block:]
        return int(iq.shape[-1])

    def flush(self) -> None:
        """Zero-pad and send any sub-block residue (end of burst)."""
        if len(self._residue):
            pad = np.zeros(self._block - len(self._residue), np.complex64)
            self.transmit_samples(pad)

    def close(self) -> None:
        self.flush()
        self._t.close()


class UdpSampleSource:
    """Receive 48 kHz int16 IQ blocks from UDP -- the
    radio_receive_samples contract (radio.cpp:157-170) with the
    network as the radio.  The native transport's background thread
    queues datagrams; receive_samples() returns one [block] complex64
    block or None after `timeout_s` of silence (end of stream).
    """

    def __init__(self, listen_port: int, block: int = BLOCK_SAMPLES,
                 timeout_s: float = 1.0):
        from ..runtime import UdpTransport

        self._t = UdpTransport("127.0.0.1", 0, bind_port=listen_port)
        self._t.start_rx()
        self._block = block
        self._timeout = timeout_s

    @property
    def port(self) -> int:
        """The port listened on (the kernel's pick for listen_port 0)."""
        return self._t.local_port

    def receive_samples(self) -> np.ndarray | None:
        w = self.receive_wire()
        return None if w is None else wire_to_iq(w.reshape(-1))

    def blocks(self) -> Iterator[np.ndarray]:
        while (b := self.receive_samples()) is not None:
            yield b

    def receive_wire(self) -> np.ndarray | None:
        """One int16 [block, 2] wire block, or None after the timeout."""
        import time

        deadline = time.monotonic() + self._timeout
        while time.monotonic() < deadline:
            d = self._t.poll()
            if d is None:
                time.sleep(0.002)
                continue
            if len(d) != self._block * 4:     # not an IQ block datagram
                continue
            return np.frombuffer(d, dtype="<i2").reshape(self._block, 2)
        return None

    def wire_blocks(self) -> Iterator[np.ndarray]:
        """int16 [block, 2] wire blocks (StreamingRx feed_block form)."""
        while (w := self.receive_wire()) is not None:
            yield w

    def close(self) -> None:
        self._t.close()


class BatchFileSource:
    """B parallel capture files -> [B, block] batched blocks; channels
    shorter than the longest are zero-padded (idle carrier)."""

    def __init__(self, paths: list[str | pathlib.Path],
                 block: int = BLOCK_SAMPLES):
        self._sources = [FileSource(p, block) for p in paths]
        self._block = block

    def receive_samples(self) -> np.ndarray | None:
        outs = []
        any_live = False
        for s in self._sources:
            b = s.receive_samples()
            if b is None:
                b = np.zeros(self._block, np.complex64)
            else:
                any_live = True
            outs.append(b)
        if not any_live:
            return None
        return np.stack(outs)
