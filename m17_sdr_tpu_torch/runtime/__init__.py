"""ctypes binding for the native host runtime (``csrc/m17_runtime.cpp``).

The port's own copy of ``m17_sdr_tpu.runtime``: the same C ABI and the
same classes (``SampleRing``, ``DatagramQueue``, ``UdpTransport``).  The
library is built by ``g++`` into ``build/`` at the repository root on
first use, under a name keyed by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one reused.  Nothing is
built at import, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from .._build import BUILD_DIR, CSRC

SOURCE = CSRC / "m17_runtime.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")
_U8P = ctypes.POINTER(ctypes.c_uint8)


def lib_path():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libm17rt-{h.hexdigest()[:16]}.so"


def _build(path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, path)          # atomic: concurrent builds agree


def _load() -> ctypes.CDLL:
    path = lib_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)

    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_push.restype = ctypes.c_int
    lib.ring_push.argtypes = [ctypes.c_void_p, u8p]
    lib.ring_pop.restype = ctypes.c_int
    lib.ring_pop.argtypes = [ctypes.c_void_p, u8p]
    lib.ring_size.restype = ctypes.c_size_t
    lib.ring_size.argtypes = [ctypes.c_void_p]

    lib.dq_create.restype = ctypes.c_void_p
    lib.dq_create.argtypes = [ctypes.c_size_t]
    lib.dq_destroy.argtypes = [ctypes.c_void_p]
    lib.dq_push.restype = ctypes.c_int
    lib.dq_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint16]
    lib.dq_pop.restype = ctypes.c_int
    lib.dq_pop.argtypes = [ctypes.c_void_p, u8p, u16p]
    lib.dq_size.restype = ctypes.c_size_t
    lib.dq_size.argtypes = [ctypes.c_void_p]

    lib.udp_create.restype = ctypes.c_void_p
    lib.udp_create.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                               ctypes.c_uint16, ctypes.c_size_t]
    lib.udp_send_to_peer.restype = ctypes.c_int
    lib.udp_send_to_peer.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int]
    lib.udp_start_rx.argtypes = [ctypes.c_void_p]
    lib.udp_poll.restype = ctypes.c_int
    lib.udp_poll.argtypes = [ctypes.c_void_p, u8p, u16p]
    lib.udp_queue_size.restype = ctypes.c_size_t
    lib.udp_queue_size.argtypes = [ctypes.c_void_p]
    lib.udp_destroy.argtypes = [ctypes.c_void_p]
    lib.udp_local_port.restype = ctypes.c_uint16
    lib.udp_local_port.argtypes = [ctypes.c_void_p]
    return lib


_lib: ctypes.CDLL | None = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


class SampleRing:
    """SPSC ring of fixed-size byte blocks (sample transport)."""

    def __init__(self, block_bytes: int, capacity_pow2: int = 64):
        self._lib = lib()
        self._block = block_bytes
        self._h = self._lib.ring_create(block_bytes, capacity_pow2)
        if not self._h:
            raise MemoryError(
                f"ring_create failed ({block_bytes} B x {capacity_pow2} "
                f"blocks = {block_bytes * capacity_pow2 / 1e9:.1f} GB)")

    def push(self, data) -> bool:
        """Copy one block (bytes, or a C-contiguous array of block_bytes)
        into the ring straight from its buffer; False when full.  The
        copy runs in C with the interpreter lock released."""
        src = np.frombuffer(data, dtype=np.uint8)
        if src.nbytes != self._block:
            raise ValueError(f"block of {src.nbytes} B, not {self._block}")
        return bool(self._lib.ring_push(self._h, src.ctypes.data_as(_U8P)))

    def pop_into(self, out: np.ndarray) -> bool:
        """Copy the oldest block into ``out`` (a writable C-contiguous
        array of block_bytes); False when the ring is empty."""
        if out.nbytes != self._block or not out.flags.c_contiguous:
            raise ValueError(f"out must be {self._block} contiguous bytes")
        return bool(self._lib.ring_pop(self._h, out.ctypes.data_as(_U8P)))

    def pop(self) -> bytes | None:
        buf = np.empty(self._block, dtype=np.uint8)
        return buf.tobytes() if self.pop_into(buf) else None

    def __len__(self) -> int:
        return self._lib.ring_size(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None


class DatagramQueue:
    """Bounded MPSC queue of datagrams (the gateway jitter buffer;
    200-frame cap like buffers.cpp:11)."""

    MAX_DGRAM = 65536  # keep in sync with m17_runtime.cpp DgramQueue::MAX_DGRAM

    def __init__(self, capacity: int = 200):
        self._lib = lib()
        self._h = self._lib.dq_create(capacity)

    def push(self, data: bytes) -> bool:
        # the wire length field is uint16: an oversize datagram must be
        # rejected HERE -- c_uint16(len) would silently truncate it to
        # len % 65536 and enqueue a corrupt prefix (the C-side bound
        # check can never fire for a uint16 argument)
        if not data or len(data) > 65535:
            return False
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return bool(self._lib.dq_push(self._h, buf, len(data)))

    def pop(self) -> bytes | None:
        buf = (ctypes.c_uint8 * self.MAX_DGRAM)()
        ln = ctypes.c_uint16()
        if self._lib.dq_pop(self._h, buf, ctypes.byref(ln)):
            return bytes(buf[: ln.value])
        return None

    def __len__(self) -> int:
        return self._lib.dq_size(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.dq_destroy(self._h)
            self._h = None


class UdpTransport:
    """UDP socket with a native background RX thread feeding a queue."""

    def __init__(self, peer_ip: str, peer_port: int,
                 bind_port: int = 0, queue_cap: int = 200):
        import socket

        self._lib = lib()
        # resolve DNS names here: the native side takes dotted quads
        # only (inet_addr), and public reflector directories commonly
        # list hostnames.  gethostbyname passes literal IPs through
        # and raises on garbage instead of letting inet_addr map it to
        # the broadcast address.
        try:
            peer_ip = socket.gethostbyname(peer_ip)
        except OSError as e:
            raise OSError(f"cannot resolve UDP peer {peer_ip!r}: {e}")
        self._h = self._lib.udp_create(
            peer_ip.encode(), peer_port, bind_port, queue_cap)
        if not self._h:
            raise OSError(f"udp_create failed for {peer_ip}:{peer_port}")

    def send(self, data: bytes) -> int:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return self._lib.udp_send_to_peer(self._h, buf, len(data))

    def start_rx(self) -> None:
        self._lib.udp_start_rx(self._h)

    def poll(self) -> bytes | None:
        buf = (ctypes.c_uint8 * DatagramQueue.MAX_DGRAM)()
        ln = ctypes.c_uint16()
        if self._lib.udp_poll(self._h, buf, ctypes.byref(ln)):
            return bytes(buf[: ln.value])
        return None

    def queue_size(self) -> int:
        return self._lib.udp_queue_size(self._h)

    @property
    def local_port(self) -> int:
        """The bound local port (the kernel's pick when bind_port was 0)."""
        return self._lib.udp_local_port(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.udp_destroy(self._h)
            self._h = None
