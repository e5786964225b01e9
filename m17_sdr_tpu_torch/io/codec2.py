"""Codec2 voice vocoder binding (mode 3200), with a graceful fallback.

The reference links drowe67/codec2 (m17_tx_rx.cpp:328-332: MODE_3200,
160 samples / 8 bytes per 20 ms frame).  The modem layer only needs
opaque 16-byte payloads (m17_rx_parse.cpp:148-159), so when libcodec2
is not present this module provides a deterministic stand-in codec so
every audio path stays exercisable end-to-end.

The port's own copy of ``m17_sdr_tpu.io.codec2``: the port imports nothing of the
JAX package, so it keeps copies of the modules it needs from it.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

CODEC2_MODE_3200 = 0
SAMPLES_PER_FRAME = 160   # 20 ms at 8 kHz
BYTES_PER_FRAME = 8


def _find_lib() -> ctypes.CDLL | None:
    name = ctypes.util.find_library("codec2")
    if name:
        try:
            return ctypes.CDLL(name)
        except OSError:
            return None
    return None


class Codec2:
    """Real codec2 if available, else the fallback stand-in."""

    def __init__(self):
        self._lib = _find_lib()
        self._st = None
        if self._lib is not None:
            self._lib.codec2_create.restype = ctypes.c_void_p
            self._lib.codec2_create.argtypes = [ctypes.c_int]
            self._lib.codec2_encode.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int16)]
            self._lib.codec2_decode.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_uint8)]
            self._lib.codec2_destroy.argtypes = [ctypes.c_void_p]
            self._st = self._lib.codec2_create(CODEC2_MODE_3200)

    def __del__(self):
        # repl/gateway processes create a Codec2 per Session; without
        # codec2_destroy each one leaks the native codec state
        st, lib_ = getattr(self, "_st", None), getattr(self, "_lib", None)
        if st is not None and lib_ is not None:
            self._st = None
            lib_.codec2_destroy(st)

    @property
    def is_real(self) -> bool:
        return self._st is not None

    def encode(self, speech: np.ndarray) -> bytes:
        """[160] int16 speech -> 8 bytes."""
        speech = np.ascontiguousarray(speech, dtype=np.int16)
        assert speech.shape == (SAMPLES_PER_FRAME,)
        if self._st is not None:
            out = (ctypes.c_uint8 * BYTES_PER_FRAME)()
            self._lib.codec2_encode(
                self._st, out,
                speech.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
            return bytes(out)
        return _fallback_encode(speech)

    def decode(self, frame: bytes) -> np.ndarray:
        """8 bytes -> [160] int16 speech."""
        assert len(frame) == BYTES_PER_FRAME
        if self._st is not None:
            out = (ctypes.c_int16 * SAMPLES_PER_FRAME)()
            buf = (ctypes.c_uint8 * BYTES_PER_FRAME).from_buffer_copy(frame)
            self._lib.codec2_decode(self._st, out, buf)
            return np.frombuffer(out, dtype=np.int16).copy()
        return _fallback_decode(frame)


def _fallback_encode(speech: np.ndarray) -> bytes:
    """Deterministic 20:1 stand-in: 8-band energy + sign signature.

    NOT a vocoder -- just enough structure that encode->decode->encode
    is stable and audio paths can be tested without libcodec2.
    """
    bands = speech.astype(np.float32).reshape(8, 20)
    rms = np.sqrt(np.mean(bands ** 2, axis=1))
    lvl = np.clip(np.log2(rms + 1.0) * 16.0, 0, 255).astype(np.uint8)
    return bytes(lvl)


def _fallback_decode(frame: bytes) -> np.ndarray:
    rng = np.random.default_rng(int.from_bytes(frame, "big") & 0xFFFFFFFF)
    lvl = np.frombuffer(frame, dtype=np.uint8).astype(np.float32)
    amp = (2.0 ** (lvl / 16.0)) - 1.0
    noise = rng.standard_normal((8, 20)).astype(np.float32)
    return (noise * amp[:, None]).reshape(160).astype(np.int16)
