"""M17 CRC-16 (poly 0x5935, init 0xFFFF) as a GF(2) affine map.

For a fixed message length the CRC is ``crc_bits(msg) = msg_bits @ A
xor crc_bits(0)``.  The product is taken as a float32 matmul followed
by ``% 2``: exact, since the operands are 0/1 and the sums stay below
2^24, and it runs on CUDA, where torch has no integer matmul.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._util import on_device
from . import bits

CRC_POLY = 0x5935
CRC_INIT = 0xFFFF


def _crc_numpy(data: np.ndarray, init: int = CRC_INIT) -> int:
    """Scalar bitwise CRC, used only to build the affine tables."""
    crc = init
    for byte in data.astype(np.uint32):
        crc ^= int(byte) << 8
        for _ in range(8):
            crc = ((crc << 1) ^ CRC_POLY if crc & 0x8000 else crc << 1) & 0xFFFF
    return crc


def _build_byte_table() -> np.ndarray:
    """CRC of each single byte from a zero register: the byte-at-a-time
    loop's table (m17_crc.cpp:26-35)."""
    return np.array([_crc_numpy(np.array([i], dtype=np.uint8), init=0) for i in range(256)],
                    dtype=np.int64)


CRC_TABLE = _build_byte_table()


@functools.lru_cache(maxsize=None)
def _affine(nbytes: int) -> tuple[np.ndarray, np.ndarray]:
    """(A [8*nbytes, 16] float32 0/1, c [16] int64): the CRC's linear part
    and the CRC bits of the all-zero message."""
    zero = np.zeros(nbytes, dtype=np.uint8)
    c_word = _crc_numpy(zero)
    a = np.zeros((8 * nbytes, 16), dtype=np.float32)
    for i in range(8 * nbytes):
        msg = zero.copy()
        msg[i // 8] = 0x80 >> (i % 8)
        w = _crc_numpy(msg) ^ c_word
        a[i] = [(w >> (15 - b)) & 1 for b in range(16)]
    c = np.array([(c_word >> (15 - b)) & 1 for b in range(16)], dtype=np.int64)
    return a, c


def crc16_fixed(data: torch.Tensor) -> torch.Tensor:
    """CRC-16 of [..., N] uint8 messages -> int64 [...].

    A message with its CRC appended yields 0.
    """
    a, c = _affine(data.shape[-1])
    dev = data.device
    msg_bits = bits.bytes_to_bits(data).to(torch.float32)
    crc_bits = (msg_bits @ on_device(a, dev)).to(torch.int64) % 2
    crc_bits = crc_bits ^ on_device(c, dev)
    shifts = torch.arange(15, -1, -1, device=dev)
    return (crc_bits << shifts).sum(dim=-1)


def crc16_append(data: torch.Tensor) -> torch.Tensor:
    """Append the big-endian CRC to [..., N] uint8 messages -> [..., N+2]."""
    crc = crc16_fixed(data)
    return torch.cat([data, bits.word_to_bytes_device(crc, 2)], dim=-1)
