"""Golay(24,12) for the LICH.  The encoder appends the parity of a GF(2)
product; the decoder takes the syndrome by the same product, then one
lookup in a 4096-entry syndrome table of (error count, data error).
The products are float32 matmuls of 0/1 values, exact (sums <= 12).

The table holds every error pattern of weight <= 3; any other syndrome
reads as 4 errors, uncorrected (as ``m17_sdr_tpu.spec.golay``).
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

from .._util import on_device

# parity generator rows, one 12-bit row per data bit, MSB first
GOLAY_GTAB = np.array(
    [0xC75, 0x63B, 0xF68, 0x7B4, 0x3DA, 0xD99,
     0x6CD, 0x367, 0xDC6, 0xA97, 0x93E, 0x8EB],
    dtype=np.int64,
)

# [12, 12] GF(2) parity matrix: parity_bits = data_bits @ P (mod 2)
_P = np.array([[(int(g) >> (11 - i)) & 1 for i in range(12)] for g in GOLAY_GTAB],
              dtype=np.float32)


def _parity_word(data: int) -> int:
    p = 0
    for n in range(12):
        if data & (0x800 >> n):
            p ^= int(GOLAY_GTAB[n])
    return p


def _build_syndrome_table() -> np.ndarray:
    """[4096] int64: (nerrors << 12) | data_error_vector, by syndrome."""
    tab = np.full(0x1000, 0x4000, dtype=np.int64)  # default: 4+ errors
    for weight in range(4):
        for pos in combinations(range(24), weight):
            word = 0
            for p in pos:
                word |= 1 << p
            data_err = word >> 12
            syndrome = (word & 0xFFF) ^ _parity_word(data_err)
            tab[syndrome] = (weight << 12) | data_err
    return tab


SYNDROME_TABLE = _build_syndrome_table()


def _parity(data: torch.Tensor) -> torch.Tensor:
    """[...] int64 12-bit data -> [...] int64 12-bit parity."""
    dev = data.device
    shifts = torch.arange(11, -1, -1, device=dev)
    dbits = ((data[..., None] >> shifts) & 1).to(torch.float32)
    pbits = (dbits @ on_device(_P, dev)).to(torch.int64) % 2
    return (pbits << shifts).sum(dim=-1)


def golay_encode(data: torch.Tensor) -> torch.Tensor:
    """[...] 12-bit data words -> [...] int64 24-bit codewords."""
    data = data.to(torch.int64)
    return (data << 12) | _parity(data)


def golay_decode(word: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[...] 24-bit words -> (data [...] int64 12-bit, nerrors [...] int32).

    nerrors == 4 means uncorrectable.
    """
    word = word.to(torch.int64)
    data = (word >> 12) & 0xFFF
    syndrome = (word & 0xFFF) ^ _parity(data)
    entry = on_device(SYNDROME_TABLE, word.device)[syndrome]
    return data ^ (entry & 0xFFF), (entry >> 12).to(torch.int32)
