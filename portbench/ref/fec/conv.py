"""M17 convolutional code: K=5, rate 1/2, 16 states.

The encoder register takes the new bit at position 4 and shifts right
(state' = (state >> 1) | (bit << 3)); the generators are
G1 = 0b10011 and G2 = 0b11101.  The trellis tables below drive the
Viterbi decoder; ``csrc/viterbi.cu`` derives the same tables from the
same generators at compile time.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._util import on_device
from ..spec import bits as bitpack

NUM_STATES = 16
TAIL_BITS = 4
G1_TAPS = 0b10011
G2_TAPS = 0b11101


def _parity5(x: int) -> int:
    return bin(x & 0x1F).count("1") & 1


# for the 5-bit register value (new bit at bit 4): the two coded bits
CLUT = np.array(
    [[_parity5(sr & G1_TAPS), _parity5(sr & G2_TAPS)] for sr in range(32)],
    dtype=np.int8,
)


def _trellis_tables():
    """Per next state v: predecessors w0 = (v & 7) << 1 and w1 = w0 + 1,
    input bit b = v >> 3, and branch dibit CLUT[w | b << 4] of each."""
    prev0 = np.zeros(NUM_STATES, dtype=np.int64)
    prev1 = np.zeros(NUM_STATES, dtype=np.int64)
    dibit0 = np.zeros(NUM_STATES, dtype=np.int64)
    dibit1 = np.zeros(NUM_STATES, dtype=np.int64)
    for v in range(NUM_STATES):
        b = v >> 3
        w0 = (v & 7) << 1
        w1 = w0 + 1
        prev0[v], prev1[v] = w0, w1
        dibit0[v] = (CLUT[w0 | (b << 4)][0] << 1) | CLUT[w0 | (b << 4)][1]
        dibit1[v] = (CLUT[w1 | (b << 4)][0] << 1) | CLUT[w1 | (b << 4)][1]
    return prev0, prev1, dibit0, dibit1


PREV0, PREV1, DIBIT0, DIBIT1 = _trellis_tables()


@functools.lru_cache(maxsize=None)
def _encode_matrix(nbits: int) -> np.ndarray:
    """[nbits, 2*(nbits+4)] GF(2) generator matrix of a terminated frame."""
    total = nbits + TAIL_BITS
    m = np.zeros((nbits, 2 * total), dtype=np.float32)
    g1_lags = [4 - p for p in range(5) if (G1_TAPS >> p) & 1]
    g2_lags = [4 - p for p in range(5) if (G2_TAPS >> p) & 1]
    for t in range(total):
        for lag in g1_lags:
            if 0 <= t - lag < nbits:
                m[t - lag, 2 * t] = 1 - m[t - lag, 2 * t]
        for lag in g2_lags:
            if 0 <= t - lag < nbits:
                m[t - lag, 2 * t + 1] = 1 - m[t - lag, 2 * t + 1]
    return m


def conv_encode_bits(bits: torch.Tensor) -> torch.Tensor:
    """Encode [..., N] hard bits -> [..., 2*(N+4)] coded bits (uint8),
    appending the 4-bit zero tail."""
    m = on_device(_encode_matrix(bits.shape[-1]), bits.device)
    return ((bits.to(torch.float32) @ m).to(torch.int64) % 2).to(torch.uint8)


def conv_encode_bytes(data: torch.Tensor) -> torch.Tensor:
    """Encode [..., N] bytes (MSB first) -> [..., 2*(8N+4)] coded bits."""
    return conv_encode_bits(bitpack.bytes_to_bits(data))
