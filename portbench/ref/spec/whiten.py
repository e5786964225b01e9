"""M17 de-correlator on 368 bits: hard bits are XORed with the whitening
sequence, soft bits sign-flipped where it has a 1."""

from __future__ import annotations

import numpy as np
import torch

from .._util import on_device

WHITEN_BYTES = np.array(
    [0xD6, 0xB5, 0xE2, 0x30, 0x82, 0xFF, 0x84, 0x62, 0xBA, 0x4E,
     0x96, 0x90, 0xD8, 0x98, 0xDD, 0x5D, 0x0C, 0xC8, 0x52, 0x43,
     0x91, 0x1D, 0xF8, 0x6E, 0x68, 0x2F, 0x35, 0xDA, 0x14, 0xEA,
     0xCD, 0x76, 0x19, 0x8D, 0xD5, 0x80, 0xD1, 0x33, 0x87, 0x13,
     0x57, 0x18, 0x2D, 0x29, 0x78, 0xC3],
    dtype=np.uint8,
)

WHITEN_BITS = np.unpackbits(WHITEN_BYTES).astype(np.uint8)          # [368]
WHITEN_SIGNS = np.where(WHITEN_BITS == 1, -1.0, 1.0).astype(np.float32)


def whiten_bits(x: torch.Tensor) -> torch.Tensor:
    """XOR hard bits [..., 368] with the whitening sequence (its own inverse)."""
    return x ^ on_device(WHITEN_BITS, x.device).to(x.dtype)


def whiten_soft(x: torch.Tensor) -> torch.Tensor:
    """Sign-flip soft bits [..., 368] where the sequence bit is 1."""
    return x * on_device(WHITEN_SIGNS, x.device)
