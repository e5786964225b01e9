"""Bit/byte packing over the trailing axis, MSB first.

Words up to 32 bits are carried in int64: torch has no full uint32
arithmetic, and int64 holds every uint32 value.
"""

from __future__ import annotations

import numpy as np
import torch


def _shifts(n: int, device) -> torch.Tensor:
    return torch.arange(n - 1, -1, -1, device=device)


def bytes_to_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., N] uint8 -> [..., 8N] bits (0/1, uint8), MSB first."""
    b = (x[..., :, None].to(torch.int32) >> _shifts(8, x.device).to(torch.int32)) & 1
    return b.reshape(*x.shape[:-1], x.shape[-1] * 8).to(torch.uint8)


def bits_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """[..., 8N] bits -> [..., N] uint8, MSB first."""
    n = x.shape[-1] // 8
    b = x.reshape(*x.shape[:-1], n, 8).to(torch.int32)
    return (b << _shifts(8, x.device).to(torch.int32)).sum(dim=-1).to(torch.uint8)


def bits_to_dibits(x: torch.Tensor) -> torch.Tensor:
    """[..., 2N] bits -> [..., N] dibits (uint8), the first bit the MSB."""
    b = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2).to(torch.int32)
    return ((b[..., 0] << 1) | b[..., 1]).to(torch.uint8)


def dibits_to_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., N] dibits -> [..., 2N] bits (uint8)."""
    b = torch.stack([(x >> 1) & 1, x & 1], dim=-1)
    return b.reshape(*x.shape[:-1], x.shape[-1] * 2).to(torch.uint8)


def bytes_to_dibits(x: torch.Tensor) -> torch.Tensor:
    """[..., N] uint8 -> [..., 4N] dibits, the most significant pair first."""
    shifts = (_shifts(4, x.device) * 2).to(torch.int32)
    d = (x[..., :, None].to(torch.int32) >> shifts) & 0x3
    return d.reshape(*x.shape[:-1], x.shape[-1] * 4).to(torch.uint8)


def word_to_bytes(word, nbytes: int) -> np.ndarray:
    """Big-endian split of integer word(s) into nbytes bytes, on the host
    (numpy): 48-bit addresses need all 64 bits."""
    word = np.asarray(word, dtype=np.uint64)
    shifts = np.arange(nbytes - 1, -1, -1, dtype=np.uint64) * np.uint64(8)
    return ((word[..., None] >> shifts) & np.uint64(0xFF)).astype(np.uint8)


def bytes_to_word_host(x) -> np.ndarray:
    """Big-endian combine of [..., N] bytes into an integer word, on the
    host (numpy uint64): 48-bit addresses need more than 32 bits."""
    x = np.asarray(x)
    shifts = np.arange(x.shape[-1] - 1, -1, -1, dtype=np.uint64) * np.uint64(8)
    return np.sum(x.astype(np.uint64) << shifts, axis=-1)


def word_to_bytes_device(word: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Big-endian split of [...] words up to 32 bits -> [..., nbytes] uint8."""
    shifts = _shifts(nbytes, word.device) * 8
    return ((word[..., None].to(torch.int64) >> shifts) & 0xFF).to(torch.uint8)


def bytes_to_word(x: torch.Tensor) -> torch.Tensor:
    """Big-endian combine of [..., N] bytes (N <= 4) -> int64 word."""
    n = x.shape[-1]
    return (x.to(torch.int64) << (_shifts(n, x.device) * 8)).sum(dim=-1)


def bytes_to_u12x4(x: torch.Tensor) -> torch.Tensor:
    """[..., 6] bytes -> [..., 4] 12-bit words (int64; LICH chunk partition)."""
    x = x.to(torch.int64)
    return torch.stack(
        [
            (x[..., 0] << 4) | (x[..., 1] >> 4),
            ((x[..., 1] & 0xF) << 8) | x[..., 2],
            (x[..., 3] << 4) | (x[..., 4] >> 4),
            ((x[..., 4] & 0xF) << 8) | x[..., 5],
        ],
        dim=-1,
    )


def u12x4_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """[..., 4] 12-bit words -> [..., 6] bytes (LICH chunk partition)."""
    x = x.to(torch.int64)
    out = torch.stack(
        [
            x[..., 0] >> 4,
            ((x[..., 0] & 0xF) << 4) | (x[..., 1] >> 8),
            x[..., 1] & 0xFF,
            x[..., 2] >> 4,
            ((x[..., 2] & 0xF) << 4) | (x[..., 3] >> 8),
            x[..., 3] & 0xFF,
        ],
        dim=-1,
    )
    return out.to(torch.uint8)


def hard_decision_word(soft: torch.Tensor) -> torch.Tensor:
    """[..., N] soft bits -> int64 word, MSB first; >= 0 decodes as 1."""
    bits = (soft >= 0).to(torch.int64)
    return (bits << _shifts(soft.shape[-1], soft.device)).sum(dim=-1)
