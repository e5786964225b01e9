"""M17 puncturing (P1/P2/P3) as static gathers, and de-puncturing, which
re-inserts 0.0 soft-bit erasures.  The mask is tiled over the coded
length and cut, so a length that is not a multiple of the period (the
BERT frame's 402 bits under P2) keeps the mask's leading part."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._util import on_device

P1 = np.array(
    [1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1,
     1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1,
     0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1],
    dtype=np.int8,
)
P2 = np.array([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0], dtype=np.int8)
P3 = np.array([1, 1, 1, 1, 1, 1, 1, 0], dtype=np.int8)

_SCHEMES = {"p1": P1, "p2": P2, "p3": P3}


@functools.lru_cache(maxsize=None)
def _indices(scheme: str, coded_len: int) -> np.ndarray:
    """Positions, in the unpunctured stream, of the kept bits."""
    mask = _SCHEMES[scheme]
    full = np.tile(mask, coded_len // len(mask) + 1)[:coded_len]
    return np.nonzero(full)[0].astype(np.int64)


def puncture(x: torch.Tensor, scheme: str) -> torch.Tensor:
    """Drop the masked bits of [..., coded_len] (hard or soft bits)."""
    return x[..., on_device(_indices(scheme, x.shape[-1]), x.device)]


def depuncture(x: torch.Tensor, scheme: str, coded_len: int) -> torch.Tensor:
    """[..., kept] soft bits -> [..., coded_len] with 0.0 at punctured bits."""
    idx = on_device(_indices(scheme, coded_len), x.device)
    out = x.new_zeros((*x.shape[:-1], coded_len))
    out[..., idx] = x
    return out
