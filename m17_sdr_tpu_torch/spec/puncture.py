"""M17 de-puncturing (P1/P2/P3): re-insert 0.0 soft-bit erasures."""

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


def depuncture(x: torch.Tensor, scheme: str, coded_len: int) -> torch.Tensor:
    """[..., kept] soft bits -> [..., coded_len] with 0.0 at punctured bits."""
    idx = on_device(_indices(scheme, coded_len), x.device)
    out = x.new_zeros((*x.shape[:-1], coded_len))
    out[..., idx] = x
    return out
