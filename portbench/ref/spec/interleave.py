"""M17 quadratic interleaver on 368 bits: pi(i) = (45 i + 92 i^2) mod 368.

pi is an involution, so one gather serves both directions.
"""

from __future__ import annotations

import numpy as np
import torch

from .._util import on_device
from .constants import PAYLOAD_SOFT_BITS

_i = np.arange(PAYLOAD_SOFT_BITS, dtype=np.int64)
INTERLEAVE_PERM = (45 * _i + 92 * _i * _i) % PAYLOAD_SOFT_BITS

if not np.array_equal(INTERLEAVE_PERM[INTERLEAVE_PERM], _i):
    raise AssertionError("the interleave permutation must be an involution")


def interleave(x: torch.Tensor) -> torch.Tensor:
    """Apply pi to the last axis (length 368)."""
    return x[..., on_device(INTERLEAVE_PERM, x.device)]


deinterleave = interleave
