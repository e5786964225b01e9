"""Sync-word correlation and lock gating, batched.

``sync_check`` takes the correlation against each of the six patterns as
an ordered sum over the 8 symbols (not a matmul), so that the receiver
scan kernel (``csrc/receiver_scan.cu``), which sums in the same order,
reaches the same decisions bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._util import on_device
from ..spec.constants import (
    FT_BERT,
    FT_LINK,
    LOCKED_MAX_VARIANCE,
    LOCKED_MAX_VOTES,
    SYNC_PATTERNS,
    SYNC_SYMBOLS,
    UNLOCKED_MAX_VARIANCE,
    UNLOCKED_MAX_VOTES,
)


class SyncCheck(NamedTuple):
    ftype: torch.Tensor     # [B] best-matching frame type (0..5), int32
    votes: torch.Tensor     # [B] count of disagreeing symbols, int32
    variance: torch.Tensor  # [B] magnitude spread of the 8 sync symbols


def sync_check(vect: torch.Tensor) -> SyncCheck:
    """Correlate [B, 8] symbols against the 6 sync patterns.

    The winner is the first largest strictly-positive correlation (type 0
    when none is positive); votes counts the symbols whose sign disagrees
    with the winner's pattern; variance is (max|s| - min|s|) / max|s|, or
    1 when all are zero.
    """
    pats = on_device(SYNC_PATTERNS, vect.device)          # [6, 8]
    s = torch.sign(vect)
    sums = vect[:, 0, None] * pats[:, 0]
    agree = s[:, 0, None] * pats[:, 0]
    for i in range(1, SYNC_SYMBOLS):
        sums = sums + vect[:, i, None] * pats[:, i]
        agree = agree + s[:, i, None] * pats[:, i]
    best = sums.argmax(dim=-1)              # first index of the maximum
    ftype = torch.where(sums.amax(dim=-1) > 0, best, 0).to(torch.int32)

    nnz = s.abs().sum(dim=-1)
    agree_best = torch.gather(agree, -1, ftype[:, None].to(torch.int64))[:, 0]
    votes = ((nnz - agree_best) * 0.5).to(torch.int32)

    mags = vect.abs()
    mmax = mags.amax(dim=-1)
    mmin = mags.amin(dim=-1)
    variance = torch.where(mmax > 0, (mmax - mmin) / torch.clamp(mmax, min=1e-30),
                           torch.ones_like(mmax))
    return SyncCheck(ftype=ftype, votes=votes, variance=variance)


def _is_payload_type(ftype: torch.Tensor) -> torch.Tensor:
    return (ftype >= FT_LINK) & (ftype <= FT_BERT)


def unlocked_pass(s: SyncCheck) -> torch.Tensor:
    """Acquisition gate."""
    return ((s.votes <= UNLOCKED_MAX_VOTES) & _is_payload_type(s.ftype)
            & (s.variance < UNLOCKED_MAX_VARIANCE))


def locked_pass(s: SyncCheck) -> torch.Tensor:
    """Tracking gate."""
    return ((s.votes <= LOCKED_MAX_VOTES) & _is_payload_type(s.ftype)
            & (s.variance < LOCKED_MAX_VARIANCE))
