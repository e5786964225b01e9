"""Dormant alternate RX front ends: the PLL FM discriminator and the
half-band filter.

Port of ``m17_sdr_tpu.dsp.pll``.  The reference compiles both but never
selects them (``dsp_pll_disc``, m17_dsp.cpp:226-291, and
``m17_halfband_filter``, m17_dsp.cpp:319-343).  The PLL is a true
per-sample feedback loop: each sample is rotated by the NCO phase ``z``,
``val = Re + Im`` of the rotated sample is both the output and the NCO's
drive (``z += val * K``).  Here it is a loop over time of batched torch
ops with ``z`` as the per-channel carry, as the JAX package's
``lax.scan`` is.  The half-band filter is one ``conv1d``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .._util import no_tf32
from ..spec.constants import RX_DECIMATION

# m17_dsp.cpp:20 -- loop gain of the fcmplx overload (260-291), applied
# directly to the phase accumulator at int16 sample scale
PLL_LOOP_GAIN = 3.0e-8


class PllState(NamedTuple):
    """Per-channel PLL carry: the NCO phase accumulator (radians)."""

    z: torch.Tensor  # [B] float32

    @staticmethod
    def init(batch: int, device) -> "PllState":
        return PllState(z=torch.zeros((batch,), dtype=torch.float32, device=device))


def pll_disc(iq2: torch.Tensor, state: PllState, k: float = PLL_LOOP_GAIN,
             decimation: int = RX_DECIMATION) -> tuple[torch.Tensor, torch.Tensor, PllState]:
    """Batched PLL FM discriminator (m17_dsp.cpp:260-291).

    iq2: planar [B, 2, T].  Returns (disc [B, T // decimation], dc_offset
    [B], new state).  The output keeps sample indices i % decimation ==
    decimation - 1 (the reference's count-then-test order), less the
    undecimated block mean, which is also returned as the DC/AFC
    measurement.  The reference carries its decimation phase across calls
    in a static counter; this function restarts it each block, so T must
    be a multiple of ``decimation`` for the two to agree.
    """
    t = iq2.shape[-1]
    assert t % decimation == 0, (
        f"pll_disc needs block length % {decimation} == 0 to match the "
        f"reference's carried decimation phase (got {t})")
    x0 = iq2[:, 0].t().contiguous()           # [T, B]
    x1 = iq2[:, 1].t().contiguous()
    z = state.z
    vals = []
    for i in range(t):
        cv, sv = torch.cos(z), torch.sin(z)
        val = (cv * x0[i] - sv * x1[i]) + (cv * x1[i] + sv * x0[i])
        z = z + val * k
        vals.append(val)
    vals = torch.stack(vals, dim=1)           # [B, T]
    dc = vals.mean(dim=-1)
    out = vals[:, decimation - 1::decimation] - dc[:, None]
    # the phase wrap (modf, m17_dsp.cpp:280-283) keeps z finite
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=z.device)
    z = z - two_pi * torch.trunc(z / two_pi)
    return out, dc, PllState(z=z)


def expand_halfband(compact: np.ndarray, flen: int) -> np.ndarray:
    """Compact half-band weights -> the full flen-tap kernel (host float32).

    ``compact[0]`` is the centre tap; ``compact[j]`` (j >= 1) sits at
    offsets +/-(2j-1) from the centre; every even offset is zero.  Only
    in-window entries are accepted: the reference's loop reads entries
    whose offsets fall outside the centred window, which is not
    reproduced (the centre tap plus the odd offsets <= flen // 2: 17
    entries for flen = 63).
    """
    assert flen % 2 == 1
    max_entries = (flen // 2 + 1) // 2 + 1
    assert len(compact) <= max_entries, (
        f"{len(compact)} compact half-band entries exceed the centered "
        f"{flen}-tap window (max {max_entries}); the reference's loop "
        "indexes outside the window there, which is not reproduced")
    h = np.zeros(flen, dtype=np.float32)
    c = flen // 2
    h[c] = compact[0]
    for j in range(1, len(compact)):
        off = 2 * j - 1
        h[c + off] = compact[j]
        h[c - off] = compact[j]
    return h


def design_halfband(flen: int = 63) -> np.ndarray:
    """Windowed-sinc half-band low-pass (cutoff fs/4) as int16-scaled
    compact weights, the shape m17_dsp.cpp's HB_FN=63 path expects."""
    assert flen % 2 == 1
    n = np.arange(flen) - flen // 2
    with np.errstate(invalid="ignore"):
        sinc = np.where(n == 0, 0.5, np.sin(np.pi * n / 2) / (np.pi * n))
    h = sinc * np.hamming(flen)
    h = h / h.sum()
    compact = [h[flen // 2]]
    off = 1
    while flen // 2 + off < flen:
        compact.append(h[flen // 2 + off])
        off += 2
    return np.round(np.asarray(compact) * 32768.0).astype(np.int16)


def halfband_filter(iq2: torch.Tensor, compact: np.ndarray, flen: int = 63) -> torch.Tensor:
    """Batched half-band FIR (m17_halfband_filter, m17_dsp.cpp:319-343).

    iq2: planar int16-valued [B, 2, T] float32.  Valid correlation:
    output length T - flen + 1, ``out[i] = floor(sum_j in[i+j] h[j] /
    32768)``, the reference's int32 accumulate and >> 15.  The float32
    accumulation can differ from the exact integer sum by one LSB where a
    sum exceeds float32's 24-bit mantissa, as in the JAX package.  On
    CUDA the ``conv1d`` runs without TF32.
    """
    h = torch.as_tensor(expand_halfband(np.asarray(compact, np.float32), flen),
                        device=iq2.device).view(1, 1, -1)
    b, _, t = iq2.shape
    with no_tf32():
        y = F.conv1d(iq2.reshape(b * 2, 1, t), h)
    return torch.floor(y / 32768.0).reshape(b, 2, t - flen + 1)
