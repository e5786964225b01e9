"""High-rate front end: the Pluto-rate x8 decimating FIR.

Port of ``m17_sdr_tpu.dsp.resample``.  A 384 kS/s capture is filtered by
a 31-tap low-pass and kept at every 8th sample, blockwise with an
explicit [B, 2, ntaps-1] history, so that a capture split into blocks
gives exactly the output of the unsplit one.

The filter is one strided ``conv1d``.  On CUDA that goes to cuDNN, which
rounds float32 operands to TF32 by default; the call runs under a local
``cudnn.flags(allow_tf32=False)`` (``_util.no_tf32``), since the JAX
reference is float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .._util import no_tf32
from .filters import lpf_filter, normalize_gain

PLUTO_DECIMATION = 8          # 384 kS/s -> 48 kS/s
PLUTO_FIR_TAPS = 31


@functools.lru_cache(maxsize=None)
def pluto_dec_taps() -> np.ndarray:
    """The x8 decimation low-pass: 31-tap sinc at 1/8 bandwidth, unit DC
    gain (host float32)."""
    return normalize_gain(lpf_filter(1.0 / PLUTO_DECIMATION, PLUTO_FIR_TAPS))


def decimate_init(batch: int, device, ntaps: int = PLUTO_FIR_TAPS) -> torch.Tensor:
    """Zero FIR history [B, 2, ntaps-1] on ``device``."""
    return torch.zeros((batch, 2, ntaps - 1), dtype=torch.float32, device=device)


def fir_decimate(iq2: torch.Tensor, taps: np.ndarray, tail: torch.Tensor,
                 factor: int = PLUTO_DECIMATION) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, 2, T] float32 planar IQ -> ([B, 2, T // factor], new tail).

    y[m] = sum_k h[k] x[m*factor - k], with x continued into the past by
    ``tail`` (the last ntaps-1 input samples of the previous block).
    ``taps`` are host float32 (filter design is host-side).  T must be a
    multiple of ``factor``, so the comb phase carries across blocks.
    """
    t = iq2.shape[-1]
    if t % factor:
        raise ValueError(f"block length {t} is not a multiple of {factor}")
    x = torch.cat([tail, iq2], dim=-1)                  # [B, 2, T+ntaps-1]
    # conv1d correlates: output m reads x[m*factor + j] with weight[j],
    # which is tap h[ntaps-1-j]
    w = torch.as_tensor(np.ascontiguousarray(taps[::-1]), dtype=torch.float32,
                        device=x.device).view(1, 1, -1)
    with no_tf32():
        y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), w, stride=factor)
    return y.view(*x.shape[:-1], t // factor), x[..., t:]


def decimate_pluto(iq2: torch.Tensor, tail: torch.Tensor,
                   factor: int = PLUTO_DECIMATION):
    """The x8 path with the standard taps."""
    return fir_decimate(iq2, pluto_dec_taps(), tail, factor)
