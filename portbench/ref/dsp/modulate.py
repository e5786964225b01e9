"""TX modulator: dibits -> RRC-shaped 4FSK planar IQ, batched over channels.

Port of ``m17_sdr_tpu.dsp.modulate``:

  dibits [B, N] --lookup--> phase increments [B, N]
         --31-tap windows @ polyphase bank--> shaped increments [B, N*os]
         --carry + cumsum--> phase [B, N*os] --cos/sin--> IQ [B, 2, N*os]

The phase is float32 throughout, as in the JAX package.  The carry
between calls (the 30-symbol filter tail and the NCO phase) makes a
transmission streamed in chunks equal to one built in one call.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .._util import on_device
from ..spec.constants import DIBIT_TO_PHASE_INC, SAMPLES_PER_SYMBOL, TX_FILTER_TAPS
from . import iq as iqmod
from .filters import tx_rrc_polyphase

# the most elements of the window copy that one matmul makes (256 MB)
_WINDOW_ELEMENTS = 1 << 26


class ModState(NamedTuple):
    """Per-channel modulator carry."""

    filter_tail: torch.Tensor  # [B, TX_FILTER_TAPS-1] f32 trailing phase increments
    phase: torch.Tensor        # [B] f32 NCO phase (radians, in [0, 2 pi))

    @staticmethod
    def init(batch: int, device) -> "ModState":
        return ModState(
            filter_tail=torch.zeros((batch, TX_FILTER_TAPS - 1), dtype=torch.float32,
                                    device=device),
            phase=torch.zeros((batch,), dtype=torch.float32, device=device),
        )


@functools.lru_cache(maxsize=None)
def _bank(oversample: int):
    return tx_rrc_polyphase(oversample)


def _shape_and_rotate(inc: torch.Tensor, state: ModState, oversample: int):
    """Phase increments [B, N] -> (IQ [B, 2, N*os], new state)."""
    b, n = inc.shape
    bank = on_device(_bank(oversample), inc.device)                 # [31, os]
    hist = torch.cat([state.filter_tail, inc], dim=-1)              # [B, N+30]
    # windows[b, t, j] = hist[b, t + j]: an unfold view; the matmul copies
    # it, so it goes in channel chunks to bound that copy
    windows = hist.unfold(-1, TX_FILTER_TAPS, 1)                    # [B, N, 31]
    rows = max(1, _WINDOW_ELEMENTS // (n * TX_FILTER_TAPS))
    shaped = torch.cat([w @ bank for w in windows.split(rows)])     # [B, N, os]
    phase = state.phase[:, None] + torch.cumsum(shaped.reshape(b, n * oversample), dim=-1)
    new_state = ModState(filter_tail=hist[:, -(TX_FILTER_TAPS - 1):],
                         phase=torch.remainder(phase[:, -1], 2.0 * math.pi))
    return iqmod.from_phase(phase), new_state


def modulate_dibits(dibits: torch.Tensor, state: ModState,
                    oversample: int = SAMPLES_PER_SYMBOL):
    """Modulate [B, N] dibits -> ([B, 2, N*oversample] planar IQ, new state).

    At oversample other than 10 the per-sample phase step shrinks, so the
    deviation stays +-800/+-2400 Hz.
    """
    scale = SAMPLES_PER_SYMBOL / oversample
    inc = on_device(DIBIT_TO_PHASE_INC, dibits.device)[dibits.to(torch.int64)] * scale
    return _shape_and_rotate(inc, state, oversample)
