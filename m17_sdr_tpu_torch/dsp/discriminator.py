"""Receive front end: RSSI/AGC, AFC mixer, limiter, FM discriminator,
DC removal and decimation by 5, for a [B, 2, T] block.

Port of ``m17_sdr_tpu.dsp.discriminator``; see that module for the
reasons behind the DC and AFC schemes.  Everything is elementwise over
the block; the carry is a 2-sample discriminator tail, the AFC NCO
phase and frequency estimate, the RSSI/AGC meter and the DC estimate.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..spec.constants import RX_DECIMATION
from . import iq as iqmod

AFC_LOOP_GAIN = 0.1
DC_SMOOTH_GAIN = 0.25
RSSI_SMOOTH = 0.9
AGC_LOW, AGC_HIGH = 0.25, 0.75
AGC_STEP = 1.05
AGC_GAIN_MIN, AGC_GAIN_MAX = 1.0 / 64.0, 64.0


class RxFrontEndState(NamedTuple):
    """Per-channel front-end carry."""

    disc_tail: torch.Tensor   # [B, 2, 2] planar: z[n-2], z[n-1]
    nco_phase: torch.Tensor   # [B] AFC mixer phase accumulator
    afc_delta: torch.Tensor   # [B] AFC frequency estimate (rad/sample)
    rssi: torch.Tensor        # [B] smoothed signal level
    agc_gain: torch.Tensor    # [B] software AGC gain recommendation
    dc_est: torch.Tensor      # [B] smoothed discriminator DC estimate
    dc_seeded: torch.Tensor   # [B] bool: dc_est holds a measurement

    @staticmethod
    def init(batch: int, device) -> "RxFrontEndState":
        f32 = dict(dtype=torch.float32, device=device)
        return RxFrontEndState(
            disc_tail=torch.zeros((batch, 2, 2), **f32),
            nco_phase=torch.zeros((batch,), **f32),
            afc_delta=torch.zeros((batch,), **f32),
            rssi=torch.zeros((batch,), **f32),
            agc_gain=torch.ones((batch,), **f32),
            dc_est=torch.zeros((batch,), **f32),
            dc_seeded=torch.zeros((batch,), dtype=torch.bool, device=device),
        )


def limit(iq2: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-magnitude hard limiter."""
    mag = torch.clamp(iqmod.magnitude(iq2), min=eps)
    return iq2 / mag[..., None, :]


def nco_mix(iq2: torch.Tensor, phase0: torch.Tensor, delta: torch.Tensor):
    """Rotate [B, 2, T] IQ by a per-channel linear phase ramp.

    Returns (mixed, final phase wrapped to [0, 2 pi))."""
    t = torch.arange(iq2.shape[-1], dtype=torch.float32, device=iq2.device)
    phase = phase0[:, None] + delta[:, None] * t
    mixed = iqmod.rotate(iq2, torch.cos(phase), torch.sin(phase))
    end = torch.remainder(phase0 + delta * iq2.shape[-1], 2.0 * math.pi)
    end = torch.where(torch.isnan(end), torch.zeros_like(end), end)  # NaN scrub
    return mixed, end


def scale_int16(wire: torch.Tensor) -> torch.Tensor:
    """int16 interleaved IQ [..., T, 2] -> planar float32 [..., 2, T],
    scaled by 3e-5 as ``rx_front_end`` scales int16 input."""
    return (wire.to(torch.float32) * 3.0e-5).movedim(-1, -2)


def rx_front_end(
    iq2: torch.Tensor,
    state: RxFrontEndState,
    in_frame: torch.Tensor,
    afc_enabled: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, RxFrontEndState]:
    """Front end for one [B, 2, T] block (T % 5 == 0), int16 or float32.

    Returns (soft samples [B, T//5] at 2 samples/symbol, DC offset [B],
    new state).  ``in_frame`` [B] bool gates the AFC integrator, which
    resets out of frame; with AFC off the estimate is dropped.
    """
    t = iq2.shape[-1]
    if t % RX_DECIMATION:
        raise ValueError(f"block length {t} is not a multiple of {RX_DECIMATION}")
    if iq2.dtype == torch.int16:
        iq2 = iq2.to(torch.float32) * 3.0e-5

    level = iqmod.magnitude(iq2).mean(dim=-1)
    rssi = torch.where(state.rssi > 0.0,
                       RSSI_SMOOTH * state.rssi + (1.0 - RSSI_SMOOTH) * level,
                       level)
    agc = torch.where(rssi < AGC_LOW, state.agc_gain * AGC_STEP,
                      torch.where(rssi > AGC_HIGH,
                                  state.agc_gain / AGC_STEP, state.agc_gain))
    agc = torch.clamp(agc, AGC_GAIN_MIN, AGC_GAIN_MAX)

    zero = torch.zeros_like(state.afc_delta)
    if afc_enabled:
        delta = torch.where(in_frame, state.afc_delta, zero)
        iq2, nco_phase = nco_mix(iq2, state.nco_phase, delta)
    else:
        nco_phase = state.nco_phase

    z = limit(iq2)
    zh = torch.cat([state.disc_tail, z], dim=-1)   # [B, 2, T+2]
    z0 = zh[..., 1:-1]   # z[n-1]
    z1 = zh[..., :-2]    # z[n-2]
    u = (iqmod.conj_mul_im(z0, z) + iqmod.conj_mul_im(z1, z0)) * 0.5

    offset = u.mean(dim=-1)

    # unlocked: subtract the block mean and reseed; locked: subtract the
    # carried estimate and update it slowly
    held = in_frame & state.dc_seeded
    dc_used = torch.where(held, state.dc_est, offset)
    dc_est = torch.where(held, state.dc_est + DC_SMOOTH_GAIN * (offset - state.dc_est),
                         offset)

    dec = u[:, RX_DECIMATION - 1::RX_DECIMATION] - dc_used[:, None]

    if afc_enabled:
        afc_delta = torch.where(in_frame, state.afc_delta - offset * AFC_LOOP_GAIN, zero)
        dc_est = dc_est + torch.where(in_frame, afc_delta - state.afc_delta, zero)
    else:
        afc_delta = zero

    new_state = RxFrontEndState(
        disc_tail=z[..., -2:], nco_phase=nco_phase, afc_delta=afc_delta,
        rssi=rssi, agc_gain=agc,
        dc_est=dc_est, dc_seeded=torch.ones_like(state.dc_seeded),
    )
    return dec, offset, new_state
