"""BER-vs-SNR sweep: every SNR point gets a block of channels, and the
whole sweep is one batched TX -> AWGN -> RX pass (per-channel sigma).

Port of ``m17_sdr_tpu.pipeline.ber_sweep``.  ``bert_sweep_counts``
keeps the error accounting on the device (``prbs.check_stream_device``).
The noise is ``noise`` ([B, 2, T], unit variance) or is drawn from
``generator``.  The sweep sharded over several devices, with its
counters summed across them, is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..dsp import channel
from ..spec import prbs
from ..spec.constants import BERT_BITS
from . import loopback
from . import tx as txp
from .rx import RxSessionState, rx_stream


class SweepPoint(NamedTuple):
    snr_db: float
    channels: int
    bits: int                 # PRBS9 bits counted over recovered frames
    bit_errors: int
    ber: float
    frames_sent: int
    frames_recovered: int
    frame_recovery: float


def ber_sweep(snr_points_db: Sequence[float], channels_per_point: int = 16,
              n_frames: int = 20, freq_offset_hz: float = 0.0, drift_ppm: float = 0.0,
              noise: torch.Tensor | None = None,
              generator: torch.Generator | None = None, device="cuda",
              use_kernel: bool | None = None) -> list[SweepPoint]:
    """The PRBS9 BERT loopback at every SNR point in one batch: channel c
    belongs to point c // channels_per_point."""
    points = np.asarray(list(snr_points_db), dtype=np.float32)
    cpp = int(channels_per_point)
    snr_vec = torch.as_tensor(np.repeat(points, cpp)).to(device)
    errors, counted = loopback.bert_loopback(
        len(points) * cpp, n_frames, snr_db=snr_vec, freq_offset_hz=freq_offset_hz,
        drift_ppm=drift_ppm, noise=noise, generator=generator, device=device,
        use_kernel=use_kernel)
    errors = errors.numpy().reshape(len(points), cpp)
    counted = counted.numpy().reshape(len(points), cpp)

    out: list[SweepPoint] = []
    for i, snr in enumerate(points):
        bits = int(counted[i].sum())
        errs = int(errors[i].sum())
        frames_rec = bits // BERT_BITS
        frames_sent = n_frames * cpp
        out.append(SweepPoint(
            snr_db=float(snr), channels=cpp, bits=bits, bit_errors=errs,
            ber=(errs / bits) if bits else 1.0,
            frames_sent=frames_sent, frames_recovered=frames_rec,
            frame_recovery=frames_rec / frames_sent,
        ))
    return out


def sweep_to_json(points: list[SweepPoint]) -> list[dict]:
    return [p._asdict() for p in points]


def recovery_tolerance(p: float, channels: int) -> float:
    """The allowed gap between two frame-recovery rates of one SNR point,
    each over ``channels`` channels of independent noise: 4 sigma of the
    difference, each channel's recovery a Bernoulli trial of rate p (the
    largest variance a rate in [0, 1] can have), plus 2 of the channels."""
    return 4.0 * math.sqrt(2.0 * p * (1.0 - p) / channels) + 2.0 / channels


def bert_sweep_counts(snr_vec: torch.Tensor, n_frames: int,
                      noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      use_kernel: bool | None = None):
    """The BERT sweep over one channel block, on ``snr_vec``'s device.

    snr_vec [B] dB.  Returns (errors [B], bits [B], unsynced [B],
    frames [B]) int32, all on the device.
    """
    batch = snr_vec.shape[0]
    dibits = txp.build_bert_session_dibits(batch, n_frames, device=snr_vec.device)
    iq, _ = txp.dibits_to_iq(dibits)
    iq = channel.awgn(iq, snr_vec, noise=noise, generator=generator)
    out, _ = rx_stream(loopback._blockify(iq), RxSessionState.init(batch, iq.device),
                       use_kernel=use_kernel)
    bv = out.bert_valid.reshape(batch, -1)
    bb = out.bert_bits.reshape(batch, bv.shape[1], -1)
    err, bits, uns = prbs.check_stream_device(bv, bb)
    return err, bits, uns, bv.sum(dim=-1, dtype=torch.int32)
