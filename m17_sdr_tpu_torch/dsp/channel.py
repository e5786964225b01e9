"""Channel impairments for loopback tests and BER sweeps, on planar IQ
[B, 2, T], batched per channel.

Port of ``m17_sdr_tpu.dsp.channel``.  The products are written in the
JAX order, so that positions and phases round alike.  The noise
functions draw from an explicit ``torch.Generator`` or take the noise
as a tensor (to replay another package's draws, or ``keyed_noise``'s
per-channel draws); none draws from a global generator.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..spec.constants import SAMPLE_RATE, SAMPLES_PER_SYMBOL
from . import iq as iqmod


def _per_channel(x, device) -> torch.Tensor:
    """Scalar or [B] parameter -> float32 [B'] (B' = 1 for a scalar)."""
    return torch.atleast_1d(torch.as_tensor(x, dtype=torch.float32, device=device))


def _sigma(snr_db, device) -> torch.Tensor:
    """Noise sigma per real component for signal power 1 at snr_db."""
    snr = 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32, device=device) / 10.0)
    return torch.sqrt(1.0 / (2.0 * snr))


def _noise(shape, like: torch.Tensor, noise, generator) -> torch.Tensor:
    if (noise is None) == (generator is None):
        raise ValueError("pass exactly one of noise and generator")
    if noise is None:
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=like.device)
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise shape {tuple(noise.shape)} != {tuple(shape)}")
    return noise.to(like.device)


def keyed_noise(shape, seed: int, first_channel: int, device) -> torch.Tensor:
    """Unit-variance noise [B, ...] whose row c depends only on ``seed`` and
    the global channel index ``first_channel + c``, as the JAX package keys
    each channel: row c is drawn from its own generator, seeded with a hash
    of (seed, channel) (numpy's ``SeedSequence``; the CPU generator keeps
    its low 32 bits).  So any split of a batch over ranks draws the same
    noise for each channel.  ``seed`` must be non-negative."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    for c in range(shape[0]):
        key = np.random.SeedSequence([seed, first_channel + c]).generate_state(1, np.uint64)
        gen.manual_seed(int(key[0]))
        torch.randn(shape[1:], generator=gen, out=out[c])
    return out


def awgn(iq2: torch.Tensor, snr_db, noise: torch.Tensor | None = None,
         generator: torch.Generator | None = None) -> torch.Tensor:
    """Add complex white Gaussian noise at per-channel SNR (dB), signal
    power 1.  ``snr_db`` is a scalar or [B]; the unit-variance noise is
    ``noise`` (shaped as iq2) or drawn from ``generator``."""
    sigma = _sigma(snr_db, iq2.device)
    while sigma.dim() < iq2.dim():
        sigma = sigma[..., None]
    return iq2 + _noise(iq2.shape, iq2, noise, generator) * sigma


def carrier_offset(iq2: torch.Tensor, freq_hz, sample_rate: int = SAMPLE_RATE,
                   phase0=0.0) -> torch.Tensor:
    """Rotate by a per-channel carrier frequency offset (Hz)."""
    freq = _per_channel(freq_hz, iq2.device)
    t = torch.arange(iq2.shape[-1], dtype=torch.float32, device=iq2.device)
    ph = 2.0 * math.pi * freq[:, None] * t / sample_rate + phase0
    return iqmod.rotate(iq2, torch.cos(ph), torch.sin(ph))


def carrier_ramp(iq2: torch.Tensor, rate_hz_per_s, start_hz=0.0,
                 sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """Linearly drifting carrier offset: phase 2 pi (f0 t + rate t^2 / 2)."""
    rate = _per_channel(rate_hz_per_s, iq2.device)
    f0 = _per_channel(start_hz, iq2.device)
    t = torch.arange(iq2.shape[-1], dtype=torch.float32, device=iq2.device) / sample_rate
    ph = 2.0 * math.pi * (f0[:, None] * t + 0.5 * rate[:, None] * t * t)
    return iqmod.rotate(iq2, torch.cos(ph), torch.sin(ph))


def timing_drift(iq2: torch.Tensor, ppm, offset_samples=0.0) -> torch.Tensor:
    """Linear-interpolation resampler: output n reads input position
    n*(1+ppm*1e-6) + offset (a static offset plus linear clock drift).

    Positions are clipped to n - 1.001, which float32 rounds to n - 1 once
    T reaches 2^15; there the upper neighbour is the last sample (frac is
    0, so the output is that sample), where the JAX function's gather
    reads past the end and fills NaN."""
    dev = iq2.device
    ppm = _per_channel(ppm, dev)
    off = _per_channel(offset_samples, dev)
    n = iq2.shape[-1]
    pos = torch.arange(n, dtype=torch.float32, device=dev)[None, :] \
        * (1.0 + ppm[:, None] * 1e-6) + off[:, None]
    pos = torch.clamp(pos, 0.0, n - 1.001)
    i0 = torch.floor(pos).to(torch.int64)
    frac = pos - i0.to(torch.float32)
    i0b = i0[:, None, :].expand(iq2.shape)
    x0 = torch.gather(iq2, -1, i0b)
    x1 = torch.gather(iq2, -1, torch.clamp(i0b + 1, max=n - 1))
    return x0 + (x1 - x0) * frac[:, None, :]


def symbol_rate_awgn(samples: torch.Tensor, snr_db, noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None,
                     sps: int = SAMPLES_PER_SYMBOL) -> torch.Tensor:
    """AWGN added to real baseband samples [B, N] (the digital
    2-samples/symbol loopback), sigma set so snr_db is Es/N0 for
    unit-amplitude symbols."""
    sigma = _sigma(snr_db, samples.device)
    if sigma.dim() == 1:
        sigma = sigma[:, None]
    return samples + _noise(samples.shape, samples, noise, generator) * sigma
