"""Signal ``isi``: the ``voice`` recipe through a two-ray multipath channel
at 48 kS/s.

The ``sessions`` voice sessions of ``voice`` (the same payloads and
rotations for a seed), each cut to whole blocks, are smeared before the
channels' rotation: a session's instantaneous frequency, the angle of
x[n] conj(x[n-1]), gains echoes of gains 0.6 and 0.3 at 5 and 10 samples
(half a symbol and one), which ramp in linearly from 0 at 35 % of the
session to full strength at 50 % (``tools/quality_gate.py``'s
``isi_2ray``, there applied to the soft samples), so that the receiver
acquires clean and the ISI reaches established sessions.  The phase is
integrated again in float64, written as cos/sin and quantized as
``voice`` does.  Every channel is impaired; no noise is added.  The
receiver's discriminator hands the echoes to its frame equalizer through
the normal IQ path.
"""

from __future__ import annotations

import torch

from portbench.signals import generator, quantize
from portbench.signals.voice import RATE, voice_sessions

ECHOES = ((5, 0.6), (10, 0.3))      # (lag in samples, gain)
RAMP = (0.35, 0.50)                 # shares of the session: echoes from 0 to full


def smear(iq: torch.Tensor) -> torch.Tensor:
    """[S, 2, L] unit-magnitude float IQ -> the same sessions through the
    channel, float32."""
    x = iq.double()
    re, im = x[:, 0], x[:, 1]
    inc = torch.zeros_like(re)
    inc[:, 1:] = torch.atan2(im[:, 1:] * re[:, :-1] - re[:, 1:] * im[:, :-1],
                             re[:, 1:] * re[:, :-1] + im[:, 1:] * im[:, :-1])
    n = re.shape[-1]
    t = torch.arange(n, dtype=torch.float64, device=iq.device) / n
    g = ((t - RAMP[0]) / (RAMP[1] - RAMP[0])).clamp(0.0, 1.0)
    out = inc.clone()
    for lag, gain in ECHOES:
        out[:, lag:] += g[lag:] * gain * inc[:, :-lag]
    phase = torch.atan2(im[:, :1], re[:, :1]) + torch.cumsum(out, dim=-1)
    return torch.stack([torch.cos(phase), torch.sin(phase)], dim=1).float()


def build(mix: dict, config: dict, seed: int, device) -> torch.Tensor:
    if int(config["input_rate"]) != RATE:
        raise ValueError(f"signal 'isi' is built at {RATE} S/s, not at the "
                         f"configuration's input_rate {config['input_rate']}")
    b, t = int(config["channels"]), int(config["block_samples"])
    gen = generator(seed, device)
    n_sessions = int(mix["sessions"])
    iq = voice_sessions(n_sessions, int(mix["frames"]), gen, device)
    period = iq.shape[-1] // t
    iq = smear(iq[:, :, : period * t])
    blk = iq.reshape(n_sessions, 2, period, t).movedim(2, 1)
    offs = torch.randint(0, period, (b,), generator=gen, device=device)
    idx = (torch.arange(period, device=device)[None, :] + offs[:, None]) % period
    src = torch.arange(b, device=device) % n_sessions
    return quantize(blk[src[:, None], idx])                       # [B, P, 2, T]
