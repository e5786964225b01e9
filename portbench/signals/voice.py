"""Signal ``voice``: the bench mix's recipe at 48 kS/s.

``sessions`` M17 voice sessions (preambles, the LSF, ``frames`` stream
frames with LICH and FN, the EOT, one idle preamble) from AB1CDE to G4GUO,
built by the reference's TX chain, cut into whole blocks (the session's
period), quantized to int16 as round(x / 3e-5).  Channel c carries
session c mod ``sessions``, its blocks rotated by an offset drawn from the
seed, so that at every block the channels sit at every phase of a session
(hunting, acquiring, locked, at EOT).  The seed draws the payload bytes
and the offsets; the sizes are the same for every seed.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.ref.frame import tx_frames
from portbench.ref.pipeline import tx as txp
from portbench.ref.spec import bits as bitpack
from portbench.ref.spec import callsign
from portbench.ref.spec.typefield import M17Type
from portbench.signals import generator, quantize

RATE = 48_000               # the TX chain's sample rate


def voice_sessions(n_sessions: int, n_frames: int, gen: torch.Generator,
                   device) -> torch.Tensor:
    """[n_sessions, 2, L] float IQ of the voice sessions, payloads from ``gen``."""
    dst = bitpack.word_to_bytes(callsign.encode_callsign("AB1CDE"), 6)
    src = bitpack.word_to_bytes(callsign.encode_callsign("G4GUO"), 6)
    lsf = tx_frames.build_lsf_bytes(
        torch.as_tensor(np.tile(dst, (n_sessions, 1))).to(device),
        torch.as_tensor(np.tile(src, (n_sessions, 1))).to(device),
        torch.full((n_sessions,), M17Type().pack(), dtype=torch.int64, device=device),
        torch.zeros((n_sessions, 14), dtype=torch.uint8, device=device))
    payloads = torch.randint(0, 256, (n_sessions, n_frames, 16), generator=gen,
                             device=device).to(torch.uint8)
    iq, _ = txp.dibits_to_iq(txp.build_voice_session_dibits(lsf, payloads))
    return iq


def build(mix: dict, config: dict, seed: int, device) -> torch.Tensor:
    if int(config["input_rate"]) != RATE:
        raise ValueError(f"signal 'voice' is built at {RATE} S/s, not at the "
                         f"configuration's input_rate {config['input_rate']}")
    b, t = int(config["channels"]), int(config["block_samples"])
    gen = generator(seed, device)
    n_sessions = int(mix["sessions"])
    iq = voice_sessions(n_sessions, int(mix["frames"]), gen, device)
    period = iq.shape[-1] // t
    blk = iq[:, :, : period * t].reshape(n_sessions, 2, period, t).movedim(2, 1)
    offs = torch.randint(0, period, (b,), generator=gen, device=device)
    idx = (torch.arange(period, device=device)[None, :] + offs[:, None]) % period
    src = torch.arange(b, device=device) % n_sessions
    return quantize(blk[src[:, None], idx])                       # [B, P, 2, T]
