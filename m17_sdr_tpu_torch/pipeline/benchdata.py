"""The bench's channel mix: 64 staggered voice sessions tiled to B channels.

Port of ``m17_sdr_tpu.pipeline.benchdata``.  64 voice sessions of 8
stream frames (AB1CDE <- G4GUO, payloads from ``default_rng(0)``) are
tiled to B channels, and channel c's block sequence is rotated by
c % nblk blocks, so that at every block the channels sit at all nblk
phases of a session (hunting, acquiring, locked, EOT).  Everything is
built on the device; nothing is read back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame import tx_frames
from ..spec import bits as bitpack
from ..spec import callsign
from ..spec.typefield import M17Type
from . import tx as txp

SESSIONS = 64
FRAMES = 8


def bench_sessions(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The 64 sessions' (LSF [64, 30], payloads [64, 8, 16]) on ``device``."""
    dst = bitpack.word_to_bytes(callsign.encode_callsign("AB1CDE"), 6)
    src = bitpack.word_to_bytes(callsign.encode_callsign("G4GUO"), 6)
    lsf = tx_frames.build_lsf_bytes(
        torch.as_tensor(np.tile(dst, (SESSIONS, 1))).to(device),
        torch.as_tensor(np.tile(src, (SESSIONS, 1))).to(device),
        torch.full((SESSIONS,), M17Type().pack(), dtype=torch.int64, device=device),
        torch.zeros((SESSIONS, 14), dtype=torch.uint8, device=device))
    rng = np.random.default_rng(0)
    payloads = rng.integers(0, 256, (SESSIONS, FRAMES, 16), dtype=np.uint8)
    return lsf, torch.as_tensor(payloads).to(device)


def make_bench_blocks(batch: int, block: int = 1920, int16: bool = True,
                      device="cuda") -> tuple[list[torch.Tensor], int]:
    """The staggered mix on ``device``: (nblk [batch, 2, block] planar-IQ
    blocks, nblk).  batch is a multiple of 64.  int16 (default) is the
    wire format, quantized as round(x / 3e-5); int16=False keeps float32.
    """
    lsf, payloads = bench_sessions(device)
    iq, _ = txp.dibits_to_iq(txp.build_voice_session_dibits(lsf, payloads))
    nblk = iq.shape[-1] // block
    blk = iq[:, :, : nblk * block].reshape(SESSIONS, 2, nblk, block).movedim(1, 2)
    tiled = blk.repeat(batch // SESSIONS, 1, 1, 1)                  # [batch, nblk, 2, T]
    offs = torch.arange(batch, device=iq.device) % nblk
    idx = (torch.arange(nblk, device=iq.device)[None, :] + offs[:, None]) % nblk
    out = torch.gather(tiled, 1, idx[:, :, None, None].expand(tiled.shape))
    if int16:
        out = torch.clamp(torch.round(out / 3.0e-5), -32768, 32767).to(torch.int16)
    return [out[:, i] for i in range(nblk)], nblk
