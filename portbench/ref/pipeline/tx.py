"""TX pipeline: session frames -> dibits -> planar IQ, batched over channels.

Port of ``m17_sdr_tpu.pipeline.tx``.  A voice session is n_preambles x
preamble, the LSF, NF stream frames (LICH counter = frame index mod 6,
FN counting from fn0 with a 15-bit wrap), the EOT and one idle preamble
so that receivers complete the EOT.  Every frame of a session encodes
in one batch.  The builders work on their inputs' device; the BERT
builder, which has no input tensor, takes ``device`` (default CUDA).
"""

from __future__ import annotations

import torch

from ..dsp.modulate import ModState, modulate_dibits
from ..frame import tx_frames
from ..spec.constants import (
    FRAME_SYMBOLS,
    LICH_CHUNKS,
    SAMPLES_PER_SYMBOL,
    STREAM_PAYLOAD_BYTES,
)


def _session(body: torch.Tensor, batch: int, n_preambles: int,
             lsf_bytes: torch.Tensor | None = None) -> torch.Tensor:
    """preambles [+ LSF] + body + EOT + idle preamble -> [B, nsym]."""
    dev = body.device
    parts = [tx_frames.preamble_frame(batch, dev) for _ in range(n_preambles)]
    if lsf_bytes is not None:
        parts.append(tx_frames.build_link_setup_frame(lsf_bytes))
    parts += [body, tx_frames.eot_frame(batch, dev), tx_frames.preamble_frame(batch, dev)]
    return torch.cat(parts, dim=-1)


def build_voice_session_dibits(lsf_bytes: torch.Tensor, payloads: torch.Tensor,
                               fn0: torch.Tensor | None = None,
                               n_preambles: int = 2) -> torch.Tensor:
    """[B,30] LSF + [B,NF,16] voice payloads -> [B, nsym] session dibits.

    ``fn0`` [B] is each channel's first frame number (default 0).  The
    FN wraps at 15 bits: its MSB is the end-of-stream marker.
    """
    b, nf, _ = payloads.shape
    dev = payloads.device
    idx = torch.arange(nf, dtype=torch.int64, device=dev)
    fn0 = torch.zeros(b, dtype=torch.int64, device=dev) if fn0 is None \
        else fn0.to(torch.int64)
    lich_count = (idx % LICH_CHUNKS).expand(b, nf).reshape(b * nf)
    fn = ((fn0[:, None] + idx[None, :]) & 0x7FFF).reshape(b * nf)
    stream = tx_frames.build_stream_frame(
        lsf_bytes.repeat_interleave(nf, dim=0), lich_count, fn,
        payloads.reshape(b * nf, STREAM_PAYLOAD_BYTES),
    ).reshape(b, nf * FRAME_SYMBOLS)
    return _session(stream, b, n_preambles, lsf_bytes)


def dibits_to_iq(dibits: torch.Tensor, mod_state: ModState | None = None,
                 oversample: int = SAMPLES_PER_SYMBOL):
    """[B, N] dibits -> ([B, 2, N*oversample] planar IQ, new ModState)."""
    if mod_state is None:
        mod_state = ModState.init(dibits.shape[0], dibits.device)
    return modulate_dibits(dibits, mod_state, oversample=oversample)
