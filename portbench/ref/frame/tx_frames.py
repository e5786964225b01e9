"""TX frame formatting: LSF, stream, packet, BERT, preamble, EOT.

Port of ``m17_sdr_tpu.frame.tx_frames``.  Every builder is batched over
a leading channel axis and returns [B, 192] uint8 dibits (8 sync + 184
payload symbols): conv -> puncture -> interleave -> whiten -> dibits,
as static gathers and GF(2) products.  Words that are uint32 in the JAX
package (type word, frame number) are carried in int64 and masked.
"""

from __future__ import annotations

import numpy as np
import torch

from .._util import on_device
from ..fec import conv
from ..spec import bits, crc, golay, interleave, puncture, whiten
from ..spec.constants import (
    EOT_DIBITS,
    FRAME_SYMBOLS,
    LICH_CHUNK_BYTES,
    LICH_CHUNKS,
    PREAMBLE_DIBITS,
    SYNC_WORD_BERT,
    SYNC_WORD_LINK,
    SYNC_WORD_PACKET,
    SYNC_WORD_STREAM,
)

_SYNC_DIBITS = {
    word: np.array([(word >> (14 - 2 * i)) & 0x3 for i in range(8)], dtype=np.uint8)
    for word in (SYNC_WORD_LINK, SYNC_WORD_STREAM, SYNC_WORD_PACKET, SYNC_WORD_BERT)
}


def _finish_frame(payload_bits: torch.Tensor, sync_word: int) -> torch.Tensor:
    """interleave -> whiten -> dibits, sync prepended -> [B, 192] dibits."""
    dib = bits.bits_to_dibits(whiten.whiten_bits(interleave.interleave(payload_bits)))
    sync = on_device(_SYNC_DIBITS[sync_word], dib.device).expand(*dib.shape[:-1], 8)
    return torch.cat([sync, dib], dim=-1)


def _hi_lo(word: torch.Tensor) -> torch.Tensor:
    """[B] 16-bit words -> [B, 2] big-endian bytes."""
    return bits.word_to_bytes_device(word.to(torch.int64) & 0xFFFF, 2)


def build_lsf_bytes(dst: torch.Tensor, src: torch.Tensor, type_word: torch.Tensor,
                    meta: torch.Tensor) -> torch.Tensor:
    """[B,6] dst + [B,6] src + [B] type + [B,14] meta -> [B,30] LSF with CRC."""
    body = torch.cat([dst, src, _hi_lo(type_word), meta], dim=-1)
    return crc.crc16_append(body)


def build_link_setup_frame(lsf_bytes30: torch.Tensor) -> torch.Tensor:
    """[B, 30] LSF bytes -> [B, 192] frame dibits (P1: 488 -> 368 bits)."""
    kept = puncture.puncture(conv.conv_encode_bytes(lsf_bytes30), "p1")
    return _finish_frame(kept, SYNC_WORD_LINK)


def build_stream_frame(lsf_bytes30: torch.Tensor, lich_count: torch.Tensor,
                       fn: torch.Tensor, payload16: torch.Tensor) -> torch.Tensor:
    """One voice/stream frame -> [B, 192] dibits.

    ``lich_count`` [B] picks the 5-byte LSF chunk of this frame's LICH
    (mod 6); ``fn`` [B] is the 16-bit frame number.
    """
    b = lsf_bytes30.shape[0]
    count = lich_count.to(torch.int64)
    start = (count % LICH_CHUNKS) * LICH_CHUNK_BYTES
    idx = start[:, None] + torch.arange(LICH_CHUNK_BYTES, device=count.device)[None, :]
    chunk = torch.gather(lsf_bytes30, 1, idx)
    cnt_byte = ((count & 0x7) << 5).to(torch.uint8)
    lich6 = torch.cat([chunk, cnt_byte[:, None]], dim=-1)            # [B, 6]

    gw = golay.golay_encode(bits.bytes_to_u12x4(lich6))             # [B, 4] 24-bit
    golay_bits = bits.bytes_to_bits(bits.word_to_bytes_device(gw, 3).reshape(b, 12))

    coded = conv.conv_encode_bytes(torch.cat([_hi_lo(fn), payload16], dim=-1))  # [B, 296]
    kept = puncture.puncture(coded, "p2")                            # [B, 272]
    return _finish_frame(torch.cat([golay_bits, kept], dim=-1), SYNC_WORD_STREAM)


def preamble_frame(batch: int, device) -> torch.Tensor:
    """[B, 192] preamble dibits (a broadcast view)."""
    return on_device(PREAMBLE_DIBITS, device).expand(batch, FRAME_SYMBOLS)


def eot_frame(batch: int, device) -> torch.Tensor:
    """[B, 192] end-of-transmission dibits (a broadcast view)."""
    return on_device(EOT_DIBITS, device).expand(batch, FRAME_SYMBOLS)
