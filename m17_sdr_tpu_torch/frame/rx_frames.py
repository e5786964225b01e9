"""Frame decoding: symbols -> soft bits -> decoded fields, batched.

Port of ``m17_sdr_tpu.frame.rx_frames``.  Each decoder takes [N, 368]
soft bits for N (channel, frame) pairs and is branchless; the session
layer decodes every frame through every typed path and selects by
mask.  ``use_kernel`` is passed to the Viterbi decoder.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..fec.viterbi import viterbi_decode
from ..spec import bits, crc, golay, interleave, puncture, whiten
from ..spec.constants import DEMAP_LSB_OFFSET, FRAME_SYMBOLS, SYNC_SYMBOLS


def demap_frame(symbols: torch.Tensor) -> torch.Tensor:
    """[..., 192] frame symbols -> [..., 368] soft bits.

    The sync symbols' mean magnitude normalizes the frame; msb = -m and
    lsb = |m| - 0.6666.
    """
    sync_mag = symbols[..., :SYNC_SYMBOLS].abs().mean(dim=-1)
    cor = 1.0 / torch.clamp(sync_mag, min=1e-9)
    m = symbols[..., SYNC_SYMBOLS:] * cor[..., None]
    soft = torch.stack([-m, m.abs() - DEMAP_LSB_OFFSET], dim=-1)
    return soft.reshape(*symbols.shape[:-1], 2 * (FRAME_SYMBOLS - SYNC_SYMBOLS))


def _unwrap(soft368: torch.Tensor) -> torch.Tensor:
    """de-correlate, then de-interleave."""
    return interleave.deinterleave(whiten.whiten_soft(soft368))


class LsfDecode(NamedTuple):
    lsf_bytes: torch.Tensor   # [N, 30] uint8
    crc_ok: torch.Tensor      # [N] bool
    metric: torch.Tensor      # [N] Viterbi confidence


def decode_lsf(soft368: torch.Tensor, use_kernel: bool | None = None) -> LsfDecode:
    """Link-setup frame: P1, Viterbi over 244 steps, CRC of the 30 bytes."""
    full = puncture.depuncture(_unwrap(soft368), "p1", 488)
    decoded, metric = viterbi_decode(full, use_kernel=use_kernel)
    lsf = bits.bits_to_bytes(decoded[..., :240])
    return LsfDecode(lsf_bytes=lsf, crc_ok=crc.crc16_fixed(lsf) == 0, metric=metric)


class StreamDecode(NamedTuple):
    lich_chunk: torch.Tensor    # [N, 5] LSF fragment bytes
    lich_seq: torch.Tensor      # [N] int32 mod-6 chunk index
    golay_errors: torch.Tensor  # [N] int32, summed over the 4 codewords
    fn: torch.Tensor            # [N] int64 16-bit frame number
    payload: torch.Tensor       # [N, 16] voice bytes
    metric: torch.Tensor        # [N]
    quality: torch.Tensor       # [N] metric / soft-input energy


def decode_stream(soft368: torch.Tensor, use_kernel: bool | None = None) -> StreamDecode:
    """Stream frame: LICH from 4 Golay words, payload by P2 + Viterbi.

    ``quality`` is the terminal path metric over the coded payload's
    total soft-bit magnitude: near 1 for a confident decode.
    """
    de = _unwrap(soft368)
    n = de.shape[0]
    gw = bits.hard_decision_word(de[..., :96].reshape(n, 4, 24))
    data12, nerr = golay.golay_decode(gw)
    lich6 = bits.u12x4_to_bytes(data12)
    lich_seq = (lich6[..., 5] >> 5).to(torch.int32)

    full = puncture.depuncture(de[..., 96:], "p2", 296)
    decoded, metric = viterbi_decode(full, use_kernel=use_kernel)
    energy = full.abs().sum(dim=-1)
    pld = bits.bits_to_bytes(decoded[..., :144])
    return StreamDecode(
        lich_chunk=lich6[..., :5],
        lich_seq=lich_seq,
        golay_errors=nerr.sum(dim=-1, dtype=torch.int32),
        fn=bits.bytes_to_word(pld[..., :2]),
        payload=pld[..., 2:18],
        metric=metric,
        quality=metric / torch.clamp(energy, min=1e-9),
    )


class PacketDecode(NamedTuple):
    data: torch.Tensor        # [N, 25] chunk bytes
    eof: torch.Tensor         # [N] bool
    fn: torch.Tensor          # [N] int32 frame number / final length
    metric: torch.Tensor


def decode_packet(soft368: torch.Tensor, use_kernel: bool | None = None) -> PacketDecode:
    """Packet frame: P3, Viterbi over 210 steps."""
    full = puncture.depuncture(_unwrap(soft368), "p3", 420)
    decoded, metric = viterbi_decode(full, use_kernel=use_kernel)
    by = bits.bits_to_bytes(decoded[..., :208])
    meta = by[..., 25].to(torch.int32)
    return PacketDecode(data=by[..., :25], eof=(meta >> 7) == 1,
                        fn=(meta >> 2) & 0x1F, metric=metric)


class BertDecode(NamedTuple):
    bits: torch.Tensor        # [N, 197] decoded PRBS bits
    metric: torch.Tensor


def decode_bert(soft368: torch.Tensor, use_kernel: bool | None = None) -> BertDecode:
    """BERT frame: the 368 soft bits are the first 368 of a 369-bit
    P2-punctured stream of 402 coded bits, padded to 410 with erasures."""
    de = _unwrap(soft368)
    full402 = puncture.depuncture(F.pad(de, (0, 1)), "p2", 402)
    decoded, metric = viterbi_decode(F.pad(full402, (0, 8)), use_kernel=use_kernel)
    return BertDecode(bits=decoded[..., :197], metric=metric)


def parse_lsf_fields(lsf_bytes: torch.Tensor):
    """Split [B, 30] LSF bytes -> (dst [B, 6], src [B, 6], type [B] int64,
    meta [B, 14]), as parse_lsf (m17_rx_parse.cpp:52-70) does."""
    return (lsf_bytes[..., 0:6], lsf_bytes[..., 6:12],
            bits.bytes_to_word(lsf_bytes[..., 12:14]), lsf_bytes[..., 14:28])
