"""End-to-end loopbacks: TX dibits -> RRC 4FSK IQ -> channel impairments
(clock drift, carrier offset, AWGN) -> ``rx_stream`` -> payload or BER
comparison, for B channels at once.

Port of ``m17_sdr_tpu.pipeline.loopback``.  The noise is ``noise``, a
unit-variance tensor shaped as the session's IQ [B, 2, T], or is drawn
from ``generator``; exactly one must be given.  A zero drift or offset
is skipped by a host-side test of the argument, never by reading a
device tensor.  ``use_kernel`` is passed to ``rx_stream``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp import channel
from ..spec import prbs
from ..spec.constants import BLOCK_SAMPLES
from ..spec.crc import _crc_numpy
from . import tx as txp
from .rx import RxSessionState, rx_stream


def _blockify(iq2: torch.Tensor, block: int = BLOCK_SAMPLES) -> torch.Tensor:
    """[B, 2, T] planar IQ -> [B, NBLK, 2, block]."""
    b, _, t = iq2.shape
    nblk = t // block
    return iq2[:, :, : nblk * block].reshape(b, 2, nblk, block).movedim(1, 2)


def _nonzero(x) -> bool:
    """Host-side: is any element of a scalar, list or numpy parameter non-zero?"""
    return float(np.max(np.abs(np.asarray(x)))) != 0.0


def _channel(iq: torch.Tensor, snr_db, freq_offset_hz, drift_ppm, noise, generator):
    if _nonzero(drift_ppm):
        iq = channel.timing_drift(iq, drift_ppm)
    if _nonzero(freq_offset_hz):
        iq = channel.carrier_offset(iq, freq_offset_hz)
    return channel.awgn(iq, snr_db, noise=noise, generator=generator)


def voice_loopback(lsf_bytes: torch.Tensor, payloads: torch.Tensor, snr_db=60.0,
                   freq_offset_hz=0.0, drift_ppm=0.0, afc: bool = False,
                   noise: torch.Tensor | None = None,
                   generator: torch.Generator | None = None,
                   use_kernel: bool | None = None):
    """Voice session TX -> channel -> RX on the inputs' device.  Returns
    (RxBlockOutput stacked over blocks, final RxSessionState)."""
    iq, _ = txp.dibits_to_iq(txp.build_voice_session_dibits(lsf_bytes, payloads))
    iq = _channel(iq, snr_db, freq_offset_hz, drift_ppm, noise, generator)
    state = RxSessionState.init(iq.shape[0], iq.device)
    return rx_stream(_blockify(iq), state, afc_enabled=afc, use_kernel=use_kernel)


def recover_stream_payloads(out, nf: int) -> tuple[np.ndarray, np.ndarray]:
    """Decoded stream payloads ordered by FN -> ([B, NF, 16] uint8,
    recovered mask [B, NF]), on the host."""
    sv = out.stream_valid.cpu().numpy()                 # [B, NBLK, F]
    b = sv.shape[0]
    flat_v = sv.reshape(b, -1)
    flat_fn = out.stream_fn.cpu().numpy().reshape(b, -1)
    flat_pl = out.stream_payload.cpu().numpy().reshape(b, -1, 16)
    got = np.zeros((b, nf, 16), dtype=np.uint8)
    mask = np.zeros((b, nf), dtype=bool)
    for ch in range(b):
        for j in np.nonzero(flat_v[ch])[0]:
            f = int(flat_fn[ch, j])
            if f < nf:
                got[ch, f] = flat_pl[ch, j]
                mask[ch, f] = True
    return got, mask


def packet_loopback(lsf_bytes: torch.Tensor, data: torch.Tensor, snr_db=60.0,
                    freq_offset_hz=0.0, drift_ppm=0.0,
                    noise: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    use_kernel: bool | None = None):
    """Packet session TX -> channel -> RX.  Returns (stacked RX output,
    final state)."""
    iq, _ = txp.dibits_to_iq(txp.build_packet_session_dibits(lsf_bytes, data))
    iq = _channel(iq, snr_db, freq_offset_hz, drift_ppm, noise, generator)
    state = RxSessionState.init(iq.shape[0], iq.device)
    return rx_stream(_blockify(iq), state, use_kernel=use_kernel)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def reassemble_packets(out) -> list[bytes | None]:
    """Each channel's packet from its decoded packet frames, on the host
    (``out``'s fields are tensors or host arrays).

    Chunks join in arrival order; the EOF frame gives only its first
    ``fn`` bytes (the final-length field).  The trailing CRC-16 is
    checked over the whole packet and stripped; a channel with no EOF
    or a bad CRC gives None.
    """
    pv = _host(out.packet_valid)                        # [B, NBLK, F]
    b = pv.shape[0]
    flat_v = pv.reshape(b, -1)
    flat_d = _host(out.packet_data).reshape(b, flat_v.shape[1], -1)
    flat_e = _host(out.packet_eof).reshape(b, -1)
    flat_f = _host(out.packet_fn).reshape(b, -1)
    results: list[bytes | None] = []
    for ch in range(b):
        buf = bytearray()
        done = False
        for j in np.nonzero(flat_v[ch])[0]:
            if flat_e[ch, j]:
                buf += bytes(flat_d[ch, j][: int(flat_f[ch, j])])
                done = True
                break
            buf += bytes(flat_d[ch, j])
        if not done or len(buf) < 3 or _crc_numpy(np.frombuffer(bytes(buf), np.uint8)) != 0:
            results.append(None)
        else:
            results.append(bytes(buf[:-2]))
    return results


def bert_loopback(batch: int, n_frames: int, snr_db=60.0, freq_offset_hz=0.0,
                  drift_ppm=0.0, noise: torch.Tensor | None = None,
                  generator: torch.Generator | None = None, device="cuda",
                  use_kernel: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """PRBS9 BER loopback on ``device``.

    Returns (bit_errors [B], bits_counted [B]) int64 on the host, over
    the recovered BERT frames of each channel (the host walk
    ``prbs.check_stream``); frames not recovered are not counted.
    """
    dibits = txp.build_bert_session_dibits(batch, n_frames, device=device)
    iq, _ = txp.dibits_to_iq(dibits)
    iq = _channel(iq, snr_db, freq_offset_hz, drift_ppm, noise, generator)
    out, _ = rx_stream(_blockify(iq), RxSessionState.init(batch, iq.device),
                       use_kernel=use_kernel)

    bv = out.bert_valid.cpu().numpy().reshape(batch, -1)
    bb = out.bert_bits.cpu().numpy().reshape(batch, bv.shape[1], -1)
    errors = np.zeros(batch, np.int64)
    counted = np.zeros(batch, np.int64)
    for ch in range(batch):
        idx = np.nonzero(bv[ch])[0]
        if len(idx):
            errors[ch], counted[ch], _ = prbs.check_stream(bb[ch, idx])
    return torch.as_tensor(errors), torch.as_tensor(counted)
