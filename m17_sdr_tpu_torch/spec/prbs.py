"""PRBS9 (x^9 + x^5 + 1) for BERT frames, and the BER stream checker.

Port of ``m17_sdr_tpu.spec.prbs``.  The 511-bit sequence is a static
table: TX windows are gathers.  ``check_stream`` and
``check_stream_frames`` are the checker's host walk in numpy;
``check_stream_device`` books the same counts for a whole batch on the
device, with a loop over the frame slots and no host read inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from .._util import on_device
from .constants import BERT_BITS

PRBS9_LEN = 511
BERT_FRAME_BITS = BERT_BITS


def _generate() -> np.ndarray:
    seq = np.zeros(PRBS9_LEN, dtype=np.uint8)
    sr = 0x01
    for i in range(PRBS9_LEN):
        bit = ((sr >> 8) ^ (sr >> 4)) & 1
        sr = ((sr << 1) | bit) & 0x1FF
        seq[i] = bit
    return seq


PRBS9_SEQUENCE = _generate()


def _shift_table(n: int) -> np.ndarray:
    """[511, n] uint8: row k is the sequence from position k, wrapped."""
    idx = (np.arange(PRBS9_LEN)[:, None] + np.arange(n)[None, :]) % PRBS9_LEN
    return PRBS9_SEQUENCE[idx]


# the checker's tables for a BERT frame: mismatches against every shift
# are  frame @ _MISMATCH + _ONES  (float32, exact: sums <= 197)
_SHIFTED = _shift_table(BERT_FRAME_BITS).astype(np.float32)      # [511, 197]
_MISMATCH = np.ascontiguousarray((1.0 - 2.0 * _SHIFTED).T)       # [197, 511]
_ONES = _SHIFTED.sum(axis=1)                                     # [511]


def tx_window(start, length: int, device=None) -> torch.Tensor:
    """PRBS9 bits [start, start+length) with wraparound, uint8.

    ``start`` is an int (then ``device`` says where) or a tensor of
    per-channel positions (the result follows its device).
    """
    if not isinstance(start, torch.Tensor):
        if device is None:
            raise ValueError("an int start needs a device")
        start = torch.tensor(start, device=device)
    idx = (torch.arange(length, device=start.device) + start.to(torch.int64)[..., None]) \
        % PRBS9_LEN
    return on_device(PRBS9_SEQUENCE, start.device)[idx]


def align_and_count_errors(rx_bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-alignment error count of [..., N] received hard bits against
    all 511 cyclic shifts -> (errors [...] int32, shift [...] int32)."""
    n = rx_bits.shape[-1]
    ref = torch.as_tensor(_shift_table(n).astype(np.float32) * 2.0 - 1.0,
                          device=rx_bits.device)
    rx = rx_bits.to(torch.float32) * 2.0 - 1.0
    errors = (n - rx @ ref.T) / 2.0                              # [..., 511]
    best = torch.argmin(errors, dim=-1)
    return (torch.gather(errors, -1, best[..., None])[..., 0].to(torch.int32),
            best.to(torch.int32))


# While synced, a frame is counted at the predicted alignment unless its
# error count says the alignment was lost; re-acquisition needs a
# clearly good match (see m17_sdr_tpu.spec.prbs for the derivation).
RESYNC_FRAC = 0.25
ACCEPT_FRAC = 0.20


def check_stream(rx_frames: np.ndarray) -> tuple[int, int, int]:
    """BER count of a sequence of received BERT frames [NF, 197].

    Acquire the alignment once on a clearly good frame, count each
    following frame at the predicted shift (TX advances 197 bits a
    frame), re-acquire only when the prediction fails.  Frames with no
    alignment are booked at the 50% a dead link delivers.

    Returns (bit_errors, bits_counted, unsynced_frames).
    """
    nf, n = np.asarray(rx_frames).shape
    per_frame = check_stream_frames(rx_frames)
    unsynced = int(np.sum(per_frame < 0))
    errors = int(np.sum(np.where(per_frame < 0, (n + 1) // 2, per_frame)))
    return errors, nf * n, unsynced


def check_stream_frames(rx_frames: np.ndarray) -> np.ndarray:
    """Per-frame bookings of the check_stream walk: the measured count of
    an aligned frame, -1 where no alignment held."""
    rx = np.asarray(rx_frames, dtype=np.uint8)
    nf, n = rx.shape
    errs = (rx[:, None, :] != _shift_table(n)[None, :, :]).sum(axis=-1)

    resync = int(RESYNC_FRAC * n)
    accept = int(ACCEPT_FRAC * n)
    synced = False
    shift = 0
    out = np.zeros(nf, np.int64)
    for f in range(nf):
        e_best = int(errs[f].min())
        s_best = int(errs[f].argmin())
        if synced and int(errs[f, shift]) <= resync:
            out[f] = int(errs[f, shift])
            shift = (shift + n) % PRBS9_LEN
        elif e_best <= accept:
            out[f] = e_best
            shift = (s_best + n) % PRBS9_LEN
            synced = True
        else:
            out[f] = -1
            synced = False
    return out


def check_stream_device(bv: torch.Tensor, bb: torch.Tensor):
    """check_stream for a batch on its device.

    bv [B, S] bool frame-valid slots, bb [B, S, 197] decoded bits (slot
    order = arrival order).  Returns (errors [B], bits [B], unsynced [B])
    int32, the numpy walk's counts for each channel's valid frames.
    """
    b, s = bv.shape
    n = BERT_FRAME_BITS
    dev = bv.device
    resync = int(RESYNC_FRAC * n)
    accept = int(ACCEPT_FRAC * n)

    # compact the valid frames to the slot front, in order
    order = torch.argsort((~bv).to(torch.uint8), dim=-1, stable=True)
    comp = torch.gather(bb, 1, order[..., None].expand(b, s, n))
    counts = bv.sum(dim=-1)
    errs = (comp.to(torch.float32) @ on_device(_MISMATCH, dev)
            + on_device(_ONES, dev)).to(torch.int32)              # [B, S, 511]

    synced = torch.zeros(b, dtype=torch.bool, device=dev)
    shift = torch.zeros(b, dtype=torch.int64, device=dev)
    err = torch.zeros(b, dtype=torch.int32, device=dev)
    nbits = torch.zeros(b, dtype=torch.int32, device=dev)
    uns = torch.zeros(b, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(s):
        row = errs[:, i]                                         # [B, 511]
        live = i < counts
        e_pred = torch.gather(row, 1, shift[:, None])[:, 0]
        e_best = row.amin(dim=-1)
        s_best = row.argmin(dim=-1)                              # the first minimum
        re_ok = synced & (e_pred <= resync)
        ac_ok = ~re_ok & (e_best <= accept)
        lost = ~re_ok & ~ac_ok
        booked = torch.where(re_ok, e_pred,
                             torch.where(ac_ok, e_best, zero + (n + 1) // 2))
        shift2 = torch.where(re_ok, (shift + n) % PRBS9_LEN,
                             torch.where(ac_ok, (s_best + n) % PRBS9_LEN, shift))
        synced = torch.where(live, re_ok | ac_ok, synced)
        shift = torch.where(live, shift2, shift)
        err = err + torch.where(live, booked, zero)
        nbits = nbits + torch.where(live, zero + n, zero)
        uns = uns + (live & lost).to(torch.int32)
    return err, nbits, uns
