"""Symbol timing recovery and framer: one sequential scan per block.

Frozen copy of the port's ``frame/receiver.py`` for the reference chain
(delayed masked emission for bit slips, in-lock resync, frames gathered
after the scan from the compacted slot stream).  The scan is written in
numpy over the channels, one step at a time, with the port's numerics:
filter operands rounded to bf16, each output the float32 sum of the
products in tap order, rounded to bf16; the sync correlations are
ordered sums over the 8 symbols.  The products of bf16 values are exact
in float32, so the scan gives the bits of the port's plain scan.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dsp.filters import polyphase_rrc_bank
from ..spec.constants import (
    FRAME_SYMBOLS,
    FT_BERT,
    FT_EOT,
    FT_LINK,
    LOCKED_MAX_VARIANCE,
    LOCKED_MAX_VOTES,
    MAX_FRAME_ERRORS,
    SYNC_PATTERNS,
    SYNC_SYMBOLS,
    TIMING_FILTER_TAPS,
    TIMING_INIT_PHASE,
    TIMING_NUM_PHASES,
    TIMING_THRESH_LOCKED,
    TIMING_THRESH_UNLOCKED,
    UNLOCKED_MAX_VARIANCE,
    UNLOCKED_MAX_VOTES,
)

# flags word per step (the layout of m17_sdr_tpu.frame.receiver_pallas)
F_VALID, F_DONE, F_PARSE, F_AOS, F_LOS, F_SLIP = 1, 2, 4, 8, 16, 32
F_SLIPFRAME = 64            # the in-progress frame was hit by a timing slip
F_TYPE_SHIFT = 8            # sync type after the step, in bits 8 and up


def max_frames_per_block(block_samples_2x: int) -> int:
    """Frame slots per block: a block of S2 samples carries ~S2/2 symbols."""
    return block_samples_2x // (2 * FRAME_SYMBOLS) + 2


class ReceiverState(NamedTuple):
    """Per-channel carry of the timing loop, the framer and the frame
    assembly across blocks."""

    window: torch.Tensor        # [B, 31] MF input history
    clk: torch.Tensor           # [B] i32 sample-phase toggle
    thr: torch.Tensor           # [B] i32 timing vote counter
    index: torch.Tensor         # [B] i32 polyphase index 0..39
    mf_sum: torch.Tensor        # [B] last matched-filter output
    mf_dif: torch.Tensor        # [B] last derivative-filter output
    pending: torch.Tensor       # [B] delayed symbol
    pending_valid: torch.Tensor  # [B] bool
    flock: torch.Tensor         # [B] bool framer lock
    fclk: torch.Tensor          # [B] i32 frame symbol counter
    ferr: torch.Tensor          # [B] i32 consecutive frame errors
    sync_win: torch.Tensor      # [B, 8] sliding sync window
    sync_type: torch.Tensor     # [B] i32 current frame's sync class
    sync_pass: torch.Tensor     # [B] bool current frame's sync verdict
    slip_in_frame: torch.Tensor  # [B] bool: a timing slip hit this frame
    sym_hist: torch.Tensor      # [B, 191] cross-block symbol history

    @staticmethod
    def init(batch: int, device) -> "ReceiverState":
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        bl = dict(dtype=torch.bool, device=device)
        return ReceiverState(
            window=torch.zeros((batch, TIMING_FILTER_TAPS), **f32),
            clk=torch.ones((batch,), **i32),
            thr=torch.zeros((batch,), **i32),
            index=torch.full((batch,), TIMING_INIT_PHASE, **i32),
            mf_sum=torch.zeros((batch,), **f32),
            mf_dif=torch.zeros((batch,), **f32),
            pending=torch.zeros((batch,), **f32),
            pending_valid=torch.zeros((batch,), **bl),
            flock=torch.zeros((batch,), **bl),
            fclk=torch.zeros((batch,), **i32),
            ferr=torch.zeros((batch,), **i32),
            sync_win=torch.zeros((batch, SYNC_SYMBOLS), **f32),
            sync_type=torch.zeros((batch,), **i32),
            sync_pass=torch.zeros((batch,), **bl),
            slip_in_frame=torch.zeros((batch,), **bl),
            sym_hist=torch.zeros((batch, FRAME_SYMBOLS - 1), **f32),
        )


class BlockEvents(NamedTuple):
    """Per-block receiver outputs (fixed shapes)."""

    frames: torch.Tensor       # [B, F, 192] extracted frame symbols
    frame_valid: torch.Tensor  # [B, F] bool: a frame completed here
    frame_type: torch.Tensor   # [B, F] i32 sync classification
    frame_parse: torch.Tensor  # [B, F] bool: passes the parse gate
    frame_slipped: torch.Tensor  # [B, F] bool: a timing slip hit the frame
    aos: torch.Tensor          # [B] bool: acquired lock in this block
    los: torch.Tensor          # [B] bool: lost lock in this block
    locked: torch.Tensor       # [B] bool: lock state after the block
    n_slips: torch.Tensor      # [B] i32 bit slips in this block


_MF_BANK, _DMF_BANK = polyphase_rrc_bank(TIMING_NUM_PHASES, TIMING_FILTER_TAPS)
# [40, 2, 31]: phase p's matched and derivative taps, rounded to bf16, in f32
_TAPS = np.stack([_MF_BANK, _DMF_BANK], axis=1).astype(np.float32)
_PATS = np.ascontiguousarray(np.asarray(SYNC_PATTERNS, dtype=np.float32).T)   # [8, 6]
_I32 = np.int32
_F0 = np.float32(0.0)


_U1, _U16, _U7FFF, _UHI = (np.uint32(v) for v in (1, 16, 0x7FFF, 0xFFFF0000))


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 (ties to even), held in float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    r = (u + ((u >> _U16) & _U1) + _U7FFF) & _UHI
    return r.view(np.float32)


_TAPS = bf16_round(_TAPS)


def _sync_check(vect: np.ndarray, rows: np.ndarray):
    """[B, 8] symbols -> (ftype i32, votes i32, variance f32).  The
    correlations with the six patterns and the sign agreements are float32
    sums over the 8 symbols taken in order."""
    s = np.sign(vect)
    prod = np.stack([vect, s], axis=1)[..., None] * _PATS            # [B, 2, 8, 6]
    acc = prod[:, :, 0]
    for i in range(1, SYNC_SYMBOLS):
        acc = acc + prod[:, :, i]
    sums, agree = acc[:, 0], acc[:, 1]                               # [B, 6] each
    best = sums.argmax(axis=-1)                                      # first maximum
    ftype = np.where(sums[rows, best] > 0, best, 0)
    nnz = np.abs(s).sum(axis=-1, dtype=np.float32)
    votes = ((nnz - agree[rows, ftype]) * np.float32(0.5)).astype(_I32)
    mags = np.abs(vect)
    mmax = mags.max(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        variance = np.where(mmax > 0, (mmax - mags.min(axis=-1))
                            / np.maximum(mmax, np.float32(1e-30)), np.float32(1.0))
    return ftype.astype(_I32), votes, variance


def receiver_scan(samples: torch.Tensor, state: ReceiverState):
    """The timing and framer scan over one [B, S2] block, in numpy.

    The filter runs over ``ext = state.window[:, 1:] ++ samples``: its
    operands are rounded to bf16 and each output is the float32 sum of
    the products in tap order, rounded to bf16; only the phase in use is
    evaluated.  Returns (slot_val [B, S2] f32, flags [B, S2] i32, new
    state) with the next ``window``; ``sym_hist`` is left to the caller.
    """
    st = {k: getattr(state, k).numpy().copy() for k in ReceiverState._fields}
    x = samples.numpy().astype(np.float32)
    b, s2 = x.shape
    rows = np.arange(b)
    ext = np.concatenate([st["window"][:, 1:], x], axis=1)
    wins = np.lib.stride_tricks.sliding_window_view(
        bf16_round(ext), TIMING_FILTER_TAPS, axis=1)
    clk, thr, index = st["clk"], st["thr"], st["index"]
    mfh = np.stack([st["mf_sum"], st["mf_dif"]], axis=1)           # [B, 2] held outputs
    mf_sum, mf_dif, pending = mfh[:, 0], mfh[:, 1], st["pending"]
    pending_valid, flock, fclk, ferr = st["pending_valid"], st["flock"], st["fclk"], st["ferr"]
    sync_win, sync_type, sync_pass = st["sync_win"], st["sync_type"], st["sync_pass"]
    slip_in_frame = st["slip_in_frame"]
    slot_out = np.zeros((s2, b), np.float32)
    events = np.zeros((7, s2, b), dtype=bool)    # valid, done, parse, aos, los, slip, slipped
    types = np.zeros((s2, b), np.int32)
    n = TIMING_NUM_PHASES
    for t in range(s2):
        clk = 1 - clk
        is_clk = clk == 1
        off = ~is_clk
        mf = bf16_round(np.cumsum(wins[:, t, None, :] * _TAPS[index], axis=-1)[..., -1])
        mfh = np.where(is_clk[:, None], mf, mfh)
        mf_sum, mf_dif = mfh[:, 0], mfh[:, 1]

        # timing vote on the off-phase
        vote = np.sign(np.where(mf_sum < 0, -mf_dif, mf_dif)).astype(_I32)
        thr = thr + vote * off
        thresh = np.where(flock, _I32(TIMING_THRESH_LOCKED), _I32(TIMING_THRESH_UNLOCKED))
        fwd = off & (thr > thresh)
        bwd = off & (thr < -thresh)
        index = ((index + fwd - bwd) % n).astype(_I32)
        thr = thr * ~(fwd | bwd)
        fwd_wrap = fwd & (index == 0)
        bwd_wrap = bwd & (index == n - 1)
        slip = fwd_wrap | bwd_wrap
        clk = clk | slip

        # delayed emission: one (value, valid) slot per step
        emit_now = is_clk | fwd_wrap
        slot_val = np.where(emit_now, pending, _F0)
        slot_valid = emit_now & pending_valid
        pending = np.where(is_clk, mf[:, 0], pending)
        pending = np.where(fwd_wrap, _F0, pending)
        pending_valid = (is_clk | fwd_wrap | pending_valid) & ~bwd_wrap

        # framer
        consumed = slot_valid
        flock0 = flock
        held = consumed & flock0
        sync_win = np.where(consumed[:, None], np.concatenate(
            [sync_win[:, 1:], slot_val[:, None]], axis=1), sync_win)
        fclk = fclk + held
        ftype, votes, variance = _sync_check(sync_win, rows)
        payload = (ftype >= FT_LINK) & (ftype <= FT_BERT)
        unlocked_ok = ((votes <= UNLOCKED_MAX_VOTES) & payload
                       & (variance < np.float32(UNLOCKED_MAX_VARIANCE)))
        locked_ok = ((votes <= LOCKED_MAX_VOTES) & payload
                     & (variance < np.float32(LOCKED_MAX_VARIANCE)))

        at8 = held & (fclk == SYNC_SYMBOLS)
        resync = (held & unlocked_ok & ~at8
                  & (fclk >= SYNC_SYMBOLS - 2) & (fclk <= SYNC_SYMBOLS + 2))
        sync_type = np.where(at8 | resync, ftype, sync_type)
        sync_pass = np.where(at8, locked_ok, sync_pass) | resync
        fclk = np.where(resync, _I32(SYNC_SYMBOLS), fclk)
        slipped = (slip_in_frame | slip) & flock0 & ~resync
        frame_done = held & (fclk == FRAME_SYMBOLS)
        fclk = fclk * ~frame_done
        is_eot = frame_done & (sync_type == FT_EOT)
        good = frame_done & sync_pass & ~is_eot
        bad = frame_done & ~sync_pass & ~is_eot
        ferr = (ferr + bad) * ~(good | resync)
        too_many = bad & (ferr > MAX_FRAME_ERRORS)
        los = is_eot | too_many
        parse = good | (bad & ~too_many)
        aos = consumed & ~flock0 & unlocked_ok
        flock = (flock0 | aos) & ~los
        fclk = np.where(aos, _I32(SYNC_SYMBOLS), fclk).astype(_I32)
        ferr = (ferr * ~aos).astype(_I32)
        sync_type = np.where(aos, ftype, sync_type)
        sync_pass = sync_pass | aos
        sync_win = sync_win * ~los[:, None]
        slip_in_frame = slipped & ~frame_done & ~aos

        slot_out[t] = slot_val
        ev = events[:, t]
        ev[0], ev[1], ev[2], ev[3], ev[4], ev[5], ev[6] = (
            slot_valid, frame_done, parse, aos, los, slip, slipped)
        types[t] = sync_type
    flags = (events.T.astype(np.int32) * np.array(
        [F_VALID, F_DONE, F_PARSE, F_AOS, F_LOS, F_SLIP, F_SLIPFRAME], np.int32)).sum(-1) \
        + (types.T << F_TYPE_SHIFT)
    new = dict(clk=clk, thr=thr, index=index, mf_sum=mf_sum, mf_dif=mf_dif, pending=pending,
               pending_valid=pending_valid, flock=flock, fclk=fclk, ferr=ferr,
               sync_win=sync_win, sync_type=sync_type, sync_pass=sync_pass,
               slip_in_frame=slip_in_frame, window=ext[:, -TIMING_FILTER_TAPS:])
    new_state = state._replace(**{k: torch.from_numpy(np.ascontiguousarray(
        v, dtype=st[k].dtype)) for k, v in new.items()})
    return (torch.from_numpy(np.ascontiguousarray(slot_out.T)),
            torch.from_numpy(np.ascontiguousarray(flags, dtype=np.int32)), new_state)


def receive_block(samples: torch.Tensor,
                  state: ReceiverState) -> tuple[BlockEvents, ReceiverState]:
    """Process one [B, S2] block of 2-samples/symbol soft samples (CPU
    tensors).  Returns fixed-shape BlockEvents and the updated carry."""
    b, s2 = samples.shape
    dev = samples.device
    slot_vals, flags, state2 = receiver_scan(samples, state)

    slot_valids = (flags & F_VALID) != 0
    frame_done = (flags & F_DONE) != 0
    parse = (flags & F_PARSE) != 0
    slipped_at = (flags & F_SLIPFRAME) != 0
    ftype = flags >> F_TYPE_SHIFT
    aos_any = ((flags & F_AOS) != 0).any(dim=-1)
    los_any = ((flags & F_LOS) != 0).any(dim=-1)
    n_slips = ((flags & F_SLIP) != 0).sum(dim=-1, dtype=torch.int32)

    # compact the valid slots in order: a stable sort of the invalid mask
    # (as uint8: sorting bool is not supported everywhere)
    order = torch.argsort((~slot_valids).to(torch.uint8), dim=-1, stable=True)
    comp = torch.gather(slot_vals, -1, order)
    stream = torch.cat([state2.sym_hist, comp], dim=-1)      # [B, 191+S2]

    vcount = torch.cumsum(slot_valids.to(torch.int32), dim=-1)

    # up to F frame completions per channel
    f = max_frames_per_block(s2)
    step_idx = torch.arange(s2, device=dev)[None, :]
    done_pos = torch.where(frame_done, step_idx, s2)
    done_sorted = torch.sort(done_pos, dim=-1).values[:, :f]  # [B, F]
    frame_valid = done_sorted < s2
    safe_pos = torch.clamp(done_sorted, max=s2 - 1)

    # a frame ends at compact index vcount[pos]-1; with the 191-symbol
    # history in front it starts at stream offset vcount[pos]-1
    vc = torch.gather(vcount, -1, safe_pos)
    start = torch.clamp(vc - 1, min=0).to(torch.int64)
    gidx = start[..., None] + torch.arange(FRAME_SYMBOLS, device=dev)
    frames = torch.gather(stream[:, None, :].expand(b, f, stream.shape[1]), -1, gidx)

    frame_type = torch.gather(ftype, -1, safe_pos)
    frame_parse = torch.gather(parse, -1, safe_pos) & frame_valid
    frame_slipped = torch.gather(slipped_at, -1, safe_pos) & frame_valid

    # roll the symbol history: the last 191 valid symbols
    total_valid = vcount[:, -1:].to(torch.int64)
    sym_hist = torch.gather(
        stream, -1, total_valid + torch.arange(FRAME_SYMBOLS - 1, device=dev))

    events = BlockEvents(
        frames=frames, frame_valid=frame_valid, frame_type=frame_type,
        frame_parse=frame_parse, frame_slipped=frame_slipped,
        aos=aos_any, los=los_any, locked=state2.flock, n_slips=n_slips,
    )
    return events, state2._replace(sym_hist=sym_hist)
