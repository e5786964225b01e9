"""Symbol timing recovery and framer: one sequential scan per block.

Port of ``m17_sdr_tpu.frame.receiver``; see that module for the design
(delayed masked emission for bit slips, in-lock resync, frames gathered
after the scan from the compacted slot stream).

The scan has two versions with one contract, ``(samples [B, S2], state)
-> (slot_val [B, S2] f32, flags [B, S2] i32, state)``, the filter running
over the 30-sample history ``state.window[:, 1:]`` in front of the block:

* ``receiver_scan_ref``, plain PyTorch: the 80-filter matched-filter
  bank for every step, then a per-step loop over ``_scan_step``;
* ``receiver_scan_cuda``, the hand-written kernel
  ``csrc/receiver_scan.cu``: one thread per channel walks the block and
  evaluates the filter only at the channel's clk steps and current phase.

Numerics follow the JAX package's XLA formulation: filter operands are
rounded to bf16, each output is the f32 sum of the products in tap
order, rounded to bf16.  The products of bf16 values are exact in f32,
so both versions produce the same bits.

The compaction after the scan (the valid slots compacted behind the
carried symbol history, the first F frame completions gathered as
frames, the history rolled) has two versions with one contract too,
``(slot_val, flags, state) -> (BlockEvents, state)``: ``compact_ref``, plain
PyTorch (a stable argsort, a sort and gathers), and ``compact_cuda``, the
hand-written kernel ``csrc/compact.cu``, one launch.  ``receive_block``
takes both kernels for CUDA tensors and both plain versions for CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .._util import on_device
from ..dsp.filters import polyphase_rrc_bank
from ..spec.constants import (
    FRAME_SYMBOLS,
    FT_EOT,
    MAX_FRAME_ERRORS,
    SYNC_PATTERNS,
    SYNC_SYMBOLS,
    TIMING_FILTER_TAPS,
    TIMING_INIT_PHASE,
    TIMING_NUM_PHASES,
    TIMING_THRESH_LOCKED,
    TIMING_THRESH_UNLOCKED,
)
from ..trace import span
from .sync import locked_pass, sync_check, unlocked_pass

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
# both banks, taps rounded to bf16 and held as f32: [80, 31]
_BANK_BF16 = torch.from_numpy(np.concatenate([_MF_BANK, _DMF_BANK], axis=0)) \
    .to(torch.bfloat16).to(torch.float32).numpy()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def mf_bank(ext: torch.Tensor) -> torch.Tensor:
    """[B, S2+30] samples -> [B, 80, S2]: all 40 phases of the matched and
    derivative filters at every step, as bf16 values held in f32.

    An explicit tap-ordered loop of elementwise products and sums (not a
    convolution), so the sum order is fixed and matches the kernel's.
    """
    s2 = ext.shape[1] - (TIMING_FILTER_TAPS - 1)
    x = _bf16(ext)[:, None, :]
    h = on_device(_BANK_BF16, ext.device)[None, :, :, None]   # [1, 80, 31, 1]
    acc = x[..., 0:s2] * h[:, :, 0]
    for k in range(1, TIMING_FILTER_TAPS):
        acc = acc + x[..., k:k + s2] * h[:, :, k]
    return _bf16(acc)


def _scan_step(state: ReceiverState, mf_t: torch.Tensor):
    """One input sample (2 samples/symbol) for all channels.

    ``mf_t`` [B, 80] holds the matched-filter (first 40) and derivative
    (last 40) outputs of this step at all 40 phases.  Returns the new
    state and the step's outputs (slot value, slot valid, frame done,
    sync type, parse, aos, los, slip, slipped-in-frame).
    """
    clk = (state.clk + 1) % 2
    is_clk = clk == 1

    idx = state.index.to(torch.int64)[:, None]
    new_sum = torch.gather(mf_t[:, :TIMING_NUM_PHASES], 1, idx)[:, 0]
    new_dif = torch.gather(mf_t[:, TIMING_NUM_PHASES:], 1, idx)[:, 0]
    mf_sum = torch.where(is_clk, new_sum, state.mf_sum)
    mf_dif = torch.where(is_clk, new_dif, state.mf_dif)

    # timing vote on the off-phase
    dif_signed = torch.where(mf_sum < 0, -mf_dif, mf_dif)
    vote = torch.sign(dif_signed).to(torch.int32)
    thr = torch.where(is_clk, state.thr, state.thr + vote)

    thresh = torch.where(state.flock, TIMING_THRESH_LOCKED, TIMING_THRESH_UNLOCKED)
    fwd = ~is_clk & (thr > thresh)
    bwd = ~is_clk & (thr < -thresh)
    index = torch.where(fwd, (state.index + 1) % TIMING_NUM_PHASES, state.index)
    index = torch.where(bwd, (index + TIMING_NUM_PHASES - 1) % TIMING_NUM_PHASES, index)
    thr = torch.where(fwd | bwd, 0, thr)
    fwd_wrap = fwd & (index == 0)
    bwd_wrap = bwd & (index == TIMING_NUM_PHASES - 1)
    clk = torch.where(fwd_wrap | bwd_wrap, 1, clk)

    # delayed emission: one (value, valid) slot per step
    emit_now = is_clk | fwd_wrap
    zero = torch.zeros_like(state.pending)
    slot_val = torch.where(emit_now, state.pending, zero)
    slot_valid = emit_now & state.pending_valid
    pending = torch.where(is_clk, new_sum, state.pending)
    pending = torch.where(fwd_wrap, zero, pending)           # inserted erasure
    pending_valid = (is_clk | fwd_wrap | state.pending_valid) & ~bwd_wrap

    # framer
    consumed = slot_valid
    flock0 = state.flock
    sync_win = torch.where(consumed[:, None],
                           torch.cat([state.sync_win[:, 1:], slot_val[:, None]], dim=-1),
                           state.sync_win)
    fclk = torch.where(consumed & flock0, state.fclk + 1, state.fclk)

    sc = sync_check(sync_win)
    sc_unlocked_ok = unlocked_pass(sc)

    at8 = consumed & flock0 & (fclk == SYNC_SYMBOLS)
    sync_type = torch.where(at8, sc.ftype, state.sync_type)
    sync_pass = torch.where(at8, locked_pass(sc), state.sync_pass)

    resync = (consumed & flock0 & sc_unlocked_ok & ~at8
              & (fclk >= SYNC_SYMBOLS - 2) & (fclk <= SYNC_SYMBOLS + 2))
    fclk = torch.where(resync, SYNC_SYMBOLS, fclk)
    sync_type = torch.where(resync, sc.ftype, sync_type)
    sync_pass = sync_pass | resync

    slipped = (state.slip_in_frame | fwd_wrap | bwd_wrap) & flock0 & ~resync

    frame_done = consumed & flock0 & (fclk == FRAME_SYMBOLS)
    fclk = torch.where(frame_done, 0, fclk)

    is_eot = frame_done & (sync_type == FT_EOT)
    good = frame_done & sync_pass & ~is_eot
    bad = frame_done & ~sync_pass & ~is_eot
    ferr = torch.where(good | resync, 0, torch.where(bad, state.ferr + 1, state.ferr))
    too_many = bad & (ferr > MAX_FRAME_ERRORS)
    los = is_eot | too_many
    parse = good | (bad & ~too_many)

    aos = consumed & ~flock0 & sc_unlocked_ok

    flock = (flock0 | aos) & ~los
    fclk = torch.where(aos, SYNC_SYMBOLS, fclk)
    ferr = torch.where(aos, 0, ferr)
    sync_type = torch.where(aos, sc.ftype, sync_type)
    sync_pass = sync_pass | aos
    sync_win = torch.where(los[:, None], torch.zeros_like(sync_win), sync_win)

    new_state = state._replace(
        clk=clk, thr=thr, index=index, mf_sum=mf_sum, mf_dif=mf_dif,
        pending=pending, pending_valid=pending_valid,
        flock=flock, fclk=fclk, ferr=ferr,
        sync_win=sync_win, sync_type=sync_type, sync_pass=sync_pass,
        slip_in_frame=slipped & ~frame_done & ~aos,
    )
    ys = (slot_val, slot_valid, frame_done, sync_type, parse, aos, los,
          fwd_wrap | bwd_wrap, slipped)
    return new_state, ys


def pack_flags(valid, done, parse, aos, los, slip, slipped, sync_type) -> torch.Tensor:
    """Per-step event masks -> one int32 flags word (F_* layout)."""
    i32 = torch.int32
    return (valid.to(i32) * F_VALID + done.to(i32) * F_DONE + parse.to(i32) * F_PARSE
            + aos.to(i32) * F_AOS + los.to(i32) * F_LOS + slip.to(i32) * F_SLIP
            + slipped.to(i32) * F_SLIPFRAME + (sync_type.to(i32) << F_TYPE_SHIFT))


def receiver_scan_ref(samples: torch.Tensor, state: ReceiverState):
    """Plain PyTorch scan over one [B, S2] block, on any device.

    The filter runs over ``ext = state.window[:, 1:] ++ samples``.
    Returns (slot_val [B, S2] f32, flags [B, S2] i32, new state) with the
    next ``window``; ``sym_hist`` is left to the caller.
    """
    ext = torch.cat([state.window[:, 1:], samples], dim=-1)
    mf_all = mf_bank(ext).permute(2, 0, 1).contiguous()       # [S2, B, 80]
    ys = []
    for t in range(mf_all.shape[0]):
        state, y = _scan_step(state, mf_all[t])
        ys.append(y)
    (slot_val, valid, done, stype, parse, aos, los, slip, slipped) = (
        torch.stack(col, dim=1) for col in zip(*ys))
    flags = pack_flags(valid, done, parse, aos, los, slip, slipped, stype)
    return slot_val, flags, state._replace(window=ext[:, -TIMING_FILTER_TAPS:])


# the ReceiverState fields the kernel carries, in its argument order
_KERNEL_FIELDS = ("clk", "thr", "index", "fclk", "ferr", "sync_type",
                  "mf_sum", "mf_dif", "pending",
                  "pending_valid", "flock", "sync_pass", "slip_in_frame",
                  "sync_win")
# the sync patterns go to the kernel by value, from host memory
_PATS_HOST = np.ascontiguousarray(SYNC_PATTERNS, dtype=np.float32)
_KERNEL_DTYPES = {"mf_sum": torch.float32, "mf_dif": torch.float32,
                  "pending": torch.float32, "sync_win": torch.float32,
                  "pending_valid": torch.bool, "flock": torch.bool,
                  "sync_pass": torch.bool, "slip_in_frame": torch.bool}


def receiver_scan_cuda(samples: torch.Tensor, state: ReceiverState):
    """The CUDA kernel K2: same contract as ``receiver_scan_ref``.

    The kernel reads ``samples`` and ``window`` itself, with their
    strides, so no ``ext`` is built; slot values and flags come back as
    contiguous [B, S2] tensors, the next window as a contiguous [B, 31].
    """
    _build.check_cuda_input("receiver_scan_cuda", samples, torch.float32, 2,
                            contiguous=False)
    b, s2 = samples.shape
    if s2 == 0:
        raise ValueError("receiver_scan_cuda: a block of 0 samples holds no step")
    dev = samples.device
    window = state.window
    _build.check_cuda_input("receiver_scan_cuda: state.window", window, torch.float32, 2,
                            contiguous=False)
    if window.shape != (b, TIMING_FILTER_TAPS) or window.device != dev:
        raise ValueError(f"receiver_scan_cuda: state.window must be [B, "
                         f"{TIMING_FILTER_TAPS}] on {dev}")
    ins = []
    for name in _KERNEL_FIELDS:
        x = getattr(state, name)
        dtype = _KERNEL_DTYPES.get(name, torch.int32)
        _build.check_cuda_input(f"receiver_scan_cuda: state.{name}", x, dtype,
                                2 if name == "sync_win" else 1)
        if x.shape[0] != b or x.device != dev:
            raise ValueError(f"receiver_scan_cuda: state.{name} does not match samples")
        ins.append(x)
    if state.sync_win.shape[1] != SYNC_SYMBOLS:
        raise ValueError("receiver_scan_cuda: sync_win must be [B, 8]")
    outs = [torch.empty_like(x) for x in ins]
    window_out = torch.empty((b, TIMING_FILTER_TAPS), dtype=torch.float32, device=dev)
    taps = on_device(_BANK_BF16, dev)
    slot = torch.empty((b, s2), dtype=torch.float32, device=dev)
    flags = torch.empty((b, s2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.RECEIVER_SCAN.launch(
            samples.data_ptr(), *samples.stride(), window.data_ptr(), *window.stride(),
            taps.data_ptr(), _PATS_HOST.ctypes.data,
            *(x.data_ptr() for x in ins), *(x.data_ptr() for x in outs),
            window_out.data_ptr(), slot.data_ptr(), flags.data_ptr(), b, s2,
            ctypes.c_void_p(stream))
    new_state = state._replace(window=window_out, **dict(zip(_KERNEL_FIELDS, outs)))
    return slot, flags, new_state


def receive_block(samples: torch.Tensor, state: ReceiverState,
                  use_kernel: bool | None = None) -> tuple[BlockEvents, ReceiverState]:
    """Process one [B, S2] block of 2-samples/symbol soft samples.

    Returns fixed-shape BlockEvents and the updated carry.  The scan and
    the compaction run on their kernels (K2, K5) for CUDA tensors and on
    their plain versions for CPU tensors, unless ``use_kernel`` says
    otherwise.
    """
    kernel = _build.use_kernel_for(samples, use_kernel)
    with span("scan"):
        slot_vals, flags, state2 = (receiver_scan_cuda if kernel else receiver_scan_ref)(
            samples, state)
    with span("compaction"):
        return (compact_cuda if kernel else compact_ref)(slot_vals, flags, state2)


def compact_ref(slot_vals: torch.Tensor, flags: torch.Tensor,
                state2: ReceiverState) -> tuple[BlockEvents, ReceiverState]:
    """The scan's [B, S2] slot values and flags -> BlockEvents, and the
    carry with the rolled symbol history; plain PyTorch, on any device."""
    b, s2 = flags.shape
    dev = flags.device
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


# a block's symbol stream stays in shared memory up to this size (the 48 KB
# a block gets without asking, less the kernel's own); above, in a scratch
_STREAM_SHARED_BYTES = 47 * 1024


def compact_cuda(slot_vals: torch.Tensor, flags: torch.Tensor,
                 state2: ReceiverState) -> tuple[BlockEvents, ReceiverState]:
    """The CUDA kernel K5: ``compact_ref``'s contract and bits, in one
    launch.  The outputs are new contiguous tensors; the inputs are only
    read."""
    name = "compact_cuda"
    _build.check_cuda_input(name, flags, torch.int32, 2, contiguous=False)
    b, s2 = flags.shape
    if s2 == 0:
        raise ValueError(f"{name}: a block of 0 steps holds no slot")
    dev = flags.device
    hist = state2.sym_hist
    for what, x, dtype, shape in (("slot_vals", slot_vals, torch.float32, (b, s2)),
                                  ("state.sym_hist", hist, torch.float32,
                                   (b, FRAME_SYMBOLS - 1))):
        _build.check_cuda_input(f"{name}: {what}", x, dtype, 2, contiguous=False)
        if tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name}: {what} must be {list(shape)} on {dev}, "
                             f"got {tuple(x.shape)} on {x.device}")
    slot_vals, flags, hist = slot_vals.contiguous(), flags.contiguous(), hist.contiguous()
    f = min(max_frames_per_block(s2), s2)     # compact_ref's sort keeps at most S2
    words = FRAME_SYMBOLS - 1 + s2 + f
    scratch = (torch.empty((b, words), dtype=torch.float32, device=dev)
               if 4 * words > _STREAM_SHARED_BYTES else None)
    frames = torch.empty((b, f, FRAME_SYMBOLS), dtype=torch.float32, device=dev)
    valid, parse, slipped = (torch.empty((b, f), dtype=torch.bool, device=dev)
                             for _ in range(3))
    ftype = torch.empty((b, f), dtype=torch.int32, device=dev)
    aos, los = (torch.empty((b,), dtype=torch.bool, device=dev) for _ in range(2))
    n_slips = torch.empty((b,), dtype=torch.int32, device=dev)
    sym_hist = torch.empty_like(hist)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.COMPACT.launch(
            slot_vals.data_ptr(), flags.data_ptr(), hist.data_ptr(), frames.data_ptr(),
            valid.data_ptr(), parse.data_ptr(), slipped.data_ptr(), ftype.data_ptr(),
            aos.data_ptr(), los.data_ptr(), n_slips.data_ptr(), sym_hist.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, s2, f,
            ctypes.c_void_p(stream))
    events = BlockEvents(
        frames=frames, frame_valid=valid, frame_type=ftype, frame_parse=parse,
        frame_slipped=slipped, aos=aos, los=los, locked=state2.flock, n_slips=n_slips,
    )
    return events, state2._replace(sym_hist=sym_hist)
