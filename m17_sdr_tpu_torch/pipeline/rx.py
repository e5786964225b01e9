"""Receive pipeline: planar IQ blocks -> decoded frames + session state.

Port of ``m17_sdr_tpu.pipeline.rx``: the front end, the timing+framer
scan, the optional frame equalizer, the four typed decodes and the
session layer (LICH reassembly, routing gates, counters).  See the JAX
module for the measurements behind the gate constants.

``use_kernel`` selects the CUDA kernels (the receiver scan and the
Viterbi decoder): None means exactly when the tensors are on CUDA,
False the plain PyTorch versions on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..dsp.discriminator import RxFrontEndState, rx_front_end
from ..dsp.equalize import EqState, equalize_frames
from ..frame import rx_frames
from ..frame.receiver import ReceiverState, receive_block
from ..spec import crc
from ..spec.constants import FT_BERT, FT_LINK, FT_PACKET, FT_STREAM, LICH_CHUNKS, LSF_BYTES
from ..trace import count, span

STREAM_QUALITY_MIN = 0.9    # minimum normalized Viterbi confidence to route voice
STREAM_FN_WINDOW = 16       # a routed FN must advance 1..16 past the anchor
# "no routed frame yet": the JAX package's uint32 sentinel, held in int64
_FN_NONE = 0xFFFFFFFF

EYE_ARM = 0.155             # eye-closure statistic that arms the equalizer
EYE_DISARM = 0.135
EYE_SMOOTH = 0.5


class RxSessionState(NamedTuple):
    """All per-channel receiver state."""

    frontend: RxFrontEndState
    receiver: ReceiverState
    eq: EqState
    lich_asm: torch.Tensor        # [B, 30] uint8 LSF being reassembled
    lich_good: torch.Tensor       # [B, 30] uint8 last CRC-valid LSF
    lich_good_valid: torch.Tensor  # [B] bool
    golay_errors: torch.Tensor    # [B] i32 running count
    n_frames: torch.Tensor        # [B] i32 frames received
    last_fn: torch.Tensor         # [B] int64 last anchored stream FN
    eye_est: torch.Tensor         # [B] smoothed eye-closure statistic
    eq_armed: torch.Tensor        # [B] bool: auto equalizer armed

    @staticmethod
    def init(batch: int, device) -> "RxSessionState":
        return RxSessionState(
            frontend=RxFrontEndState.init(batch, device),
            receiver=ReceiverState.init(batch, device),
            eq=EqState.init_identity(batch, device),
            lich_asm=torch.zeros((batch, LSF_BYTES), dtype=torch.uint8, device=device),
            lich_good=torch.zeros((batch, LSF_BYTES), dtype=torch.uint8, device=device),
            lich_good_valid=torch.zeros((batch,), dtype=torch.bool, device=device),
            golay_errors=torch.zeros((batch,), dtype=torch.int32, device=device),
            n_frames=torch.zeros((batch,), dtype=torch.int32, device=device),
            last_fn=torch.full((batch,), _FN_NONE, dtype=torch.int64, device=device),
            eye_est=torch.zeros((batch,), dtype=torch.float32, device=device),
            eq_armed=torch.zeros((batch,), dtype=torch.bool, device=device),
        )


class RxBlockOutput(NamedTuple):
    """Decoded results for one block (F = frame slots per block)."""

    stream_valid: torch.Tensor    # [B, F]
    stream_fn: torch.Tensor       # [B, F] int64
    stream_payload: torch.Tensor  # [B, F, 16]
    stream_gate: torch.Tensor     # [B, F] payload routed
    lsf_valid: torch.Tensor       # [B, F] an LSF frame decoded with good CRC
    lsf_bytes: torch.Tensor       # [B, F, 30]
    packet_valid: torch.Tensor    # [B, F]
    packet_data: torch.Tensor     # [B, F, 25]
    packet_eof: torch.Tensor      # [B, F]
    packet_fn: torch.Tensor       # [B, F]
    bert_valid: torch.Tensor      # [B, F]
    bert_bits: torch.Tensor       # [B, F, 197]
    locked: torch.Tensor          # [B]
    aos: torch.Tensor             # [B]
    los: torch.Tensor             # [B]
    n_slips: torch.Tensor         # [B]
    golay_errors_blk: torch.Tensor  # [B] errors in this block
    dc_offset: torch.Tensor       # [B]
    rssi: torch.Tensor            # [B]
    viterbi_metric: torch.Tensor  # [B, F] decode confidence of the used path
    frame_slipped: torch.Tensor   # [B, F]
    stream_quality: torch.Tensor  # [B, F]
    stream_lich_ok: torch.Tensor  # [B, F] an LSF was known for routing
    stream_fn_ok: torch.Tensor    # [B, F] FN-continuity window passed


def rx_block(iq: torch.Tensor, state: RxSessionState, afc_enabled: bool = False,
             equalize=False, use_kernel: bool | None = None):
    """Process one [B, 2, T] planar IQ block (int16 or float32, T % 5 == 0).

    ``equalize``: False or "off", True or "on", or "auto" (arm the frame
    equalizer per channel when the eye closes).  Returns
    (RxBlockOutput, new RxSessionState).
    """
    with span("rx_block"):
        with span("front_end"):
            soft2x, dc_offset, fe_state = rx_front_end(
                iq, state.frontend, in_frame=state.receiver.flock, afc_enabled=afc_enabled)
        return _decode_soft(soft2x, dc_offset, fe_state, state,
                            equalize=equalize, use_kernel=use_kernel)


def rx_block_soft(soft2x: torch.Tensor, state: RxSessionState, equalize=False,
                  use_kernel: bool | None = None):
    """Process one [B, S2] block of 2-samples/symbol soft samples, without
    the front end."""
    with span("rx_block"):
        with span("front_end"):
            dc = torch.zeros(soft2x.shape[0], dtype=torch.float32, device=soft2x.device)
        return _decode_soft(soft2x, dc, state.frontend, state,
                            equalize=equalize, use_kernel=use_kernel)


def _decode_soft(soft2x, dc_offset, fe_state, state: RxSessionState,
                 equalize=False, use_kernel: bool | None = None):
    """Timing/framer scan, equalizer, typed decode and session update."""
    b = soft2x.shape[0]
    events, rx_state = receive_block(soft2x, state.receiver, use_kernel=use_kernel)
    f = events.frames.shape[1]

    frames_sym, eq_c = events.frames, state.eq.c
    eye_est, eq_armed = state.eye_est, state.eq_armed
    if equalize in (True, "on", "auto"):
        with span("equalize"):
            frames_sym, eq_c, eye_est, eq_armed = _equalize(events, state, equalize)
    eq_state = state.eq._replace(c=eq_c)

    # ---- decode every frame slot through every typed path
    with span("demap"):
        soft = rx_frames.demap_frame(frames_sym.reshape(b * f, -1))
    with span("decode.lsf"):
        lsf = rx_frames.decode_lsf(soft, use_kernel)
    with span("decode.stream"):
        stream = rx_frames.decode_stream(soft, use_kernel)
    with span("decode.packet"):
        packet = rx_frames.decode_packet(soft, use_kernel)
    with span("decode.bert"):
        bert = rx_frames.decode_bert(soft, use_kernel)
    with span("session"):
        return _session(events, rx_state, fe_state, eq_state, eye_est, eq_armed, dc_offset,
                        state, lsf, stream, packet, bert)


def _equalize(events, state: RxSessionState, equalize):
    """The frame equalizer, "on" or "auto" -> (frames, taps, eye_est, eq_armed)."""
    eq_c = state.eq.c
    frames_sym = events.frames
    valid_f = events.frame_valid & events.frame_parse            # [B, F]
    eye_est = state.eye_est
    eq_armed = state.eq_armed
    if equalize in (True, "on"):
        frames_sym, eq_c = equalize_frames(frames_sym, eq_c, update=valid_f)
    elif equalize == "auto":
        # eye-closure statistic of the raw symbols, in demap units
        sync_mag = frames_sym[..., :8].abs().mean(dim=-1)
        cor = 1.0 / torch.clamp(sync_mag, min=1e-9)
        mag = frames_sym[..., 8:].abs() * cor[..., None]
        disp = torch.minimum((mag - 1.0 / 3.0).abs(), (mag - 1.0).abs())
        d_frame = disp.mean(dim=-1)                              # [B, F]
        # signal-bearing frames only (junk frames after a session look
        # like heavy ISI but carry no signal)
        lvl = frames_sym.abs().mean(dim=-1)
        sig_f = valid_f & (lvl > 0.15)
        nsig = sig_f.sum(dim=-1)
        zero = torch.zeros_like(d_frame)
        d_mean = torch.where(sig_f, d_frame, zero).sum(dim=-1) / torch.clamp(nsig, min=1)
        eye_est = torch.where(
            nsig > 0,
            torch.where(state.eye_est > 0.0,
                        EYE_SMOOTH * state.eye_est + (1.0 - EYE_SMOOTH) * d_mean,
                        d_mean),
            state.eye_est)
        # arm on the worst frame now, disarm on the smoothed estimate
        d_now = torch.where(sig_f, d_frame, zero).amax(dim=-1)
        eq_armed = torch.where(torch.maximum(eye_est, d_now) > EYE_ARM, True,
                               torch.where(eye_est < EYE_DISARM, False, state.eq_armed))
        # The JAX package runs this stage under lax.cond(any(eq_armed)).
        # Here it always runs, masked by eq_armed: the same outputs
        # (unarmed channels keep their frames and taps) without a
        # device->host read of the condition on every block.
        out, eq_c = equalize_frames(frames_sym, eq_c, update=valid_f & eq_armed[:, None])
        frames_sym = torch.where(eq_armed[:, None, None], out, frames_sym)
    return frames_sym, eq_c, eye_est, eq_armed


def _session(events, rx_state, fe_state, eq_state, eye_est, eq_armed, dc_offset,
             state: RxSessionState, lsf, stream, packet, bert):
    """The session layer over the typed decodes of the F slots: selection
    by frame type, LICH reassembly, FN continuity, gates, counters."""
    b, f = events.frame_valid.shape
    dev = events.frame_valid.device
    use = events.frame_valid & events.frame_parse
    # every slot went through all four typed decodes; ``use`` of them
    # held a parsed frame, each decoded by its own type's path
    n_use = use.sum(dim=-1, dtype=torch.int32)
    count("decode.slots", 4 * b * f)
    count("decode.frames", n_use)
    is_lsf = use & (events.frame_type == FT_LINK)
    is_stream = use & (events.frame_type == FT_STREAM)
    is_packet = use & (events.frame_type == FT_PACKET)
    is_bert = use & (events.frame_type == FT_BERT)

    lsf_ok = is_lsf & lsf.crc_ok.reshape(b, f)

    # ---- LICH reassembly over the F slots in order; the CRC of every
    # intermediate assembly is one batched call
    chunk = stream.lich_chunk.reshape(b, f, 5)
    seq = stream.lich_seq.reshape(b, f)
    lsf_frame_bytes = lsf.lsf_bytes.reshape(b, f, LSF_BYTES)

    upd = is_stream & (seq < LICH_CHUNKS)
    pos = (seq * 5)[..., None].to(torch.int64)                  # [B, F, 1]
    col = torch.arange(LSF_BYTES, device=dev)[None, None, :]
    write = upd[..., None] & (col >= pos) & (col < pos + 5)     # [B, F, 30]
    src = torch.gather(chunk, -1, torch.clamp(col - pos, 0, 4))

    asm = state.lich_asm
    asm_states = []
    for i in range(f):
        asm = torch.where(write[:, i], src[:, i], asm)
        asm_states.append(asm)
    lich_asm = asm
    asm_stack = torch.stack(asm_states, dim=1)                  # [B, F, 30]
    asm_ok = upd & (crc.crc16_fixed(asm_stack) == 0)

    # a CRC-valid LSF frame also refreshes the good copy; the last wins
    take = asm_ok | lsf_ok
    good_src = torch.where(lsf_ok[..., None], lsf_frame_bytes, asm_stack)
    lich_good = state.lich_good
    for i in range(f):
        lich_good = torch.where(take[:, i, None], good_src[:, i], lich_good)
    lich_good_valid = state.lich_good_valid | take.any(dim=-1)

    quality = stream.quality.reshape(b, f)
    quality_ok = quality > STREAM_QUALITY_MIN

    # FN continuity over the slots in order.  The JAX package does this in
    # uint32; int64 with the 15-bit mask gives the same low bits.
    fn_all = stream.fn.reshape(b, f)
    last_fn = torch.where(events.aos, _FN_NONE, state.last_fn)
    fn_ok_cols = []
    for i in range(f):
        delta = (fn_all[:, i] - last_fn) & 0x7FFF
        fresh = last_fn == _FN_NONE
        fn_ok_cols.append(fresh | ((delta >= 1) & (delta <= STREAM_FN_WINDOW)))
        anchor = is_stream[:, i] & quality_ok[:, i]
        last_fn = torch.where(anchor, fn_all[:, i], last_fn)
    fn_ok = torch.stack(fn_ok_cols, dim=1)

    stream_gate = is_stream & lich_good_valid[:, None] & quality_ok & fn_ok

    golay_blk = torch.where(is_stream, stream.golay_errors.reshape(b, f), 0) \
        .sum(dim=-1, dtype=torch.int32)

    metric = torch.where(
        is_lsf, lsf.metric.reshape(b, f),
        torch.where(is_packet, packet.metric.reshape(b, f),
                    torch.where(is_bert, bert.metric.reshape(b, f),
                                stream.metric.reshape(b, f))))

    # AOS resets the per-session counters
    golay_total = torch.where(events.aos, 0, state.golay_errors) + golay_blk
    n_frames = torch.where(events.aos, 0, state.n_frames) + n_use

    out = RxBlockOutput(
        stream_valid=is_stream,
        stream_fn=fn_all,
        stream_payload=stream.payload.reshape(b, f, 16),
        stream_gate=stream_gate,
        lsf_valid=lsf_ok,
        lsf_bytes=lsf_frame_bytes,
        packet_valid=is_packet,
        packet_data=packet.data.reshape(b, f, 25),
        packet_eof=packet.eof.reshape(b, f),
        packet_fn=packet.fn.reshape(b, f),
        bert_valid=is_bert,
        bert_bits=bert.bits.reshape(b, f, -1),
        locked=events.locked,
        aos=events.aos,
        los=events.los,
        n_slips=events.n_slips,
        golay_errors_blk=golay_blk,
        dc_offset=dc_offset,
        rssi=fe_state.rssi,
        viterbi_metric=metric,
        frame_slipped=events.frame_slipped,
        stream_quality=quality,
        stream_lich_ok=lich_good_valid[:, None].expand(b, f),
        stream_fn_ok=fn_ok,
    )
    new_state = RxSessionState(
        frontend=fe_state, receiver=rx_state, eq=eq_state,
        lich_asm=lich_asm, lich_good=lich_good, lich_good_valid=lich_good_valid,
        golay_errors=golay_total, n_frames=n_frames,
        last_fn=last_fn, eye_est=eye_est, eq_armed=eq_armed,
    )
    return out, new_state


def _stack_blocks(outs: list[RxBlockOutput]) -> RxBlockOutput:
    return RxBlockOutput(*(torch.stack(col, dim=1) for col in zip(*outs)))


def rx_stream(iq_blocks: torch.Tensor, state: RxSessionState, afc_enabled: bool = False,
              equalize=False, use_kernel: bool | None = None):
    """rx_block over [B, NBLK, 2, T] -> outputs stacked on axis 1."""
    outs = []
    for i in range(iq_blocks.shape[1]):
        out, state = rx_block(iq_blocks[:, i], state, afc_enabled=afc_enabled,
                              equalize=equalize, use_kernel=use_kernel)
        outs.append(out)
    return _stack_blocks(outs), state


def rx_stream_soft(soft_blocks: torch.Tensor, state: RxSessionState, equalize=False,
                   use_kernel: bool | None = None):
    """rx_block_soft over [B, NBLK, S2] -> outputs stacked on axis 1."""
    outs = []
    for i in range(soft_blocks.shape[1]):
        out, state = rx_block_soft(soft_blocks[:, i], state, equalize=equalize,
                                   use_kernel=use_kernel)
        outs.append(out)
    return _stack_blocks(outs), state
