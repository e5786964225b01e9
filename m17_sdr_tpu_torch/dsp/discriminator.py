"""Receive front end: RSSI/AGC, AFC mixer, limiter, FM discriminator,
DC removal and decimation by 5, for a [B, 2, T] block.

Port of ``m17_sdr_tpu.dsp.discriminator``; see that module for the
reasons behind the DC and AFC schemes.  Everything is elementwise over
the block but two per-channel means; the carry is a 2-sample
discriminator tail, the AFC NCO phase and frequency estimate, the
RSSI/AGC meter and the DC estimate.

``rx_front_end`` runs the CUDA kernel K3 (``csrc/front_end.cu``) for
CUDA tensors and the plain PyTorch version, ``rx_front_end_ref``, for
CPU tensors; ``use_kernel=False`` is the plain version on any device.
The two give the same bits on the card: the means add in one fixed
order (``pairwise_sum``) that the kernel reproduces.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build
from ..spec.constants import RX_DECIMATION
from . import iq as iqmod

AFC_LOOP_GAIN = 0.1
DC_SMOOTH_GAIN = 0.25
RSSI_SMOOTH = 0.9
AGC_LOW, AGC_HIGH = 0.25, 0.75
AGC_STEP = 1.05
AGC_GAIN_MIN, AGC_GAIN_MAX = 1.0 / 64.0, 64.0


class RxFrontEndState(NamedTuple):
    """Per-channel front-end carry."""

    disc_tail: torch.Tensor   # [B, 2, 2] planar: z[n-2], z[n-1]
    nco_phase: torch.Tensor   # [B] AFC mixer phase accumulator
    afc_delta: torch.Tensor   # [B] AFC frequency estimate (rad/sample)
    rssi: torch.Tensor        # [B] smoothed signal level
    agc_gain: torch.Tensor    # [B] software AGC gain recommendation
    dc_est: torch.Tensor      # [B] smoothed discriminator DC estimate
    dc_seeded: torch.Tensor   # [B] bool: dc_est holds a measurement

    @staticmethod
    def init(batch: int, device) -> "RxFrontEndState":
        f32 = dict(dtype=torch.float32, device=device)
        return RxFrontEndState(
            disc_tail=torch.zeros((batch, 2, 2), **f32),
            nco_phase=torch.zeros((batch,), **f32),
            afc_delta=torch.zeros((batch,), **f32),
            rssi=torch.zeros((batch,), **f32),
            agc_gain=torch.ones((batch,), **f32),
            dc_est=torch.zeros((batch,), **f32),
            dc_seeded=torch.zeros((batch,), dtype=torch.bool, device=device),
        )


def limit(iq2: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-magnitude hard limiter."""
    mag = torch.clamp(iqmod.magnitude(iq2), min=eps)
    return iq2 / mag[..., None, :]


def nco_mix(iq2: torch.Tensor, phase0: torch.Tensor, delta: torch.Tensor):
    """Rotate [B, 2, T] IQ by a per-channel linear phase ramp.

    Returns (mixed, final phase wrapped to [0, 2 pi))."""
    t = torch.arange(iq2.shape[-1], dtype=torch.float32, device=iq2.device)
    phase = phase0[:, None] + delta[:, None] * t
    mixed = iqmod.rotate(iq2, torch.cos(phase), torch.sin(phase))
    end = torch.remainder(phase0 + delta * iq2.shape[-1], 2.0 * math.pi)
    end = torch.where(torch.isnan(end), torch.zeros_like(end), end)  # NaN scrub
    return mixed, end


def scale_int16(wire: torch.Tensor) -> torch.Tensor:
    """int16 interleaved IQ [..., T, 2] -> planar float32 [..., 2, T],
    scaled by 3e-5 as ``rx_front_end`` scales int16 input."""
    return (wire.to(torch.float32) * 3.0e-5).movedim(-1, -2)


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in float64 as a balanced tree of adjacent
    pairs: the axis zero-padded to a power of two, then pairs, pairs of
    pairs, and so on (padding by one zero at each odd level adds the
    same).  A fixed order, which K3 reproduces, so the sum does not depend
    on how a device splits the reduction.  Float64, because a float32 tree
    is a unit in the last place away from the correctly rounded mean often
    enough that the AFC loop carries the difference past the JAX
    package's tolerance."""
    x = x.double()
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = F.pad(x, (0, 1))
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def pairwise_mean(x: torch.Tensor) -> torch.Tensor:
    """``pairwise_sum`` over the last axis divided by its length, a true
    division in float64 on every device, rounded to float32."""
    s = pairwise_sum(x)
    return (s / torch.full_like(s, x.shape[-1])).float()


def rx_front_end(
    iq2: torch.Tensor,
    state: RxFrontEndState,
    in_frame: torch.Tensor,
    afc_enabled: bool = False,
    use_kernel: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor, RxFrontEndState]:
    """Front end for one [B, 2, T] block (T a positive multiple of 5),
    int16 or float32.

    Returns (soft samples [B, T//5] at 2 samples/symbol, DC offset [B],
    new state).  ``in_frame`` [B] bool gates the AFC integrator, which
    resets out of frame; with AFC off the estimate is dropped.  K3 runs
    for CUDA tensors, the plain version for CPU tensors, unless
    ``use_kernel`` says otherwise (see ``_build.use_kernel_for``).
    """
    t = iq2.shape[-1]
    if t % RX_DECIMATION or t == 0:
        raise ValueError(f"block length {t} is not a positive multiple of {RX_DECIMATION}")
    if _build.use_kernel_for(iq2, use_kernel):
        return rx_front_end_cuda(iq2, state, in_frame, afc_enabled)
    return rx_front_end_ref(iq2, state, in_frame, afc_enabled)


def rx_front_end_ref(iq2: torch.Tensor, state: RxFrontEndState, in_frame: torch.Tensor,
                     afc_enabled: bool = False):
    """The plain PyTorch front end, on any device: ``rx_front_end``'s
    contract."""
    if iq2.dtype == torch.int16:
        iq2 = iq2.to(torch.float32) * 3.0e-5

    level = pairwise_mean(iqmod.magnitude(iq2))
    rssi = torch.where(state.rssi > 0.0,
                       RSSI_SMOOTH * state.rssi + (1.0 - RSSI_SMOOTH) * level,
                       level)
    agc = torch.where(rssi < AGC_LOW, state.agc_gain * AGC_STEP,
                      torch.where(rssi > AGC_HIGH,
                                  state.agc_gain / AGC_STEP, state.agc_gain))
    agc = torch.clamp(agc, AGC_GAIN_MIN, AGC_GAIN_MAX)

    zero = torch.zeros_like(state.afc_delta)
    if afc_enabled:
        delta = torch.where(in_frame, state.afc_delta, zero)
        iq2, nco_phase = nco_mix(iq2, state.nco_phase, delta)
    else:
        nco_phase = state.nco_phase

    z = limit(iq2)
    zh = torch.cat([state.disc_tail, z], dim=-1)   # [B, 2, T+2]
    z0 = zh[..., 1:-1]   # z[n-1]
    z1 = zh[..., :-2]    # z[n-2]
    u = (iqmod.conj_mul_im(z0, z) + iqmod.conj_mul_im(z1, z0)) * 0.5

    offset = pairwise_mean(u)

    # unlocked: subtract the block mean and reseed; locked: subtract the
    # carried estimate and update it slowly
    held = in_frame & state.dc_seeded
    dc_used = torch.where(held, state.dc_est, offset)
    dc_est = torch.where(held, state.dc_est + DC_SMOOTH_GAIN * (offset - state.dc_est),
                         offset)

    dec = u[:, RX_DECIMATION - 1::RX_DECIMATION] - dc_used[:, None]

    if afc_enabled:
        afc_delta = torch.where(in_frame, state.afc_delta - offset * AFC_LOOP_GAIN, zero)
        dc_est = dc_est + torch.where(in_frame, afc_delta - state.afc_delta, zero)
    else:
        afc_delta = zero

    new_state = RxFrontEndState(
        disc_tail=z[..., -2:], nco_phase=nco_phase, afc_delta=afc_delta,
        rssi=rssi, agc_gain=agc,
        dc_est=dc_est, dc_seeded=torch.ones_like(state.dc_seeded),
    )
    return dec, offset, new_state


# K3's launch shape (csrc/front_end.cu): a chunk is the samples a thread
# block takes at a time, 128 threads x 8 consecutive samples
_CHUNK = 1024
_MAX_CHUNKS = 32              # chunks a thread block takes at most
_BLOCKS_WANTED = 4            # thread blocks a streaming multiprocessor, at least


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def front_end_split(b: int, t: int, sms: int) -> tuple[int, int]:
    """(chunks a thread block, thread blocks a channel) for K3 at [b, 2, t]
    on a card of ``sms`` multiprocessors.  A channel's chunks go to as few
    blocks as fill the card ``_BLOCKS_WANTED`` times over; a block's
    chunks are a power of two, so each block sums one whole subtree of
    ``pairwise_sum``'s order."""
    n_chunks = -(-t // _CHUNK)
    k = min(1 << (n_chunks - 1).bit_length(), _MAX_CHUNKS)
    while k > 1 and b * -(-n_chunks // k) < _BLOCKS_WANTED * sms:
        k //= 2
    return k, -(-n_chunks // k)


def rx_front_end_cuda(iq2: torch.Tensor, state: RxFrontEndState, in_frame: torch.Tensor,
                      afc_enabled: bool = False):
    """The CUDA kernel K3: ``rx_front_end_ref``'s contract and bits.

    One launch (two where a channel is split over several thread blocks:
    the blocks' arrival counters are zeroed first).  The input is read
    through its strides, so slices of a larger tensor need no copy; the
    outputs and the new state are new contiguous tensors, and the input
    state is only read.
    """
    name = "rx_front_end_cuda"
    if iq2.dtype not in (torch.int16, torch.float32):
        raise ValueError(f"{name}: expected int16 or float32 IQ, got {iq2.dtype}")
    _build.check_cuda_input(name, iq2, iq2.dtype, 3, contiguous=False)
    b, planes, t = iq2.shape
    if planes != 2:
        raise ValueError(f"{name}: expected [B, 2, T] planar IQ, got {tuple(iq2.shape)}")
    if t % RX_DECIMATION or t == 0:
        raise ValueError(f"{name}: block length {t} is not a positive multiple of "
                         f"{RX_DECIMATION}")
    dev = iq2.device
    fields = {}
    for f, x in zip(RxFrontEndState._fields, state):
        dtype = torch.bool if f == "dc_seeded" else torch.float32
        ndim = 3 if f == "disc_tail" else 1
        _build.check_cuda_input(f"{name}: state.{f}", x, dtype, ndim, contiguous=False)
        want = (b, 2, 2) if f == "disc_tail" else (b,)
        if tuple(x.shape) != want or x.device != dev:
            raise ValueError(f"{name}: state.{f} must be {list(want)} on {dev}, "
                             f"got {tuple(x.shape)} on {x.device}")
        fields[f] = x if f == "disc_tail" else x.contiguous()
    _build.check_cuda_input(f"{name}: in_frame", in_frame, torch.bool, 1, contiguous=False)
    if tuple(in_frame.shape) != (b,) or in_frame.device != dev:
        raise ValueError(f"{name}: in_frame must be [{b}] on {dev}")
    in_frame = in_frame.contiguous()

    f32 = dict(dtype=torch.float32, device=dev)
    nd = t // RX_DECIMATION
    dec = torch.empty((b, nd), **f32)
    offset = torch.empty((b,), **f32)
    out = {f: torch.empty_like(x, memory_format=torch.contiguous_format)
           for f, x in fields.items()}
    esize = iq2.element_size()
    vec = (iq2.stride(2) == 1 and iq2.data_ptr() % 16 == 0
           and (iq2.stride(0) * esize) % 16 == 0 and (iq2.stride(1) * esize) % 16 == 0)
    with torch.cuda.device(dev):
        k, g = front_end_split(b, t, _sm_count(torch.cuda.current_device()))
        if g > 1:
            partial = torch.empty((b * g, 2), dtype=torch.float64, device=dev)
            arrived = torch.zeros((b,), dtype=torch.int32, device=dev)
            scratch = (partial.data_ptr(), arrived.data_ptr())
        else:
            scratch = (None, None)
        tail = fields["disc_tail"]
        stream = torch.cuda.current_stream().cuda_stream
        _build.FRONT_END.launch(
            iq2.data_ptr(), int(iq2.dtype == torch.int16), *iq2.stride(), int(vec),
            in_frame.data_ptr(), tail.data_ptr(), *tail.stride(),
            *(fields[f].data_ptr() for f in RxFrontEndState._fields[1:]),
            dec.data_ptr(), offset.data_ptr(),
            *(out[f].data_ptr() for f in RxFrontEndState._fields),
            *scratch, b, t, k, g, int(afc_enabled), ctypes.c_void_p(stream))
    return dec, offset, RxFrontEndState(**out)
