"""Adaptive equalizers: the Kalman (RLS) trainer and the in-pipeline
frame-domain equalizer (the stage ``rx_block`` runs).

Port of ``m17_sdr_tpu.dsp.equalize``.

``equalize_train`` is the reference's 5-tap fractionally-spaced (2
samples a symbol) adaptive equalizer, m17_equalize.cpp: its gain comes
from a Bierman UD-factorised square-root Kalman recursion
(eq_k_calculate, :40-102), trained on known symbols (eq_train_known,
:163-180) or decision-directed with a 4FSK slicer at +-0.66
(eq_train_unknown, :185-212).  The recursion's loops over KN=5 are
unrolled into ops over the channel batch, and the symbol loop is a
Python loop with the whole filter state as its carry, as the JAX
package's ``lax.scan`` is.  q = 0.08 and E = 0.01 follow eq_open
(:217-222); d starts at 0.1 (eq_k_reset_ud, :23-35).

The frame stage filters each extracted frame's 192 timing-recovered
symbols with a 5-tap symbol-spaced filter, and each frame then makes one
regularized least-squares tap update toward its sync symbols (+-3) and
its 4FSK decisions.  ``equalize_stage`` is the whole stage as
``rx_block`` runs it, "on" or "auto" (armed per channel by an
eye-closure statistic): the CUDA kernel K4 (``csrc/equalize.cu``, one
launch a call) for CUDA tensors, the plain ``equalize_stage_ref`` for
CPU tensors; ``use_kernel=False`` is the plain version on any device.
The two give the same bits on the card: every sum over a frame's
symbols adds in ``pairwise_sum``'s fixed order, and the 5x5 solve is an
LDL^T factorisation written out in float64, which the kernel follows
step for step (the JAX package leaves both to its einsum and LU solve).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build
from ..spec.constants import FRAME_SYMBOLS
from .discriminator import pairwise_sum

KN = 5          # taps (m17_equalize.cpp:3)
Q = 0.08        # m_q (m17_equalize.cpp:219)
E = 0.01        # m_E (m17_equalize.cpp:220)
D0 = 0.1        # initial d (m17_equalize.cpp:33)

EQ_FRAME_MU = 0.5        # per-frame tap blend toward the LS solution
EQ_FRAME_LAMBDA = 1e-3   # Tikhonov regularizer on XtX

EYE_ARM = 0.155          # eye-closure statistic that arms the auto equalizer
EYE_DISARM = 0.135
EYE_SMOOTH = 0.5
SYNC_SYMBOLS = 8         # a frame's leading sync word (+-3)


class EqState(NamedTuple):
    """Per-channel equalizer state (the statics of m17_equalize.cpp); the
    frame stage uses ``c`` only."""

    c: torch.Tensor        # [B, KN] filter coefficients
    u: torch.Tensor        # [B, KN, KN] strictly-upper UD factor (unit diagonal implied)
    d: torch.Tensor        # [B, KN] diagonal of the UD factor
    samples: torch.Tensor  # [B, KN] delay line, 2 samples a symbol
    level: torch.Tensor    # [B] running |symbol| estimate

    @staticmethod
    def init(batch: int, device) -> "EqState":
        f32 = dict(dtype=torch.float32, device=device)
        return EqState(
            c=torch.zeros((batch, KN), **f32),
            u=torch.zeros((batch, KN, KN), **f32),
            d=torch.full((batch, KN), D0, **f32),
            samples=torch.zeros((batch, KN), **f32),
            level=torch.zeros((batch,), **f32),
        )

    @staticmethod
    def init_identity(batch: int, device) -> "EqState":
        """Centre-tap-1 start: the stage passes its input through
        unchanged until it adapts."""
        st = EqState.init(batch, device)
        st.c[:, KN // 2] = 1.0
        return st

    def restart(self) -> "EqState":
        """Reset the UD factors but keep the converged taps (eq_restart,
        m17_equalize.cpp:141-144)."""
        return self._replace(u=torch.zeros_like(self.u), d=torch.full_like(self.d, D0))


def slicer(sym: torch.Tensor) -> torch.Tensor:
    """4FSK decision at normalized amplitudes +-1/3, +-1
    (eq_train_unknown, m17_equalize.cpp:193-204)."""
    mag = torch.where(sym.abs() >= 0.66, 1.0, 0.333)
    return torch.where(sym > 0, mag, -mag).to(torch.float32)


def _kalman_gain(x: torch.Tensor, u: torch.Tensor, d: torch.Tensor):
    """One UD-factorised gain update over the batch: eq_k_calculate
    (m17_equalize.cpp:40-102) with its loops over KN unrolled, in the
    reference's order of operations.  Returns (g [B, KN], y [B], new u,
    new d)."""
    f = [x[:, 0]]                                               # f = U^T x (6.2-6.3)
    for j in range(1, KN):
        fj = x[:, j]
        for i in range(j):
            fj = fj + u[:, i, j] * x[:, i]
        f.append(fj)

    g = [d[:, j] * f[j] for j in range(KN)]                     # 6.4

    a = [E + g[0] * f[0]]                                       # 6.5
    for j in range(1, KN):
        a.append(a[j - 1] + g[j] * f[j])                        # 6.6

    hq = 1.0 + Q                                                # 6.7
    ht = a[KN - 1] * Q
    y = 1.0 / (a[0] + ht)                                       # 6.19

    new_d = [d[:, 0] * hq * (E + ht) * y]                       # 6.20
    new_u = u.clone()
    for j in range(1, KN):
        b = a[j - 1] + ht                                       # 6.21
        hj = -f[j] * y                                          # 6.11
        y = 1.0 / (a[j] + ht)                                   # 6.22
        new_d.append(d[:, j] * hq * b * y)                      # 6.13
        for i in range(j):
            b0 = u[:, i, j]
            new_u[:, i, j] = b0 + hj * g[i]                     # 6.15
            g[i] = g[i] + g[j] * b0                             # 6.16

    return torch.stack(g, dim=-1), y, new_u, torch.stack(new_d, dim=-1)


def _step(state: EqState, s2: torch.Tensor, known: torch.Tensor, use_known: torch.Tensor):
    """One symbol: shift 2 samples in, equalize, train, adapt.  s2 [B, 2],
    known [B], use_known [B] bool."""
    samples = torch.cat([state.samples[:, 2:], s2], dim=-1)
    prod = samples * state.c                                    # eq_equalize
    sym = prod[:, 0]
    for k in range(1, KN):              # in tap order, as XLA's CPU reduce sums
        sym = sym + prod[:, k]
    err = torch.where(use_known, known, slicer(sym)) - sym
    g, y, u, d = _kalman_gain(samples, state.u, state.d)
    c = state.c + (err * y)[:, None] * g                        # eq_k_update
    return EqState(c=c, u=u, d=d, samples=samples, level=state.level), sym


def equalize_train(samples2x: torch.Tensor, state: EqState,
                   train_symbols: torch.Tensor | None = None,
                   train_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, EqState]:
    """Equalize [B, 2N] fractionally-spaced samples -> [B, N] symbols.

    Where ``train_mask`` is True the ``train_symbols`` column drives the
    adaptation (known-symbol training, e.g. over sync words); elsewhere it
    is decision-directed.  Without ``train_symbols`` all of it is
    decision-directed; ``train_symbols`` without ``train_mask`` trains on
    every symbol.
    """
    b, n2 = samples2x.shape
    n = n2 // 2
    pairs = samples2x.reshape(b, n, 2)
    if train_symbols is None:
        known = torch.zeros((b, n), dtype=torch.float32, device=samples2x.device)
        mask = torch.zeros((b, n), dtype=torch.bool, device=samples2x.device)
    else:
        known = train_symbols.to(torch.float32)
        mask = (torch.ones((b, n), dtype=torch.bool, device=samples2x.device)
                if train_mask is None else train_mask)
    syms = []
    for i in range(n):
        state, sym = _step(state, pairs[:, i], known[:, i], mask[:, i])
        syms.append(sym)
    return torch.stack(syms, dim=1), state


def _frame_windows(fr: torch.Tensor) -> torch.Tensor:
    """[B, N] frame symbols -> [B, N, KN] centred windows, edge-clamped."""
    pad = KN // 2
    x = torch.cat([fr[:, :1].expand(-1, pad), fr, fr[:, -1:].expand(-1, pad)], dim=1)
    return x.unfold(1, KN, 1)


def slicer4(yn: torch.Tensor) -> torch.Tensor:
    """4FSK decision in +-1/+-3 units (threshold 2)."""
    mag = torch.where(yn.abs() >= 2.0, 3.0, 1.0)
    return torch.where(yn > 0, mag, -mag).to(torch.float32)


def _tree_mean(x: torch.Tensor, n: int) -> torch.Tensor:
    """``pairwise_sum`` over the last axis divided by ``n``: a true
    division in float64 on every device, rounded to float32."""
    s = pairwise_sum(x)
    return (s / torch.full_like(s, n)).float()


def _solve5(a: list, rhs: list) -> list:
    """Solve the symmetric positive definite KN x KN system ``a`` (nested
    lists of [B] float64 tensors) for ``rhs`` by LDL^T in a fixed order:
    no pivoting, one reciprocal a pivot, every inner sum in index order.
    A pivot that is not positive gives taps that are not finite, which
    ``equalize_frames`` discards."""
    lo = [[None] * KN for _ in range(KN)]       # unit lower factor L
    dg, r = [None] * KN, [None] * KN            # D and 1 / D
    for j in range(KN):
        ld = [lo[j][k] * dg[k] for k in range(j)]
        t = a[j][j]
        for k in range(j):
            t = t - lo[j][k] * ld[k]
        dg[j], r[j] = t, torch.reciprocal(t)
        for i in range(j + 1, KN):
            t = a[i][j]
            for k in range(j):
                t = t - lo[i][k] * ld[k]
            lo[i][j] = t * r[j]
    z = []
    for i in range(KN):                         # L z = rhs
        t = rhs[i]
        for k in range(i):
            t = t - lo[i][k] * z[k]
        z.append(t)
    x = [None] * KN
    for i in reversed(range(KN)):               # L^T x = z / D
        t = z[i] * r[i]
        for k in range(i + 1, KN):
            t = t - lo[k][i] * x[k]
        x[i] = t
    return x


def equalize_frames(
    frames: torch.Tensor,
    c: torch.Tensor,
    update: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Equalize [B, F, 192] frame symbols with per-channel taps c [B, KN];
    adapt once per frame where ``update`` [B, F] is True.

    Frame i is filtered with the taps as of its start; its sync and
    decisions then update the taps for frame i+1.  Returns (equalized
    frames, new taps).  The filter adds its taps in order; X^T X and
    X^T d are float64 sums of exact products in ``pairwise_sum``'s order,
    solved by ``_solve5``; taps that come out non-finite are discarded.
    """
    f = frames.shape[1]
    outs = []
    for i in range(f):
        x = _frame_windows(frames[:, i])                 # [B, N, KN]
        y = x[..., 0] * c[:, None, 0]
        for k in range(1, KN):
            y = y + x[..., k] * c[:, None, k]
        outs.append(y)
        # normalize on the sync word (nominal +-3) for the decisions
        scale = torch.clamp(_tree_mean(y[:, :SYNC_SYMBOLS].abs(), 3 * SYNC_SYMBOLS),
                            min=1e-9)[:, None]
        yn = y / scale
        tgt = slicer4(yn)
        tgt[:, :SYNC_SYMBOLS] = torch.sign(yn[:, :SYNC_SYMBOLS]) * 3.0
        d = (tgt * scale).double()
        xd = x.double().movedim(1, -1)                   # [B, KN, N]
        xtx = pairwise_sum(xd[:, :, None] * xd[:, None])  # [B, KN, KN]
        xtd = pairwise_sum(xd * d[:, None])              # [B, KN]
        a = [[xtx[:, k, m] + EQ_FRAME_LAMBDA if k == m else xtx[:, k, m] for m in range(KN)]
             for k in range(KN)]
        c_ls = torch.stack(_solve5(a, list(xtd.unbind(1))), dim=-1).float()
        c_new = c + EQ_FRAME_MU * (c_ls - c)
        c_new = torch.where(torch.isfinite(c_new), c_new, c)
        c = torch.where(update[:, i, None], c_new, c)
    return torch.stack(outs, dim=1), c


def eye_closure(frames: torch.Tensor, valid: torch.Tensor, eye_est: torch.Tensor,
                armed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The auto stage's arming rule over one call's raw frames [B, F, 192]
    -> (new eye_est [B], new armed [B]).

    A frame's eye closure is its symbols' mean dispersion about the 4FSK
    levels 1/3 and 1, in units of its sync word's mean magnitude.  Only
    valid frames with signal count (junk frames after a session look like
    heavy ISI but carry none); their mean, added in frame order, is
    smoothed into ``eye_est``.  A channel arms on its worst such frame and
    disarms on the smoothed estimate, so one good frame does not drop a
    converged equalizer."""
    a = frames.abs()
    sync_mag = _tree_mean(a[..., :SYNC_SYMBOLS], SYNC_SYMBOLS)        # [B, F]
    cor = torch.reciprocal(torch.clamp(sync_mag, min=1e-9))
    mag = a[..., SYNC_SYMBOLS:] * cor[..., None]
    disp = torch.minimum((mag - 1.0 / 3.0).abs(), (mag - 1.0).abs())
    d_frame = _tree_mean(F.pad(disp, (SYNC_SYMBOLS, 0)), disp.shape[-1])
    lvl = _tree_mean(a, a.shape[-1])
    sig = valid & (lvl > 0.15)
    nsig = sig.sum(dim=-1)
    d_sig = torch.where(sig, d_frame, torch.zeros_like(d_frame))
    d_sum = d_sig[:, 0]
    for i in range(1, d_sig.shape[1]):
        d_sum = d_sum + d_sig[:, i]
    d_mean = d_sum / torch.clamp(nsig, min=1)
    eye_est = torch.where(
        nsig > 0,
        torch.where(eye_est > 0.0, EYE_SMOOTH * eye_est + (1.0 - EYE_SMOOTH) * d_mean,
                    d_mean),
        eye_est)
    d_now = d_sig.amax(dim=-1)
    armed = torch.where(torch.maximum(eye_est, d_now) > EYE_ARM, True,
                        torch.where(eye_est < EYE_DISARM, False, armed))
    return eye_est, armed


def equalize_stage(frames: torch.Tensor, valid: torch.Tensor, c: torch.Tensor,
                   eye_est: torch.Tensor, armed: torch.Tensor, auto: bool,
                   use_kernel: bool | None = None):
    """The frame equalizer stage of one call: frames [B, F, 192] f32, the
    slots that hold a parsed frame ``valid`` [B, F], the carried taps c
    [B, KN], ``eye_est`` [B] and ``armed`` [B] -> (frames, taps, eye_est,
    armed).

    ``auto`` False is the stage forced on: every channel is equalized and
    adapts on every valid slot; ``eye_est`` and ``armed`` pass through.
    ``auto`` True arms channels by ``eye_closure``: an armed channel's
    frames are equalized and its taps adapt on valid slots; an unarmed
    channel keeps its frames and taps.  K4 for CUDA tensors, the plain
    version for CPU tensors, unless ``use_kernel`` says otherwise (see
    ``_build.use_kernel_for``)."""
    if _build.use_kernel_for(frames, use_kernel):
        return equalize_stage_cuda(frames, valid, c, eye_est, armed, auto)
    return equalize_stage_ref(frames, valid, c, eye_est, armed, auto)


def equalize_stage_ref(frames, valid, c, eye_est, armed, auto: bool):
    """The plain PyTorch version of ``equalize_stage``."""
    if not auto:
        out, c = equalize_frames(frames, c, update=valid)
        return out, c, eye_est, armed
    eye_est, armed = eye_closure(frames, valid, eye_est, armed)
    out, c = equalize_frames(frames, c, update=valid & armed[:, None])
    return torch.where(armed[:, None, None], out, frames), c, eye_est, armed


def equalize_stage_cuda(frames, valid, c, eye_est, armed, auto: bool):
    """The CUDA kernel K4: ``equalize_stage_ref``'s contract and bits, in
    one launch.  The outputs are new contiguous tensors; the inputs are
    only read."""
    name = "equalize_stage_cuda"
    _build.check_cuda_input(name, frames, torch.float32, 3, contiguous=False)
    b, f, n = frames.shape
    if n != FRAME_SYMBOLS or b == 0 or f == 0:
        raise ValueError(f"{name}: expected [B, F, {FRAME_SYMBOLS}] frames with B, F >= 1, "
                         f"got {tuple(frames.shape)}")
    dev = frames.device
    for what, x, dtype, shape in (("valid", valid, torch.bool, (b, f)),
                                  ("c", c, torch.float32, (b, KN)),
                                  ("eye_est", eye_est, torch.float32, (b,)),
                                  ("armed", armed, torch.bool, (b,))):
        _build.check_cuda_input(f"{name}: {what}", x, dtype, len(shape), contiguous=False)
        if tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name}: {what} must be {list(shape)} on {dev}, "
                             f"got {tuple(x.shape)} on {x.device}")
    frames, valid, c = frames.contiguous(), valid.contiguous(), c.contiguous()
    eye_est, armed = eye_est.contiguous(), armed.contiguous()
    out = torch.empty_like(frames)
    c_out, eye_out, armed_out = (torch.empty_like(x) for x in (c, eye_est, armed))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.EQUALIZE.launch(
            frames.data_ptr(), valid.data_ptr(), c.data_ptr(), eye_est.data_ptr(),
            armed.data_ptr(), out.data_ptr(), c_out.data_ptr(), eye_out.data_ptr(),
            armed_out.data_ptr(), b, f, int(auto), ctypes.c_void_p(stream))
    return out, c_out, eye_out, armed_out


def isi_channel(symbols2x: torch.Tensor, taps: tuple[float, ...]) -> torch.Tensor:
    """A static multipath (ISI) channel for equalizer tests:
    y[t] = sum_k taps[k] * x[t - k]."""
    k = len(taps)
    x = F.pad(symbols2x, (k - 1, 0))
    out = torch.zeros_like(symbols2x)
    for i, t in enumerate(taps):
        out = out + t * x[:, k - 1 - i: x.shape[1] - i]
    return out
