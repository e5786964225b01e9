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
its 4FSK decisions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

KN = 5          # taps (m17_equalize.cpp:3)
Q = 0.08        # m_q (m17_equalize.cpp:219)
E = 0.01        # m_E (m17_equalize.cpp:220)
D0 = 0.1        # initial d (m17_equalize.cpp:33)

EQ_FRAME_MU = 0.5        # per-frame tap blend toward the LS solution
EQ_FRAME_LAMBDA = 1e-3   # Tikhonov regularizer on XtX


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


def equalize_frames(
    frames: torch.Tensor,
    c: torch.Tensor,
    update: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Equalize [B, F, 192] frame symbols with per-channel taps c [B, KN];
    adapt once per frame where ``update`` [B, F] is True.

    Frame i is filtered with the taps as of its start; its sync and
    decisions then update the taps for frame i+1.  Returns (equalized
    frames, new taps).  The 5x5 solve is ``solve_ex``, which, unlike
    ``solve``, does not check for singular systems on the host; taps
    that come out non-finite are discarded below instead.
    """
    f = frames.shape[1]
    eye = EQ_FRAME_LAMBDA * torch.eye(KN, dtype=frames.dtype, device=frames.device)
    outs = []
    for i in range(f):
        x = _frame_windows(frames[:, i])                 # [B, N, KN]
        y = torch.einsum("bnk,bk->bn", x, c)
        outs.append(y)
        scale = torch.clamp(y[:, :8].abs().mean(dim=-1) / 3.0, min=1e-9)[:, None]
        tgt = slicer4(y / scale)
        tgt[:, :8] = torch.sign(y[:, :8] / scale) * 3.0
        d = tgt * scale
        xtx = torch.einsum("bnk,bnl->bkl", x, x) + eye
        xtd = torch.einsum("bnk,bn->bk", x, d)
        c_ls = torch.linalg.solve_ex(xtx, xtd[..., None])[0][..., 0]
        c_new = c + EQ_FRAME_MU * (c_ls - c)
        c_new = torch.where(torch.isfinite(c_new), c_new, c)
        c = torch.where(update[:, i, None], c_new, c)
    return torch.stack(outs, dim=1), c


def isi_channel(symbols2x: torch.Tensor, taps: tuple[float, ...]) -> torch.Tensor:
    """A static multipath (ISI) channel for equalizer tests:
    y[t] = sum_k taps[k] * x[t - k]."""
    k = len(taps)
    x = F.pad(symbols2x, (k - 1, 0))
    out = torch.zeros_like(symbols2x)
    for i, t in enumerate(taps):
        out = out + t * x[:, k - 1 - i: x.shape[1] - i]
    return out
