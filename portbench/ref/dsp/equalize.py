"""The in-pipeline frame-domain equalizer (the stage ``rx_block`` runs),
copied from the port's ``dsp/equalize.py``.

The frame stage filters each extracted frame's 192 timing-recovered
symbols with a 5-tap symbol-spaced filter, and each frame then makes one
regularized least-squares tap update toward its sync symbols (+-3) and
its 4FSK decisions.  ``EqState`` is the port's whole equalizer carry; the
frame stage uses ``c`` only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

KN = 5          # taps (m17_equalize.cpp:3)
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
