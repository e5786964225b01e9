"""Planar IQ: float32 [..., 2, T] with plane 0 = re and plane 1 = im.

Kept planar, as in the JAX package, so that the two packages' public
functions take the same layout.
"""

from __future__ import annotations

import torch


def make(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.stack([re, im], dim=-2)


def re(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0, :]


def im(x: torch.Tensor) -> torch.Tensor:
    return x[..., 1, :]


def magnitude(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(re(x) * re(x) + im(x) * im(x))


def conj_mul_im(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Im(conj(a) * b): the quadrature discriminator cross product."""
    return re(a) * im(b) - im(a) * re(b)


def rotate(x: torch.Tensor, cos_ph: torch.Tensor, sin_ph: torch.Tensor) -> torch.Tensor:
    """x * exp(j*phase), by per-sample cos/sin."""
    return make(
        re(x) * cos_ph - im(x) * sin_ph,
        re(x) * sin_ph + im(x) * cos_ph,
    )


def from_phase(phase: torch.Tensor) -> torch.Tensor:
    """exp(j*phase) as planar IQ [..., 2, T] from phase [..., T]."""
    return make(torch.cos(phase), torch.sin(phase))
