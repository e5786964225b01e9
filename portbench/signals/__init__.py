"""Signal builders: a mix's parameters, the configuration and a seed ->
the cell's input.

A mix (``portbench/traffic/<mix>.json``) names its ``signal``; the harness
loads ``portbench/signals/<signal>.py`` by that name and calls its
``build(mix, config, seed, device)``, which returns the periodic planar
int16 signal ``[B, P, 2, T]`` on ``device``: P blocks of T samples
(``config["block_samples"]``) for each of the configuration's B channels,
cycled.  A builder reads the configuration's ``input_rate`` and refuses a
rate it does not generate.  Everything is made on the device from the
seed (``generator``), in a few large calls; the same seed gives the same
signal.

This module holds what the builders share.
"""

from __future__ import annotations

import torch

WIRE_SCALE = 3.0e-5          # int16 LSB in the receiver's float units


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def quantize(iq: torch.Tensor) -> torch.Tensor:
    """float IQ -> int16 wire values, round(x / 3e-5) with saturation."""
    return torch.clamp(torch.round(iq / WIRE_SCALE), -32768, 32767).to(torch.int16)
