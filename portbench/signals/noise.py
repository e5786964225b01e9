"""Signal ``noise``: normal noise of standard deviation ``sigma`` in I and
in Q, quantized as the voice mix is, with a period of ``NOISE_BLOCKS``
blocks: channels that hunt and never lock.  White noise is the same at
every input rate: a block is the configuration's ``block_samples``."""

from __future__ import annotations

import torch

from portbench.signals import generator, quantize

NOISE_BLOCKS = 13            # period of the signal, in blocks


def build(mix: dict, config: dict, seed: int, device) -> torch.Tensor:
    b, t = int(config["channels"]), int(config["block_samples"])
    noise = torch.randn((b, NOISE_BLOCKS, 2, t), generator=generator(seed, device),
                        device=device)
    return quantize(noise * float(mix["sigma"]))
