"""Counterpart of the repository's ``__graft_entry__.entry``: one receive
block through the port's main path.

    python -m m17_sdr_tpu_torch.entry      # on CUDA when available
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline.rx import RxBlockOutput, RxSessionState, rx_block
from .spec.constants import BLOCK_SAMPLES

BATCH = 64


def entry(device) -> tuple[RxBlockOutput, RxSessionState]:
    """One ``rx_block`` at B=64, T=1920 on ``device``, on seeded noise."""
    rng = np.random.default_rng(0)
    iq = torch.as_tensor(rng.normal(size=(BATCH, 2, BLOCK_SAMPLES)).astype(np.float32)).to(device)
    return rx_block(iq, RxSessionState.init(BATCH, device))


if __name__ == "__main__":
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    out, _ = entry(dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    print(f"entry ok on {dev}: stream_valid {tuple(out.stream_valid.shape)}")
