"""Counterpart of the repository's ``__graft_entry__.entry``: one receive
block through the port's main path.

    python -m m17_sdr_tpu_torch.entry          # on the CUDA card
    python -m m17_sdr_tpu_torch.entry --cpu    # on the CPU, plain versions

Without ``--cpu`` it needs a CUDA card and exits non-zero where there is
none.
"""

from __future__ import annotations

import argparse
import sys

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m m17_sdr_tpu_torch.entry")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU through the plain versions")
    args = parser.parse_args(argv)
    if args.cpu:
        dev = "cpu"
    elif torch.cuda.is_available():
        dev = "cuda"
    else:
        print("m17_sdr_tpu_torch.entry: no CUDA card; pass --cpu to run on the CPU",
              file=sys.stderr)
        return 1
    out, _ = entry(dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    print(f"entry ok on {dev}: stream_valid {tuple(out.stream_valid.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
