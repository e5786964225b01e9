"""Per-block timing of ``rx_block`` on a signal and on noise.

Port of the JAX package's ``tools/bench_debug.py``.  Modes:

  ``gen``    build the validation session's blocks
             (``kernel_validate.session_blocks``: 64 voice sessions tiled to
             ``batch`` channels, float32 [batch, nblk, 2, 1920]) and save
             them to ``--path``;
  ``run``    load them and chain ``rx_block`` one block a call from a fresh
             state, after one warm call; each call is fenced with
             ``torch.cuda.synchronize()`` and timed by the host clock;
  ``noise``  the same on ``default_rng(1).normal`` float32 noise of the
             saved blocks' shape, where a channel locks only by chance, so
             nearly every channel hunts on every block.

``run`` and ``noise`` print the JAX tool's two lines: the per-block ms
(min, median, max and all of them), then the median throughput in M
channel-samples/s.

    python -m m17_sdr_tpu_torch.tools.bench_debug gen|run|noise [batch=4096]
        [--path PATH] [--device cuda|cpu]

``batch`` (a multiple of 64) is read by ``gen`` only.  ``--path``
defaults to ``blocks.npy`` in the temporary directory (the JAX tool's
fixed ``/tmp/blocks.npy`` where TMPDIR is unset).  ``--device`` defaults
to the card and exits 1 without one.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from .._util import fence
from ..pipeline.benchdata import SESSIONS
from ..pipeline.rx import RxBlockOutput, RxSessionState, rx_block
from .kernel_validate import BATCH, session_blocks

NOISE_SEED = 1


class Run(NamedTuple):
    times_ms: np.ndarray        # [nblk] each fenced call's wall ms
    out: RxBlockOutput          # the last call's output
    state: RxSessionState       # the state after the last call


def gen(batch: int, path: str, device="cuda") -> np.ndarray:
    """Build the session's blocks on ``device`` and save them to ``path``:
    the blocks, [batch, nblk, 2, 1920] float32."""
    blocks = session_blocks(batch, device)[0].cpu().numpy()
    np.save(path, blocks)
    print("saved", blocks.shape, blocks.dtype)
    return blocks


def noise(shape: tuple) -> np.ndarray:
    """The ``noise`` mode's input: ``default_rng(1).normal`` of ``shape``, float32."""
    return np.random.default_rng(NOISE_SEED).normal(size=shape).astype(np.float32)


def run(data: np.ndarray, device="cuda") -> Run:
    """``rx_block`` over ``data`` [batch, nblk, 2, T] one block a call from
    a fresh state, every call fenced and timed, after one warm call on
    block 0; prints the per-block ms and the median throughput."""
    dev = torch.device(device)
    batch, nblk, _, block = data.shape
    state = RxSessionState.init(batch, dev)
    blocks = [torch.as_tensor(data[:, i]).to(dev) for i in range(nblk)]
    rx_block(blocks[0], state)
    fence(dev)
    times = []
    out, st = None, state
    for x in blocks:
        t0 = time.perf_counter()
        out, st = rx_block(x, st)
        fence(dev)
        times.append(time.perf_counter() - t0)
    times = np.array(times) * 1e3
    print(f"per-block ms: min={times.min():.2f} med={np.median(times):.2f} "
          f"max={times.max():.2f}  all={np.round(times, 2).tolist()}")
    sps = batch * block / (np.median(times) / 1e3)
    print(f"median throughput: {sps / 1e6:.1f} M samples/s")
    return Run(times, out, st)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m m17_sdr_tpu_torch.tools.bench_debug",
                                 description="Per-block rx_block times on a signal and on noise.")
    ap.add_argument("mode", choices=("gen", "run", "noise"))
    ap.add_argument("batch", type=int, nargs="?", default=BATCH)
    ap.add_argument("--path", default=os.path.join(tempfile.gettempdir(), "blocks.npy"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "gen" and (args.batch <= 0 or args.batch % SESSIONS):
        ap.error(f"batch must be a positive multiple of {SESSIONS}")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; run with --device cpu to use the CPU", file=sys.stderr)
        return 1
    if args.mode == "gen":
        gen(args.batch, args.path, args.device)
    elif args.mode == "run":
        run(np.load(args.path), args.device)
    else:
        run(noise(np.load(args.path, mmap_mode="r").shape), args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
