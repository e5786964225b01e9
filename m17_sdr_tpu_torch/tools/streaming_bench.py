"""Streaming-session throughput and chunk latency.

Port of the JAX package's ``tools/streaming_bench.py``.  It measures
``StreamingRx`` end to end, the CLI's receive path: host int16 blocks,
chunked uploads, the receive pipeline on the device, the state carried
on the device.  Throughput mode reports a real-time factor (1.0 keeps up
with one live radio at the input rate); ``--chunk-latency`` mode waits
for the device after every chunk and reports the distribution of the
chunk's wall time, what a live session's voice latency rides on.
``--rate 384000`` adds the Pluto-rate x8 decimating front end.

The input is 50 blocks of uniform int16 noise from ``default_rng(0)``,
fed in turn.  The noise never locks, so every channel hunts, and the
receiver scan runs its sync check at every step.  The timed region
follows one warm session (one chunk, then ``flush_pending``) and ends
at ``torch.cuda.synchronize()``; the session's one device-to-host read
(``finish``) is not in it.

    python -m m17_sdr_tpu_torch.tools.streaming_bench [batch] [blocks]
        [--rate 48000|384000] [--chunk-blocks N] [--chunk-latency]
        [--equalize off|on|auto] [--runs N] [--device cuda|cpu]

``--device`` defaults to the card and exits non-zero without one.
Prints one JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .._util import fence
from ..app.streaming import DEFAULT_CHUNK_BLOCKS, StreamingRx, rate_factor
from ..spec.constants import BLOCK_SAMPLES

NOISE_BLOCKS = 50


def noise_blocks(batch: int, rate: int) -> list[np.ndarray]:
    """The 50 host wire blocks [batch, T_in, 2] int16 the sessions cycle
    through."""
    rng = np.random.default_rng(0)
    block_in = BLOCK_SAMPLES * rate_factor(rate)
    return [rng.integers(-8000, 8000, (batch, block_in, 2), dtype=np.int16)
            for _ in range(NOISE_BLOCKS)]


def throughput_session(srx: StreamingRx, blocks: list, n_blocks: int) -> float:
    """Feed ``n_blocks`` blocks (cycling through ``blocks``) and drain:
    the wall seconds up to the device's fence."""
    t0 = time.perf_counter()
    for i in range(n_blocks):
        srx.feed_block(blocks[i % len(blocks)])
    srx.flush_pending()
    fence(srx.device)
    return time.perf_counter() - t0


def latency_session(srx: StreamingRx, blocks: list, n_blocks: int) -> list[float]:
    """Feed whole chunks, draining and waiting for the device after each:
    each chunk's wall seconds, from its first block fed to its decode
    done.  ``max(1, n_blocks // chunk_blocks)`` chunks."""
    lats, i = [], 0
    for _ in range(max(1, n_blocks // srx.chunk_blocks)):
        t0 = time.perf_counter()
        for _ in range(srx.chunk_blocks):
            srx.feed_block(blocks[i % len(blocks)])
            i += 1
        srx.flush_pending()
        fence(srx.device)
        lats.append(time.perf_counter() - t0)
    return lats


def run(batch: int = 1, n_blocks: int = 500, rate: int = 48_000,
        chunk_blocks: int | None = None, chunk_latency: bool = False,
        equalize: str = "auto", runs: int = 1, device="cuda", blocks: list | None = None):
    """The JAX tool's runs: (one result dict a run, the last run's
    ``StreamingRx``, not finished).  ``blocks`` are the wire blocks to
    cycle through (default ``noise_blocks``)."""
    device = torch.device(device)
    chunk_blocks = chunk_blocks or DEFAULT_CHUNK_BLOCKS
    blocks = blocks if blocks is not None else noise_blocks(batch, rate)
    block_in = blocks[0].shape[1]

    def mk():
        return StreamingRx(batch=batch, input_rate=rate, chunk_blocks=chunk_blocks,
                           equalize=equalize, device=device)

    warm = mk()                       # one chunk: builds the kernels, caches
    for i in range(chunk_blocks):
        warm.feed_block(blocks[i % len(blocks)])
    warm.flush_pending()
    fence(device)

    results = []
    for _ in range(runs):
        srx = mk()
        if chunk_latency:
            lats_ms = sorted(t * 1e3 for t in latency_session(srx, blocks, n_blocks))
            chunk_signal_ms = chunk_blocks * BLOCK_SAMPLES / 48.0
            med = lats_ms[len(lats_ms) // 2]
            results.append({
                "mode": "chunk_latency", "platform": device.type, "equalize": equalize,
                "batch": batch, "rate": rate, "chunk_blocks": chunk_blocks,
                "chunk_signal_ms": round(chunk_signal_ms, 1),
                "chunks": len(lats_ms),
                "chunk_wall_ms": {"min": round(lats_ms[0], 2), "med": round(med, 2),
                                  "p90": round(lats_ms[int(len(lats_ms) * 0.9)], 2),
                                  "max": round(lats_ms[-1], 2)},
                "realtime_margin_med": round(chunk_signal_ms / med, 1),
            })
            continue
        dt = throughput_session(srx, blocks, n_blocks)
        signal_seconds = n_blocks * block_in / rate
        results.append({
            "mode": "throughput", "platform": device.type, "equalize": equalize,
            "batch": batch, "rate": rate, "blocks": n_blocks,
            "wall_s": round(dt, 3),
            "channel_samples_per_s": round(batch * n_blocks * block_in / dt),
            "realtime_factor_per_channel": round(signal_seconds / dt, 1),
            "realtime_channels": round(batch * signal_seconds / dt),
        })
    return results, srx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m m17_sdr_tpu_torch.tools.streaming_bench",
                                 description="StreamingRx throughput and chunk latency.")
    ap.add_argument("batch", type=int, nargs="?", default=1)
    ap.add_argument("blocks", type=int, nargs="?", default=500)
    ap.add_argument("--rate", type=int, default=48_000, choices=[48_000, 384_000])
    ap.add_argument("--chunk-blocks", type=int, default=None)
    ap.add_argument("--chunk-latency", action="store_true")
    ap.add_argument("--equalize", default="auto", choices=["off", "on", "auto"],
                    help="equalizer mode; auto is the session default, so the "
                         "bench measures the CLI's receive path")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; run with --device cpu to use the CPU", file=sys.stderr)
        return 1
    results, _ = run(args.batch, args.blocks, args.rate, args.chunk_blocks,
                     args.chunk_latency, args.equalize, args.runs, args.device)
    for r in results:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
