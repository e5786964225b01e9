"""Headline benchmark: channel-samples/s of the whole receive path on one card.

Port of the JAX package's ``bench.py``.  It runs ``rx_block`` (front end,
the timing and framer scan, frame extraction, the demap and the four
typed decodes, LICH reassembly and the voice gates) with its defaults,
AFC and equalizer off, on B channels of the staggered bench mix
(``pipeline/benchdata.py``: 64 voice sessions tiled to B channels, channel
c's 13 blocks rotated by c % 13, so that every block holds channels at
every phase of a session), int16 planar IQ, the radio's wire format.

Headline: one whole session (13 blocks = 24960 samples) a call, with
``torch.cuda.synchronize()`` after every call, after one warm call (the
kernels' build, their ``cudaFuncSetAttribute`` and the table uploads are
outside the clock).  REPS reps of at least REP_S seconds each, a fresh
state a rep; a rep's rate is B * 24960 * calls / seconds, and ``value``
is the median rep.  ``vs_baseline`` divides it by the reference C++ RX
chain's rate on a CPU (BASELINE.md).

Roofline guard: a rate implies an input read of rate * 4 bytes a second
(int16 I and Q).  A rep above the card's HBM bandwidth plus 5 % is not a
measurement (the JAX bench tests the median; every rep is stricter): it
is printed on stderr and the process exits 1.  The
JAX bench waits and retries there, because its TPU's readiness signal
could run ahead of execution; ``synchronize()`` is a true fence, so the
port refuses instead.

``ab_t1920``: the per-dispatch config, one 1920-sample block a call,
chained over the 13 blocks with a drain every DRAIN_PASSES passes; each
of AB_REPS reps runs whole 13-block passes for at least REP_S seconds.
The JAX bench runs two receiver formulations here (``xla``, ``pallas``);
the port has one fast receiver, so the dict holds one leg: ``kernel`` on
the card, ``plain`` on the CPU.  ``min`` and ``med`` are the rates at the
least and the median time a pass, as the JAX record's are.

Viterbi: frames/s of the decoder on [4096, 296] soft bits from
``default_rng(1)`` (148 trellis steps), each call chained on the previous
call's metric so that calls run in order, VIT_CALLS calls a loop, the
best of VIT_LOOPS loops; the kernel on the card, the plain version on
the CPU (there, about 11 minutes at the defaults).

    python -m m17_sdr_tpu_torch.bench [batch=4096] [--device cuda|cpu]

``batch`` is a multiple of 64.  ``--device`` defaults to the card and
exits 1 without one.  Prints {"ab_t1920": ...} on stderr, then ONE JSON
line on stdout:
  {"metric", "value", "unit", "vs_baseline", "receiver": "kernel"|"plain",
   "config": {...}, "ab_t1920": {...}, "viterbi_frames_per_s",
   "viterbi_vs_baseline", "phase_probes": []}
``phase_probes`` stays empty: the JAX bench's probe of its TPU link has no
counterpart on a card, and the key is kept so that both records read alike.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ._util import device_record, fence
from .pipeline.benchdata import SESSIONS, make_bench_blocks
from .pipeline.rx import RxBlockOutput, RxSessionState
from .spec.constants import BLOCK_SAMPLES
from .tools.profile_stages import rx, rx_session, viterbi_chained

REFERENCE_RX_SAMPLES_PER_S = 69_644_203.0   # BASELINE.md, the reference C++ RX chain
REFERENCE_VITERBI_FRAMES_PER_S = 179_000.0  # BASELINE.md
REPS = 5                # headline reps
AB_REPS = 3             # per-block reps
REP_S = 2.5             # least wall seconds a rep
DRAIN_PASSES = 25       # per-block leg: a fence every this many 13-block passes
VIT_BATCH = 4096
VIT_STEPS = 148         # 296 depunctured soft bits: a stream frame's trellis
VIT_CALLS = 2000
VIT_LOOPS = 3
# NVIDIA H100 SXM (H100 80GB HBM3): 3.35 TB/s of HBM, plus a 5 % margin
HBM_ROOF_GBPS = 3350.0 * 1.05
INPUT_BYTES_PER_SAMPLE = 4  # int16 I and Q


class Headline(NamedTuple):
    """The headline's reps in ascending order of rate, each list aligned
    with ``rates``, and the warm call's result: one ``rx_block`` call on
    the session from a fresh state, the work every rep's first call does."""

    rates: list            # channel-samples/s
    calls: list            # whole-session calls in the rep
    seconds: list          # the rep's wall seconds
    rep_s: float
    out: RxBlockOutput
    state: RxSessionState


class BenchRun(NamedTuple):
    doc: dict
    headline: Headline
    vit_soft: torch.Tensor   # [VIT_BATCH, 296] the Viterbi leg's input
    vit_bits: torch.Tensor   # [VIT_BATCH, 148] its last call's bits
    vit_metric: torch.Tensor  # [VIT_BATCH] and metric


def receiver_leg(device) -> str:
    """The receiver ``rx_block`` runs on ``device``: "kernel" on CUDA,
    "plain" on the CPU."""
    return "kernel" if torch.device(device).type == "cuda" else "plain"


def headline(session: torch.Tensor, reps: int = REPS, rep_s: float = REP_S) -> Headline:
    """Whole-session calls of ``rx_block`` on ``session`` [B, 2, S], each
    followed by a fence: ``reps`` reps of at least ``rep_s`` seconds."""
    batch, dev = session.shape[0], session.device
    out, state = rx_session(session, RxSessionState.init(batch, dev), 1)
    runs = []
    for _ in range(reps):
        st = RxSessionState.init(batch, dev)
        calls = 0
        t0 = time.perf_counter()
        while True:
            _, st = rx_session(session, st, 1)
            calls += 1
            dt = time.perf_counter() - t0
            if dt > rep_s:
                break
        runs.append((batch * session.shape[-1] * calls / dt, calls, dt))
    runs.sort()
    return Headline([r[0] for r in runs], [r[1] for r in runs], [r[2] for r in runs],
                    rep_s, out, state)


def ab_t1920(blocks: list, ab_reps: int = AB_REPS, rep_s: float = REP_S) -> dict:
    """The per-block leg over ``blocks`` (nblk [B, 2, 1920]): {leg: {"min",
    "med"}} in channel-samples/s."""
    batch, dev = blocks[0].shape[0], blocks[0].device
    samples_a_pass = batch * blocks[0].shape[-1] * len(blocks)
    rx(blocks, RxSessionState.init(batch, dev), 1)
    fence(dev)
    per_pass = []
    for _ in range(ab_reps):
        st = RxSessionState.init(batch, dev)
        passes = 0
        t0 = time.perf_counter()
        while True:
            _, st = rx(blocks, st, 1)
            passes += 1
            if passes % DRAIN_PASSES == 0:
                fence(dev)
            if time.perf_counter() - t0 >= rep_s:
                break
        fence(dev)
        per_pass.append((time.perf_counter() - t0) / passes)
    per_pass.sort()
    return {receiver_leg(dev): {"min": round(samples_a_pass / per_pass[0]),
                                "med": round(samples_a_pass / per_pass[len(per_pass) // 2])}}


def viterbi_input(batch: int, device) -> torch.Tensor:
    """[batch, 296] float32 soft bits from ``default_rng(1)``."""
    rng = np.random.default_rng(1)
    return torch.as_tensor(rng.normal(size=(batch, 2 * VIT_STEPS)).astype(np.float32)).to(device)


def viterbi_rate(soft: torch.Tensor, vit_calls: int = VIT_CALLS, loops: int = VIT_LOOPS):
    """(frames/s, bits, metric): ``loops`` loops of ``vit_calls`` chained
    decodes of ``soft``, the best loop; bits and metric of the last call."""
    dev = soft.device
    bits, m = viterbi_chained(soft, torch.zeros(soft.shape[0], device=dev))
    fence(dev)
    ts = []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(vit_calls):
            bits, m = viterbi_chained(soft, m)
        fence(dev)
        ts.append(time.perf_counter() - t0)
    return soft.shape[0] * vit_calls / min(ts), bits, m


def roof_error(rates: list) -> str | None:
    """Why the headline's reps are refused, or None: a rep implies an
    input read above HBM_ROOF_GBPS."""
    gbps = max(rates) * INPUT_BYTES_PER_SAMPLE / 1e9
    if gbps <= HBM_ROOF_GBPS:
        return None
    return (f"roofline guard: a rep implies {gbps:.1f} GB/s of input read, above "
            f"the card's {HBM_ROOF_GBPS:.1f} GB/s (3.35 TB/s + 5 %): not a measurement")


def document(batch: int, nblk: int, head: Headline, ab: dict, vit_frames_per_s: float,
             receiver: str, device: dict, launches: dict) -> dict:
    """The bench's JSON line: the JAX bench's keys.  ``config`` holds the
    reps' rates, calls and seconds aligned (rate = batch * block_samples
    * calls / seconds), the device record and the kernels' launches over
    the run."""
    value = head.rates[len(head.rates) // 2]
    return {
        "metric": f"rx_pipeline_channel_samples_per_s_per_chip_b{batch}",
        "value": round(value),
        "unit": "samples/s",
        "vs_baseline": round(value / REFERENCE_RX_SAMPLES_PER_S, 2),
        "receiver": receiver,
        "config": {"block_samples": nblk * BLOCK_SAMPLES, "sync": "per_call",
                   "hal_blocks_per_call": nblk, "calls_per_rep": head.calls,
                   "rep_s": head.rep_s, "rep_seconds": head.seconds,
                   "afc": "off", "equalize": "off (rx_block's default)",
                   "implied_input_read_gbps": round(value * INPUT_BYTES_PER_SAMPLE / 1e9, 1),
                   "roof_gbps": HBM_ROOF_GBPS,
                   "rep_rates": [round(r) for r in head.rates],
                   "device": device, "kernel_launches": launches},
        "ab_t1920": ab,
        "viterbi_frames_per_s": round(vit_frames_per_s),
        "viterbi_vs_baseline": round(vit_frames_per_s / REFERENCE_VITERBI_FRAMES_PER_S, 1),
        "phase_probes": [],
    }


def run(batch: int, device, reps: int = REPS, rep_s: float = REP_S, ab_reps: int = AB_REPS,
        vit_calls: int = VIT_CALLS) -> BenchRun:
    """The whole bench at ``batch`` channels on ``device``: the per-block
    leg (printed on stderr), the headline, the Viterbi leg, the document."""
    if batch % SESSIONS:
        raise ValueError(f"batch {batch} is not a multiple of {SESSIONS}")
    device = torch.device(device)
    blocks, nblk = make_bench_blocks(batch, BLOCK_SAMPLES, device=device)
    vit_soft = viterbi_input(VIT_BATCH, device)
    before = {k.symbol: k.launches for k in _build.KERNELS}
    ab = ab_t1920(blocks, ab_reps=ab_reps, rep_s=rep_s)
    print(json.dumps({"ab_t1920": ab}), file=sys.stderr, flush=True)
    head = headline(torch.cat(blocks, dim=-1), reps=reps, rep_s=rep_s)
    vit, bits, metric = viterbi_rate(vit_soft, vit_calls=vit_calls)
    launches = {k.symbol: k.launches - before[k.symbol] for k in _build.KERNELS}
    doc = document(batch, nblk, head, ab, vit, receiver_leg(device), device_record(device),
                   launches)
    return BenchRun(doc, head, vit_soft, bits, metric)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m m17_sdr_tpu_torch.bench",
                                 description="Headline RX throughput of the port.")
    ap.add_argument("batch", type=int, nargs="?", default=4096)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; run with --device cpu to use the CPU", file=sys.stderr)
        return 1
    if args.batch % SESSIONS:
        ap.error(f"batch must be a multiple of {SESSIONS}")
    res = run(args.batch, args.device)
    refused = roof_error(res.headline.rates)
    if refused:
        print(refused, file=sys.stderr)
        return 1
    print(json.dumps(res.doc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
