"""Per-stage times of the receive path over the bench session.

Port of the JAX package's ``tools/profile_stages.py``, with its method:
every stage runs as a state-chained loop (each call takes the previous
call's carry, so the calls run in order) over the 13-block bench session,
``iters`` passes a rep, with one fence after the rep; the stages' reps
are interleaved round-robin in one process after one throwaway rep each,
so that drift spreads over all stages instead of booking to the last.
The fence is ``torch.cuda.synchronize()`` on the card.  The host clock
around a rep reads what a caller waits for: where the host issues
launches more slowly than the card runs them, as on the main path, that
is the host's issue time, not the card's busy time.

Stages:
  rx_session           ``rx_block`` on one whole session (13 blocks =
                       24960 samples) a call, synced after every call,
                       one call a pass; reported per 1920-sample block.
                       The JAX tool makes 125 calls a pass, a guard
                       against its device signalling readiness early;
                       ``synchronize()`` is a true fence, so one call
                       measures the same thing.
  rx_kernel / rx_plain ``rx_block`` one 1920-sample block a call
  front_end            ``rx_front_end`` alone
  recv_kernel / recv_plain   ``receive_block`` (the scan, the compaction
                       and the frame extraction)
  kernel_only          the receiver scan alone (``receiver_scan_cuda``),
                       without the compaction and extraction
  viterbi4096          ``viterbi_decode`` on [B, 296] soft bits
  decode_typed         the demap and the four typed decoders on [3B, 192]
                       frame symbols

On the card the kernel legs run, at every batch; the plain legs are left
out there (the plain receiver scan takes about a second a block at
B=4096).  On the CPU the plain legs run, under their ``_plain`` names.

Derived:
  dispatch_overhead_ms_per_block = rx_kernel (rx_plain on the CPU)
                       - rx_session: the same pipeline, one block a call
                       against 13 blocks a call
  extraction_ms      = recv_kernel - kernel_only.  The port's kernel reads
                       the filter window from the carry itself, so this
                       holds the compaction only (K5 on the card, the
                       plain version's sorts and gathers on the CPU); in
                       the JAX tool it also holds the ``concatenate`` that
                       builds the kernel's input.
  typed_decode_ms    = rx_kernel - recv_kernel - front_end

    python -m m17_sdr_tpu_torch.tools.profile_stages [batch] [--json=PATH]
        [--trace[=DIR]] [--device cuda|cpu]

``batch`` defaults to 4096.  ``--device`` defaults to the card and exits
non-zero without one.  ``--trace`` writes a ``torch.profiler`` Chrome
trace of one session of ``rx_block`` into DIR (default ``m17_trace``).
The trace shows the receiver's stage ranges (``m17.rx_block`` and, inside
it, ``m17.front_end``, ``m17.scan``, ``m17.compaction``, ``m17.equalize``,
``m17.demap``, ``m17.decode.lsf|stream|packet|bert``, ``m17.session``;
``m17_sdr_tpu_torch.trace``) on the host thread, and the tool prints the
traced session's device time by stage (``stage_split``) to stderr.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .. import trace as stage_trace
from .._util import fence
from ..dsp.discriminator import RxFrontEndState, rx_front_end
from ..fec.viterbi import viterbi_decode
from ..frame import rx_frames
from ..frame.receiver import ReceiverState, receive_block, receiver_scan_cuda, receiver_scan_ref
from ..pipeline.benchdata import SESSIONS, make_bench_blocks
from ..pipeline.rx import RxSessionState, rx_block
from ..spec.constants import BLOCK_SAMPLES

ITERS = 40             # passes over the session a rep
REPS = 4
TRACE_DIR = "m17_trace"


class Inputs(NamedTuple):
    """What the stages read, all on one device."""

    blocks: list          # nblk [B, 2, 1920] int16 IQ blocks (the bench mix)
    soft_blocks: list     # nblk [B, 384] front-end outputs, one chained pass
    session: torch.Tensor  # [B, 2, nblk * 1920] the blocks end to end
    vit_soft: torch.Tensor  # [B, 296] soft bits from default_rng(1)
    frames: torch.Tensor  # [3B, 192] frame symbols from the same generator


def bench_inputs(batch: int, device) -> Inputs:
    """The stages' inputs at ``batch`` channels on ``device``.

    The blocks are ``make_bench_blocks``' staggered mix: built at the next
    multiple of 64 channels, of which the first ``batch`` are kept (channel
    c holds session c % 64 rotated by c % 13 blocks at any width).
    """
    width = -(-batch // SESSIONS) * SESSIONS
    blocks, _ = make_bench_blocks(width, BLOCK_SAMPLES, device=device)
    blocks = [b[:batch].contiguous() for b in blocks]
    fe = RxFrontEndState.init(batch, device)
    in_frame = torch.zeros(batch, dtype=torch.bool, device=device)
    soft_blocks = []
    for blk in blocks:
        dec, _, fe = rx_front_end(blk, fe, in_frame)
        soft_blocks.append(dec)
    rng = np.random.default_rng(1)
    vit_soft = torch.as_tensor(rng.normal(size=(batch, 296)).astype(np.float32)).to(device)
    frames = torch.as_tensor(rng.normal(size=(batch * 3, 192)).astype(np.float32)).to(device)
    return Inputs(blocks, soft_blocks, torch.cat(blocks, dim=-1), vit_soft, frames)


# ---------------------------------------------------------------- stage bodies

def kernel_only(soft: torch.Tensor, state: ReceiverState):
    """The receiver scan alone on one [B, S2] block: (slot values, flags,
    state), on the kernel for CUDA tensors, the plain version for CPU ones."""
    scan = receiver_scan_cuda if _build.use_kernel_for(soft, None) else receiver_scan_ref
    return scan(soft, state)


def viterbi_chained(soft: torch.Tensor, prev_metric: torch.Tensor):
    """``viterbi_decode`` with its input made to depend on the previous
    call's metric (a term that is always 0), so that calls run in order."""
    return viterbi_decode(soft + torch.where(prev_metric[:1] > 1e30, 1.0, 0.0))


def decode_typed(frames: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """The demap and the four typed decoders on [N, 192] frame symbols,
    chained on ``prev`` as ``viterbi_chained`` is: the metrics' sum [N, 1]."""
    soft = rx_frames.demap_frame(frames + torch.where(prev[:1, :1] > 1e30, 1.0, 0.0))
    lsf = rx_frames.decode_lsf(soft)
    stream = rx_frames.decode_stream(soft)
    packet = rx_frames.decode_packet(soft)
    bert = rx_frames.decode_bert(soft)
    return (lsf.metric + stream.metric + packet.metric + bert.metric)[:, None]


def rx(blocks: list, state: RxSessionState, iters: int):
    """``iters`` chained passes of ``rx_block`` over the blocks: the last
    block's output and the state."""
    for _ in range(iters):
        for blk in blocks:
            out, state = rx_block(blk, state)
    return out, state


def rx_session(session: torch.Tensor, state: RxSessionState, calls: int):
    """``calls`` chained ``rx_block`` calls on the whole session, each
    followed by a fence: the last output and the state."""
    for _ in range(calls):
        out, state = rx_block(session, state)
        fence(session.device)
    return out, state


def front_end(blocks: list, state: RxFrontEndState, iters: int):
    """``iters`` chained passes of ``rx_front_end`` (out of frame, AFC
    off): the last soft block and the state."""
    in_frame = torch.zeros(blocks[0].shape[0], dtype=torch.bool, device=blocks[0].device)
    for _ in range(iters):
        for blk in blocks:
            dec, _, state = rx_front_end(blk, state, in_frame)
    return dec, state


def recv(soft_blocks: list, state: ReceiverState, iters: int):
    """``iters`` chained passes of ``receive_block``: the last events and
    the state."""
    for _ in range(iters):
        for soft in soft_blocks:
            ev, state = receive_block(soft, state)
    return ev, state


# ---------------------------------------------------------------- the profile

def _stages(inp: Inputs, device) -> list:
    """(name, rep) pairs; rep(iters) runs ``iters`` passes and returns the
    wall seconds up to its fence."""
    batch = inp.vit_soft.shape[0]
    nblk = len(inp.blocks)

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        fence(device)
        return time.perf_counter() - t0

    def rep_rx(iters):
        st = RxSessionState.init(batch, device)
        return timed(lambda: rx(inp.blocks, st, iters))

    def rep_rx_session(iters):
        st = RxSessionState.init(batch, device)
        return timed(lambda: rx_session(inp.session, st, iters))

    def rep_front_end(iters):
        st = RxFrontEndState.init(batch, device)
        return timed(lambda: front_end(inp.blocks, st, iters))

    def rep_recv(iters):
        st = ReceiverState.init(batch, device)
        return timed(lambda: recv(inp.soft_blocks, st, iters))

    def rep_kernel_only(iters):
        def run():
            st = ReceiverState.init(batch, device)
            for _ in range(iters):
                for soft in inp.soft_blocks:
                    _, _, st = kernel_only(soft, st)
        return timed(run)

    def rep_viterbi(iters):
        def run():
            m = torch.zeros(batch, dtype=torch.float32, device=device)
            for _ in range(iters * nblk):
                _, m = viterbi_chained(inp.vit_soft, m)
        return timed(run)

    def rep_decode_typed(iters):
        def run():
            prev = torch.zeros((batch * 3, 1), dtype=torch.float32, device=device)
            for _ in range(iters * nblk):
                prev = decode_typed(inp.frames, prev)
        return timed(run)

    if torch.device(device).type == "cuda":
        return [("rx_kernel", rep_rx), ("rx_session", rep_rx_session),
                ("front_end", rep_front_end), ("recv_kernel", rep_recv),
                ("kernel_only", rep_kernel_only), ("viterbi4096", rep_viterbi),
                ("decode_typed", rep_decode_typed)]
    return [("rx_session", rep_rx_session), ("rx_plain", rep_rx),
            ("front_end", rep_front_end), ("recv_plain", rep_recv),
            ("viterbi4096", rep_viterbi), ("decode_typed", rep_decode_typed)]


def profile(batch: int, device, iters: int = ITERS, reps: int = REPS,
            inputs: Inputs | None = None) -> dict:
    """The stage document at ``batch`` channels on ``device``: the JAX
    tool's keys, with ``backend`` "cuda" or "cpu", plus ``device`` (the
    card's name, or "cpu").  Progress goes to stderr."""
    device = torch.device(device)
    inp = inputs if inputs is not None else bench_inputs(batch, device)
    nblk = len(inp.blocks)
    stages = _stages(inp, device)
    print(f"batch={batch} nblk={nblk} iters={iters} reps={reps} device={device}",
          file=sys.stderr)
    for name, rep in stages:          # one throwaway rep: builds, caches
        rep(1)
        print(f"warmed {name}", file=sys.stderr)
    times = {name: [] for name, _ in stages}
    for r in range(reps):
        for name, rep in stages:
            times[name].append(rep(iters))
        print(f"rep {r + 1}/{reps} done", file=sys.stderr)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return document(times, batch, nblk, iters, reps, device.type, name)


def document(times: dict, batch: int, nblk: int, iters: int, reps: int,
             backend: str, device_name: str) -> dict:
    """The stage document from each stage's rep times in seconds (a rep is
    ``iters`` passes over ``nblk`` blocks)."""
    doc = {"batch": batch, "nblk": nblk, "iters": iters, "reps": reps, "backend": backend,
           "device": device_name, "stages": {}}
    nb = iters * nblk                 # blocks a rep
    for name, ts in times.items():
        ts = sorted(ts)
        per_block_ms = [t / nb * 1e3 for t in ts]
        doc["stages"][name] = {
            "ms_per_block_min": round(per_block_ms[0], 4),
            "ms_per_block_med": round(per_block_ms[len(per_block_ms) // 2], 4),
            "samples_per_s": round(batch * BLOCK_SAMPLES / (per_block_ms[0] / 1e3)),
        }
    s = {name: v["ms_per_block_min"] for name, v in doc["stages"].items()}
    cuda = backend == "cuda"
    rx_leg, recv_leg = ("rx_kernel", "recv_kernel") if cuda else ("rx_plain", "recv_plain")
    doc["derived"] = {"dispatch_overhead_ms_per_block": round(s[rx_leg] - s["rx_session"], 4)}
    if cuda:
        doc["derived"].update({
            "extraction_ms": round(s[recv_leg] - s["kernel_only"], 4),
            "typed_decode_ms": round(s[rx_leg] - s[recv_leg] - s["front_end"], 4),
        })
    return doc


def _innermost(ranges: list) -> tuple[list, list]:
    """Nested host ranges [(start, end, name)] of one thread -> the times at
    which the innermost open range changes, and its name from each time on
    (None where no range is open)."""
    times, names, stack = [], [], []

    def close(upto):
        while stack and stack[-1][1] <= upto:
            end = stack.pop()[1]
            times.append(end)
            names.append(stack[-1][2] if stack else None)

    for r in sorted(ranges, key=lambda r: (r[0], -r[1])):
        close(r[0])
        stack.append(r)
        times.append(r[0])
        names.append(r[2])
    close(float("inf"))
    return times, names


def stage_split(events) -> tuple[dict, list]:
    """A profile's device time by receiver stage.

    ``events`` are the profiler's raw events
    (``prof.profiler.kineto_results.events()``).  Each device operation
    (kernel, copy or set, not the device-side copy of a user range) is
    tied to the host call that launched it by the profiler's correlation
    id, and booked to the innermost stage range (``m17.<stage>``) open on
    the launching thread at the launch; None holds those launched outside
    every stage, "untied" those with no launch in the trace.  Returns
    ({stage: device ns}, [launch-to-start lag ns of every tied operation]).
    """
    ranges: dict = {}
    launches: dict = {}
    ops = []
    for ev in events:
        name = ev.name()
        if not str(ev.device_type()).endswith("CPU"):
            if not ev.is_user_annotation():   # a user range's device-side copy
                ops.append(ev)
        elif name.startswith(stage_trace.PREFIX):
            start = ev.start_ns()
            ranges.setdefault(ev.start_thread_id(), []).append(
                (start, start + ev.duration_ns(), name[len(stage_trace.PREFIX):]))
        elif name.startswith("cu"):           # the CUDA API calls (launches, copies)
            launches[ev.correlation_id()] = (ev.start_ns(), ev.start_thread_id())
    threads = {tid: _innermost(r) for tid, r in ranges.items()}
    split: dict = {}
    lags = []
    for op in ops:
        launch = launches.get(op.correlation_id())
        if launch is None:
            stage = "untied"
        else:
            t, tid = launch
            times, names = threads.get(tid, ([], []))
            i = bisect.bisect_right(times, t) - 1
            stage = names[i] if i >= 0 else None
            lags.append(op.start_ns() - t)
        split[stage] = split.get(stage, 0) + op.duration_ns()
    return split, lags


def trace(inputs: Inputs, device, out_dir) -> tuple[Path, dict]:
    """A ``torch.profiler`` Chrome trace of one session of ``rx_block``
    (one block a call) into ``out_dir``: the file's path, and the
    session's device ms by stage (``stage_split``) with the launch-to-start
    lags' median and largest, and the count of operations that started on
    the card before their launch on the host."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    device = torch.device(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    st = RxSessionState.init(inputs.vit_soft.shape[0], device)
    with torch_profile(activities=acts) as prof:
        rx(inputs.blocks, st, 1)
        fence(device)
    path = Path(out_dir) / "rx_block_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    split, lags = stage_split(prof.profiler.kineto_results.events())
    lags.sort()
    doc = {"stage_device_ms": {str(k): v / 1e6 for k, v in split.items()},
           "launch_to_start_ms": {"median": lags[len(lags) // 2] / 1e6 if lags else None,
                                  "max": lags[-1] / 1e6 if lags else None},
           "started_before_launch": sum(1 for x in lags if x < 0)}
    return path, doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m m17_sdr_tpu_torch.tools.profile_stages",
                                 description="Per-stage times of the receive path.")
    ap.add_argument("batch", type=int, nargs="?", default=4096)
    ap.add_argument("--json", metavar="PATH", help="also write the document here")
    ap.add_argument("--trace", metavar="DIR", nargs="?", const=TRACE_DIR,
                    help="write a torch.profiler trace of one session of rx_block")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; run with --device cpu to use the CPU", file=sys.stderr)
        return 1
    device = torch.device(args.device)
    inp = bench_inputs(args.batch, device)
    doc = profile(args.batch, device, ITERS, REPS, inputs=inp)
    print(json.dumps(doc, indent=1))
    if args.trace:
        path, split = trace(inp, device, args.trace)
        print(f"profiler trace written to {path}; by stage: {json.dumps(split)}",
              file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
