#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card -- its kernels, receive and transmit
paths and application layer -- and check them.

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one.  Phases, each printed:

1. the card (nvidia-smi name and power limit) and the kernel build;
2. K1, the Viterbi kernel, against its plain version at the main path's
   shapes (B=4096 channels x 3 frame slots, the four trellis lengths):
   bits and metric must be equal; median times of both, the bound and
   the share of it, clocks and power;
3. K2, the receiver-scan kernel, against its plain version over a
   13-block staggered session mix at B=4096 after the front end: slot
   values, flags and every state field must be equal; times per block,
   and the kernel's median over 30 launches on one fixed mid-session
   block and state, with its bound, share, clocks and power;
3b. K3, the front-end kernel, alone against its plain version on int16
   noise at the bench's whole-session call [4096, 2, 24960] and at one
   block of 16384 channels [16384, 2, 1920], after a block that seeds the
   DC estimate on half the channels: dec, offset and every state field
   must be equal; median device times of both, the bound and the share;
3c. K5, the compaction kernel, alone against its plain version on K2's
   slot values and flags for the staggered mix as one whole-session call
   [4096, 4992] (the benchmark's call), the same tiled to [16384, 4992],
   and its first block [4096, 384]: every output must be equal, floats
   bit for bit; median device times of both, the bound and the share;
4. the main path, ``rx_stream`` at B=4096 and T=1920 over the same mix,
   on the kernels and on the plain versions: every output field and the
   final state must be equal, and every kernel must have been launched
   by the kernel run (K4, the frame equalizer, once a block); times per block; then device time, launches and the
   top kernels per block under torch.profiler;
5. the main path against the JAX package's recorded decode of the
   committed fixture sessions (m17_sdr_tpu_torch/data/rx_fixture.npz),
   tiled to B=4096: every recorded field must equal the record;
6. the port's TX against the JAX record: the fixture's 8 sessions built
   on the card from their payloads, the record's carrier offset and noise
   applied on the host, quantized: within TX_LSB of the recorded int16
   IQ, and ``rx_stream`` of it decodes every recorded field as recorded
   (a decoded field where its frame type's valid flag is set: a slot
   holding no such frame decodes noise, which a few LSB may change);
7. the bench mix built on the card by the port (``make_bench_blocks`` at
   B=4096) through ``rx_stream``: every routed stream payload equals the
   payload sent at its FN, and channels c % 13 == 0 route all 8 frames;
   TX build time and ms/block;
8. the BER sweep of SWEEP_POD_r5.json (16 points 8-20 dB, 256 channels a
   point, 20 frames) on the card with a seeded generator: each point's
   frame recovery within ``ber_sweep.recovery_tolerance`` of the recorded
   curve, no bit errors at 19.2 and 20 dB; wall time and ms/block; then a BERT
   and a packet session at B=256 through ``rx_stream`` on the kernels and
   on the plain versions: every output field and the final state equal;
9. the app's streaming receiver, ``StreamingRx`` at 48 kHz and B=4096:
   the staggered mix of phase 3 as host int16 wire blocks [B, 1920, 2]
   through ``run()`` (the native ring, the producer thread, pinned
   uploads on their own stream; 13 blocks, so one 8+4+1 tail): every
   output field and the final state equal to phase 4's ``rx_stream`` on
   the card, through the ring and fed directly; the unrotated fixture mix
   the same way, equal to the JAX record on all channels; then the timing:
   the staggered mix repeated to 100 blocks (4 whole 25-block chunks),
   equal to ``rx_stream`` of the same blocks, and after that warm session,
   sessions of 50 and 100 blocks through the ring and fed directly in
   alternating order: ms/block and channel-samples/s over the whole
   session and in the steady chunks (the 100- minus the 50-block
   session), uploads included, beside ``rx_stream`` fed from the card;
10. the Pluto-rate path: the 8 fixture sessions built on the card by the
   port's TX at 384 kHz (oversample 80), tiled and staggered to B=1024,
   through ``StreamingRx(input_rate=384000, chunk_blocks=5)`` as host
   wire blocks [B, 15360, 2]: every routed payload is the one sent at its
   FN, the unrotated channels route all 8, every recovered LSF reads
   AB1CDE <- G4GUO; the x8 decimator on one block against a float64
   numpy FIR, within DEC_REL of the output's peak, and its time on that
   block against its bound; wall time per block on the first and on a
   second session;
11. checkpoint split-resume on the card: phase 9's staggered capture run
   for SPLIT_BLOCKS blocks, checkpointed, resumed by a new StreamingRx:
   bit-identical to phase 9's unbroken run;
12. the CLI as a user runs it, in subprocesses on the card: ``tx`` of two
   captures, ``rx`` of both as one batch (payloads equal to those sent,
   the callsigns given, 0 Golay errors, ``--save-state``), ``bert
   --channels 4096 --frames 25 --snr 25`` (BER 0.0) and ``sweep --pod``
   (4 points, 256 channels, 8 frames, in a one-rank ``nccl`` world: the
   JAX CLI's keys, totals equal to the points' sums, no bit error at
   20 dB); each subprocess reports its kernel launches at exit;
13. live receive over UDP: ``Session.rx_live`` on a free loopback port
   the kernel picks, fed by a ``tx --udp-out ... --pace`` sender
   subprocess started once the port is bound: every payload routed,
   decoded while the sender was still sending; the median turnaround of
   its 5-block chunks at B=1;
14. the mesh layer in a one-rank ``nccl`` world (the machine has one
   card, and NCCL takes one rank a card): ``sharded_rx_stream`` over the
   staggered mix at B=4096 equals ``rx_stream`` with the same arguments
   field by field and its reduced metrics equal the local sums;
   ``time_parallel_rx`` with 3 warm-up blocks equals ``rx_stream`` over 3
   zero blocks and the mix with the first 3 dropped; ``overlap_save_conv``
   is within FIR_TOL of a float64 FIR; ms/block of each beside phase 4's;
15. the sharded BER sweep (``pod_bert_sweep``) of SWEEP_POD_r5.json in the
   same world, noise keyed per channel: equal bit for bit to the unsharded
   ``bert_sweep_counts`` with the same seed, totals equal to the sums,
   every point within ``recovery_tolerance`` of the record, no bit error
   at 19.2 and 20 dB; wall time;
16. the dormant DSP on the card against the same functions on the CPU:
   ``pll_disc`` on one B=4096 block of the mix (within PLL_REL of the
   output's peak) and ``equalize_train`` at B=4096 over EQ_SYMBOLS
   symbols (within EQ_TOL); each one's wall time and device launches
   (plain torch loops: the launch count is their cost);
17. the soft-domain parity record, BER_PARITY_r4.json (64 channels x 64
   frames; stream 11 points, packet and BERT 7 each): every point
   regenerated with the record's seed scheme by ``ber_parity.replay_record``
   and decoded on the card, all points of a kind in one ``rx_stream_soft``
   call; each point must equal the recorded ``jax`` entry exactly (frames,
   total, bit errors, bits, and the typed extras garbled frames, clean
   errors, clean bits, packets ok) and pass the record's predicates
   against its ``ref`` tuple; wall time per kind; then the stream 12 dB
   point decoded on the kernels again (its score equal to the record), and
   its first PARITY_PLAIN_BLOCKS blocks on the kernels and on the plain
   versions: equal decodes;
18. the IQ-domain parity record, BER_PARITY_IQ_r5.json (16 x 16 int16 IQ,
   ``awgn`` and ``offset300Hz``, 7 points each), regenerated by
   ``ber_parity_iq.replay_record_iq`` with noise from a seeded generator on
   the card (an independent realization: JAX's draws are not available
   here) and decoded through ``rx_stream`` in one call: every point must
   pass ``frame_agreement_ok`` and ``ber_agreement_ok`` against the
   recorded ``ref``; the recorded ``jax`` tuple is printed beside the
   port's; wall time; then, at each config's 18 dB point, the card's
   decode of the replayed wire must equal the CPU's decode of the same
   wire, and the frames recovered over 8 further noise draws are printed
   (the spread of the draw; tests/test_torch_ber_parity_iq_record.py holds
   the port's decode of JAX's own wires to the recorded ``jax`` tuples);
19. the stream quality gate (``m17_sdr_tpu_torch.tools.quality_gate``, the
   port of tools/quality_gate.py): its seven regimes at QUALITY_GATE_r5.json's
   size (32 channels x 24 frames, seed 0) through ``rx_stream_soft`` and
   ``rx_stream`` on the card; the five numpy-noise regimes (AWGN 7, 10 and
   14 dB, two-ray ISI under the auto-armed and the forced equalizer) must
   equal the record (integers exactly, the quality extremes and
   ``eye_est_med`` within QG_FLOAT_ABS), offset+drift and Pluto, on noise
   drawn on the card, must meet ``gate_ok``'s two bounds, and the card's
   decode of their wires must equal the CPU's (floats within
   QG_RTOL/QG_ATOL, the difference nearest its bound printed); then all
   seven at scale, B=4096 (Pluto B=1024) x 24 frames: each regime's whole
   tally, ``gate_ok`` (printed, not asserted: a bound missed there is a
   finding about the gate), wall times and launches, and its first
   QG_SLICE channels decoded on the CPU must equal the card's decode field
   by field (likewise);
20. the stage profiler (``m17_sdr_tpu_torch.tools.profile_stages``, the
   port of tools/profile_stages.py) at B=4096 on the bench mix: its seven
   kernel-path stages, PROFILE_ITERS passes a rep, PROFILE_REPS interleaved
   reps, one whole-session call a pass, and the
   document printed beside phase 4's device busy ms per block under the
   profiler (the stages' host-clock times are host-bound, not device
   time); then the device busy time of ``rx_kernel``'s calls
   (PROFILE_BLOCKS blocks) and of one ``rx_session`` call under the
   profiler, each beside its stage time; that whole-session ``rx_block``
   call (S2=4992) at B=4096 must equal, in its first QG_SLICE channels,
   output and state, a CPU plain call on the same channels (floats within
   QG_RTOL/QG_ATOL, the difference nearest its bound printed);
21. the streaming bench (``m17_sdr_tpu_torch.tools.streaming_bench``, the
   port of tools/streaming_bench.py) on its uniform int16 noise, the legs of
   STREAMING_r5.json: throughput at 48 kHz (B=1, 256, 4096) and 384 kHz
   (B=256, 1024; 50 x B x 15360 x 4 bytes of noise, so not 4096), and
   5-block chunk latency at B=1 and 256 at both rates; each JSON line, its
   wall time and launches; then, for each (B, rate), one more card session
   of STREAM_CHECK_BLOCKS noise blocks through the tool's
   ``throughput_session`` (the chunk of the pair's first leg) must equal, in
   its first min(B, QG_SLICE) channels, every output field and the final
   state, a plain ``StreamingRx`` session on the CPU over the same channels
   (floats within QG_RTOL/QG_ATOL, the difference nearest its bound
   printed);
22. the port's headline bench (``m17_sdr_tpu_torch.bench``, the port of
   bench.py) at B=4096 in full: its JSON line, which must name the kernel
   receiver, with every headline rep's implied input read under the HBM
   roof; the headline's call (one whole session from a fresh state) must
   equal, in its first QG_SLICE channels, output and state, a CPU plain
   call on those channels' session (floats within QG_RTOL/QG_ATOL), and the
   Viterbi leg's last call must equal ``viterbi_decode_ref`` in bits and
   metric on its first BENCH_VIT_CHECK rows; then K1 alone at the Viterbi
   leg's shape, by CUDA events, with its plain time and bound, beside the
   leg's time a call;
23. the weak-scaling tool (``m17_sdr_tpu_torch.tools.weak_scaling``, the
   port of tools/weak_scaling.py) with ``nccl`` ranks at WS_CH_PER_DEV
   channels a rank and WS_BLOCKS blocks, one rank a card (N = 1 on a
   one-card machine): the point, whose legs must agree (outputs, state,
   reduced metrics); the nocomm leg's last output and final state on the
   draw's first KEPT channels must equal two plain ``rx_stream`` calls on
   the CPU over those rows from a fresh state (floats within
   QG_RTOL/QG_ATOL, the difference nearest its bound printed); the ranks'
   kernel launches come back in the document;
24. the Viterbi self-test (``python -m m17_sdr_tpu_torch.tools.cuda_selftest``,
   the port of tools/tpu_selftest.py) in a subprocess as a user runs it: its
   12 checks (random soft bits, clean and noisy codewords at T = 244, 148,
   210 and 201, 128 trellises each) must read ``ok`` with 0 bit mismatches;
   then K1 alone at the self-test's new length, 128 x 2*201, against the
   plain decoder, by CUDA events, with its plain time and bound;
25. the acceptance gate (``python -m m17_sdr_tpu_torch.tools.kernel_validate``,
   the port of tools/pallas_validate.py) at B=4096 in a subprocess: the
   voice session through ``rx_block`` on the kernels and on the plain
   versions must read ``ok``, both legs 32768 frames with 0 byte errors;
   each leg's wall time and ms a block;
26. the pod sweep (``python -m m17_sdr_tpu_torch.tools.sweep_pod --out ...``,
   the port of tools/sweep_pod.py) at its defaults (4096 channels x 16
   points x 20 frames) on one ``nccl`` rank in a subprocess: sharded equal
   to unsharded, totals equal to the sums, every point's frame recovery
   within ``recovery_tolerance`` of SWEEP_POD_r5.json, no bit error at
   19.2 and 20 dB; both elapsed times;
27. the per-block harness (``python -m m17_sdr_tpu_torch.tools.bench_debug``,
   the port of tools/bench_debug.py) at B=4096 in subprocesses: ``gen``'s
   saved blocks must equal phase 25's session blocks built here, and
   ``run`` and ``noise`` print their per-block ms; then each of ``run`` and
   ``noise`` once more in this process, whose last output and final state
   on channels 0 to QG_SLICE-1 must equal a plain CPU chain over the same
   rows from a fresh state (floats within QG_RTOL/QG_ATOL, the difference
   nearest its bound printed); the median ms a block of signal against
   noise beside phase 20's ``rx_kernel``;
28. a ``kernels`` summary, then one JSON line with each kernel's launches
   (summed over the paths of phases 4, 6-15 and 17-27, each counted from 0
   just before it), error, times and bound, then the last line
   ``{"ok": true, "device": ...}``.

A kernel's bound is the least time the card could take for its work: the
larger of its bytes (each input read once, each output written once) over
HBM_BYTES_PER_S and its f32 operations over F32_OPS_PER_S, the H100 SXM's
published peaks.

Any mismatch prints where it was found and exits 1 before the last line.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B = 4096                 # channels on the main path
T = 1920                 # samples per block (40 ms at 48 kHz)
NBLK = 13                # blocks in one fixture session
F = 3                    # frame slots per block
TRELLIS_STEPS = {"lsf": 244, "stream": 148, "packet": 210, "bert": 205}
FLOAT_TOL = 1e-6         # kernel vs plain floats; exact is expected
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_OPS_PER_STEP = 68     # 16 states x (2 adds, compare, select) + 4 branch adds
K2_OPS_PER_CLK = 122     # 2 filters x (31 products + 30 sums) at a clk step
K2_BLOCK = NBLK // 2     # the mid-session block K2 is timed on
K3_SHAPES = ((4096, 24960), (16384, 1920))   # K3's timed calls: (channels, samples)
K3_OPS_PER_SAMPLE = 20   # scale, |iq|, limiter, discriminator, the two sums
K5_SHAPES = ((4096, 4992), (16384, 4992), (4096, 384))   # K5's timed calls: (channels, S2)
PROFILE_BLOCKS = 4       # steady-state blocks of the main path under the profiler
TX_LSB = 20              # port TX vs the JAX record, int16 LSB (3e-5 each): 6e-4
SWEEP_SEED = 0           # the BER sweep's noise generator
SWEEP_CLEAN_DB = (19.2, 20.0)   # sweep points that must show no bit error
PLAIN_B = 256            # channels of the kernel-vs-plain TX sessions
PLAIN_BERT_FRAMES = 8
PLAIN_PACKET_BYTES = 100
# the fixture's impairments (tests/test_torch_fixture.py)
FIXTURE_NOISY = slice(4, 8)
FIXTURE_CARRIER_HZ = 300.0
FIXTURE_SIGMA = 0.02
PLUTO_B = 1024           # channels of the 384 kHz leg
PLUTO_FACTOR = 8
DEC_REL = 1e-5           # decimator vs float64, relative to the output's peak
SPLIT_BLOCKS = 6         # phase 11 checkpoints after this many blocks
STREAM_BLOCKS = (50, 100)   # phase 9's timed sessions: 2 and 4 whole 25-block chunks
STREAM_REPS = 3          # timed sessions of each length and feed
DEC_REPS = 20            # timed launches of the decimator on one Pluto block
CLI_TIMEOUT_S = 300
LIVE_FRAMES = 40         # frames of the live UDP session (45 blocks)
LIVE_CHUNK = 5           # blocks a live chunk: 200 ms of signal
FIR_TOL = 1e-5           # overlap-save FIR vs float64 (tests/test_mesh.py's bound)
FIR_SHAPE = (256, 8 * T)  # the overlap-save check's input
WARMUP = 3               # time_parallel_rx warm-up blocks
PLL_REL = 1e-4           # pll_disc card vs CPU, relative to the output's peak
EQ_SYMBOLS = 192         # equalize_train's symbols (one frame)
EQ_TOL = 1e-4            # equalize_train card vs CPU, symbols and taps (trained on known symbols)
POD_CLI = ("--points", "4", "--channels", "256", "--frames", "8", "--snr-min", "8",
           "--snr-step", "4")
PARITY_SOFT = "BER_PARITY_r4.json"
PARITY_IQ = "BER_PARITY_IQ_r5.json"
PARITY_KINDS = ("stream", "packet", "bert")
PARITY_PLAIN_DB = 12.0   # the soft-domain stream point also decoded on the plain versions
PARITY_PLAIN_BLOCKS = 25  # ... over its first blocks (the plain scan takes ~1.6 s a block)
PARITY_IQ_DB = 18.0      # the IQ points also decoded on the CPU and drawn again
PARITY_IQ_SEEDS = 8      # further noise draws at each PARITY_IQ_DB point
QUALITY_GATE = "QUALITY_GATE_r5.json"
QG_B = 4096              # channels of the 48 kHz quality-gate regimes at scale
QG_PLUTO_B = 1024        # channels of the Pluto regime at scale (8x the bytes a channel)
QG_SLICE = 8             # channels of each at-scale regime also decoded on the CPU
QG_FLOAT_ABS = 1e-3      # the record's quality extremes and eye_est_med (1e-4 relative apart)
QG_RTOL, QG_ATOL = 1e-3, 1e-5   # card vs CPU float fields (tests/torch_parity.py's bounds)
PROFILE_ITERS, PROFILE_REPS = 40, 4   # the stage profiler's passes a rep and reps (JAX's)
# phase 21's legs: (mode, batch, rate, runs); 5-block chunks in the latency
# legs (the JAX tool's defaults and STREAMING_r5.json); 500 blocks each, the
# tool's default
STREAM_LEGS = (("throughput", 1, 48_000, 3), ("chunk_latency", 1, 48_000, 1),
               ("throughput", 256, 48_000, 3), ("chunk_latency", 256, 48_000, 1),
               ("throughput", 4096, 48_000, 3),
               ("chunk_latency", 1, 384_000, 1),
               ("throughput", 256, 384_000, 2), ("chunk_latency", 256, 384_000, 1),
               ("throughput", 1024, 384_000, 2))
STREAM_BENCH_BLOCKS = 500
STREAM_CHECK_BLOCKS = 30  # a checked session: a 25-block chunk and its 5-block tail
LATENCY_CHUNK = 5
BENCH_VIT_CHECK = 64     # rows of the bench's Viterbi leg held to the plain decoder
WS_CH_PER_DEV, WS_BLOCKS = 4096, 16   # the weak-scaling point on the card
SELFTEST_STEPS = 201      # the self-test's trellis length that no main path decodes
CLI_MODULE = "m17_sdr_tpu_torch.app.main"
TOOLS = "m17_sdr_tpu_torch.tools."


def module_wrap(module: str) -> str:
    """Code that runs ``module`` as `python -m` does, then reports the
    kernels' launch counts on stderr at exit."""
    return ("import atexit, json, runpy, sys\n"
            "from m17_sdr_tpu_torch import _build\n"
            "atexit.register(lambda: print('launches ' + json.dumps("
            "{k.symbol: k.launches for k in _build.KERNELS}), file=sys.stderr))\n"
            f"runpy.run_module('{module}', run_name='__main__', alter_sys=True)\n")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


HOLD_CYCLES = 10_000_000  # a few ms of device spin ahead of each timed call


def timed(fn):
    """(device ms, result) of one fn() by CUDA events.  The stream is held
    busy first, so the host has enqueued all of fn's work before the start
    event fires and its launch overhead is not timed (for a host-bound fn,
    such as a plain version, it still shows)."""
    torch.cuda._sleep(HOLD_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), res


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() in ms over reps calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(timed(fn)[0] for _ in range(reps))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations") for the given work."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def first_diff(name: str, a: torch.Tensor, b: torch.Tensor, block_axis: bool) -> str:
    """Where two tensors first differ: channel (and block) of the element."""
    neq = a != b
    if a.dtype.is_floating_point:
        neq = (a - b).abs() > FLOAT_TOL * (1 + b.abs())
    idx = neq.nonzero()[0].tolist()
    where = f"channel {idx[0]}" + (f", block {idx[1]}" if block_axis and len(idx) > 1 else "")
    return f"{name} differs at {where}: {a[tuple(idx)].item()} vs {b[tuple(idx)].item()}"


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return torch.allclose(a, b, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    return torch.equal(a, b)


def staggered_blocks(iq16: np.ndarray, dev) -> torch.Tensor:
    """Fixture sessions tiled to B channels, channel c's block sequence
    rotated by c % NBLK (as m17_sdr_tpu/pipeline/benchdata.py does):
    [B, NBLK, 2, T] int16 on the card."""
    s = iq16.shape[0]
    blk = torch.as_tensor(iq16).reshape(s, 2, NBLK, T).permute(0, 2, 1, 3)
    tiled = blk.repeat(B // s, 1, 1, 1).to(dev)
    offs = torch.arange(B, device=dev) % NBLK
    idx = (torch.arange(NBLK, device=dev)[None, :] + offs[:, None]) % NBLK
    return torch.gather(tiled, 1, idx[:, :, None, None].expand(B, NBLK, 2, T)).contiguous()


def reset_launches(kernels) -> None:
    for k in kernels:
        k.launches = 0


def read_launches(path: str, kernels, paths: dict) -> dict:
    """Launch counts since reset_launches, recorded under ``path``; fails
    if a kernel was not launched, except K4, which runs only where the
    path's receiver has the frame equalizer on or automatic."""
    from m17_sdr_tpu_torch import _build

    torch.cuda.synchronize()
    got = {k.symbol: k.launches for k in kernels}
    for sym, n in got.items():
        if n == 0 and sym != _build.EQUALIZE.symbol:
            fail(f"{path} never launched {sym}")
    paths[path] = got
    return got


def compare_outputs(what: str, out_k, st_k, out_r, st_r) -> None:
    for name in out_k._fields:
        a, b = getattr(out_k, name), getattr(out_r, name)
        if not same(a, b):
            fail(f"{what}: " + first_diff(name, a, b, a.dim() > 1))
    for (name, a), (_, b) in zip(flatten_state(st_k), flatten_state(st_r)):
        if not same(a, b):
            fail(f"{what} final state: " + first_diff(name, a, b, False))


def flatten_state(state, prefix=""):
    for name, x in state._asdict().items():
        if isinstance(x, tuple):
            yield from flatten_state(x, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", x


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.dsp.discriminator import RxFrontEndState, rx_front_end
    from m17_sdr_tpu_torch.fec.viterbi import viterbi_decode_cuda, viterbi_decode_ref
    from m17_sdr_tpu_torch.frame.receiver import (
        _KERNEL_FIELDS, ReceiverState, receiver_scan_cuda, receiver_scan_ref)
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream

    paths = {}                 # path -> {kernel symbol: launches}

    # ---- phase 1: the card and the build
    card = smi("name,power.limit").splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s for "
          f"{len(_build.KERNELS)} kernels", flush=True)

    rng = np.random.default_rng(0)
    report = {}

    # ---- phase 2: K1 parity and time
    k1_ms = k1_plain_ms = k1_err = k1_bound = 0.0
    k1_ops = k1_bytes = 0
    for name, steps in TRELLIS_STEPS.items():
        soft = rng.normal(size=(B * F, 2 * steps)).astype(np.float32)
        soft[:, 11::12] = 0.0                       # erasures, as depunctured
        x = torch.as_tensor(soft).to(dev)
        bits_k, met_k = viterbi_decode_cuda(x)
        bits_r, met_r = viterbi_decode_ref(x)
        if not torch.equal(bits_k, bits_r):
            fail(first_diff(f"K1 bits ({name})", bits_k, bits_r, False))
        if not torch.equal(met_k, met_r):
            fail(first_diff(f"K1 metric ({name})", met_k, met_r, False))
        err = (met_k - met_r).abs().max().item()
        ms = cuda_ms(lambda: viterbi_decode_cuda(x), 20)
        plain = cuda_ms(lambda: viterbi_decode_ref(x), 3)
        nbytes = x.nbytes + bits_k.nbytes + met_k.nbytes
        ops = K1_OPS_PER_STEP * x.shape[0] * steps
        b_ms, _ = bound(nbytes, ops)
        k1_ms, k1_plain_ms, k1_err = k1_ms + ms, k1_plain_ms + plain, max(k1_err, err)
        k1_bound, k1_bytes, k1_ops = k1_bound + b_ms, k1_bytes + nbytes, k1_ops + ops
        print(f"phase 2 K1 {name}: {B * F} trellises x {steps} steps: bits and metric "
              f"equal; kernel {ms:.4f} ms, plain {plain:.1f} ms; bound {b_ms * 1e3:.2f} us "
              f"({nbytes / 1e6:.2f} MB), share {b_ms / ms:.3f}", flush=True)
    _, k1_by = bound(k1_bytes, k1_ops)
    report["viterbi"] = dict(ms=k1_ms, plain_ms=k1_plain_ms, max_abs_err=k1_err,
                             bound_ms=k1_bound, bound_by=k1_by)
    print(f"phase 2 K1 one block's four decodes: kernel {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.1f} ms; bound {k1_bound * 1e3:.2f} us ({k1_by}), "
          f"share {k1_bound / k1_ms:.3f}; {card}; clocks.sm, power.draw, power.limit: "
          f"{smi('clocks.sm,power.draw,power.limit')}", flush=True)

    # ---- phase 3: K2 parity and time over the staggered mix
    with np.load(_fixture_path()) as z:
        fx = {k: z[k] for k in z.files}
    blocks = staggered_blocks(fx["iq"], dev)
    fe = RxFrontEndState.init(B, dev)
    st_k = st_r = ReceiverState.init(B, dev)
    k2_ms, k2_plain_ms, k2_err = [], [], 0.0
    for i in range(NBLK):
        soft2x, _, fe = rx_front_end(blocks[:, i], fe, in_frame=st_k.flock, afc_enabled=True)
        if i == K2_BLOCK:
            fixed = (soft2x, st_k)
        ms, (slot_k, flags_k, st_k) = timed(lambda: receiver_scan_cuda(soft2x, st_k))
        plain, (slot_r, flags_r, st_r) = timed(lambda: receiver_scan_ref(soft2x, st_r))
        for name, a, b in (("slot_val", slot_k, slot_r), ("flags", flags_k, flags_r),
                           *((f"state.{f}", getattr(st_k, f), getattr(st_r, f))
                             for f in ReceiverState._fields)):
            if not torch.equal(a, b):
                fail(f"K2 block {i}: " + first_diff(name, a, b, False))
        k2_err = max(k2_err, (slot_k - slot_r).abs().max().item())
        k2_ms.append(ms)
        k2_plain_ms.append(plain)
    locked = int(st_k.flock.sum())
    # medians: block 0's launch also loads the kernel's module onto the card
    k2_med, k2_plain_med = statistics.median(k2_ms), statistics.median(k2_plain_ms)
    print(f"phase 3 K2: {NBLK} blocks x {B} channels: slots, flags and state equal "
          f"({locked} channels locked at the end); one launch a block: median kernel "
          f"{k2_med:.4f} ms/block (block 0: {k2_ms[0]:.3f}), plain {k2_plain_med:.1f} "
          f"ms/block", flush=True)
    samples, st = fixed
    slot, flags, st_out = receiver_scan_cuda(samples, st)
    state_fields = ("window", *_KERNEL_FIELDS)
    nbytes = (samples.nbytes + slot.nbytes + flags.nbytes
              + sum(getattr(st, f).nbytes + getattr(st_out, f).nbytes for f in state_fields))
    k2_bound, k2_by = bound(nbytes, K2_OPS_PER_CLK * samples.numel() / 2)
    k2_fixed = cuda_ms(lambda: receiver_scan_cuda(samples, st), 30)
    report["receiver_scan"] = dict(ms=k2_fixed, plain_ms=k2_plain_med, max_abs_err=k2_err,
                                   bound_ms=k2_bound, bound_by=k2_by)
    print(f"phase 3 K2 block {K2_BLOCK}, median of 30 launches: kernel {k2_fixed:.4f} ms; "
          f"bound {k2_bound * 1e3:.2f} us ({k2_by}, {nbytes / 1e6:.2f} MB), share "
          f"{k2_bound / k2_fixed:.3f}; {card}; clocks.sm, power.draw, power.limit: "
          f"{smi('clocks.sm,power.draw,power.limit')}", flush=True)

    front_end_k3(dev, report, card)
    compact_k5(blocks, dev, report, card)

    # ---- phase 4: the main path, kernels vs plain
    legs = {}
    for leg, use_kernel in (("kernel", None), ("plain", False)):
        # one block first, so that library set-up (cuBLAS, cuSOLVER) is
        # not timed
        rx_stream(blocks[:, :1], RxSessionState.init(B, dev), afc_enabled=True,
                  equalize="auto", use_kernel=use_kernel)
        torch.cuda.synchronize()
        if use_kernel is None:
            for k in _build.KERNELS:
                k.launches = 0
        t0 = time.perf_counter()
        out, state = rx_stream(blocks, RxSessionState.init(B, dev), afc_enabled=True,
                               equalize="auto", use_kernel=use_kernel)
        torch.cuda.synchronize()
        per_block = (time.perf_counter() - t0) / NBLK
        if use_kernel is None:
            launches = read_launches("main path", _build.KERNELS, paths)
            if launches[_build.EQUALIZE.symbol] != NBLK:
                fail(f"main path: {launches[_build.EQUALIZE.symbol]} K4 launches for {NBLK} "
                     "blocks with the equalizer automatic")
        legs[leg] = (out, state, per_block)
        print(f"phase 4 main path ({leg}): {per_block * 1e3:.1f} ms/block, "
              f"{B * T / per_block / 1e6:.1f} M channel-samples/s", flush=True)
    (out_k, st_k, _), (out_r, st_r, _) = legs["kernel"], legs["plain"]
    compare_outputs("main path", out_k, st_k, out_r, st_r)
    print(f"phase 4 main path: all {len(out_k._fields)} output fields and the final "
          f"state equal (floats to {FLOAT_TOL}); launches {launches}", flush=True)
    busy_ms = profile_main_path(blocks, dev, rx_stream, RxSessionState)

    # ---- phase 5: the main path against the JAX record
    iq = torch.as_tensor(fx["iq"]).reshape(-1, 2, NBLK, T).permute(0, 2, 1, 3)
    n_sess = iq.shape[0]
    iq = iq.repeat(B // n_sess, 1, 1, 1).to(dev).contiguous()
    out, _ = rx_stream(iq, RxSessionState.init(B, dev), afc_enabled=True, equalize="auto")
    sess = torch.arange(B) % n_sess
    recorded = [k for k in fx if k not in ("iq", "payloads")]
    for name in recorded:
        got = getattr(out, name).cpu().to(torch.int64)
        want = torch.as_tensor(fx[name]).to(torch.int64)[sess]
        if not torch.equal(got, want):
            fail("fixture record: " + first_diff(name, got, want, True))
    routed = int(out.stream_gate.sum())
    print(f"phase 5 fixture: {', '.join(recorded)} equal to the JAX record on all {B} "
          f"channels ({routed} stream frames routed)", flush=True)

    tx_fixture(fx, dev, paths)
    bench_mix(dev, paths)
    sweep(dev, paths, card)
    wire = streaming_48k(fx, blocks, out_k, st_k, dev, paths, card)
    pluto(fx, dev, paths, card)
    split_resume(wire, dev, paths)
    cli(dev, paths, card)
    live_udp(dev, paths, card)
    from m17_sdr_tpu_torch.mesh import launch
    with launch.process_group(dev):
        mesh(blocks, legs["kernel"][2], dev, paths, card)
        pod_sweep(dev, paths, card)
    dormant_dsp(blocks, dev, card)
    parity_soft(dev, paths, card)
    parity_iq(dev, paths, card)
    quality_gate(dev, paths, card)
    rx_kernel = profile_stages(dev, paths, card, busy_ms)
    streaming_bench(dev, paths, card)
    bench(dev, paths, card)
    weak_scaling(paths, card)
    cuda_selftest(dev, paths, card)
    kernel_validate(paths, card)
    sweep_pod(paths, card)
    bench_debug(dev, paths, card, rx_kernel)

    # ---- phase 28: summary
    sources = {"viterbi": ("m17_sdr_tpu_torch/csrc/viterbi.cu",
                           "m17_sdr_tpu/fec/viterbi_pallas.py:58", _build.VITERBI),
               "receiver_scan": ("m17_sdr_tpu_torch/csrc/receiver_scan.cu",
                                 "m17_sdr_tpu/frame/receiver_pallas.py:73",
                                 _build.RECEIVER_SCAN),
               "front_end": ("m17_sdr_tpu_torch/csrc/front_end.cu",
                             "none: XLA's fusion of m17_sdr_tpu/dsp/discriminator.py",
                             _build.FRONT_END),
               "compact": ("m17_sdr_tpu_torch/csrc/compact.cu",
                           "none: XLA's sort and gathers in m17_sdr_tpu/frame/receiver.py",
                           _build.COMPACT)}
    launches = {k.symbol: sum(p.get(k.symbol, 0) for p in paths.values())
                for k in _build.KERNELS}
    kernels = []
    for name, (source, replaces, k) in sources.items():
        r = report[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[k.symbol],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "bound_us": r["bound_ms"] * 1e3, "share": r["bound_ms"] / r["ms"]})
    summary = []
    for name, (_, _, k) in sources.items():
        per_path = ", ".join(f"{p} {n[k.symbol]}" for p, n in paths.items() if k.symbol in n)
        summary.append(f"{name}: {launches[k.symbol]} launches on the paths ({per_path}), "
                       "parity ok")
    k4 = _build.EQUALIZE.symbol
    per_path = ", ".join(f"{p} {n[k4]}" for p, n in paths.items() if n.get(k4))
    summary.append(f"equalize: {sum(p.get(k4, 0) for p in paths.values())} launches on the "
                   f"paths with the equalizer on or automatic ({per_path})")
    print("kernels " + "; ".join(summary), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def front_end_k3(dev, report: dict, card: str) -> None:
    """Phase 3b: K3 alone against the plain front end at K3_SHAPES."""
    from m17_sdr_tpu_torch.dsp.discriminator import RxFrontEndState, rx_front_end

    gen = torch.Generator(dev).manual_seed(3)
    for b, t in K3_SHAPES:
        iq = (torch.randn((b, 2, t), generator=gen, device=dev) * 10000.0).clamp_(
            -32768, 32767).to(torch.int16)
        inf = torch.arange(b, device=dev) % 2 == 0
        st = rx_front_end(iq, RxFrontEndState.init(b, dev), inf)[2]
        got = rx_front_end(iq, st, inf)
        want = rx_front_end(iq, st, inf, use_kernel=False)
        for name, a, r in (("dec", got[0], want[0]), ("offset", got[1], want[1]),
                           *((f"state.{f}", getattr(got[2], f), getattr(want[2], f))
                             for f in RxFrontEndState._fields)):
            if not torch.equal(a, r):
                fail(f"K3 [{b}, 2, {t}]: " + first_diff(name, a, r, False))
        ms = cuda_ms(lambda: rx_front_end(iq, st, inf), 20)
        plain = cuda_ms(lambda: rx_front_end(iq, st, inf, use_kernel=False), 5)
        # int16 in, dec, offset and in_frame, the state in and out
        nbytes = iq.nbytes + b * (t // 5) * 4 + b * 4 + b + 2 * b * (16 + 5 * 4 + 1)
        b_ms, by = bound(nbytes, K3_OPS_PER_SAMPLE * b * t)
        if (b, t) == K3_SHAPES[0]:
            report["front_end"] = dict(ms=ms, plain_ms=plain, max_abs_err=0.0,
                                       bound_ms=b_ms, bound_by=by)
        print(f"phase 3b K3 [{b}, 2, {t}] int16: dec, offset and state equal; kernel "
              f"{ms:.4f} ms, plain {plain:.3f} ms ({plain / ms:.1f}x); bound "
              f"{b_ms * 1e3:.2f} us ({by}, {nbytes / 1e6:.1f} MB), share {b_ms / ms:.3f}; "
              f"{card}; clocks.sm, power.draw, power.limit: "
              f"{smi('clocks.sm,power.draw,power.limit')}", flush=True)


def compact_k5(blocks: torch.Tensor, dev, report: dict, card: str) -> None:
    """Phase 3c: K5 alone against compact_ref at K5_SHAPES, on K2's output
    for the staggered mix."""
    from m17_sdr_tpu_torch.dsp.discriminator import RxFrontEndState, rx_front_end
    from m17_sdr_tpu_torch.frame.receiver import (
        BlockEvents, ReceiverState, compact_cuda, compact_ref, max_frames_per_block,
        receiver_scan_cuda)

    session = blocks.permute(0, 2, 1, 3).reshape(B, 2, NBLK * T)
    for b, s2 in K5_SHAPES:
        iq = session[..., :s2 * 5].repeat(b // B, 1, 1)
        soft, _, _ = rx_front_end(iq, RxFrontEndState.init(b, dev),
                                  torch.zeros(b, dtype=torch.bool, device=dev))
        slot, flags, st = receiver_scan_cuda(soft, ReceiverState.init(b, dev))
        st = st._replace(sym_hist=torch.randn((b, 191), device=dev))
        got, want = compact_cuda(slot, flags, st), compact_ref(slot, flags, st)
        for name, a, r in (*zip(BlockEvents._fields, got[0], want[0]),
                           ("sym_hist", got[1].sym_hist, want[1].sym_hist)):
            if a.dtype == torch.float32:
                a, r = a.view(torch.int32), r.view(torch.int32)
            if not torch.equal(a, r):
                fail(f"K5 [{b}, {s2}]: " + first_diff(name, a, r, False))
        ms = cuda_ms(lambda: compact_cuda(slot, flags, st), 20)
        plain = cuda_ms(lambda: compact_ref(slot, flags, st), 5)
        f = max_frames_per_block(s2)
        # slots and flags in, the history in and out, frames, four [B, F]
        # masks and aos, los and n_slips out (portbench/metrics/k5_roofline.py)
        nbytes = b * (s2 * 4 * 2 + 191 * 4 * 2 + f * 192 * 4 + f * (1 + 4 + 1 + 1) + 1 + 1 + 4)
        b_ms, by = bound(nbytes, 0.0)
        if (b, s2) == K5_SHAPES[0]:
            report["compact"] = dict(ms=ms, plain_ms=plain, max_abs_err=0.0,
                                     bound_ms=b_ms, bound_by=by)
        print(f"phase 3c K5 [{b}, {s2}] ({int(got[0].frame_valid.sum())} frames): every "
              f"output equal; kernel {ms:.4f} ms, plain {plain:.3f} ms ({plain / ms:.1f}x); "
              f"bound {b_ms * 1e3:.2f} us ({by}, {nbytes / 1e6:.1f} MB), share "
              f"{b_ms / ms:.3f}; {card}; clocks.sm, power.draw, power.limit: "
              f"{smi('clocks.sm,power.draw,power.limit')}", flush=True)


def tx_fixture(fx: dict, dev, paths: dict) -> None:
    """Phase 6: the fixture's sessions rebuilt by the port's TX on the card."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.pipeline import tx as txp
    from m17_sdr_tpu_torch.pipeline.benchdata import bench_sessions
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream

    payloads = torch.as_tensor(fx["payloads"]).to(dev)
    b0 = payloads.shape[0]
    lsf = bench_sessions(dev)[0][:b0]          # the fixture's LSF: AB1CDE <- G4GUO
    iq, _ = txp.dibits_to_iq(txp.build_voice_session_dibits(lsf, payloads))
    # the record's impairments, on the host in float64 as the record was made
    iq = iq.cpu().numpy().astype(np.float64)
    t = iq.shape[-1]
    z = iq[:, 0] + 1j * iq[:, 1]
    noisy = FIXTURE_NOISY
    z[noisy] *= np.exp(2j * np.pi * FIXTURE_CARRIER_HZ / 48_000 * np.arange(t))
    noise_rng = np.random.default_rng(1)
    z[noisy] += FIXTURE_SIGMA * (noise_rng.normal(size=z[noisy].shape)
                                 + 1j * noise_rng.normal(size=z[noisy].shape))
    iq16 = np.clip(np.round(np.stack([z.real, z.imag], axis=1) / 3.0e-5),
                   -32768, 32767).astype(np.int16)
    lsb = int(np.abs(iq16.astype(np.int32) - fx["iq"]).max())
    if iq16.shape != fx["iq"].shape or lsb > TX_LSB:
        fail(f"TX fixture: {iq16.shape} int16 IQ {lsb} LSB from the JAX record "
             f"(limit {TX_LSB})")
    blocks = torch.as_tensor(iq16).reshape(b0, 2, NBLK, T).permute(0, 2, 1, 3).to(dev)
    reset_launches(_build.KERNELS)
    out, _ = rx_stream(blocks, RxSessionState.init(b0, dev), afc_enabled=True,
                       equalize="auto")
    got = read_launches("tx fixture", _build.KERNELS, paths)
    recorded = [k for k in fx if k not in ("iq", "payloads")]
    valid_of = {"stream_fn": "stream_valid", "stream_payload": "stream_valid",
                "lsf_bytes": "lsf_valid"}
    for name in recorded:
        a = getattr(out, name).cpu().to(torch.int64)
        b = torch.as_tensor(fx[name]).to(torch.int64)
        neq = a != b
        if name in valid_of:
            held = torch.as_tensor(fx[valid_of[name]])
            neq &= held.reshape(held.shape + (1,) * (a.dim() - held.dim()))
        if neq.any():
            c, blk = neq.nonzero()[0].tolist()[:2]
            fail(f"TX fixture decode: {name} differs at channel {c}, block {blk}")
    print(f"phase 6 TX fixture: {b0} sessions built by the port on the card are within "
          f"{lsb} LSB (limit {TX_LSB}) of the recorded int16 IQ; rx_stream decodes "
          f"{', '.join(recorded)} as recorded ({int(out.stream_gate.sum())} stream frames "
          f"routed); launches {got}", flush=True)


def bench_mix(dev, paths: dict) -> None:
    """Phase 7: the bench mix built on the card by the port, through rx_stream."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.pipeline.benchdata import (
        FRAMES, SESSIONS, bench_sessions, make_bench_blocks)
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream

    build_s = []
    for _ in range(2):                         # the first call includes one-time set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks, nblk = make_bench_blocks(B, device=dev)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
    iq = torch.stack(blocks, dim=1)            # [B, nblk, 2, T] int16
    reset_launches(_build.KERNELS)
    t0 = time.perf_counter()
    out, _ = rx_stream(iq, RxSessionState.init(B, dev))
    got = read_launches("bench mix", _build.KERNELS, paths)
    per_block = (time.perf_counter() - t0) / nblk

    sent = bench_sessions(dev)[1][torch.arange(B, device=dev) % SESSIONS]   # [B, 8, 16]
    gate, fn = out.stream_gate, out.stream_fn
    want = torch.gather(sent, 1, fn.clamp(0, FRAMES - 1).reshape(B, -1, 1).expand(-1, -1, 16))
    ok = (fn.reshape(B, -1) < FRAMES) & (out.stream_payload.reshape(B, -1, 16) == want).all(-1)
    bad = gate.reshape(B, -1) & ~ok
    if bad.any():
        c, j = bad.nonzero()[0].tolist()
        fail(f"bench mix: channel {c} slot {j} routed FN {int(fn.reshape(B, -1)[c, j])} "
             "with a payload other than the one sent")
    # the unrotated channels (c % nblk == 0) hold the whole session in order
    whole = torch.arange(B, device=dev) % nblk == 0
    idx = torch.where(gate.reshape(B, -1), fn.reshape(B, -1).clamp(0, FRAMES), FRAMES)
    hit = torch.zeros((B, FRAMES + 1), dtype=torch.int32, device=dev).scatter_add_(
        1, idx, torch.ones_like(idx, dtype=torch.int32))
    missing = whole & ~(hit[:, :FRAMES] > 0).all(-1)
    if missing.any():
        c = int(missing.nonzero()[0])
        fail(f"bench mix: unrotated channel {c} routed FNs "
             f"{(hit[c, :FRAMES] > 0).nonzero().flatten().tolist()}, not all {FRAMES}")
    print(f"phase 7 bench mix: TX build of the {B}-channel mix on the card "
          f"{build_s[0] * 1e3:.1f} ms (first call) / {build_s[1] * 1e3:.1f} ms; rx_stream "
          f"{per_block * 1e3:.2f} ms/block over {nblk} blocks; {int(gate.sum())} routed "
          f"stream payloads all equal to the payload sent at their FN; the "
          f"{int(whole.sum())} unrotated channels route all {FRAMES} frames; launches {got}",
          flush=True)


def sweep(dev, paths: dict, card: str) -> None:
    """Phase 8: the recorded BER sweep on the card, then kernel vs plain on
    a BERT and a packet session."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.dsp import channel
    from m17_sdr_tpu_torch.pipeline import tx as txp
    from m17_sdr_tpu_torch.pipeline.benchdata import bench_sessions
    from m17_sdr_tpu_torch.pipeline.ber_sweep import bert_sweep_counts, recovery_tolerance
    from m17_sdr_tpu_torch.pipeline.loopback import _blockify
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream

    rec = json.loads((Path(__file__).resolve().parent / "SWEEP_POD_r5.json").read_text())
    curve, cpp, nf = rec["curve"], rec["channels_per_point"], rec["frames_per_channel"]
    snr_pts = np.float32([p["snr_db"] for p in curve])
    snr = torch.as_tensor(np.repeat(snr_pts, cpp)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SWEEP_SEED)
    nblk = (nf + 4) * 192 * 10 // T            # 2 preambles + frames + EOT + idle
    reset_launches(_build.KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    err, bits, _, frames = bert_sweep_counts(snr, nf, generator=gen)
    got = read_launches("ber sweep", _build.KERNELS, paths)
    wall = time.perf_counter() - t0
    err, bits = err.reshape(-1, cpp).sum(-1).cpu(), bits.reshape(-1, cpp).sum(-1).cpu()
    frames = frames.reshape(-1, cpp).sum(-1).cpu()
    rows = []
    for i, p in enumerate(curve):
        rate = int(frames[i]) / (nf * cpp)
        tol = recovery_tolerance(p["frame_recovery"], cpp)
        rows.append(f"{p['snr_db']:.1f} dB {rate:.4f}/{p['frame_recovery']:.4f} "
                    f"ber {int(err[i]) / max(int(bits[i]), 1):.2e}")
        if abs(rate - p["frame_recovery"]) > tol:
            fail(f"BER sweep at {p['snr_db']:.1f} dB: frame recovery {rate:.4f} vs the "
                 f"recorded {p['frame_recovery']:.4f} (tolerance {tol:.4f})")
        if any(abs(p["snr_db"] - c) < 0.05 for c in SWEEP_CLEAN_DB) and int(err[i]):
            fail(f"BER sweep at {p['snr_db']:.1f} dB: {int(err[i])} bit errors")
    print(f"phase 8 BER sweep: {len(curve)} points x {cpp} channels x {nf} frames "
          f"({snr.numel()} channels, {nblk} blocks) in {wall:.2f} s wall, "
          f"{wall / nblk * 1e3:.1f} ms/block (TX, noise, rx_stream and the error count); "
          f"frame recovery port/recorded and BER: {'; '.join(rows)}; launches {got}; {card}",
          flush=True)

    # kernel vs plain on real BERT and packet frames
    g = torch.Generator(device=dev).manual_seed(SWEEP_SEED + 1)
    pts = torch.linspace(8.0, 20.0, 16, device=dev).repeat_interleave(PLAIN_B // 16)
    bert = txp.build_bert_session_dibits(PLAIN_B, PLAIN_BERT_FRAMES, device=dev)
    lsf = bench_sessions(dev)[0][:1].expand(PLAIN_B, -1)
    data = torch.randint(0, 256, (PLAIN_B, PLAIN_PACKET_BYTES), generator=g, device=dev,
                         dtype=torch.uint8)
    packet = txp.build_packet_session_dibits(lsf, data)
    for name, dibits, snr_db in (("BERT", bert, pts), ("packet", packet, pts + 6.0)):
        iq = channel.awgn(txp.dibits_to_iq(dibits)[0], snr_db, generator=g)
        blocks = _blockify(iq)
        t0 = time.perf_counter()
        out_k, st_k = rx_stream(blocks, RxSessionState.init(PLAIN_B, dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out_r, st_r = rx_stream(blocks, RxSessionState.init(PLAIN_B, dev), use_kernel=False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        compare_outputs(f"{name} session, kernel vs plain", out_k, st_k, out_r, st_r)
        valid = out_k.bert_valid if name == "BERT" else out_k.packet_valid
        print(f"phase 8 {name} session at B={PLAIN_B} ({blocks.shape[1]} blocks): every "
              f"output field and the final state equal on the kernels and the plain "
              f"versions ({int(valid.sum())} {name} frames decoded); "
              f"{(t1 - t0) / blocks.shape[1] * 1e3:.1f} vs "
              f"{(t2 - t1) / blocks.shape[1] * 1e3:.1f} ms/block", flush=True)


def host_wire_blocks(blocks: torch.Tensor) -> list[np.ndarray]:
    """[B, NBLK, 2, T] int16 on the card -> NBLK host wire blocks [B, T, 2]."""
    wire = blocks.transpose(-1, -2).contiguous().cpu().numpy()
    return [np.ascontiguousarray(wire[:, i]) for i in range(wire.shape[1])]


def stream_blocks(wire: list[np.ndarray], dev, use_ring: bool = True, **kw):
    """One StreamingRx session over host wire blocks through run() (by
    default through the ring and the producer thread): (out, state,
    n_blocks, wall s)."""
    from m17_sdr_tpu_torch.app.streaming import StreamingRx

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srx = StreamingRx(batch=wire[0].shape[0], device=dev, **kw)
    srx.run(iter(wire), use_ring=use_ring)
    out, state, n = srx.finish()
    return out, state, n, time.perf_counter() - t0


def compare_host(what: str, out, state, out_ref, st_ref) -> None:
    """A host StreamingRx result against a device one: every field equal."""
    from m17_sdr_tpu_torch.convert import state_to_numpy

    for name in out_ref._fields:
        a, b = getattr(out, name), getattr(out_ref, name).cpu().numpy()
        if a.shape != b.shape or not np.array_equal(a, b):
            fail(f"{what}: {name} differs")
    want = state_to_numpy(st_ref)
    for k, v in state_to_numpy(state).items():
        if not np.array_equal(v, want[k]):
            fail(f"{what} final state: {k} differs")


def streaming_48k(fx, blocks, out_ref, st_ref, dev, paths: dict, card: str):
    """Phase 9: StreamingRx at B=4096 over host wire blocks; returns them."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream

    wire = host_wire_blocks(blocks)
    reset_launches(_build.KERNELS)
    out, state, n, _ = stream_blocks(wire, dev, afc=True, equalize="auto")
    got = read_launches("streaming 48k", _build.KERNELS, paths)
    if n != NBLK:
        fail(f"StreamingRx 48k: {n} blocks, not {NBLK}")
    compare_host("StreamingRx 48k vs rx_stream", out, state, out_ref, st_ref)
    tiled = np.tile(fx["iq"].transpose(0, 2, 1), (B // fx["iq"].shape[0], 1, 1))
    rec_wire = [np.ascontiguousarray(tiled[:, i * T:(i + 1) * T]) for i in range(NBLK)]
    out, _, _, _ = stream_blocks(rec_wire, dev, afc=True, equalize="auto")
    sess = np.arange(B) % fx["iq"].shape[0]
    recorded = [k for k in fx if k not in ("iq", "payloads")]
    for name in recorded:
        if not np.array_equal(getattr(out, name).astype(np.int64),
                              fx[name].astype(np.int64)[sess]):
            fail(f"StreamingRx 48k vs the JAX record: {name} differs")
    out, state, _, _ = stream_blocks(wire, dev, use_ring=False, afc=True, equalize="auto")
    compare_host("StreamingRx 48k without the ring vs rx_stream", out, state, out_ref, st_ref)
    print(f"phase 9 StreamingRx 48 kHz, B={B}, {NBLK} blocks (one 8+4+1 tail): every output "
          f"field and the final state equal to rx_stream on the card, through the ring and "
          f"fed directly; on the unrotated fixture mix {', '.join(recorded)} equal to the JAX "
          f"record on all {B} channels; launches {got}", flush=True)

    # timing: the staggered mix repeated into sessions of whole 25-block
    # chunks, after a warm session of the same input; ring and direct feed
    # alternate, so order and input are the same for both
    n_long = max(STREAM_BLOCKS)
    long = [wire[i % NBLK] for i in range(n_long)]
    long_dev = blocks[:, torch.arange(n_long, device=dev) % NBLK]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_l, st_l = rx_stream(long_dev, RxSessionState.init(B, dev), afc_enabled=True,
                            equalize="auto")
    torch.cuda.synchronize()
    dev_fed = (time.perf_counter() - t0) / n_long
    del long_dev
    out, state, _, warm = stream_blocks(long, dev, afc=True, equalize="auto")
    compare_host(f"StreamingRx 48k, {n_long} blocks vs rx_stream", out, state, out_l, st_l)
    del out, state, out_l, st_l
    walls = {(ring, n): [] for ring in (True, False) for n in STREAM_BLOCKS}
    lo, hi = STREAM_BLOCKS
    order = [(True, hi), (False, hi), (True, lo), (False, lo)]
    for rep in range(STREAM_REPS):
        for ring, n in order if rep % 2 == 0 else order[::-1]:
            walls[(ring, n)].append(stream_blocks(long[:n], dev, use_ring=ring, afc=True,
                                                  equalize="auto")[3])
    legs = []
    for ring in (True, False):
        w_lo, w_hi = (statistics.median(walls[(ring, n)]) for n in STREAM_BLOCKS)
        steady = (w_hi - w_lo) / (hi - lo)
        legs.append(f"{'ring' if ring else 'direct'}: {w_hi / hi * 1e3:.1f} ms/block over the "
                    f"whole {hi}-block session ({B * T * hi / w_hi / 1e6:.1f} M "
                    f"channel-samples/s), {steady * 1e3:.1f} ms/block steady ({B * T / steady / 1e6:.1f} "
                    f"M channel-samples/s; {hi}- minus {lo}-block session, medians of "
                    f"{STREAM_REPS}: "
                    + ", ".join(f"{n}: " + "/".join(f"{w:.3f}" for w in walls[(ring, n)]) + " s"
                                for n in STREAM_BLOCKS) + ")")
    print(f"phase 9 StreamingRx 48 kHz timing, B={B}, the staggered mix repeated to {hi} blocks "
          f"(4 whole 25-block chunks): equal to rx_stream of the same blocks; warm session "
          f"{warm / hi * 1e3:.1f} ms/block; {'; '.join(legs)}; rx_stream fed from device "
          f"memory {dev_fed * 1e3:.1f} ms/block; wall times include the uploads, the decode "
          f"and finish()'s host read; {card}", flush=True)
    return wire


def fir_decimate_f64(x: np.ndarray, tail: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """The x8 decimating FIR in float64 numpy: y[m] = sum_k h[k] x[8m - k]."""
    xx = np.concatenate([tail, x], axis=-1).astype(np.float64)
    m, n = x.shape[-1] // PLUTO_FACTOR, len(taps)
    return sum(float(taps[n - 1 - j]) * xx[..., j: j + PLUTO_FACTOR * (m - 1) + 1: PLUTO_FACTOR]
               for j in range(n))


def pluto(fx, dev, paths: dict, card: str) -> None:
    """Phase 10: the fixture sessions at 384 kHz through StreamingRx."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.dsp import resample
    from m17_sdr_tpu_torch.dsp.discriminator import scale_int16
    from m17_sdr_tpu_torch.pipeline import tx as txp
    from m17_sdr_tpu_torch.pipeline.benchdata import bench_sessions
    from m17_sdr_tpu_torch.spec import callsign
    from m17_sdr_tpu_torch.spec.bits import bytes_to_word_host

    payloads = torch.as_tensor(fx["payloads"]).to(dev)              # [8, 8, 16]
    n_sess, n_frames = payloads.shape[:2]
    lsf = bench_sessions(dev)[0][:n_sess]
    iq, _ = txp.dibits_to_iq(txp.build_voice_session_dibits(lsf, payloads),
                             oversample=10 * PLUTO_FACTOR)          # [8, 2, 13*15360]
    t_in = T * PLUTO_FACTOR
    w = torch.round(iq * 0x3FFF).to(torch.int16)                    # the FileSink wire scale
    w = w.reshape(n_sess, 2, NBLK, t_in).permute(0, 2, 3, 1)          # [8, NBLK, t_in, 2]
    tiled = w.repeat(PLUTO_B // n_sess, 1, 1, 1)
    offs = torch.arange(PLUTO_B, device=dev) % NBLK
    idx = (torch.arange(NBLK, device=dev)[None, :] + offs[:, None]) % NBLK
    tiled = torch.gather(tiled, 1, idx[:, :, None, None].expand(-1, -1, t_in, 2))
    host = tiled.cpu().numpy()
    wire = [np.ascontiguousarray(host[:, i]) for i in range(NBLK)]
    del tiled, host

    x = scale_int16(torch.as_tensor(wire[0]).to(dev))                # [B, 2, t_in]
    zero = resample.decimate_init(PLUTO_B, dev)
    taps = resample.pluto_dec_taps()
    y, _ = resample.fir_decimate(x, taps, zero)
    ref = fir_decimate_f64(x.cpu().numpy(), zero.cpu().numpy(), taps)
    dec_err = float(np.abs(y.cpu().numpy() - ref).max())
    if dec_err > DEC_REL * np.abs(ref).max():
        fail(f"x8 decimator vs float64: max error {dec_err:.3g} over a peak of "
             f"{np.abs(ref).max():.3g} (limit {DEC_REL} of it)")
    dec_ms = cuda_ms(lambda: resample.fir_decimate(x, taps, zero), DEC_REPS)
    # reads the block and the tail once, writes the output and the new tail
    dec_bytes = x.nbytes + y.nbytes + 2 * zero.nbytes
    dec_bound, dec_by = bound(dec_bytes, 2 * len(taps) * y.numel())

    reset_launches(_build.KERNELS)
    out, state, n, wall = stream_blocks(wire, dev, input_rate=48_000 * PLUTO_FACTOR,
                                        chunk_blocks=5, equalize="auto")
    got = read_launches("streaming 384k", _build.KERNELS, paths)
    wall2 = stream_blocks(wire, dev, input_rate=48_000 * PLUTO_FACTOR, chunk_blocks=5,
                          equalize="auto")[3]
    sent = fx["payloads"][np.arange(PLUTO_B) % n_sess]              # [B, 8, 16]
    gate = out.stream_gate.reshape(PLUTO_B, -1)
    fn = out.stream_fn.reshape(PLUTO_B, -1)
    pl = out.stream_payload.reshape(PLUTO_B, -1, 16)
    c, j = np.nonzero(gate)
    if (fn[c, j] >= n_frames).any() or (pl[c, j] != sent[c, np.minimum(fn[c, j], n_frames - 1)]
                                        ).any():
        fail("StreamingRx 384k: a routed payload is not the one sent at its FN")
    whole = np.arange(PLUTO_B) % NBLK == 0
    for ch in np.nonzero(whole)[0]:
        if sorted(fn[ch][gate[ch]].tolist()) != list(range(n_frames)):
            fail(f"StreamingRx 384k: unrotated channel {ch} routed FNs "
                 f"{sorted(fn[ch][gate[ch]].tolist())}")
    valid = state.lich_good_valid
    calls = {(callsign.decode_callsign(int(bytes_to_word_host(row[0:6]))).strip(),
              callsign.decode_callsign(int(bytes_to_word_host(row[6:12]))).strip())
             for row in state.lich_good[valid]}
    if calls != {("AB1CDE", "G4GUO")} or not valid[whole].all():
        fail(f"StreamingRx 384k: LSF callsigns {calls} on {int(valid.sum())} channels")
    print(f"phase 10 Pluto rate: {n_sess} sessions built by the port at 384 kHz, B={PLUTO_B} "
          f"staggered, {n} blocks of [B, {t_in}, 2] int16 ({wire[0].nbytes / 1e6:.0f} MB a "
          f"block) in 5-block chunks (2 whole and a 2+1 tail): {len(c)} routed payloads all "
          f"as sent, the {int(whole.sum())} unrotated channels route all {n_frames}, LSF "
          f"AB1CDE <- G4GUO on {int(valid.sum())} channels; decimator vs float64 max error "
          f"{dec_err:.3g} (peak {np.abs(ref).max():.3f}); decimator on one block "
          f"{dec_ms:.4f} ms (median of {DEC_REPS}), bound {dec_bound * 1e3:.2f} us ({dec_by}, "
          f"{dec_bytes / 1e6:.1f} MB), share {dec_bound / dec_ms:.3f}; {wall / n * 1e3:.1f} "
          f"ms/block wall on the first 384 kHz session, {wall2 / n * 1e3:.1f} on the second; "
          f"launches {got}; {card}", flush=True)


def split_resume(wire: list[np.ndarray], dev, paths: dict) -> None:
    """Phase 11: checkpoint after SPLIT_BLOCKS blocks, resume, compare
    with one unbroken run."""
    import tempfile

    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.app.streaming import StreamingRx
    from m17_sdr_tpu_torch.convert import state_to_numpy

    ref_out, ref_state, _, _ = stream_blocks(wire, dev, afc=True, equalize="auto")
    reset_launches(_build.KERNELS)
    with tempfile.TemporaryDirectory() as td:
        ck = str(Path(td) / "state.npz")
        first = StreamingRx(batch=B, afc=True, equalize="auto", device=dev)
        for blk in wire[:SPLIT_BLOCKS]:
            first.feed_block(blk)
        first.checkpoint(ck)
        out1, _, n1 = first.finish()
        second = StreamingRx(batch=B, afc=True, equalize="auto", device=dev)
        second.resume(ck)
        for blk in wire[SPLIT_BLOCKS:]:
            second.feed_block(blk)
        out2, state2, n2 = second.finish()
    got = read_launches("checkpoint resume", _build.KERNELS, paths)
    for name in ref_out._fields:
        joined = np.concatenate([getattr(out1, name), getattr(out2, name)], axis=1)
        if not np.array_equal(joined, getattr(ref_out, name)):
            fail(f"split-resume: {name} differs from the unbroken run")
    want = state_to_numpy(ref_state)
    for k, v in state_to_numpy(state2).items():
        if not np.array_equal(v, want[k]):
            fail(f"split-resume: final state {k} differs from the unbroken run")
    print(f"phase 11 checkpoint split-resume: B={B}, {n1} + {n2} blocks across a checkpoint "
          f"file, bit-identical to the unbroken run (every field and the final state); "
          f"launches {got}", flush=True)


def run_module(module: str, *args: str) -> tuple[str, str, dict]:
    """(stdout, stderr, the kernel launches) of one ``python -m module
    args`` run in a subprocess from the repository root; fails unless it
    exits 0."""
    r = subprocess.run([sys.executable, "-c", module_wrap(module), *args], capture_output=True,
                       text=True, timeout=CLI_TIMEOUT_S,
                       cwd=Path(__file__).resolve().parent)
    if r.returncode != 0:
        fail(f"{module} {' '.join(args[:1])} exited {r.returncode}: {r.stdout[-1000:]} "
             f"{r.stderr[-2000:]}")
    launches = [ln for ln in r.stderr.splitlines() if ln.startswith("launches ")]
    return r.stdout, r.stderr, json.loads(launches[-1][9:])


def run_cli(*args: str) -> tuple[dict, dict]:
    """(the last stdout JSON line, the kernel launches) of one CLI run."""
    out, _, launches = run_module(CLI_MODULE, *args)
    return json.loads(out.splitlines()[-1]), launches


def record_launches(path: str, launches: dict, paths: dict) -> None:
    """Launch counts another process reported, recorded under ``path``;
    fails if a kernel it names was not launched, except K4 (see
    ``read_launches``)."""
    from m17_sdr_tpu_torch import _build

    for sym, n in launches.items():
        if n == 0 and sym != _build.EQUALIZE.symbol:
            fail(f"{path} never launched {sym}")
    paths[path] = launches


def cli(dev, paths: dict, card: str) -> None:
    """Phase 12: tx -> rx round trip and bert through the CLI."""
    import tempfile

    rng = np.random.default_rng(12)
    with tempfile.TemporaryDirectory() as td:
        d = Path(td)
        sent, caps = [], []
        t0 = time.perf_counter()
        for i in range(2):
            pay = rng.integers(0, 256, (8, 16), dtype=np.uint8).tobytes()
            (d / f"p{i}.bin").write_bytes(pay)
            cap = str(d / f"c{i}.iq")
            stats, _ = run_cli("tx", "--out", cap, "--frames", "8", "--src", "G4GUO",
                               "--dest", "AB1CDE", "--payload", str(d / f"p{i}.bin"))
            if stats.get("frames") != 8:
                fail(f"CLI tx: {stats}")
            sent.append(pay)
            caps.append(cap)
        t_tx = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats, launches = run_cli("rx", "--in", caps[0], "--in", caps[1], "--payload-out",
                                  str(d / "rx.bin"), "--save-state", str(d / "st.npz"))
        t_rx = time.perf_counter() - t0
        record_launches("cli rx", launches, paths)
        for i, ch in enumerate(stats["channels"]):
            got = (d / f"rx.bin.ch{i}").read_bytes()
            if (got != sent[i] or ch["lsf"] != {"dst": "AB1CDE", "src": "G4GUO"}
                    or ch["golay_errors"] != 0 or ch["payload_frames"] != 8):
                fail(f"CLI rx channel {i}: {ch}, payloads {'equal' if got == sent[i] else 'differ'}")
        with np.load(d / "st.npz") as z:
            if "dec_tail" not in z.files:
                fail("CLI rx --save-state: no dec_tail in the checkpoint")
    t0 = time.perf_counter()
    bert, launches = run_cli("bert", "--channels", str(B), "--frames", "25", "--snr", "25")
    t_bert = time.perf_counter() - t0
    record_launches("cli bert", launches, paths)
    if bert["ber"] != 0.0 or bert["bits"] == 0:
        fail(f"CLI bert: {bert}")
    t0 = time.perf_counter()
    pod, launches = run_cli("sweep", "--pod", *POD_CLI)
    t_pod = time.perf_counter() - t0
    record_launches("cli sweep --pod", launches, paths)
    pts = pod.get("points", [])
    sums = [sum(p[k] for p in pts) for k in ("bit_errors", "bits", "frames_recovered")]
    if (set(pod) != {"mesh_devices", "channels", "totals_psum", "points"} or len(pts) != 4
            or pod["mesh_devices"] != 1 or pod["channels"] != 256
            or [pod["totals_psum"][i] for i in (0, 1, 3)] != sums
            or pts[-1]["bit_errors"] or not pts[-1]["bits"]):
        fail(f"CLI sweep --pod: {pod}")
    print(f"phase 12 CLI on the card: tx of 2 captures ({t_tx:.1f} s for both processes), "
          f"rx of both as one batch: payloads as sent, AB1CDE <- G4GUO, 0 Golay errors "
          f"({t_rx:.1f} s, launches {paths['cli rx']}); bert --channels {B} --frames 25 "
          f"--snr 25: {bert['bits']} bits, {bert['errors']} errors, ber {bert['ber']} "
          f"({t_bert:.1f} s, launches {paths['cli bert']}); sweep --pod {' '.join(POD_CLI)} "
          f"in a one-rank nccl world: totals {pod['totals_psum']} equal to the points' "
          f"sums, frames recovered " + "/".join(str(p["frames_recovered"]) for p in pts)
          + f" of {pts[0]['frames_sent']} a point, no bit error at {pts[-1]['snr_db']} dB "
          f"({t_pod:.1f} s, launches {paths['cli sweep --pod']}); wall times include each "
          f"process's start; {card}", flush=True)


def live_udp(dev, paths: dict, card: str) -> None:
    """Phase 13: Session.rx_live fed by a tx --udp-out sender process."""
    import tempfile

    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.app.session import Session

    rng = np.random.default_rng(13)
    sent = rng.integers(0, 256, (LIVE_FRAMES, 16), dtype=np.uint8).tobytes()
    nblk = LIVE_FRAMES + 5
    with tempfile.TemporaryDirectory() as td:
        d = Path(td)
        (d / "p.bin").write_bytes(sent)
        senders = []

        def start_sender(port: int) -> None:
            # rx_live listens on a free port the kernel picks and names it here
            senders.append(subprocess.Popen(
                [sys.executable, "-m", CLI_MODULE, "tx", "--out",
                 str(d / "live.iq"), "--payload", str(d / "p.bin"), "--src", "G4GUO",
                 "--dest", "AB1CDE", "--udp-out", f"127.0.0.1:{port}", "--pace"],
                cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))

        try:
            events = []
            sess = Session(device=str(dev))
            reset_launches(_build.KERNELS)
            stats = sess.rx_live(0, payload_out=str(d / "rx.bin"),
                                 chunk_blocks=LIVE_CHUNK, idle_timeout_s=60.0,
                                 max_blocks=nblk, on_listen=start_sender,
                                 on_chunk=lambda s: events.append(
                                     (s["turnaround_s"], senders[0].poll() is None)))
            got = read_launches("live udp", _build.KERNELS, paths)
            sender = senders[0]
            out, err = sender.communicate(timeout=60)
        finally:
            for p in senders:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if sender.returncode != 0:
            fail(f"tx --udp-out sender exited {sender.returncode}: {err[-2000:]}")
        received = (d / "rx.bin").read_bytes()
    if (stats["payload_frames"] != LIVE_FRAMES or received != sent
            or stats["lsf"] != {"dst": "AB1CDE", "src": "G4GUO"} or stats["golay_errors"]):
        fail(f"rx_live: {stats}, payloads {'as sent' if received == sent else 'differ'}")
    mid = sum(alive for _, alive in events)
    if not mid:
        fail("rx_live decoded no chunk while the sender was sending")
    turn = [t for t, _ in events]
    print(f"phase 13 live UDP: rx_live on the card fed by a tx --udp-out --pace process: "
          f"{stats['blocks']} blocks in {stats['chunks']} chunks of {LIVE_CHUNK}, all "
          f"{LIVE_FRAMES} payloads routed as sent, {mid} chunks decoded while the sender "
          f"was sending; chunk turnaround (upload, decode, host read) median "
          f"{statistics.median(turn) * 1e3:.1f} ms, max {max(turn) * 1e3:.1f} ms, for "
          f"{LIVE_CHUNK * 40} ms of signal a chunk at B=1; launches {got}; {card}", flush=True)


def mesh(blocks, main_per_block: float, dev, paths: dict, card: str) -> None:
    """Phase 14: the mesh layer in this process's one-rank nccl world."""
    import torch.distributed as dist

    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.mesh import halo, sharding
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream

    group = sharding.make_mesh().get_group("ch")
    # NCCL sets its communicator up at the group's first collective: not timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(torch.zeros(1, device=dev), group=group)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    out_r, st_r = rx_stream(blocks, RxSessionState.init(B, dev), afc_enabled=True)
    reset_launches(_build.KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_s, st_s, metrics = sharding.sharded_rx_stream(group, afc_enabled=True)(
        sharding.shard_channels(blocks, group),
        sharding.shard_channels(RxSessionState.init(B, dev), group))
    got_ch = read_launches("mesh channels", _build.KERNELS, paths)
    t_ch = (time.perf_counter() - t0) / NBLK
    compare_outputs("sharded_rx_stream vs rx_stream", out_s, st_s, out_r, st_r)
    local = torch.stack([st_r.n_frames.sum().float(), st_r.golay_errors.sum().float(),
                         out_r.locked[:, -1].float().sum()])
    if not torch.equal(metrics, local):
        fail(f"sharded_rx_stream metrics {metrics.tolist()} vs local sums {local.tolist()}")

    zeros = torch.zeros_like(blocks[:, :WARMUP])
    out_w, _ = rx_stream(torch.cat([zeros, blocks], dim=1), RxSessionState.init(B, dev),
                         afc_enabled=True)
    out_w = type(out_w)(*(x[:, WARMUP:] for x in out_w))
    run = halo.time_parallel_rx(sharding.make_mesh(axis="time").get_group("time"),
                                warmup_blocks=WARMUP, block=T, afc_enabled=True)
    reset_launches(_build.KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_t = run(blocks)
    got_t = read_launches("mesh time slabs", _build.KERNELS, paths)
    t_time = (time.perf_counter() - t0) / (NBLK + WARMUP)
    for name in out_w._fields:
        a, b = getattr(out_t, name), getattr(out_w, name)
        if not same(a, b):
            fail("time_parallel_rx vs rx_stream: " + first_diff(name, a, b, True))

    rng = np.random.default_rng(14)
    x = rng.normal(size=FIR_SHAPE).astype(np.float32)
    taps = rng.normal(size=31).astype(np.float32)
    y = halo.overlap_save_conv(group, taps)(torch.as_tensor(x).to(dev)).cpu().numpy()
    xp = np.pad(x, [(0, 0), (30, 0)]).astype(np.float64)
    want = sum(xp[:, j:j + x.shape[1]] * float(taps[j]) for j in range(31))
    fir_err = float(np.abs(y - want).max())
    if fir_err > FIR_TOL * max(1.0, float(np.abs(want).max())):
        fail(f"overlap_save_conv vs float64: max error {fir_err:.3g}")
    print(f"phase 14 mesh, one-rank nccl world (NCCL set-up at the first collective "
          f"{t_setup * 1e3:.0f} ms): sharded_rx_stream over the staggered mix at "
          f"B={B} equals rx_stream field by field, metrics {metrics.tolist()} equal to the "
          f"local sums, {t_ch * 1e3:.1f} ms/block (launches {got_ch}); time_parallel_rx with "
          f"{WARMUP} warm-up blocks equals rx_stream over {WARMUP} zero blocks and the mix, "
          f"{t_time * 1e3:.1f} ms a block run (launches {got_t}); overlap_save_conv "
          f"{FIR_SHAPE} within {fir_err:.3g} of float64; phase 4 main path "
          f"{main_per_block * 1e3:.1f} ms/block; {card}", flush=True)


def pod_sweep(dev, paths: dict, card: str) -> None:
    """Phase 15: the sharded BER sweep of the record in the one-rank world."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.mesh import sharding
    from m17_sdr_tpu_torch.pipeline.ber_sweep import (
        bert_sweep_counts, pod_bert_sweep, recovery_tolerance)

    rec = json.loads((Path(__file__).resolve().parent / "SWEEP_POD_r5.json").read_text())
    curve, cpp, nf = rec["curve"], rec["channels_per_point"], rec["frames_per_channel"]
    snr = torch.as_tensor(np.repeat(np.float32([p["snr_db"] for p in curve]), cpp)).to(dev)
    group = sharding.make_mesh().get_group("ch")
    reset_launches(_build.KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    *counts, totals = pod_bert_sweep(group, snr, nf, seed=SWEEP_SEED)
    got = read_launches("pod sweep", _build.KERNELS, paths)
    wall = time.perf_counter() - t0
    want = bert_sweep_counts(snr, nf, seed=SWEEP_SEED)
    for name, a, b in zip(("errors", "bits", "unsynced", "frames"), counts, want):
        if not torch.equal(a, b):
            fail("pod sweep vs unsharded: " + first_diff(name, a, b, False))
    if totals.tolist() != [int(x.sum()) for x in counts]:
        fail(f"pod sweep totals {totals.tolist()} are not the sums")
    err, bits, _, frames = (x.reshape(-1, cpp).sum(-1).cpu() for x in counts)
    rows = []
    for i, p in enumerate(curve):
        rate = int(frames[i]) / (nf * cpp)
        tol = recovery_tolerance(p["frame_recovery"], cpp)
        rows.append(f"{p['snr_db']:.1f} {rate:.4f}")
        if abs(rate - p["frame_recovery"]) > tol:
            fail(f"pod sweep at {p['snr_db']:.1f} dB: frame recovery {rate:.4f} vs the "
                 f"recorded {p['frame_recovery']:.4f} (tolerance {tol:.4f})")
        if any(abs(p["snr_db"] - c) < 0.05 for c in SWEEP_CLEAN_DB) and int(err[i]):
            fail(f"pod sweep at {p['snr_db']:.1f} dB: {int(err[i])} bit errors")
    print(f"phase 15 pod sweep, one-rank nccl world: {len(curve)} points x {cpp} channels x "
          f"{nf} frames, noise keyed per channel (seed {SWEEP_SEED}): equal bit for bit to the "
          f"unsharded sweep, totals {totals.tolist()} equal to the sums, every point within "
          f"tolerance of the record (dB, recovery: {'; '.join(rows)}), no bit error at "
          f"{' and '.join(map(str, SWEEP_CLEAN_DB))} dB; {wall:.2f} s wall (keyed noise, TX, "
          f"rx_stream, the count and the all_reduce); launches {got}; {card}", flush=True)


def device_launches(fn) -> tuple[int, object]:
    """(device kernels launched by fn(), its result), by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA), res


def wall_ms(fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, res


def dormant_dsp(blocks, dev, card: str) -> None:
    """Phase 16: pll_disc and equalize_train on the card against the CPU."""
    from m17_sdr_tpu_torch.dsp import equalize, pll

    x = blocks[:, K2_BLOCK].float()                  # int16 scale, as the reference's
    st = pll.PllState.init(B, dev)
    pll_fn = lambda: pll.pll_disc(x, st)             # noqa: E731
    pll_fn()
    pll_ms, (out, dc, st_out) = wall_ms(pll_fn)
    pll_n, _ = device_launches(pll_fn)
    ref = pll.pll_disc(x.cpu(), pll.PllState.init(B, "cpu"))
    peak = float(ref[0].abs().max())
    pll_err = max(float((a.cpu() - b).abs().max()) for a, b in zip((out, dc), ref[:2]))
    z_err = float((st_out.z.cpu() - ref[2].z).abs().max())
    if pll_err > PLL_REL * peak or z_err > PLL_REL:
        fail(f"pll_disc card vs CPU: max error {pll_err:.3g} (peak {peak:.3g}), z {z_err:.3g}")

    rng = np.random.default_rng(16)
    syms = rng.choice(np.float32([-1.0, -0.333, 0.333, 1.0]), size=(B, EQ_SYMBOLS))
    rx = equalize.isi_channel(torch.as_tensor(np.repeat(syms, 2, axis=-1)), (1.0, 0.0, 0.35))
    rx = rx + torch.as_tensor(0.05 * rng.normal(size=rx.shape).astype(np.float32))
    known = torch.as_tensor(syms)
    eq_fn = lambda: equalize.equalize_train(rx.to(dev), equalize.EqState.init(B, dev),  # noqa
                                            known.to(dev))
    eq_fn()
    eq_ms, (y, est) = wall_ms(eq_fn)
    eq_n, _ = device_launches(eq_fn)
    y_ref, est_ref = equalize.equalize_train(rx, equalize.EqState.init(B, "cpu"), known)
    eq_err = max(float((y.cpu() - y_ref).abs().max()), float((est.c.cpu() - est_ref.c).abs().max()))
    if eq_err > EQ_TOL:
        fail(f"equalize_train card vs CPU: max error {eq_err:.3g}")
    mse = float(((y_ref[:, -64:] - known[:, -64:]) ** 2).mean())
    print(f"phase 16 dormant DSP: pll_disc on one block at B={B} ({T} steps) within "
          f"{pll_err:.3g} of the CPU (peak {peak:.3g}), z within {z_err:.3g}: {pll_ms:.1f} ms, "
          f"{pll_n} device launches; equalize_train at B={B} over {EQ_SYMBOLS} symbols of an "
          f"ISI channel within {eq_err:.3g} of the CPU (last-64 MSE {mse:.4f}): {eq_ms:.1f} ms, "
          f"{eq_n} device launches; {card}", flush=True)


def parity_soft(dev, paths: dict, card: str) -> None:
    """Phase 17: BER_PARITY_r4.json regenerated and decoded on the card."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.pipeline import ber_parity as bp

    record = Path(__file__).resolve().parent / PARITY_SOFT
    reset_launches(_build.KERNELS)
    results, walls = {}, {}
    for kind in PARITY_KINDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[kind] = bp.replay_record(record, (kind,), device=dev)
        walls[kind] = time.perf_counter() - t0
    # soft input: no front end, so no K3
    got = read_launches("BER parity soft", (_build.VITERBI, _build.RECEIVER_SCAN), paths)
    for kind, pts in results.items():
        for p in pts:
            if not p.equals_recorded_jax():
                fail(f"parity replay {kind} {p.snr_db} dB: port {p.port} {p.port_extra} vs "
                     f"the recorded jax {p.recorded['jax']} {p.recorded.get('extra', {})}")
            if not p.checks_ok():
                fail(f"parity replay {kind} {p.snr_db} dB: {p.checks} against the recorded "
                     f"ref {p.recorded['ref']}, port {p.port}")
        rows = "; ".join(f"{p.snr_db:g} dB {p.port[0]}/{p.port[1]} {p.port[2]}/{p.port[3]}"
                         for p in pts)
        print(f"phase 17 parity {kind}: {len(pts)} points x {pts[0].port[1]} frames, one "
              f"rx_stream_soft call: every point equal to the recorded jax entry"
              f"{' and its typed extras' if kind != 'stream' else ''} and passing "
              f"{', '.join(pts[0].checks)} against the recorded ref; {walls[kind]:.2f} s wall "
              f"(waveforms, decode, scoring); frames and bit errors: {rows}; {card}", flush=True)
    print(f"phase 17 parity soft: launches {got}", flush=True)

    # the stream point at PARITY_PLAIN_DB on the kernels, scored; its first
    # PARITY_PLAIN_BLOCKS blocks on the kernels and on the plain versions
    rec = json.loads(record.read_text())
    i, row = next((i, r) for i, r in enumerate(rec["stream"]["points"])
                  if r["snr_db"] == PARITY_PLAIN_DB)
    wave, payloads, _, nf = bp.record_point(rec, "stream", i, dev)
    dec = bp.run_chain(wave, nf=nf, device=dev)
    tup = bp.score(dec.stream, payloads, bp.MIN_FN)
    if tup != bp._tuple(row["jax"]):
        fail(f"parity {PARITY_PLAIN_DB:g} dB stream: {tup} vs the recorded {row['jax']}")
    head = wave[:, :PARITY_PLAIN_BLOCKS * bp.CHUNK_2X]
    legs = {}
    for leg, use_kernel in (("kernel", None), ("plain", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        legs[leg] = (bp.run_chain(head, nf=nf, device=dev, use_kernel=use_kernel),
                     time.perf_counter() - t0)
    (dec_k, t_k), (dec_r, t_r) = legs["kernel"], legs["plain"]
    if not bp.same_decodes(dec_k, dec_r):
        fail(f"parity {PARITY_PLAIN_DB:g} dB stream: kernel and plain decodes of the first "
             f"{PARITY_PLAIN_BLOCKS} blocks differ")
    print(f"phase 17 parity stream {PARITY_PLAIN_DB:g} dB, {wave.shape[0]} channels x "
          f"{wave.shape[1] // bp.CHUNK_2X} blocks on the kernels: {len(dec.stream)} payloads "
          f"routed, score {tup}; its first {PARITY_PLAIN_BLOCKS} blocks decode equal on the "
          f"kernels and the plain versions ({len(dec_k.stream)} payloads routed); {t_k:.2f} s "
          f"vs {t_r:.2f} s wall", flush=True)


def parity_iq(dev, paths: dict, card: str) -> None:
    """Phase 18: BER_PARITY_IQ_r5.json regenerated on the card (own draws)."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.pipeline import ber_parity_iq as biq

    record = Path(__file__).resolve().parent / PARITY_IQ
    reset_launches(_build.KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts = biq.replay_record_iq(record, device=dev)
    wall = time.perf_counter() - t0
    got = read_launches("BER parity IQ", _build.KERNELS, paths)
    for p in pts:
        if not p.checks_ok():
            fail(f"IQ parity replay {p.kind} {p.snr_db} dB: {p.checks}; port {p.port} vs the "
                 f"recorded ref {p.recorded['ref']}")
    for cfg in dict.fromkeys(p.kind for p in pts):
        rows = "; ".join(f"{p.snr_db:g} dB port {p.port[0]}/{p.port[1]} {p.port[2]} err, "
                         f"recorded jax {p.recorded_jax()[0]} {p.recorded_jax()[2]} err, "
                         f"ref {p.recorded['ref']['frames']} {p.recorded['ref']['bit_errors']} err"
                         for p in pts if p.kind == cfg)
        print(f"phase 18 IQ parity {cfg}: every point passes frame_agreement_ok and "
              f"ber_agreement_ok against the recorded ref (the port's noise is drawn on the "
              f"card, so its draws differ from the record's): {rows}", flush=True)
    print(f"phase 18 IQ parity: {len(pts)} points in one rx_stream call; {wall:.2f} s wall "
          f"(TX, noise, decode, scoring); launches {got}; {card}", flush=True)

    # each config's PARITY_IQ_DB point: the card's decode of the replayed wire
    # against the CPU's decode of the same wire, and the frames recovered over
    # PARITY_IQ_SEEDS further draws (seeds after the record's)
    from m17_sdr_tpu_torch.pipeline import ber_parity as bp

    rec = json.loads(record.read_text())
    nch, nf, min_fn = rec["channels"], rec["frames"], rec["min_fn_scored"]
    for name, cfg in rec["configs"].items():
        i = next(i for i, r in enumerate(cfg["points"]) if r["snr_db"] == PARITY_IQ_DB)
        wire, payloads = biq.record_point_iq(rec, name, i, dev)
        on_card, on_cpu = (biq.run_chain_iq(wire, device=d) for d in (dev, "cpu"))
        if on_card != on_cpu:
            differ = set(on_card.stream.items()) ^ set(on_cpu.stream.items())
            fail(f"IQ parity {name} {PARITY_IQ_DB:g} dB: the card's decode differs from the "
                 f"CPU's on the same wire ({len(differ)} deliveries)")
        seeds = [bp.SEED_BASE + bp.SEED_STEP * i + s for s in range(1, PARITY_IQ_SEEDS + 1)]
        off = biq.config_offset_hz(name)
        made = [biq.make_iq_wire(nch, nf, PARITY_IQ_DB, seed=s, freq_offset_hz=off, device=dev)
                for s in seeds]
        dec = biq.run_chain_iq(np.concatenate([w for w, _ in made]), device=dev)
        frames = [bp.score(bp._channels(dec, k * nch, nch).stream, p, min_fn)[0]
                  for k, (_, p) in enumerate(made)]
        row = cfg["points"][i]
        print(f"phase 18 IQ parity {name} {PARITY_IQ_DB:g} dB: the card's decode of the replayed "
              f"wire equals the CPU's ({len(on_card.stream)} payloads routed, "
              f"{bp.score(on_card.stream, payloads, min_fn)[0]}/{nch * (nf - min_fn)} scored); "
              f"frames over {PARITY_IQ_SEEDS} further draws (seeds {seeds[0]}-{seeds[-1]}): "
              f"{frames}, mean {statistics.mean(frames):.2f}; recorded ref {row['ref']['frames']}, "
              f"jax {row['jax']['frames']}", flush=True)


def match_cpu(what: str, out_card, out_cpu) -> tuple[float, float, str]:
    """Every output field of the card's decode against the CPU's decode of
    the same input; see ``match_fields``."""
    return match_fields(what, ((name, getattr(out_card, name), getattr(out_cpu, name))
                               for name in out_cpu._fields))


def match_fields(what: str, pairs) -> tuple[float, float, str]:
    """(name, card tensor, CPU tensor) pairs: integer, bool and byte tensors
    exactly, floats within QG_RTOL/QG_ATOL (NaN equal to NaN).  Returns the
    float difference that takes the largest share of its bound: (share,
    difference, name)."""
    worst = (0.0, 0.0, "")
    for name, a, b in pairs:
        a = a.cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{what}: {name} is {a.dtype} {list(a.shape)} on the card, "
                 f"{b.dtype} {list(b.shape)} on the CPU")
        if a.dtype.is_floating_point:
            neq = ~torch.isclose(a, b, rtol=QG_RTOL, atol=QG_ATOL, equal_nan=True)
            d = (a - b).abs().flatten()
            share = torch.nan_to_num(d / (QG_ATOL + QG_RTOL * b.abs().flatten()), nan=0.0)
            if share.numel() and share.max().item() > worst[0]:
                i = share.argmax()
                worst = (share[i].item(), d[i].item(), name)
        else:
            neq = a != b
        if neq.any():
            idx = neq.nonzero()[0].tolist()
            fail(f"{what}: {name} differs between the card and the CPU at channel {idx[0]}"
                 f"{f', index {idx[1:]}' if len(idx) > 1 else ''}: "
                 f"{a[tuple(idx)].item()} vs {b[tuple(idx)].item()}")
    return worst


def quality_gate(dev, paths: dict, card: str) -> None:
    """Phase 19: the stream quality gate's seven regimes, at the record's
    size against QUALITY_GATE_r5.json, then at scale."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.tools import quality_gate as qg

    rec = json.loads((Path(__file__).resolve().parent / QUALITY_GATE).read_text())
    nch, nf = rec["channels"], rec["frames_per_session"]

    # (a) the record's size on the card; offset+drift and Pluto on the card's draws
    reset_launches(_build.KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    made, decoded = qg.decode_regimes(nch, nf, 0, dev)
    doc = qg.document(made, decoded, nch, nf)
    wall = time.perf_counter() - t0
    got = read_launches("quality gate record", _build.KERNELS, paths)
    for name in qg.REGIMES:
        r, want = doc["regimes"][name], rec["regimes"][name]
        if name in qg.IQ_REGIMES:
            if not qg.gate_ok({name: r}):
                fail(f"quality gate {name} on the card's draws misses a bound: {json.dumps(r)}")
            continue
        for key, value in want.items():
            if key in ("clean_quality_floor", "garbage_quality_ceiling", "eye_est_med") \
                    and value is not None and r[key] is not None:
                ok = abs(r[key] - value) <= QG_FLOAT_ABS
            else:
                ok = r[key] == value
            if not ok:
                fail(f"quality gate {name}: {key} {r[key]} vs the record's {value}")
    out_card = decoded[qg.IQ_REGIMES][0]
    out_cpu, _ = qg.decode_group(qg.IQ_REGIMES, (made[name][0].cpu() for name in qg.IQ_REGIMES),
                                 "cpu")
    diffs = {}
    for k, name in enumerate(qg.IQ_REGIMES):
        diffs[name] = match_cpu(f"quality gate record {name}",
                                qg.channels(out_card, k * nch, nch),
                                qg.channels(out_cpu, k * nch, nch))
    for name, r in doc["regimes"].items():
        print(f"phase 19 quality gate record {qg.summary_line(name, r)}", flush=True)
    print(f"phase 19 quality gate record ({nch} x {nf}, seed 0): the five numpy-noise regimes "
          f"equal {QUALITY_GATE} (integers exactly, quality extremes and eye_est_med within "
          f"{QG_FLOAT_ABS:g}); offset+drift and Pluto on the card's draws within both bounds, "
          f"and the card's decode of their wires equal to the CPU's (the float difference "
          f"nearest its bound, rtol {QG_RTOL:g} atol {QG_ATOL:g}: "
          + "; ".join(f"{n} {d:.3g} in {f}, {s:.3g} of the bound"
                      for n, (s, d, f) in diffs.items())
          + f"); ok {doc['ok']}; {wall:.2f} s wall; "
          f"launches {got}; {card}", flush=True)

    # (b) at scale: every regime on the card, its first QG_SLICE channels on the CPU
    reset_launches(_build.KERNELS)
    regimes, slices = {}, {}
    for name in qg.REGIMES:
        b = QG_PLUTO_B if name == qg.PLUTO else QG_B
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name != qg.ISI_EQ:                # both ISI regimes decode one wave
            x, payloads = qg.regime_input(name, b, nf, 0, dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        before = {k.symbol: k.launches for k in _build.KERNELS}
        t_dec, (out, st) = wall_ms(lambda: qg.decode(name, x, dev))  # noqa: B023
        n = {k.symbol: k.launches - before[k.symbol] for k in _build.KERNELS}
        t0 = time.perf_counter()
        r = regimes[name] = qg.regime_tally(name, out, st, payloads, nf)
        t_score = time.perf_counter() - t0
        slices[name] = (x[:QG_SLICE].cpu() if torch.is_tensor(x) else x[:QG_SLICE].copy(),
                        type(out)(*(f.cpu() for f in qg.channels(out, 0, QG_SLICE))))
        print(f"phase 19 quality gate {name} at B={b} x {nf} frames: gate_ok "
              f"{qg.gate_ok({name: r})}; build {t_build:.2f} s, decode {t_dec / 1e3:.2f} s, "
              f"scoring {t_score:.2f} s wall; launches {n}; {card}; tally {json.dumps(r)}",
              flush=True)
        del out, st
        torch.cuda.empty_cache()
    got = read_launches("quality gate 4096", _build.KERNELS, paths)
    t0 = time.perf_counter()
    for group in qg.GROUPS:
        out_cpu, _ = qg.decode_group(group, (slices[name][0] for name in group), "cpu")
        for k, name in enumerate(group):
            s, d, field = match_cpu(f"quality gate {name} channels 0-{QG_SLICE - 1}",
                                    slices[name][1],
                                    qg.channels(out_cpu, k * QG_SLICE, QG_SLICE))
            print(f"phase 19 quality gate {name} channels 0-{QG_SLICE - 1}: card = CPU; the "
                  f"float difference nearest its bound {d:.3g} in {field or '-'}, {s:.3g} of "
                  f"the bound", flush=True)
    t_cpu = time.perf_counter() - t0
    print(f"phase 19 quality gate at scale (B={QG_B}, Pluto B={QG_PLUTO_B}, {nf} frames): "
          f"gate_ok {qg.gate_ok(regimes)} (printed, not asserted); each regime's first "
          f"{QG_SLICE} channels decode on the CPU as on the card, field by field, floats within "
          f"rtol {QG_RTOL:g} atol {QG_ATOL:g} ({t_cpu:.1f} s of CPU decodes); launches {got}",
          flush=True)


def profile_stages(dev, paths: dict, card: str, busy_ms: float | None) -> dict:
    """Phase 20: the stage profiler at B=4096, then the whole-session call
    on the card against the CPU.  Returns the ``rx_kernel`` stage's entry."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_block
    from m17_sdr_tpu_torch.tools import profile_stages as ps

    t_phase = t0 = time.perf_counter()
    inp = ps.bench_inputs(B, dev)
    reset_launches(_build.KERNELS)
    torch.cuda.synchronize()
    doc = ps.profile(B, dev, PROFILE_ITERS, PROFILE_REPS, inputs=inp)
    got = read_launches("profile stages", _build.KERNELS, paths)
    wall = time.perf_counter() - t0
    print(f"phase 20 profile stages document: {json.dumps(doc)}", flush=True)
    busy = f"{busy_ms:.3f}" if busy_ms is not None else "not measured"
    print(f"phase 20 profile stages at B={B} ({PROFILE_ITERS} passes x {doc['nblk']} blocks a "
          f"rep, {PROFILE_REPS} interleaved reps, host clock to synchronize(), min/med ms "
          "a block): " + ", ".join(f"{n} {v['ms_per_block_min']}/{v['ms_per_block_med']}"
                                   for n, v in doc["stages"].items())
          + f"; derived {json.dumps(doc['derived'])}; beside phase 4's device busy {busy} "
          f"ms/block under the profiler (AFC on, equalizer auto); launches {got}; "
          f"{wall:.1f} s wall; {card}; clocks.sm, power.draw, power.limit: "
          f"{smi('clocks.sm,power.draw,power.limit')}", flush=True)

    # device time of the two rx stages' calls, then the long-block path: one
    # call on the whole session, S2 = 4992, its first channels against the CPU
    _, st = ps.rx(inp.blocks[:1], RxSessionState.init(B, dev), 1)
    busy_rx, _ = profile_window(
        "phase 20 profile rx_kernel (AFC off, equalizer off)",
        lambda: ps.rx(inp.blocks[1:1 + PROFILE_BLOCKS], st, 1), PROFILE_BLOCKS)
    busy_session, (out, state) = profile_window(
        "phase 20 profile rx_session (one call on the session)",
        lambda: ps.rx_session(inp.session, RxSessionState.init(B, dev), 1), doc["nblk"])
    for name, busy_stage in (("rx_kernel", busy_rx), ("rx_session", busy_session)):
        if busy_stage is not None:
            stage_ms = doc["stages"][name]["ms_per_block_min"]
            print(f"phase 20 {name}: device busy {busy_stage:.3f} ms/block under the profiler "
                  f"against its stage time {stage_ms} ms/block: idle share "
                  f"{1 - busy_stage / stage_ms:.3f}", flush=True)
    t0 = time.perf_counter()
    out_cpu, st_cpu = rx_block(inp.session[:QG_SLICE].cpu(), RxSessionState.init(QG_SLICE, "cpu"))
    t_cpu = time.perf_counter() - t0
    worst = max(
        match_fields(f"rx_session channels 0-{QG_SLICE - 1}",
                     ((n, getattr(out, n)[:QG_SLICE], getattr(out_cpu, n))
                      for n in out_cpu._fields)),
        match_fields(f"rx_session channels 0-{QG_SLICE - 1} final state",
                     ((n, a[:QG_SLICE], b) for (n, a), (_, b)
                      in zip(flatten_state(state), flatten_state(st_cpu)))))
    s, d, field = worst
    print(f"phase 20 rx_session: one rx_block call on the {inp.session.shape[-1]}-sample session "
          f"at B={B} ({int(out.stream_valid.sum())} stream "
          f"frames); channels 0-{QG_SLICE - 1}, every output field and the final state, equal "
          f"to the CPU's plain call ({t_cpu:.1f} s); the float difference nearest its bound "
          f"{d:.3g} in {field or '-'}, {s:.3g} of the bound (rtol {QG_RTOL:g} atol "
          f"{QG_ATOL:g}); phase 20 {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return doc["stages"]["rx_kernel"]


def streaming_bench(dev, paths: dict, card: str) -> None:
    """Phase 21: the streaming bench's legs on its noise blocks."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.tools import streaming_bench as sb

    t_phase = time.perf_counter()
    reset_launches(_build.KERNELS)
    rt = {}
    for (b, rate), legs in itertools.groupby(STREAM_LEGS, key=lambda leg: leg[1:3]):
        legs = list(legs)
        t0 = time.perf_counter()
        noise = sb.noise_blocks(b, rate)
        print(f"phase 21 streaming bench noise B={b} {rate // 1000} kHz: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for mode, _, _, runs in legs:
            t0 = time.perf_counter()
            latency = mode == "chunk_latency"
            results, _ = sb.run(b, STREAM_BENCH_BLOCKS, rate,
                                chunk_blocks=LATENCY_CHUNK if latency else None,
                                chunk_latency=latency, runs=runs, device=dev, blocks=noise)
            for r in results:
                print(f"phase 21 streaming bench {mode} B={b} {rate // 1000} kHz: "
                      f"{json.dumps(r)}", flush=True)
            if not latency:
                rt[(b, rate)] = max(r["realtime_channels"] for r in results)
            print(f"phase 21 streaming bench {mode} B={b} {rate // 1000} kHz: "
                  f"{time.perf_counter() - t0:.1f} s wall with its warm session; {card}; "
                  f"clocks.sm, power.draw, power.limit: "
                  f"{smi('clocks.sm,power.draw,power.limit')}", flush=True)
        check_stream(b, rate, LATENCY_CHUNK if legs[0][0] == "chunk_latency" else None,
                     noise, dev)
        del noise
    got = read_launches("streaming bench", _build.KERNELS, paths)
    print(f"phase 21 streaming bench: {len(STREAM_LEGS)} legs, {STREAM_BENCH_BLOCKS} blocks "
          f"each; best real-time channels "
          + ", ".join(f"B={b} {rate // 1000} kHz {n}" for (b, rate), n in rt.items())
          + f"; launches {got}; {time.perf_counter() - t_phase:.1f} s wall", flush=True)


def bench(dev, paths: dict, card: str) -> None:
    """Phase 22: the port's bench at B=4096 in full; its headline call's
    first channels against the CPU, its Viterbi bits against the plain
    decoder."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch import bench as pb
    from m17_sdr_tpu_torch.fec.viterbi import viterbi_decode_cuda, viterbi_decode_ref
    from m17_sdr_tpu_torch.pipeline.benchdata import make_bench_blocks
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_block

    t_phase = time.perf_counter()
    reset_launches(_build.KERNELS)
    torch.cuda.synchronize()
    res = pb.run(B, dev)
    got = read_launches("bench", _build.KERNELS, paths)
    wall = time.perf_counter() - t_phase
    doc, head = res.doc, res.headline
    print(f"phase 22 bench document: {json.dumps(doc)}", flush=True)
    if doc["receiver"] != "kernel":
        fail(f"bench: the receiver leg is {doc['receiver']}, not the kernel")
    refused = pb.roof_error(head.rates)
    if refused:
        fail(f"bench: {refused}")
    gbps = [r * pb.INPUT_BYTES_PER_SAMPLE / 1e9 for r in head.rates]
    ab = doc["ab_t1920"]["kernel"]
    print(f"phase 22 bench at B={B}: headline {doc['value']} channel-samples/s "
          f"(vs_baseline {doc['vs_baseline']}; reps {doc['config']['rep_rates']}, calls "
          f"{head.calls}, implied input read {min(gbps):.1f}-{max(gbps):.1f} GB/s, every rep "
          f"under the roof {pb.HBM_ROOF_GBPS:.1f}); ab_t1920 kernel min {ab['min']} med "
          f"{ab['med']}; Viterbi {doc['viterbi_frames_per_s']} frames/s (vs_baseline "
          f"{doc['viterbi_vs_baseline']}); launches {got}; {wall:.1f} s wall; {card}; clocks.sm, "
          f"power.draw, power.limit: {smi('clocks.sm,power.draw,power.limit')}", flush=True)

    blocks, _ = make_bench_blocks(B, T, device=dev)
    session = torch.cat([b[:QG_SLICE] for b in blocks], dim=-1).cpu()
    t0 = time.perf_counter()
    out_cpu, st_cpu = rx_block(session, RxSessionState.init(QG_SLICE, "cpu"))
    t_cpu = time.perf_counter() - t0
    s, d, field = max(
        match_fields(f"bench headline call channels 0-{QG_SLICE - 1}",
                     ((n, getattr(head.out, n)[:QG_SLICE], getattr(out_cpu, n))
                      for n in out_cpu._fields)),
        match_fields(f"bench headline call channels 0-{QG_SLICE - 1} final state",
                     ((n, a[:QG_SLICE], b) for (n, a), (_, b)
                      in zip(flatten_state(head.state), flatten_state(st_cpu)))))
    n_vit = BENCH_VIT_CHECK
    bits_r, met_r = viterbi_decode_ref(res.vit_soft[:n_vit])
    if not torch.equal(res.vit_bits[:n_vit], bits_r):
        fail(first_diff("bench Viterbi bits", res.vit_bits[:n_vit], bits_r, False))
    if not torch.equal(res.vit_metric[:n_vit], met_r):
        fail(first_diff("bench Viterbi metric", res.vit_metric[:n_vit], met_r, False))
    # K1 alone at the Viterbi leg's shape, beside the leg's time a call
    x = res.vit_soft
    k1_ms = cuda_ms(lambda: viterbi_decode_cuda(x), 20)
    plain_ms = cuda_ms(lambda: viterbi_decode_ref(x), 3)
    nbytes = x.nbytes + res.vit_bits.nbytes + res.vit_metric.nbytes
    b_ms, by = bound(nbytes, K1_OPS_PER_STEP * x.shape[0] * pb.VIT_STEPS)
    call_ms = 1e3 * x.shape[0] / doc["viterbi_frames_per_s"]
    print(f"phase 22 K1 at the bench's Viterbi shape {list(x.shape)}: kernel {k1_ms:.4f} ms "
          f"(median of 20 by CUDA events), plain {plain_ms:.2f} ms; bound {b_ms * 1e3:.2f} us "
          f"({by}, {nbytes / 1e6:.2f} MB), share {b_ms / k1_ms:.3f}; the Viterbi leg's chained "
          f"call {call_ms:.4f} ms by the host clock, K1 {k1_ms / call_ms:.3f} of it", flush=True)
    print(f"phase 22 bench headline call ({int(head.out.stream_valid.sum())} stream frames): "
          f"channels 0-{QG_SLICE - 1}, every output field and the final state, equal to the "
          f"CPU's plain call ({t_cpu:.1f} s); the float difference nearest its bound {d:.3g} in "
          f"{field or '-'}, {s:.3g} of the bound (rtol {QG_RTOL:g} atol {QG_ATOL:g}); the "
          f"Viterbi leg's last call on rows 0-{n_vit - 1}: bits and metric equal to "
          f"viterbi_decode_ref; phase 22 {time.perf_counter() - t_phase:.1f} s wall", flush=True)


def weak_scaling(paths: dict, card: str) -> None:
    """Phase 23: the weak-scaling tool on the card's nccl ranks; rank 0's
    first channels of each point against a plain CPU ``rx_stream``."""
    from m17_sdr_tpu_torch.convert import state_to_numpy
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream
    from m17_sdr_tpu_torch.tools import weak_scaling as ws

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    doc, ranks = ws.scaling(WS_CH_PER_DEV, WS_BLOCKS, "cuda")
    print(f"phase 23 weak scaling document: {json.dumps(doc)}", flush=True)
    for p in doc["points"]:
        if not (p["legs_equal"] and p["metrics_equal_sum"]):
            fail(f"weak scaling N={p['devices']}: legs equal {p['legs_equal']}, reduced "
                 f"metrics equal the sum {p['metrics_equal_sum']}")
    # channels 0..k-1 of the draw are rank 0's first k at every N: the warm
    # call and a rep's, two rx_stream calls from a fresh state
    k = min(WS_CH_PER_DEV, ws.KEPT)
    t_cpu = time.perf_counter()
    iq = torch.as_tensor(ws.rank_rows(ws.SEED, (k, WS_BLOCKS, 2, T), 0, 1))
    out_cpu, st_cpu = rx_stream(iq, RxSessionState.init(k, "cpu"))
    out_cpu, st_cpu = rx_stream(iq, st_cpu)
    t_cpu = time.perf_counter() - t_cpu
    checked = []
    for p, res in zip(doc["points"], ranks):
        what = f"weak scaling N={p['devices']} nocomm leg channels 0-{k - 1}"
        t = torch.from_numpy
        checked.append(max(
            match_fields(what, ((f, t(res[0][f"out/{f}"]), getattr(out_cpu, f))
                                for f in out_cpu._fields)),
            match_fields(f"{what} final state",
                         ((f, t(res[0][f"state/{f}"]), t(c))
                          for f, c in state_to_numpy(st_cpu).items()))))
    s, d, field = max(checked)
    record_launches("weak scaling", {sym: sum(p["kernel_launches"][sym] for p in doc["points"])
                                     for sym in doc["points"][0]["kernel_launches"]}, paths)
    print(f"phase 23 weak scaling ({doc['backend']} ranks at N = {doc['ranks']}, the cards "
          f"this machine has): " + "; ".join(
              f"N={p['devices']} {p['channels']} channels x {p['blocks']} blocks: nocomm "
              f"{p['t_nocomm_s']:.4f} s, sharded {p['t_sharded_s']:.4f} s, efficiency "
              f"{p['sharding_efficiency']}, both legs equal" for p in doc["points"])
          + f"; the nocomm leg's last call, channels 0-{k - 1}, every output field and the "
          f"final state, equal to two plain rx_stream calls on the CPU ({t_cpu:.1f} s); the "
          f"float difference nearest its bound {d:.3g} in {field or '-'}, {s:.3g} of the "
          f"bound (rtol {QG_RTOL:g} atol {QG_ATOL:g}); launches {paths['weak scaling']}; "
          f"{time.perf_counter() - t0:.1f} s wall; {card}", flush=True)


def cuda_selftest(dev, paths: dict, card: str) -> None:
    """Phase 24: the Viterbi self-test as a user runs it; then K1 alone at
    its new trellis length."""
    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.fec.viterbi import viterbi_decode_cuda, viterbi_decode_ref
    from m17_sdr_tpu_torch.tools import cuda_selftest as cs

    t0 = time.perf_counter()
    out, _, launches = run_module(TOOLS + "cuda_selftest")
    wall = time.perf_counter() - t0
    doc = json.loads(out.splitlines()[-1])
    if not (doc["ok"] and doc["bit_mismatches"] == 0 and doc["platform"] == "cuda"):
        fail(f"self-test: {json.dumps(doc)}")
    # the self-test decodes on K1 only
    record_launches("self-test", {_build.VITERBI.symbol: launches[_build.VITERBI.symbol]}, paths)
    d = next(d for d in cs.draws() if d.steps == SELFTEST_STEPS)
    x = torch.as_tensor(d.soft).to(dev)
    bits, met = viterbi_decode_cuda(x)
    bits_r, met_r = viterbi_decode_ref(x)
    if not torch.equal(bits, bits_r):
        fail(first_diff("K1 bits (self-test T=201)", bits, bits_r, False))
    if not torch.equal(met, met_r):
        fail(first_diff("K1 metric (self-test T=201)", met, met_r, False))
    k1_ms = cuda_ms(lambda: viterbi_decode_cuda(x), 20)
    plain_ms = cuda_ms(lambda: viterbi_decode_ref(x), 3)
    nbytes = x.nbytes + bits.nbytes + met.nbytes
    b_ms, by = bound(nbytes, K1_OPS_PER_STEP * x.shape[0] * SELFTEST_STEPS)
    print(f"phase 24 self-test: {json.dumps(doc)}; {len(doc['checks'])} checks, 0 bit "
          f"mismatches; launches {paths['self-test']} (K1 only); {wall:.1f} s wall with the "
          f"process start; {card}", flush=True)
    print(f"phase 24 K1 at the self-test's shape {list(x.shape)} (T={SELFTEST_STEPS}): bits and "
          f"metric equal to the plain decoder; kernel {k1_ms:.4f} ms (median of 20 by CUDA "
          f"events), plain {plain_ms:.2f} ms; bound {b_ms * 1e3:.3f} us ({by}, "
          f"{nbytes / 1e6:.3f} MB), share {b_ms / k1_ms:.4f}; {card}; clocks.sm, power.draw, "
          f"power.limit: {smi('clocks.sm,power.draw,power.limit')}", flush=True)


def kernel_validate(paths: dict, card: str) -> None:
    """Phase 25: the acceptance gate at B=4096 as a user runs it."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out, err, launches = run_module(TOOLS + "kernel_validate")
    wall = time.perf_counter() - t0
    doc = json.loads(out.splitlines()[-1])
    want = {"frames": B * 8, "byte_errors": 0}
    if not (doc["ok"] and doc["kernel"] == want and doc["plain"] == want
            and doc["platform"] == "cuda"):
        fail(f"kernel_validate: {json.dumps(doc)}")
    record_launches("kernel validate", launches, paths)
    legs = [ln for ln in err.splitlines() if " leg: " in ln]
    print(f"phase 25 kernel_validate: {json.dumps(doc)}; " + "; ".join(legs)
          + f"; launches {launches}; {wall:.1f} s wall with the process start; {card}",
          flush=True)


def sweep_pod(paths: dict, card: str) -> None:
    """Phase 26: the pod sweep at its defaults on one nccl rank, against
    the record."""
    import tempfile

    from m17_sdr_tpu_torch.pipeline.ber_sweep import recovery_tolerance

    torch.cuda.empty_cache()
    rec = json.loads((Path(__file__).resolve().parent / "SWEEP_POD_r5.json").read_text())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "sweep_pod.json"
        out, _, launches = run_module(TOOLS + "sweep_pod", "--out", str(path))
        doc = json.loads(path.read_text())
    wall = time.perf_counter() - t0
    if not (doc["sharded_equals_unsharded"] and doc["totals_equal_sums"]):
        fail(f"sweep_pod: sharded equals unsharded {doc['sharded_equals_unsharded']}, totals "
             f"equal the sums {doc['totals_equal_sums']}")
    if (doc["mesh"]["backend"], doc["channels"], doc["snr_points"],
            doc["frames_per_channel"]) != ("nccl", rec["channels"], rec["snr_points"],
                                           rec["frames_per_channel"]):
        fail(f"sweep_pod ran {doc['mesh']} at {doc['channels']} channels x {doc['snr_points']} "
             f"points x {doc['frames_per_channel']} frames, not the record's size on nccl")
    if doc["kernel_launches"]["unsharded"] != launches:
        fail(f"sweep_pod: the unsharded run reports {doc['kernel_launches']['unsharded']} "
             f"launches, the process {launches}")
    cpp = doc["channels_per_point"]
    rows = []
    for got, want in zip(doc["curve"], rec["curve"]):
        tol = recovery_tolerance(want["frame_recovery"], cpp)
        rows.append(f"{got['snr_db']:.1f} {got['frame_recovery']:.4f}")
        if abs(got["snr_db"] - want["snr_db"]) > 1e-4:
            fail(f"sweep_pod point {got['snr_db']} dB is not the record's {want['snr_db']} dB")
        if abs(got["frame_recovery"] - want["frame_recovery"]) > tol:
            fail(f"sweep_pod at {got['snr_db']:.1f} dB: frame recovery "
                 f"{got['frame_recovery']:.4f} vs the recorded {want['frame_recovery']:.4f} "
                 f"(tolerance {tol:.4f})")
        if any(abs(got["snr_db"] - c) < 0.05 for c in SWEEP_CLEAN_DB) and got["bit_errors"]:
            fail(f"sweep_pod at {got['snr_db']:.1f} dB: {got['bit_errors']} bit errors")
    both = {sym: doc["kernel_launches"]["sharded"][sym] + n for sym, n in launches.items()}
    record_launches("sweep_pod", both, paths)
    print(f"phase 26 sweep_pod ({doc['mesh']['devices']} {doc['mesh']['backend']} rank(s), "
          f"{doc['channels']} channels x {doc['snr_points']} points x "
          f"{doc['frames_per_channel']} frames): sharded {doc['sharded_elapsed_s']:.3f} s, "
          f"unsharded {doc['unsharded_elapsed_s']:.3f} s; sharded equals unsharded, totals "
          f"{doc['totals_psum']} equal the sums; every point within tolerance of the record "
          f"(dB, recovery: {'; '.join(rows)}), no bit error at "
          f"{' and '.join(map(str, SWEEP_CLEAN_DB))} dB; launches {both} (sharded "
          f"{doc['kernel_launches']['sharded']}); {wall:.1f} s wall with two process starts; "
          f"{card}", flush=True)


def bench_debug(dev, paths: dict, card: str, rx_kernel: dict) -> None:
    """Phase 27: the per-block harness as a user runs it, then its run and
    noise chains here, their first channels against a plain CPU chain."""
    import tempfile

    from m17_sdr_tpu_torch import _build
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_block
    from m17_sdr_tpu_torch.tools import bench_debug as bd
    from m17_sdr_tpu_torch.tools.kernel_validate import session_blocks

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    med = {}
    with tempfile.TemporaryDirectory() as td:
        path = str(Path(td) / "blocks.npy")
        out, _, _ = run_module(TOOLS + "bench_debug", "gen", str(B), "--path", path)
        print(f"phase 27 bench_debug gen: {out.strip()}", flush=True)
        data = np.load(path)
        if not np.array_equal(data, session_blocks(B, dev)[0].cpu().numpy()):
            fail("bench_debug gen: the saved blocks are not the validation session's")
        for mode in ("run", "noise"):
            t0 = time.perf_counter()
            out, _, launches = run_module(TOOLS + "bench_debug", mode, "--path", path)
            record_launches(f"bench_debug {mode}", launches, paths)
            print(f"phase 27 bench_debug {mode} ({B} channels x {data.shape[1]} blocks): "
                  + " | ".join(out.strip().splitlines()) + f"; launches {launches}; "
                  f"{time.perf_counter() - t0:.1f} s wall with the process start", flush=True)
        for mode, x in (("run", data), ("noise", bd.noise(data.shape))):
            res = bd.run(x, dev)
            med[mode] = float(np.median(res.times_ms))
            t0 = time.perf_counter()
            st_cpu = RxSessionState.init(QG_SLICE, "cpu")
            for i in range(x.shape[1]):
                out_cpu, st_cpu = rx_block(torch.as_tensor(x[:QG_SLICE, i]), st_cpu)
            t_cpu = time.perf_counter() - t0
            what = f"bench_debug {mode} channels 0-{QG_SLICE - 1}"
            s, d, field = max(
                match_fields(what, ((n, getattr(res.out, n)[:QG_SLICE], getattr(out_cpu, n))
                                    for n in out_cpu._fields)),
                match_fields(f"{what} final state",
                             ((n, a[:QG_SLICE], b) for (n, a), (_, b)
                              in zip(flatten_state(res.state), flatten_state(st_cpu)))))
            print(f"phase 27 bench_debug {mode} here: median {med[mode]:.2f} ms a block "
                  f"({int(res.out.locked.sum())} of {B} channels locked at the end); channels "
                  f"0-{QG_SLICE - 1}, the last output and the final state, equal to a plain CPU "
                  f"chain from a fresh state ({t_cpu:.1f} s); the float difference nearest its "
                  f"bound {d:.3g} in {field or '-'}, {s:.3g} of the bound (rtol {QG_RTOL:g} "
                  f"atol {QG_ATOL:g})", flush=True)
    print(f"phase 27 bench_debug: rx_block one block a call, fenced, median {med['run']:.2f} "
          f"ms a block on the signal and {med['noise']:.2f} on noise (noise/signal "
          f"{med['noise'] / med['run']:.3f}), beside phase 20's rx_kernel "
          f"{rx_kernel['ms_per_block_min']}/{rx_kernel['ms_per_block_med']} (min/med, bench "
          f"mix); {time.perf_counter() - t_phase:.1f} s wall; {card}; clocks.sm, power.draw, "
          f"power.limit: {smi('clocks.sm,power.draw,power.limit')}", flush=True)

def check_stream(b: int, rate: int, chunk_blocks: int | None, noise: list, dev) -> None:
    """One card session of STREAM_CHECK_BLOCKS noise blocks through the
    streaming bench's ``throughput_session``, its first min(b, QG_SLICE)
    channels against a plain session on the CPU over the same channels:
    every output field and the final state."""
    from m17_sdr_tpu_torch.app.streaming import DEFAULT_CHUNK_BLOCKS, StreamingRx
    from m17_sdr_tpu_torch.tools import streaming_bench as sb

    k = min(b, QG_SLICE)
    chunk_blocks = chunk_blocks or DEFAULT_CHUNK_BLOCKS
    sessions, t_cpu = [], 0.0
    for d, blocks in ((dev, noise), ("cpu", [x[:k] for x in noise])):
        t0 = time.perf_counter()
        srx = StreamingRx(batch=blocks[0].shape[0], input_rate=rate, chunk_blocks=chunk_blocks,
                          equalize="auto", device=d)
        sb.throughput_session(srx, blocks, STREAM_CHECK_BLOCKS)
        sessions.append(srx.finish())
        t_cpu = time.perf_counter() - t0
    (out, state, n), (out_cpu, st_cpu, n_cpu) = sessions
    what = f"streaming bench B={b} {rate // 1000} kHz channels 0-{k - 1}"
    if (n, n_cpu) != (STREAM_CHECK_BLOCKS, STREAM_CHECK_BLOCKS):
        fail(f"{what}: {n} blocks on the card, {n_cpu} on the CPU, not {STREAM_CHECK_BLOCKS}")
    t = torch.from_numpy
    s, d, field = max(
        match_fields(what, ((f, t(getattr(out, f)[:k]), t(getattr(out_cpu, f)))
                            for f in out_cpu._fields)),
        match_fields(f"{what} final state", ((f, t(a[:k]), t(c)) for (f, a), (_, c)
                                             in zip(flatten_state(state),
                                                    flatten_state(st_cpu)))))
    print(f"phase 21 streaming bench B={b} {rate // 1000} kHz: a {STREAM_CHECK_BLOCKS}-block "
          f"session in {chunk_blocks}-block chunks ({int(out.stream_valid.sum())} stream "
          f"frames); channels 0-{k - 1}, every output field and the final state, equal to the "
          f"CPU's plain session ({t_cpu:.1f} s); the float difference nearest its bound "
          f"{d:.3g} in {field or '-'}, {s:.3g} of the bound (rtol {QG_RTOL:g} atol "
          f"{QG_ATOL:g})", flush=True)


def profile_main_path(blocks, dev, rx_stream, session_state) -> float | None:
    """Device time and kernel launches per block of the kernel path, by
    torch.profiler over PROFILE_BLOCKS steady-state blocks: the device's
    busy ms per block, or None where the profiler recorded none."""
    _, state = rx_stream(blocks[:, :1], session_state.init(B, dev), afc_enabled=True,
                         equalize="auto")
    torch.cuda.synchronize()
    run = blocks[:, 1:1 + PROFILE_BLOCKS]
    busy_ms, _ = profile_window(
        "phase 4 profile", lambda: rx_stream(run, state, afc_enabled=True, equalize="auto"),
        PROFILE_BLOCKS)
    return busy_ms


def profile_window(label: str, fn, nblk: int) -> tuple[float | None, object]:
    """(device busy ms per block, fn's result) of one fn() over ``nblk``
    blocks' work under torch.profiler, with its launches a block and top
    kernels printed; busy is None where the profiler recorded no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = [getattr(e, "self_device_time_total", 0.0) for e in kern]
    if not kern or sum(dev_us) == 0:
        print(f"{label}: the profiler recorded no device time (not measured)", flush=True)
        return None, res
    busy_ms = sum(dev_us) / 1e3 / nblk
    top = sorted(zip(dev_us, kern), key=lambda p: -p[0])[:8]
    print(f"{label} ({nblk} blocks under torch.profiler): device busy "
          f"{busy_ms:.3f} ms/block of {wall * 1e3 / nblk:.1f} ms/block wall; "
          f"{sum(e.count for e in kern) / nblk:.0f} device launches/block; top: "
          + "; ".join(f"{e.key[:60]} {us / 1e3 / nblk:.3f} ms "
                      f"x{e.count / nblk:.3g}" for us, e in top), flush=True)
    return busy_ms, res


def _fixture_path():
    from pathlib import Path

    import m17_sdr_tpu_torch

    return Path(m17_sdr_tpu_torch.__file__).resolve().parent / "data" / "rx_fixture.npz"


if __name__ == "__main__":
    sys.exit(main())
