#!/usr/bin/env python3
"""Drive the PyTorch port's receive and transmit paths on one CUDA card and
check them.

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
4. the main path, ``rx_stream`` at B=4096 and T=1920 over the same mix,
   on the kernels and on the plain versions: every output field and the
   final state must be equal, and both kernels must have been launched
   by the kernel run; times per block; then device time, launches and the
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
9. a ``kernels`` summary, then one JSON line with each kernel's launches
   (summed over the paths of phases 4 and 6-8, each counted from 0 just
   before it), error, times and bound, then the last line
   ``{"ok": true, "device": ...}``.

A kernel's bound is the least time the card could take for its work: the
larger of its bytes (each input read once, each output written once) over
HBM_BYTES_PER_S and its f32 operations over F32_OPS_PER_S, the H100 SXM's
published peaks.

Any mismatch prints where it was found and exits 1 before the last line.
"""

from __future__ import annotations

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
    if a kernel was not launched."""
    torch.cuda.synchronize()
    got = {k.symbol: k.launches for k in kernels}
    for sym, n in got.items():
        if n == 0:
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
        legs[leg] = (out, state, per_block)
        print(f"phase 4 main path ({leg}): {per_block * 1e3:.1f} ms/block, "
              f"{B * T / per_block / 1e6:.1f} M channel-samples/s", flush=True)
    (out_k, st_k, _), (out_r, st_r, _) = legs["kernel"], legs["plain"]
    compare_outputs("main path", out_k, st_k, out_r, st_r)
    print(f"phase 4 main path: all {len(out_k._fields)} output fields and the final "
          f"state equal (floats to {FLOAT_TOL}); launches {launches}", flush=True)
    profile_main_path(blocks, dev, rx_stream, RxSessionState)

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

    # ---- phase 9: summary
    sources = {"viterbi": ("m17_sdr_tpu_torch/csrc/viterbi.cu",
                           "m17_sdr_tpu/fec/viterbi_pallas.py:58", _build.VITERBI),
               "receiver_scan": ("m17_sdr_tpu_torch/csrc/receiver_scan.cu",
                                 "m17_sdr_tpu/frame/receiver_pallas.py:73",
                                 _build.RECEIVER_SCAN)}
    launches = {k.symbol: sum(p[k.symbol] for p in paths.values()) for k in _build.KERNELS}
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
        per_path = ", ".join(f"{p} {n[k.symbol]}" for p, n in paths.items())
        summary.append(f"{name}: {launches[k.symbol]} launches on the paths ({per_path}), "
                       "parity ok")
    print("kernels " + "; ".join(summary), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


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


def profile_main_path(blocks, dev, rx_stream, session_state) -> None:
    """Device time and kernel launches per block of the kernel path, by
    torch.profiler over PROFILE_BLOCKS steady-state blocks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, state = rx_stream(blocks[:, :1], session_state.init(B, dev), afc_enabled=True,
                         equalize="auto")
    torch.cuda.synchronize()
    run = blocks[:, 1:1 + PROFILE_BLOCKS]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rx_stream(run, state, afc_enabled=True, equalize="auto")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = [getattr(e, "self_device_time_total", 0.0) for e in kern]
    if not kern or sum(dev_us) == 0:
        print("phase 4 profile: the profiler recorded no device time (not measured)",
              flush=True)
        return
    busy_ms = sum(dev_us) / 1e3 / PROFILE_BLOCKS
    top = sorted(zip(dev_us, kern), key=lambda p: -p[0])[:8]
    print(f"phase 4 profile ({PROFILE_BLOCKS} blocks under torch.profiler): device busy "
          f"{busy_ms:.3f} ms/block of {wall * 1e3 / PROFILE_BLOCKS:.1f} ms/block wall; "
          f"{sum(e.count for e in kern) / PROFILE_BLOCKS:.0f} device launches/block; top: "
          + "; ".join(f"{e.key[:60]} {us / 1e3 / PROFILE_BLOCKS:.3f} ms "
                      f"x{e.count // PROFILE_BLOCKS}" for us, e in top), flush=True)


def _fixture_path():
    from pathlib import Path

    import m17_sdr_tpu_torch

    return Path(m17_sdr_tpu_torch.__file__).resolve().parent / "data" / "rx_fixture.npz"


if __name__ == "__main__":
    sys.exit(main())
