#!/usr/bin/env python3
"""Drive the PyTorch port's receive path on one CUDA card and check it.

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
6. a ``kernels`` summary, then one JSON line with each kernel's launches,
   error, times and bound, then the last line ``{"ok": true, "device": ...}``.

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
            launches = {k.symbol: k.launches for k in _build.KERNELS}
        legs[leg] = (out, state, per_block)
        print(f"phase 4 main path ({leg}): {per_block * 1e3:.1f} ms/block, "
              f"{B * T / per_block / 1e6:.1f} M channel-samples/s", flush=True)
    for k in _build.KERNELS:
        if launches[k.symbol] == 0:
            fail(f"the main path never launched {k.symbol}")
    (out_k, st_k, _), (out_r, st_r, _) = legs["kernel"], legs["plain"]
    for name in out_k._fields:
        a, b = getattr(out_k, name), getattr(out_r, name)
        if not same(a, b):
            fail("main path: " + first_diff(name, a, b, a.dim() > 1))
    for (name, a), (_, b) in zip(flatten_state(st_k), flatten_state(st_r)):
        if not same(a, b):
            fail("main path final state: " + first_diff(name, a, b, False))
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

    # ---- phase 6: summary
    sources = {"viterbi": ("m17_sdr_tpu_torch/csrc/viterbi.cu",
                           "m17_sdr_tpu/fec/viterbi_pallas.py:58", _build.VITERBI),
               "receiver_scan": ("m17_sdr_tpu_torch/csrc/receiver_scan.cu",
                                 "m17_sdr_tpu/frame/receiver_pallas.py:73",
                                 _build.RECEIVER_SCAN)}
    kernels = []
    for name, (source, replaces, k) in sources.items():
        r = report[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[k.symbol],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "bound_us": r["bound_ms"] * 1e3, "share": r["bound_ms"] / r["ms"]})
    print("kernels " + "; ".join(
        f"{k['name']}: {k['launches']} launches on the main path, parity ok"
        for k in kernels), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


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
