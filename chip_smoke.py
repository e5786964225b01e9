#!/usr/bin/env python3
"""Drive the PyTorch port's receive path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one.  Phases, each printed:

1. the card (nvidia-smi name and power limit) and the kernel build;
2. K1, the Viterbi kernel, against its plain version at the main path's
   shapes (B=4096 channels x 3 frame slots, the four trellis lengths):
   bits and metric must be equal; median times of both;
3. K2, the receiver-scan kernel, against its plain version over a
   13-block staggered session mix at B=4096 after the front end: slot
   values, flags and every state field must be equal; median times per
   block;
4. the main path, ``rx_stream`` at B=4096 and T=1920 over the same mix,
   on the kernels and on the plain versions: every output field and the
   final state must be equal, and both kernels must have been launched
   by the kernel run; times per block;
5. the main path against the JAX package's recorded decode of the
   committed fixture sessions (m17_sdr_tpu_torch/data/rx_fixture.npz),
   tiled to B=4096: every recorded field must equal the record;
6. a ``kernels`` summary, then one JSON line with each kernel's launches,
   error and times, then the last line ``{"ok": true, "device": ...}``.

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


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() in ms, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
        ReceiverState, receiver_scan_cuda, receiver_scan_ref)
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream
    from m17_sdr_tpu_torch.spec.constants import TIMING_FILTER_TAPS

    # ---- phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s for "
          f"{len(_build.KERNELS)} kernels", flush=True)

    rng = np.random.default_rng(0)
    report = {}

    # ---- phase 2: K1 parity and time
    k1_ms = k1_plain_ms = k1_err = 0.0
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
        k1_ms, k1_plain_ms, k1_err = k1_ms + ms, k1_plain_ms + plain, max(k1_err, err)
        print(f"phase 2 K1 {name}: {B * F} trellises x {steps} steps: bits and metric "
              f"equal; kernel {ms:.3f} ms, plain {plain:.1f} ms", flush=True)
    report["viterbi"] = dict(ms=k1_ms, plain_ms=k1_plain_ms, max_abs_err=k1_err)
    print(f"phase 2 K1 one block's four decodes: kernel {k1_ms:.3f} ms, "
          f"plain {k1_plain_ms:.1f} ms", flush=True)

    # ---- phase 3: K2 parity and time over the staggered mix
    with np.load(_fixture_path()) as z:
        fx = {k: z[k] for k in z.files}
    blocks = staggered_blocks(fx["iq"], dev)
    fe = RxFrontEndState.init(B, dev)
    st_k = st_r = ReceiverState.init(B, dev)
    window = st_k.window
    k2_ms, k2_plain_ms, k2_err = [], [], 0.0
    for i in range(NBLK):
        soft2x, _, fe = rx_front_end(blocks[:, i], fe, in_frame=st_k.flock, afc_enabled=True)
        ext = torch.cat([window[:, 1:], soft2x], dim=-1)
        times = {}
        for leg, scan, st in (("kernel", receiver_scan_cuda, st_k),
                              ("plain", receiver_scan_ref, st_r)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = scan(ext, st)
            end.record()
            end.synchronize()
            times[leg] = (start.elapsed_time(end), res)
        (ms, (slot_k, flags_k, st_k)), (plain, (slot_r, flags_r, st_r)) = \
            times["kernel"], times["plain"]
        for name, a, b in (("slot_val", slot_k, slot_r), ("flags", flags_k, flags_r),
                           *((f"state.{f}", getattr(st_k, f), getattr(st_r, f))
                             for f in ReceiverState._fields)):
            if not torch.equal(a, b):
                fail(f"K2 block {i}: " + first_diff(name, a, b, False))
        k2_err = max(k2_err, (slot_k - slot_r).abs().max().item())
        k2_ms.append(ms)
        k2_plain_ms.append(plain)
        window = ext[:, -TIMING_FILTER_TAPS:]
    locked = int(st_k.flock.sum())
    # medians: block 0's launch also loads the kernel's module onto the card
    k2_med, k2_plain_med = statistics.median(k2_ms), statistics.median(k2_plain_ms)
    report["receiver_scan"] = dict(ms=k2_med, plain_ms=k2_plain_med, max_abs_err=k2_err)
    print(f"phase 3 K2: {NBLK} blocks x {B} channels: slots, flags and state equal "
          f"({locked} channels locked at the end); median kernel {k2_med:.3f} ms/block "
          f"(block 0: {k2_ms[0]:.3f}), plain {k2_plain_med:.1f} ms/block", flush=True)

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
                        "plain_ms": r["plain_ms"]})
    print("kernels " + "; ".join(
        f"{k['name']}: {k['launches']} launches on the main path, parity ok"
        for k in kernels), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def _fixture_path():
    from pathlib import Path

    import m17_sdr_tpu_torch

    return Path(m17_sdr_tpu_torch.__file__).resolve().parent / "data" / "rx_fixture.npz"


if __name__ == "__main__":
    sys.exit(main())
