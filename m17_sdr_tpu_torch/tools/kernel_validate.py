"""End-to-end acceptance gate for receiver and kernel changes.

Port of the JAX package's ``tools/pallas_validate.py``.  A modulated voice
session, 64 sessions of FRAMES stream frames (AB1CDE <- G4GUO, payloads
from ``default_rng(0)``: ``pipeline/benchdata.py::bench_sessions``) built
by the port's TX on the device and tiled to ``batch`` channels as float32
planar IQ blocks [batch, nblk, 2, 1920], goes through a chain of
``rx_block`` calls (AFC and the equalizer off) from
``RxSessionState.init`` twice:

  ``kernel``  on the CUDA kernels (K1, K2 and K3, ``use_kernel=True``);
  ``plain``   on their plain PyTorch versions (``use_kernel=False``).

Each leg is scored on the device as the JAX tool scores it: a routed
stream frame (``stream_valid`` and FN < FRAMES) writes its payload into
its FN's row, the last write winning; ``frames`` counts the rows written
and ``byte_errors`` the bytes of those rows that differ from the payloads
sent.  The pass rule is the JAX tool's: both legs route batch * FRAMES
frames with no byte error.  The four counts cross to the host in one read.

    python -m m17_sdr_tpu_torch.tools.kernel_validate [--batch 4096]
        [--device cuda|cpu]

``batch`` is a multiple of 64.  ``--device`` defaults to the card and
exits 1 without one.  Under ``--device cpu`` both legs are the plain
versions (a CPU tensor cannot take the kernels), and the run says so on
stderr.  Prints each leg's wall time on stderr, then one JSON line
{"platform", "plain", "kernel", "expected_frames", "ok"}; exits 0 only on
a pass.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import torch

from .. import _build
from .._util import fence
from ..pipeline import tx as txp
from ..pipeline.benchdata import SESSIONS, bench_sessions
from ..pipeline.rx import RxSessionState, rx_block
from ..spec.constants import BLOCK_SAMPLES

BATCH = 4096


def session_blocks(batch: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The validation session on ``device``: (blocks [batch, nblk, 2, 1920]
    float32, the payloads sent [batch, FRAMES, 16] uint8), the 64 sessions
    tiled batch / 64 times.  ``batch`` is a multiple of 64."""
    if batch % SESSIONS:
        raise ValueError(f"batch must be a multiple of {SESSIONS}, got {batch}")
    lsf, payloads = bench_sessions(device)
    iq, _ = txp.dibits_to_iq(txp.build_voice_session_dibits(lsf, payloads))
    nblk = iq.shape[-1] // BLOCK_SAMPLES
    blk = iq[:, :, : nblk * BLOCK_SAMPLES].reshape(SESSIONS, 2, nblk, BLOCK_SAMPLES)
    reps = batch // SESSIONS
    return (blk.movedim(1, 2).repeat(reps, 1, 1, 1).contiguous(),
            payloads.repeat(reps, 1, 1))


class Score(NamedTuple):
    frames: torch.Tensor        # 0-d: rows written
    byte_errors: torch.Tensor   # 0-d: bytes of written rows unlike the payloads sent
    got: torch.Tensor           # [batch, FRAMES, 16] the last payload routed at each FN
    have: torch.Tensor          # [batch, FRAMES] bool: a payload was routed at the FN


def score(blocks: torch.Tensor, expect: torch.Tensor, use_kernel: bool) -> Score:
    """One leg: ``rx_block`` over ``blocks`` [batch, nblk, 2, T] block by
    block from a fresh state, scored against ``expect`` [batch, nf, 16] on
    the device."""
    batch, nblk = blocks.shape[:2]
    nf = expect.shape[1]
    dev = blocks.device
    fns = torch.arange(nf, device=dev)
    st = RxSessionState.init(batch, dev)
    got = torch.zeros_like(expect)
    have = torch.zeros((batch, nf), dtype=torch.bool, device=dev)
    for i in range(nblk):
        out, st = rx_block(blocks[:, i], st, use_kernel=use_kernel)
        for s in range(out.stream_fn.shape[1]):
            fn = out.stream_fn[:, s]
            ok = out.stream_valid[:, s] & (fn < nf)
            onehot = (fns[None, :] == fn.clamp(0, nf - 1)[:, None]) & ok[:, None]
            got = torch.where(onehot[..., None], out.stream_payload[:, s, None, :], got)
            have = have | onehot
    errs = ((got != expect) & have[..., None]).sum()
    return Score(have.sum(), errs, got, have)


def validate(batch: int = BATCH, device="cuda") -> dict:
    """Both legs at ``batch`` channels: the tool's JSON document.  Each
    leg's wall time (to a fence) goes to stderr."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        _build.build_all()             # no nvcc inside a leg's time
    blocks, expect = session_blocks(batch, dev)
    legs = {}
    for leg, use_kernel in (("plain", False), ("kernel", on_card)):
        t0 = time.perf_counter()
        legs[leg] = score(blocks, expect, use_kernel)
        fence(dev)
        wall = time.perf_counter() - t0
        print(f"{leg} leg: {blocks.shape[1]} blocks x {batch} channels, {wall:.3f} s, "
              f"{wall * 1e3 / blocks.shape[1]:.2f} ms/block", file=sys.stderr, flush=True)
    counts = torch.stack([legs["plain"].frames, legs["plain"].byte_errors,
                          legs["kernel"].frames, legs["kernel"].byte_errors])
    fx, ex, fk, ek = counts.tolist()   # the one transfer
    expected = batch * expect.shape[1]
    ok = fk == fx and ek == 0 and ex == 0 and fx == expected
    return {"platform": dev.type,
            "plain": {"frames": fx, "byte_errors": ex},
            "kernel": {"frames": fk, "byte_errors": ek},
            "expected_frames": expected,
            "ok": bool(ok)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m m17_sdr_tpu_torch.tools.kernel_validate",
                                 description="A voice session through both receiver legs.")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.batch <= 0 or args.batch % SESSIONS:
        ap.error(f"--batch must be a positive multiple of {SESSIONS}")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; run with --device cpu to use the CPU", file=sys.stderr)
        return 1
    if args.device == "cpu":
        print("note: on the CPU both legs are the plain versions; this run checks the "
              "session and the scoring, not the kernels", file=sys.stderr)
    doc = validate(args.batch, args.device)
    print(json.dumps(doc))
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
