"""The pod-scale BER sweep as one sharded program, then unsharded.

Port of the JAX package's ``tools/sweep_pod.py``.  ``channels`` channels
over ``points`` SNR points spanning the chain's RF waterfall (8-20 dB),
``frames`` BERT frames a channel: TX synthesis, noise keyed per global
channel by ``--seed``, the full RX pipeline and the PRBS error count, all
on the device.  The channels are sharded over N process ranks
(``mesh/launch.py::spawn``: ``nccl`` ranks, one card a rank, on cards;
``gloo`` ranks under ``--device cpu``), each running
``pipeline/ber_sweep.py::pod_bert_sweep`` on its own channels, whose
totals cross the ranks in one ``all_reduce``; rank 0 gathers the
per-channel counters.  The same sweep then runs unsharded in this process
(``bert_sweep_counts``, the same seed), and the two must agree counter for
counter, and the totals must equal the counters' sums.

    python -m m17_sdr_tpu_torch.tools.sweep_pod [--channels 4096]
        [--frames 20] [--points 16] [--snr-min 8] [--snr-max 20]
        [--devices N] [--seed 0] [--skip-unsharded] [--out PATH]
        [--device cuda|cpu]

``--devices`` defaults to the cards there are on CUDA (it may not exceed
them) and to 8 on the CPU, the JAX tool's virtual mesh.  ``--device``
defaults to the card and exits 1 without one.  Prints the JAX tool's
lines (one a point, then the verdict); the document (the JAX tool's keys;
``mesh.backend`` is ``nccl`` or ``gloo``; elapsed times unrounded; plus
``device`` and ``kernel_launches``) is written only with ``--out``.  Exits
1 when the sharded counters differ from the unsharded ones or the totals
from the sums.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import _build
from .._util import device_record, fence
from ..mesh import launch
from ..pipeline import ber_sweep as bs

COUNTERS = ("err", "bits", "uns", "frames")
CPU_DEVICES = 8


def snr_vector(args) -> np.ndarray:
    """[channels] SNR in dB: ``points`` points from snr_min to snr_max, each
    a run of channels / points channels."""
    pts = np.linspace(args.snr_min, args.snr_max, args.points).astype(np.float32)
    return np.repeat(pts, args.channels // args.points)


def _launches() -> dict:
    return {k.symbol: k.launches for k in _build.KERNELS}


def _rank(rank: int, n: int, dev, snr: np.ndarray, frames: int, seed: int,
          out_dir: str) -> None:
    """One rank of the sharded sweep; rank 0 writes ``out_dir/sharded.npz``:
    the gathered counters, the totals, the slowest rank's seconds and the
    ranks' summed kernel launches."""
    group = dist.group.WORLD
    before = _launches()
    snr_vec = torch.as_tensor(snr).to(dev)
    dist.barrier()
    t0 = time.perf_counter()
    *counts, totals = bs.pod_bert_sweep(group, snr_vec, frames, seed=seed)
    fence(dev)
    elapsed = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=dev)
    dist.all_reduce(elapsed, op=dist.ReduceOp.MAX)
    launches = torch.tensor([k.launches - before[k.symbol] for k in _build.KERNELS],
                            dtype=torch.int64, device=dev)
    dist.all_reduce(launches)
    res = {"totals": totals.cpu().numpy(), "elapsed": elapsed.cpu().numpy(),
           "launches": launches.cpu().numpy()}
    for name, x in zip(COUNTERS, counts):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        res[name] = torch.cat(parts).cpu().numpy()
    if rank == 0:
        np.savez(Path(out_dir) / "sharded.npz", **res)


def sharded(args, snr: np.ndarray) -> dict:
    """The sharded sweep over ``args.devices`` spawned ranks: rank 0's result."""
    with tempfile.TemporaryDirectory() as td:
        launch.spawn(_rank, args.devices, snr, args.frames, args.seed, td,
                     device=args.device)
        with np.load(Path(td) / "sharded.npz") as z:
            return {k: z[k] for k in z.files}


def unsharded(args, snr: np.ndarray) -> tuple[dict, float, dict]:
    """The same sweep in this process: (counters, seconds, kernel launches)."""
    dev = torch.device(args.device)
    before = _launches()
    snr_vec = torch.as_tensor(snr).to(dev)
    fence(dev)
    t0 = time.perf_counter()
    counts = bs.bert_sweep_counts(snr_vec, args.frames, seed=args.seed)
    fence(dev)
    elapsed = time.perf_counter() - t0
    after = _launches()
    return ({k: x.cpu().numpy() for k, x in zip(COUNTERS, counts)}, elapsed,
            {s: after[s] - before[s] for s in after})


def curve(args, snr_pts: np.ndarray, counters: dict) -> list[dict]:
    """The JAX document's per-point rows from the sharded counters."""
    cpp = args.channels // args.points
    err, bits, frames = (counters[k].reshape(args.points, cpp)
                         for k in ("err", "bits", "frames"))
    rows = []
    for i, s in enumerate(snr_pts):
        nb = int(bits[i].sum())
        rows.append({
            "snr_db": float(s),
            "bit_errors": int(err[i].sum()), "bits": nb,
            "ber": round(err[i].sum() / nb, 6) if nb else 1.0,
            "frames_recovered": int(frames[i].sum()),
            "frames_sent": args.frames * cpp,
            "frame_recovery": round(frames[i].sum() / (args.frames * cpp), 4),
        })
    return rows


def sweep(args) -> dict:
    """The document (see the module docstring)."""
    snr = snr_vector(args)
    snr_pts = np.linspace(args.snr_min, args.snr_max, args.points).astype(np.float32)
    res = sharded(args, snr)
    totals = [int(x) for x in res["totals"]]
    doc = {
        "config": "BASELINE config 5: pod-scale BERT BER sweep "
                  f"{args.snr_min:g}-{args.snr_max:g} dB over the "
                  "chain's RF waterfall as one sharded program",
        "channels": args.channels, "snr_points": args.points,
        "channels_per_point": args.channels // args.points,
        "frames_per_channel": args.frames,
        "mesh": {"devices": args.devices, "axis": "ch",
                 "backend": launch.backend(args.device),
                 "collective": "all_reduce of [errors, bits, unsynced, frames] counters"},
        "sharded_elapsed_s": float(res["elapsed"][0]),
        "totals_psum": totals,
        "device": device_record(args.device)["name"],
        "kernel_launches": {"sharded": {k.symbol: int(res["launches"][i])
                                        for i, k in enumerate(_build.KERNELS)}},
    }
    if not args.skip_unsharded:
        ref, elapsed, launches = unsharded(args, snr)
        doc["unsharded_elapsed_s"] = elapsed
        doc["sharded_equals_unsharded"] = all(np.array_equal(res[k], ref[k])
                                              for k in COUNTERS)
        doc["totals_equal_sums"] = totals == [int(res[k].sum()) for k in COUNTERS]
        doc["kernel_launches"]["unsharded"] = launches
    doc["curve"] = curve(args, snr_pts, res)
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m m17_sdr_tpu_torch.tools.sweep_pod",
                                 description="The pod-scale BER sweep, sharded and unsharded.")
    ap.add_argument("--channels", type=int, default=4096)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--points", type=int, default=16)
    ap.add_argument("--snr-min", type=float, default=8.0)
    ap.add_argument("--snr-max", type=float, default=20.0)
    ap.add_argument("--devices", type=int)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-unsharded", action="store_true")
    ap.add_argument("--out", help="write the document here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; run with --device cpu to use the CPU", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count() if args.device == "cuda" else None
    if args.devices is None:
        args.devices = cards or CPU_DEVICES
    if cards is not None and args.devices > cards:
        ap.error(f"--devices {args.devices}: nccl takes one card a rank, and there are {cards}")
    if args.devices <= 0 or args.channels % args.points or args.channels % args.devices:
        ap.error("--channels must be a multiple of --points and of --devices")
    if args.seed < 0:
        ap.error("--seed must be non-negative")

    doc = sweep(args)
    if args.out:
        Path(args.out).write_text(json.dumps(doc, indent=1))
    for row in doc["curve"]:
        print(f"snr={row['snr_db']:5.2f} ber={row['ber']:.5f} "
              f"recovery={row['frame_recovery']:.3f}")
    print("sharded==unsharded:", doc.get("sharded_equals_unsharded"),
          "->", args.out or "(no --out: not written)")
    if args.skip_unsharded:
        return 0
    if not (doc["sharded_equals_unsharded"] and doc["totals_equal_sums"]):
        print(f"error: sharded equals unsharded {doc['sharded_equals_unsharded']}, totals "
              f"equal the sums {doc['totals_equal_sums']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
