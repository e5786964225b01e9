"""Two controller processes run one sharded BER sweep; their counters
must equal a single process's.

Port of the JAX package's ``tools/multihost_demo.py``.  The JAX tool
starts two ``jax.distributed`` processes on localhost and shards the
sweep's channels over their joint mesh.  Here two separately launched
worker processes join one ``torch.distributed`` process group through
``mesh/launch.py::process_group``'s ``env://`` rendezvous (RANK,
WORLD_SIZE, MASTER_ADDR=127.0.0.1 and a MASTER_PORT found free when the
tool starts), the path a launcher on two hosts takes.  Each runs
``pipeline/ber_sweep.py::pod_bert_sweep`` on its half of the channels
(the totals cross the process boundary in its ``all_reduce``) and
all-gathers the per-channel counters ``err``, ``bits``, ``uns`` and
``frames``.  The parent then runs the same sweep in one process
(``bert_sweep_counts``, the same per-channel noise keys) and exits 0 only
if the processes agree, their gathered counters equal the single
process's, and the reduced totals equal its sums.

With ``--device cpu`` the workers use ``gloo``.  On cards each worker
takes its own card with ``nccl``, so the tool needs two; with fewer it
exits 1 and says why (it never falls back to the CPU).

    python -m m17_sdr_tpu_torch.tools.multihost_demo [--channels 128]
        [--frames 8] [--points 8] [--snr-min 8] [--snr-max 20] [--seed 0]
        [--timeout 900] [--out PATH] [--device cuda|cpu]

Prints the four verdicts as one JSON line; the whole document is written
only with ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..mesh import launch
from ..pipeline import ber_sweep as bs

NPROC = 2
COUNTERS = ("err", "bits", "uns", "frames")
PACKAGE_ROOT = Path(__file__).resolve().parents[2]


def snr_vector(args, device) -> torch.Tensor:
    """[channels] SNR in dB: ``points`` points from snr_min to snr_max, each
    a run of channels / points channels."""
    points = np.linspace(args.snr_min, args.snr_max, args.points).astype(np.float32)
    return torch.as_tensor(np.repeat(points, args.channels // args.points)).to(device)


def worker(args) -> None:
    """One controller process: join the group, run the sharded sweep,
    gather the counters, write this process's view."""
    torch.set_num_threads(1)
    with launch.process_group(args.device) as dev:
        group = dist.group.WORLD
        t0 = time.perf_counter()
        *counts, totals = bs.pod_bert_sweep(group, snr_vector(args, dev), args.frames,
                                            seed=args.seed)
        view = {"process_id": dist.get_rank(), "process_count": dist.get_world_size(),
                "totals_psum": totals.cpu().tolist()}
        for name, x in zip(COUNTERS, counts):
            parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, x, group=group)
            view[name] = torch.cat(parts).cpu().tolist()
        view["elapsed_s"] = time.perf_counter() - t0
    (args.scratch / f"worker{view['process_id']}.json").write_text(json.dumps(view))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_workers(args, scratch: Path) -> list[int]:
    """Start the NPROC workers and wait for them: their exit codes.  A
    worker still running when the others are done or the timeout is up is
    killed (a peer that died before the rendezvous leaves it waiting)."""
    env = dict(os.environ, WORLD_SIZE=str(NPROC), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    cmd = [sys.executable, "-m", __spec__.name, "--channels", str(args.channels),
           "--frames", str(args.frames), "--points", str(args.points),
           "--snr-min", str(args.snr_min), "--snr-max", str(args.snr_max),
           "--seed", str(args.seed), "--device", args.device, "--scratch", str(scratch)]
    procs = [subprocess.Popen(cmd + ["--worker"], cwd=str(PACKAGE_ROOT),
                              env=dict(env, RANK=str(n), LOCAL_RANK=str(n)))
             for n in range(NPROC)]
    t0 = time.perf_counter()
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(10.0, args.timeout - (time.perf_counter() - t0))))
    except subprocess.TimeoutExpired:
        rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10.0)
    return rcs


def document(args, views: list[dict], ref: dict, backend: str, device: str) -> dict:
    agree = all(all(v[k] == views[0][k] for k in ("totals_psum", *COUNTERS)) for v in views)
    match = all(views[0][k] == ref[k] for k in COUNTERS)
    totals_match = views[0]["totals_psum"] == [sum(ref[k]) for k in COUNTERS]
    return {
        "what": "two worker processes joined through torch.distributed's env:// rendezvous "
                "on localhost, channels sharded across them, the counters' totals "
                "all_reduced across the process boundary and the per-channel counters "
                "all_gathered (the code path of a launch on two hosts)",
        "processes": NPROC,
        "local_devices_per_process": 1,
        "global_devices": views[0]["process_count"],
        "channels": args.channels, "frames": args.frames,
        "snr_points": args.points,
        "snr_range_db": [args.snr_min, args.snr_max],
        "totals_psum": views[0]["totals_psum"],
        "worker_elapsed_s": [v["elapsed_s"] for v in views],
        "processes_agree": agree,
        "distributed_equals_single_process": match,
        "totals_equal_single_process": totals_match,
        "ok": agree and match and totals_match,
        "backend": backend,
        "device": device,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m m17_sdr_tpu_torch.tools.multihost_demo",
                                 description="Two processes, one sharded BER sweep.")
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--points", type=int, default=8)
    ap.add_argument("--snr-min", type=float, default=8.0)
    ap.add_argument("--snr-max", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", help="write the document here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--scratch", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.channels % args.points or args.channels % NPROC:
        ap.error(f"--channels must be a multiple of --points and of {NPROC}")
    if args.worker:
        worker(args)
        return 0
    if args.device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < NPROC:
            print(f"error: the workers take a card each, and this machine has {cards}; "
                  "run with --device cpu to use the CPU", file=sys.stderr)
            return 1

    with tempfile.TemporaryDirectory() as td:
        rcs = start_workers(args, Path(td))
        if rcs != [0] * NPROC:
            print(f"error: worker exit codes {rcs}", file=sys.stderr)
            return 1
        views = [json.loads((Path(td) / f"worker{n}.json").read_text()) for n in range(NPROC)]

    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    counts = bs.bert_sweep_counts(snr_vector(args, dev), args.frames, seed=args.seed)
    ref = {k: x.cpu().tolist() for k, x in zip(COUNTERS, counts)}
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    doc = document(args, views, ref, launch.backend(dev), name)
    if args.out:
        Path(args.out).write_text(json.dumps(doc, indent=1))
    print(json.dumps({k: doc[k] for k in ("processes_agree", "distributed_equals_single_process",
                                          "totals_equal_single_process", "ok")}))
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
