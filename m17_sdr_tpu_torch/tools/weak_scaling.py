"""Weak-scaling efficiency of the channel-sharded receive path.

Port of the JAX package's ``tools/weak_scaling.py``, with its method: at
each world size N the same B = ch_per_dev * N channels run two legs that
differ only in what sharding adds,

  ``nocomm``   each rank's own ``rx_stream`` on its channels, no collective:
               N independent pipelines, the embarrassingly parallel ideal;
  ``sharded``  ``mesh/sharding.py::sharded_rx_stream``, the same pipeline
               plus its one ``all_reduce`` of the metrics,

and efficiency = min(t_nocomm) / min(t_sharded): 1 less the partition and
collective overhead.  The JAX tool runs the N shards as the devices of a
virtual CPU mesh in one process; here every shard is a process rank
(``mesh/launch.py::spawn``): ``gloo`` ranks on the CPU at N = 1, 2, 4, 8,
``nccl`` ranks on cards, one card a rank, at those N up to the cards the
machine has (on a one-card machine N = 1 only).  The input is the JAX
draw, ``default_rng(0)`` normal [B, n_blocks, 2, 1920] float32, rank r
taking rows [r ch_per_dev, (r+1) ch_per_dev).

Each rank runs one warm call of each leg, then REPS reps with the legs
interleaved (nocomm, sharded, nocomm, ...) so that drift hits both, each
from the state the warm call left, as the JAX tool's are.  A leg's
time in a rep is the slowest rank's: the ranks meet at a barrier, each
times its call up to a fence, and the times are max-reduced after the
reps.  Every rank also checks that its two legs' outputs and states are
equal and that the reduced metrics are the sum of the ranks' own, and
keeps its nocomm leg's last output and state on its first KEPT channels,
so that a caller can hold them against a plain decode of those rows.

    python -m m17_sdr_tpu_torch.tools.weak_scaling [ch_per_dev=512]
        [n_blocks=16] [--device cuda|cpu]

``--device`` defaults to the card and exits 1 without one.  Prints one
JSON object (the JAX tool's keys plus ``device``, ``backend`` and
``ranks``); exits 1 if a point's legs disagree.  Times are unrounded, so
that ``sharding_efficiency`` recomputes from them.
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
from ..convert import state_to_numpy
from ..mesh import launch, sharding
from ..pipeline.rx import RxSessionState, rx_stream
from ..spec.constants import BLOCK_SAMPLES

CH_PER_DEV = 512
N_BLOCKS = 16
REPS = 5
WORLD_SIZES = (1, 2, 4, 8)
SEED = 0
LEGS = ("nocomm", "sharded")
KEPT = 8                # channels of each rank whose last output and state it keeps


def rank_rows(seed: int, shape: tuple, rank: int, n: int) -> np.ndarray:
    """Rows [rank R, (rank+1) R) of ``default_rng(seed).normal(size=shape)``
    as float32, R = shape[0] / n, drawn R rows at a time so that no rank
    holds the whole draw."""
    rows = shape[0] // n
    rng = np.random.default_rng(seed)
    for _ in range(rank):
        rng.normal(size=(rows, *shape[1:]))
    return rng.normal(size=(rows, *shape[1:])).astype(np.float32)


def world_sizes(device) -> list[int]:
    """The N the tool runs on ``device``: all of WORLD_SIZES on the CPU,
    those up to the number of cards on CUDA."""
    if torch.device(device).type == "cuda":
        return [n for n in WORLD_SIZES if n <= torch.cuda.device_count()]
    return list(WORLD_SIZES)


def _legs_equal(a, b) -> bool:
    (out_a, st_a), (out_b, st_b) = a, b
    return (all(torch.equal(x, y) for x, y in zip(out_a, out_b))
            and all(np.array_equal(x, y) for x, y in zip(state_to_numpy(st_a).values(),
                                                         state_to_numpy(st_b).values())))


def _rank(rank: int, n: int, dev, ch_per_dev: int, n_blocks: int, reps: int,
          out_dir: str) -> None:
    """One rank's two legs: writes ``out_dir/rank<r>.npz``."""
    group = dist.group.WORLD
    iq = torch.as_tensor(rank_rows(SEED, (ch_per_dev * n, n_blocks, 2, BLOCK_SAMPLES),
                                   rank, n)).to(dev)
    run_sharded = sharding.sharded_rx_stream(group)
    legs = {"nocomm": lambda st: (*rx_stream(iq, st), None),
            "sharded": lambda st: run_sharded(iq, st)}
    before = [k.launches for k in _build.KERNELS]
    _, st, _ = legs["nocomm"](RxSessionState.init(ch_per_dev, dev))
    legs["sharded"](st)
    fence(dev)
    times = torch.zeros((len(LEGS), reps), dtype=torch.float64)
    last = {}
    for r in range(reps):
        for i, name in enumerate(LEGS):
            dist.barrier()
            t0 = time.perf_counter()
            last[name] = legs[name](st)
            fence(dev)
            times[i, r] = time.perf_counter() - t0
    times = times.to(dev)
    dist.all_reduce(times, op=dist.ReduceOp.MAX)
    out, state, _ = last["nocomm"]
    own = torch.stack([state.n_frames.sum().to(torch.float32),
                       state.golay_errors.sum().to(torch.float32),
                       out.locked[:, -1].to(torch.float32).sum()])
    res = {"times": times.cpu().numpy(),
           "launches": np.array([k.launches - b for k, b in zip(_build.KERNELS, before)]),
           "metrics": last["sharded"][2].cpu().numpy(), "own": own.cpu().numpy(),
           "legs_equal": np.array(_legs_equal(last["nocomm"][:2], last["sharded"][:2]))}
    k = min(ch_per_dev, KEPT)
    res.update({f"out/{f}": v[:k].cpu().numpy() for f, v in out._asdict().items()})
    res.update({f"state/{f}": v[:k] for f, v in state_to_numpy(state).items()})
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)


def run_point(n: int, ch_per_dev: int = CH_PER_DEV, n_blocks: int = N_BLOCKS,
              device="cuda", reps: int = REPS):
    """Both legs at world size ``n``: (the point's entry, the ranks'
    results).  A rank's result holds ``times`` [2, reps] (the max over
    ranks, nocomm then sharded), ``launches`` (per kernel of
    ``_build.KERNELS``), ``metrics`` (the reduced ones), ``own`` (its own
    three), ``legs_equal``, and its nocomm leg's last output
    ("out/<field>") and final state ("state/<key>") on its first
    min(ch_per_dev, KEPT) channels: those of two ``rx_stream`` calls on
    its rows from ``RxSessionState.init``."""
    with tempfile.TemporaryDirectory() as td:
        launch.spawn(_rank, n, ch_per_dev, n_blocks, reps, td,
                     device=torch.device(device).type)
        ranks = []
        for r in range(n):
            with np.load(Path(td) / f"rank{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
    t_nocomm, t_sharded = ranks[0]["times"].min(axis=1)
    point = {
        "devices": n,
        "channels": ch_per_dev * n,
        "blocks": n_blocks,
        "t_nocomm_s": float(t_nocomm),
        "t_sharded_s": float(t_sharded),
        "samples_processed": ch_per_dev * n * n_blocks * BLOCK_SAMPLES,
        "sharding_efficiency": round(float(t_nocomm / t_sharded), 4),
        "legs_equal": all(bool(x["legs_equal"]) for x in ranks),
        "metrics_equal_sum": all(np.array_equal(x["metrics"], sum(y["own"] for y in ranks))
                                 for x in ranks),
        "kernel_launches": {k.symbol: int(sum(x["launches"][i] for x in ranks))
                            for i, k in enumerate(_build.KERNELS)},
    }
    return point, ranks


def document(points: list, ch_per_dev: int, device) -> dict:
    device = torch.device(device)
    backend = launch.backend(device)
    sizes = [p["devices"] for p in points]
    where = ("gloo ranks on the CPU" if backend == "gloo" else
             f"nccl ranks, one card a rank, up to the {torch.cuda.device_count()} card(s) of "
             "this machine")
    return {
        "methodology": f"at each N in {sizes}, N process ranks ({where}), each running both "
                       "legs on its own channels, interleaved over the reps; a leg's time is "
                       "the slowest rank's (barrier, fence, max-reduce); efficiency = "
                       "t(no collective) / t(sharded_rx_stream with its metrics all_reduce) "
                       "= 1 - partition/collective overhead (see the module docstring)",
        "ch_per_dev": ch_per_dev,
        "points": points,
        "device": device_record(device)["name"],
        "backend": backend,
        "ranks": sizes,
    }


def scaling(ch_per_dev: int = CH_PER_DEV, n_blocks: int = N_BLOCKS, device="cuda",
            reps: int = REPS) -> tuple[dict, list]:
    """(the document over ``world_sizes(device)``, each point's ranks'
    results); progress on stderr."""
    points, ranks = [], []
    for n in world_sizes(device):
        point, res = run_point(n, ch_per_dev, n_blocks, device, reps)
        print(f"N={n}: {json.dumps(point)}", file=sys.stderr, flush=True)
        points.append(point)
        ranks.append(res)
    return document(points, ch_per_dev, device), ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m m17_sdr_tpu_torch.tools.weak_scaling",
                                 description="Weak-scaling efficiency of the sharded RX path.")
    ap.add_argument("ch_per_dev", type=int, nargs="?", default=CH_PER_DEV)
    ap.add_argument("n_blocks", type=int, nargs="?", default=N_BLOCKS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; run with --device cpu to use the CPU", file=sys.stderr)
        return 1
    doc, _ = scaling(args.ch_per_dev, args.n_blocks, args.device)
    print(json.dumps(doc))
    bad = [p["devices"] for p in doc["points"]
           if not (p["legs_equal"] and p["metrics_equal_sum"])]
    if bad:
        print(f"error: the legs disagree at N = {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
