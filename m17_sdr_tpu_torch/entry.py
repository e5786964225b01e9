"""Counterparts of the repository's ``__graft_entry__``: ``entry``, one
receive block through the port's main path, and ``dryrun_multichip``, one
sharded step over N ranks.

    python -m m17_sdr_tpu_torch.entry               # on the CUDA card
    python -m m17_sdr_tpu_torch.entry --cpu         # on the CPU, plain versions
    python -m m17_sdr_tpu_torch.entry --dryrun 4 --cpu   # 4 gloo ranks

Without ``--cpu`` it needs a CUDA card (``--dryrun N``: N cards) and exits
non-zero where there is none.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .pipeline.rx import RxBlockOutput, RxSessionState, rx_block
from .spec.constants import BLOCK_SAMPLES

BATCH = 64


def entry(device) -> tuple[RxBlockOutput, RxSessionState]:
    """One ``rx_block`` at B=64, T=1920 on ``device``, on seeded noise."""
    rng = np.random.default_rng(0)
    iq = torch.as_tensor(rng.normal(size=(BATCH, 2, BLOCK_SAMPLES)).astype(np.float32)).to(device)
    return rx_block(iq, RxSessionState.init(BATCH, device))


DRY_BLOCK = 480          # tiny: 96 timing-scan steps a block


def dryrun_multichip(n: int, device="cuda") -> None:
    """One sharded step over ``n`` ranks started on this host (``n`` cards
    for ``device="cuda"``, ``nccl``; CPU processes for ``"cpu"``, ``gloo``),
    on the shapes of the JAX dry run: blocks of DRY_BLOCK samples, 2
    channels and 2 blocks a rank.

    For n < 4 or odd n the channels are sharded over all ranks
    (``sharded_rx_stream``).  For even n >= 4 the ranks form a 2-D mesh of
    n/2 ``ch`` x 2 ``time``: channels over ``ch``, blocks over ``time``,
    ``time_parallel_rx`` on the ``time`` group with one warm-up block.
    (The JAX dry run passes its 2-D mesh itself to ``time_parallel_rx``,
    which splits blocks over its first axis, ``ch``.)  Raises if a rank
    fails.
    """
    from .mesh import launch

    launch.spawn(_dryrun_rank, n, device=device)


def _dryrun_rank(rank: int, n: int, dev) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from .mesh import halo, sharding

    n_time = 2 if n % 2 == 0 and n >= 4 else 1
    n_ch = n // n_time
    b, nblk = 2 * n_ch, 2 * n_time
    rng = np.random.default_rng(0)
    iq = torch.as_tensor(rng.normal(size=(b, nblk, 2, DRY_BLOCK)).astype(np.float32)).to(dev)
    if n_time > 1:
        mesh = init_device_mesh(dev.type, (n_ch, n_time), mesh_dim_names=("ch", "time"))
        c, t = mesh.get_local_rank("ch"), mesh.get_local_rank("time")
        run = halo.time_parallel_rx(mesh.get_group("time"), warmup_blocks=1, block=DRY_BLOCK)
        out = run(iq[2 * c:2 * c + 2, 2 * t:2 * t + 2])
    else:
        group = sharding.make_mesh(n).get_group("ch")
        run = sharding.sharded_rx_stream(group)
        out, _, _ = run(sharding.shard_channels(iq, group),
                        sharding.shard_channels(RxSessionState.init(b, dev), group))
    if out.stream_valid.shape[:2] != (2, 2):
        raise RuntimeError(f"rank {rank}: outputs of shape {tuple(out.stream_valid.shape)}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m m17_sdr_tpu_torch.entry")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU through the plain versions")
    parser.add_argument("--dryrun", type=int, metavar="N",
                        help="run one sharded step over N ranks instead")
    args = parser.parse_args(argv)
    if args.cpu:
        dev = "cpu"
    elif torch.cuda.is_available():
        dev = "cuda"
    else:
        print("m17_sdr_tpu_torch.entry: no CUDA card; pass --cpu to run on the CPU",
              file=sys.stderr)
        return 1
    if args.dryrun:
        if dev == "cuda" and torch.cuda.device_count() < args.dryrun:
            print(f"m17_sdr_tpu_torch.entry: --dryrun {args.dryrun} needs {args.dryrun} "
                  f"CUDA cards, this host has {torch.cuda.device_count()}", file=sys.stderr)
            return 1
        dryrun_multichip(args.dryrun, dev)
        print(f"dryrun ok: {args.dryrun} ranks on {dev}")
        return 0
    out, _ = entry(dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    print(f"entry ok on {dev}: stream_valid {tuple(out.stream_valid.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
