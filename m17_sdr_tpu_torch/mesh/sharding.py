"""Channel sharding of the modem pipelines over a process group.

Port of ``m17_sdr_tpu.mesh.sharding``.  The JAX package's scale-out axes
are ``ch`` (independent channels sharded over devices; only metric
reductions cross them) and ``time`` (a long capture split into slabs,
``mesh/halo.py``), expressed as a ``jax.sharding.Mesh`` and ``shard_map``.
Here each rank is one process that holds its own slice of the channel
axis; the mesh is a ``DeviceMesh`` whose dims are named as the JAX axes,
and the one collective on the channel path is an ``all_reduce``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..pipeline.rx import rx_stream


def _tree_map(fn, tree):
    """fn on every tensor of a (nested) NamedTuple tree, or on one tensor."""
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    return fn(tree)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n: int | None = None, axis: str = "ch") -> DeviceMesh:
    """A 1-D mesh over the first ``n`` ranks (all by default) with its dim
    named ``axis``; ``mesh.get_group(axis)`` is the group the functions
    below take."""
    return init_device_mesh(_device_type(), (n or dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def shard_channels(tree, group):
    """This rank's slice on dim 0 of every tensor of a NamedTuple tree (or
    of one tensor): rank r of n holds rows [r B/n, (r+1) B/n)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} channels do not split over {n} ranks")
        step = x.shape[0] // n
        return x[r * step:(r + 1) * step]
    return _tree_map(take, tree)


def replicate(tree, group):
    """Every tensor of the tree as the group's rank 0 holds it, on every
    rank (a broadcast from rank 0; the inputs are not written)."""
    src = dist.get_global_rank(group, 0)

    def bcast(x):
        x = x.clone()
        dist.broadcast(x, src, group=group)
        return x
    return _tree_map(bcast, tree)


def sharded_rx_stream(group, afc_enabled: bool = False):
    """Channel-sharded ``rx_stream``: fn(iq_blocks, state) on this rank's
    channels [B/n, NBLK, 2, T] -> (outputs, new state, global metrics).

    The metrics are float32 [frames, Golay errors, channels locked at the
    last block], summed over the group by one ``all_reduce``.
    """
    def run(iq_blocks, state):
        out, new_state = rx_stream(iq_blocks, state, afc_enabled=afc_enabled)
        metrics = torch.stack([
            new_state.n_frames.sum().to(torch.float32),
            new_state.golay_errors.sum().to(torch.float32),
            out.locked[:, -1].to(torch.float32).sum(),
        ])
        dist.all_reduce(metrics, group=group)
        return out, new_state, metrics

    return run
