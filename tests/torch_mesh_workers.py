"""Rank bodies for tests/test_torch_mesh.py, started by
``m17_sdr_tpu_torch.mesh.launch.spawn``.  They import torch, numpy and the
port only (no JAX, no conftest): each reads its jobs from an .npz the test
wrote and writes its results to ``<out>/rank<r>.npz``."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from m17_sdr_tpu_torch.convert import state_to_numpy
from m17_sdr_tpu_torch.mesh import halo, sharding
from m17_sdr_tpu_torch.pipeline.ber_sweep import pod_bert_sweep
from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream


def run_jobs(rank: int, n: int, dev, in_path: str, out_dir: str) -> None:
    """Every job whose inputs the .npz holds:

    - ``ch_blocks`` [B, NBLK, 2, T]: ``sharded_rx_stream`` on this rank's
      channels, its outputs (``ch/<field>``), final state (``ch_state/<key>``)
      and reduced metrics (``ch_metrics``); also ``replicate`` of the rank
      number (``replicated``);
    - ``fir_x`` [B, T], ``fir_taps`` [K]: ``overlap_save_conv`` on this rank's
      slab (``fir_y``);
    - ``slab<i>_blocks`` [B, NBLK, 2, T] with ``slab<i>_warmup``:
      ``time_parallel_rx`` on this rank's slab of blocks (``slab<i>/<field>``);
    - ``seq<i>_blocks`` [B, NBLK, 2, T]: the unsharded ``rx_stream`` of all
      of them from a cold state, on rank i % n only (``seq<i>/<field>``),
      the sequential references of the slabs, run beside the rest;
    - ``pod<i>_snr`` [B] with ``pod<i>_frames`` and ``pod<i>_seed`` or
      ``pod<i>_noise`` [B, 2, T]: ``pod_bert_sweep`` (``pod<i>_counts``
      [4, B/n], ``pod<i>_totals``).
    """
    with np.load(in_path) as z:
        jobs = {k: z[k] for k in z.files}
    mesh = sharding.make_mesh(n)
    group = mesh.get_group("ch")
    res = {}
    if "ch_blocks" in jobs:
        blocks = torch.as_tensor(jobs["ch_blocks"]).to(dev)
        b = blocks.shape[0]
        out, state, metrics = sharding.sharded_rx_stream(group)(
            sharding.shard_channels(blocks, group),
            sharding.shard_channels(RxSessionState.init(b, dev), group))
        res.update({f"ch/{k}": v.cpu().numpy() for k, v in out._asdict().items()})
        res.update({f"ch_state/{k}": v for k, v in state_to_numpy(state).items()})
        res["ch_metrics"] = metrics.cpu().numpy()
        res["replicated"] = sharding.replicate(torch.tensor([rank], device=dev),
                                               group).cpu().numpy()
    if "fir_x" in jobs:
        x = sharding.shard_channels(torch.as_tensor(jobs["fir_x"]).T.contiguous(), group).T
        res["fir_y"] = halo.overlap_save_conv(group, jobs["fir_taps"])(
            x.contiguous().to(dev)).cpu().numpy()
    for i in range(10):
        if f"slab{i}_blocks" not in jobs:
            break
        blocks = torch.as_tensor(jobs[f"slab{i}_blocks"])
        slab = sharding.shard_channels(blocks.transpose(0, 1), group).transpose(0, 1)
        run = halo.time_parallel_rx(group, warmup_blocks=int(jobs[f"slab{i}_warmup"]),
                                    block=blocks.shape[-1])
        out = run(slab.contiguous().to(dev))
        res.update({f"slab{i}/{k}": v.cpu().numpy() for k, v in out._asdict().items()})
    for i in range(10):
        if f"seq{i}_blocks" not in jobs:
            break
        if i % n == rank:
            blocks = torch.as_tensor(jobs[f"seq{i}_blocks"]).to(dev)
            out, _ = rx_stream(blocks, RxSessionState.init(blocks.shape[0], dev))
            res.update({f"seq{i}/{k}": v.cpu().numpy() for k, v in out._asdict().items()})
    for i in range(10):
        if f"pod{i}_snr" not in jobs:
            break
        noise = jobs.get(f"pod{i}_noise")
        seed = jobs.get(f"pod{i}_seed")
        *counts, totals = pod_bert_sweep(
            group, torch.as_tensor(jobs[f"pod{i}_snr"]).to(dev), int(jobs[f"pod{i}_frames"]),
            seed=None if seed is None else int(seed),
            noise=None if noise is None else torch.as_tensor(noise).to(dev))
        res[f"pod{i}_counts"] = torch.stack(counts).cpu().numpy()
        res[f"pod{i}_totals"] = totals.cpu().numpy()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
