"""One run of one cell: make the input, warm up, measure, check, report.

``execute`` is the whole run after the harness has found its card; the
command line (``portbench/run.py``) adds the look for the card and the
printing.  The CPU tests call ``execute`` on a CPU device at tiny sizes.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import cells, compare, roofline
from .tracing import Profile, Spans, breakdown

# top-level module names the process must not hold once the window closes
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "m17_sdr_tpu")


class Run:
    """What the entry, the check and the metric readers share."""

    def __init__(self, cell: cells.Cell, seed: int, device, trace: bool):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.spans = Spans()
        self.profile = Profile(self.spans, self.device.type == "cuda") if trace else None
        self.config = cell.config
        self.channels = int(cell.config["channels"])
        self.calls_traced = 0          # rx_block calls under the profiler
        self.call_samples = 0          # input samples of one rx_block call, a channel
        rng = np.random.default_rng(self.seed)
        self.sample = np.sort(rng.choice(self.channels, int(cell.limits["check_channels"]),
                                         replace=False))

    @property
    def blocks_traced(self) -> float:
        """40 ms blocks of every channel's signal that the traced calls took."""
        return self.calls_traced * self.call_samples / int(self.cell.config["block_samples"])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one the
    benchmark must not load, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def card_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def per_layer(run: Run) -> dict:
    """The cell's per-layer metrics that find something to read."""
    ctx = {"run": run, "trace": run.profile.trace if run.profile else None,
           "card": card_name(run.device), "roofline": roofline}
    out = {}
    for m in run.cell.per_layer():
        value = cells.metric_reader(run.cell, m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, log=print, sampler=None, control: bool = False) -> dict:
    """The run; returns the result's fields (the last line less printing).
    ``sampler`` (start/stop) runs during the window only.  ``control``
    also puts the reference in bfloat16 in the program's place and judges
    it the same way (``_control``): the benchmark's own runs do not."""
    run = Run(cell, seed, device, trace)
    entry = cells.entry_module(cell)
    if run.device.type == "cuda":
        from m17_sdr_tpu_torch import _build
        _build.build_all()
    run.signal = cells.signal_builder(cell)(cell.traffic, cell.config, run.seed, run.device)
    entry.prepare(run)
    entry.warm(run)
    if run.profile is not None:
        run.profile.warm()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    setup_s = time.perf_counter() - t_start

    if sampler is not None:
        sampler.start()
    try:
        win = entry.window(run, seconds)
    finally:
        if sampler is not None:
            sampler.stop()

    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    if run.profile is not None:
        run.profile.reduce()
    for name in ("call_input", "blocks"):
        if hasattr(run, name):
            setattr(run, name, None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = entry.reference(run)
    numbers = entry.check(run, ref)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s for {len(run.sample)} channels; "
        f"{numbers['frames']} decoded frames compared; largest root mean square gap "
        f"{numbers['soft_rms']!r} in {numbers['rms_in']}; widest gap {numbers['soft_gap']!r} "
        f"in {numbers['widest']} (no limit)")
    correct, check = compare.verdict(numbers, cell.limits["limits"])
    ctl = None
    if control:
        low = entry.reference(run, lowp=True)
        ctl = entry.check_control(run, ref, low)

    if trace:
        metrics = per_layer(run)
    else:
        # channels kept in real time: samples at the input rate a second, a channel
        rate = win["channel_samples"] / win["elapsed_s"] / float(cell.config["input_rate"])
        # a metric is named by its quantity up to the first dot
        values = {"realtime_channels": rate, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": card_name(run.device), "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": dev}
    tr = run.profile.trace if run.profile else None
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr)
    result["check"] = check
    result["_window"] = win
    if ctl is not None:
        result["_control"] = {"numbers": ctl, "correct": compare.verdict(
            ctl, cell.limits["limits"])[0], "program": numbers}
    return result
