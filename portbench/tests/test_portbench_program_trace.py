"""The program's stage ranges and counters as the benchmark sees them: the
reduction of profiler events keeps the ranges out of every field it had,
and ``decode_useful_share`` reads the counters."""

from __future__ import annotations

import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from m17_sdr_tpu_torch import trace
from portbench import cells, harness, roofline
from portbench.tests.test_portbench_metrics import _Ev
from portbench.tests.tiny import REPO, make_root
from portbench.tracing import Trace, reduce_events

CELLS = ("m17_northstar4096.session_voice", "m17_northstar4096.session_hunt")


def _events():
    return [_Ev("call", "DeviceType.CPU", 0, 100), _Ev("aten::add", "DeviceType.CPU", 1, 5),
            _Ev("call", "DeviceType.CUDA", 10, 80),
            _Ev("k_a", "DeviceType.CUDA", 10, 20), _Ev("k_b", "DeviceType.CUDA", 50, 10),
            _Ev("Memcpy HtoD", "DeviceType.CUDA", 65, 3), _Ev("k_a", "DeviceType.CUDA", 70, 20)]


def test_program_ranges_leave_the_trace_as_it_was():
    """The program's ranges are host ranges at function scope, with no
    device-side copy: the Trace is the one of the same events without them."""
    ranges = [_Ev("m17.rx_block", "DeviceType.CPU", 2, 90),
              _Ev("m17.front_end", "DeviceType.CPU", 3, 20),
              _Ev("m17.scan", "DeviceType.CPU", 25, 10),
              _Ev("m17.session", "DeviceType.CPU", 60, 30)]
    plain = reduce_events(_events(), {"call"}, 1e-7)
    mixed = _events()
    for i, r in enumerate(ranges):
        mixed.insert(2 * i + 1, r)
    assert reduce_events(mixed, {"call"}, 1e-7) == plain
    assert [o.name for o in plain.ops] == ["k_a", "k_b", "Memcpy HtoD", "k_a"]


def _read(tr, cell=CELLS[0]):
    ctx = {"run": None, "trace": tr, "card": "cpu", "roofline": None}
    return cells.metric_reader(cells.load_cell(REPO, cell), "decode_useful_share")(ctx)


@pytest.mark.parametrize("cell", CELLS)
def test_decode_useful_share_reads_the_counters(cell):
    tr = Trace([], [], 1.0, 0.0, [], 0, 0)
    trace.reset_counters()
    trace.count("decode.slots", 480)            # no profiler: not counted
    with profile(activities=[ProfilerActivity.CPU]):
        for frames in ([3, 0, 1, 2, 0, 0, 4, 2], [1] * 8):
            trace.count("decode.slots", 4 * 8 * 15)
            trace.count("decode.frames", torch.tensor(frames, dtype=torch.int32))
    assert _read(tr, cell) == pytest.approx(20 / 960)
    assert _read(None, cell) is None
    trace.reset_counters()
    assert _read(tr, cell) is None


def test_decode_useful_share_without_the_counters(monkeypatch):
    """A program without the tracing module (the parent of this metric)
    gives nothing."""
    monkeypatch.setitem(sys.modules, "m17_sdr_tpu_torch.trace", None)
    assert _read(Trace([], [], 1.0, 0.0, [], 0, 0)) is None


def test_traced_session_run_reports_decode_useful_share(tmp_path):
    """A tiny traced run of the resident voice cell: the share is in the
    line and is the counters' ratio over the traced call."""
    root = make_root(tmp_path)
    cell = cells.load_cell(root, "tiny.session_voice")
    cell.traffic["trace_from"] = 0                  # the window's first call, however slow
    trace.reset_counters()
    r = harness.execute(cell, 3_000_000_019, 0.2, True, "cpu", time.perf_counter(),
                        log=lambda m: None)
    c = trace.counters()
    cfg = cell.config                               # one traced call of B x F slots
    f = roofline.frame_slots(cfg["session_blocks"] * cfg["block_samples"])
    assert c["decode.slots"] == 4 * cfg["channels"] * f
    assert r["metrics"]["decode_useful_share"] == {
        "value": pytest.approx(c["decode.frames"] / c["decode.slots"]), "unit": "share"}
