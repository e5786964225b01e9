"""Each per-layer reader's arithmetic on a synthetic trace, and the
reduction of profiler events."""

from __future__ import annotations

import pytest

from portbench import cells, roofline
from portbench.tests.tiny import REPO
from portbench.tracing import DeviceOp, Span, Spans, Trace, breakdown, merge_intervals, \
    reduce_events

CARD = "NVIDIA H100 80GB HBM3"


class _Run:
    """What a reader takes from a run: 2 calls of one 1920-sample block, 64 channels."""
    channels = 64
    call_samples = 1920
    calls_traced = 2
    blocks_traced = 2.0

    def __init__(self):
        self.spans = Spans()
        self.spans.spans = [Span("feed", 0.0, 0.004, False), Span("feed", 1.0, 1.006, False),
                            Span("feed", 2.0, 2.5, True), Span("finish", 3.0, 3.25, False)]


def _trace():
    ms = 1_000_000
    ops = [DeviceOp("void at::native::elementwise_kernel<128>", 0, 3 * ms),
           DeviceOp("(anonymous namespace)::viterbi_kernel(float const*)", 3 * ms, 1 * ms),
           DeviceOp("(anonymous namespace)::receiver_scan_kernel(float)", 5 * ms, 2 * ms),
           DeviceOp("Memcpy HtoD (Pinned -> Device)", 8 * ms, 1 * ms),
           DeviceOp("Memset (Device)", 9 * ms, ms // 2)]
    iv = merge_intervals(ops)
    return Trace(ops, [("call", 0, 10 * ms)], 0.020, sum(b - a for a, b in iv) / 1e9,
                 iv, 0, 20 * ms)


def _read(name, trace=None):
    cell = cells.load_cell(REPO, "m17_northstar4096.session_voice")
    ctx = {"run": _Run(), "trace": trace, "card": CARD, "roofline": roofline}
    return cells.metric_reader(cell, name)(ctx)


def test_merge_and_busy():
    tr = _trace()
    assert tr.intervals == [(0, 4_000_000), (5_000_000, 7_000_000), (8_000_000, 9_500_000)]
    assert tr.busy_s == pytest.approx(0.0075)


def test_span_metrics():
    # the traced span is left out while untraced ones exist
    assert _read("feed_ms_per_block") == pytest.approx(5.0)
    assert _read("finish_ms_per_session") == pytest.approx(250.0)


def test_device_metrics():
    tr = _trace()
    assert _read("launches_per_block", tr) == pytest.approx(3 / 2)
    assert _read("glue_device_ms_per_block", tr) == pytest.approx(1.5)
    assert _read("device_idle_share", tr) == pytest.approx(1 - 0.0075 / 0.020)
    k1 = roofline.bound_s(roofline.k1_work(64, 1920), CARD)
    assert _read("k1_roofline", tr) == pytest.approx(100 * 2 * k1 / 0.001)
    k2 = roofline.bound_s(roofline.k2_work(64, 1920), CARD)
    assert _read("k2_roofline", tr) == pytest.approx(100 * 2 * k2 / 0.002)


def test_nothing_to_read_gives_nothing():
    for name in ("launches_per_block", "glue_device_ms_per_block", "k1_roofline",
                 "k2_roofline", "device_idle_share"):
        assert _read(name, None) is None
    empty = Trace([], [], 1.0, 0.0, [], 0, 0)
    for name in ("k1_roofline", "k2_roofline", "device_idle_share", "launches_per_block"):
        assert _read(name, empty) is None


def test_work_from_shapes():
    # one block at B=4096: 3 slots, 12288 trellises a decode (PERF.md's K1 row)
    nbytes, ops = roofline.k1_work(4096, 1920)
    assert nbytes == pytest.approx(sum(12288 * (8 * t + t + 4) for t in (244, 148, 210, 205)))
    assert ops == 68 * 12288 * (244 + 148 + 210 + 205)
    assert roofline.frame_slots(24960) == 15
    nbytes, ops = roofline.k2_work(4096, 1920)
    assert nbytes == 4096 * 384 * 12 + 2 * 4096 * roofline.K2_STATE_BYTES
    assert roofline.bound_s((1.0, 1.0), "unknown card") is None


class _Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def test_reduce_events_and_breakdown():
    evs = [_Ev("call", "DeviceType.CPU", 0, 100), _Ev("aten::add", "DeviceType.CPU", 1, 5),
           _Ev("call", "DeviceType.CUDA", 10, 80),       # the range's device-side copy
           _Ev("k_a", "DeviceType.CUDA", 10, 20), _Ev("k_b", "DeviceType.CUDA", 50, 10),
           _Ev("k_a", "DeviceType.CUDA", 70, 20)]
    tr = reduce_events(evs, {"call"}, 1e-7)
    assert [o.name for o in tr.ops] == ["k_a", "k_b", "k_a"]
    assert tr.busy_s == pytest.approx(50e-9)
    assert tr.host == [("call", 0, 100)]
    bd = breakdown(tr)
    assert bd["device_ops"][0] == ["k_a", pytest.approx(40e-9)]
    assert bd["idle_gaps"][0] == ["call", pytest.approx(20e-9)]
    assert len(bd["idle_gaps"]) == 4
