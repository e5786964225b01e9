"""The compaction kernel's roofline reader on synthetic traces."""

from __future__ import annotations

import pytest

from portbench import cells, roofline
from portbench.metrics import k5_roofline
from portbench.tests.test_portbench_metrics import CARD, _Run, _trace
from portbench.tests.tiny import REPO
from portbench.tracing import DeviceOp, Trace, merge_intervals


def _read(trace, cell="m17_northstar4096.session_voice"):
    ctx = {"run": _Run(), "trace": trace, "card": CARD, "roofline": roofline}
    return cells.metric_reader(cells.load_cell(REPO, cell), "k5_roofline")(ctx)


def _work(channels, call_samples):
    return k5_roofline.work(channels, call_samples, roofline.steps, roofline.frame_slots)


def test_share_of_the_compaction_kernels_time():
    ms = 1_000_000
    ops = [DeviceOp("(anonymous namespace)::compact_kernel((anonymous namespace)::Params)",
                    0, ms // 20),
           DeviceOp("(anonymous namespace)::compact_kernel((anonymous namespace)::Params)",
                    ms, ms // 20),
           DeviceOp("void at::native::elementwise_kernel<128>", 2 * ms, ms)]
    iv = merge_intervals(ops)
    tr = Trace(ops, [], 0.003, sum(b - a for a, b in iv) / 1e9, iv, 0, 3 * ms)
    least = roofline.bound_s(_work(64, 1920), CARD)
    assert _read(tr) == pytest.approx(100 * 2 * least / 0.0001)
    assert _read(tr, "m17_autoeq16384.session_isi") == _read(tr)


@pytest.mark.parametrize("channels, mb, us", [(4096, 217.48, 64.92), (16384, 869.91, 259.67)])
def test_work_from_shapes(channels, mb, us):
    # the cells' call: 24960 samples, S2 = 4992 steps, F = 15 frame slots
    nbytes, ops = _work(channels, 24960)
    assert nbytes == channels * (4992 * 8 + 191 * 8 + 15 * 192 * 4 + 15 * 7 + 6)
    assert nbytes / 1e6 == pytest.approx(mb, abs=0.01)
    assert roofline.bound_s((nbytes, ops), CARD) == pytest.approx(us * 1e-6, abs=1e-8)
    assert ops == 0.0


def test_no_compaction_kernel_gives_nothing():
    assert _read(None) is None
    assert _read(_trace()) is None        # the eager compaction: no K5 in the trace
