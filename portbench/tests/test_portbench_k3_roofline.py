"""The front-end kernel's roofline reader on synthetic traces."""

from __future__ import annotations

import pytest

from portbench import cells, roofline
from portbench.metrics import k3_roofline
from portbench.tests.test_portbench_metrics import CARD, _Run, _trace
from portbench.tests.tiny import REPO
from portbench.tracing import DeviceOp, Trace, merge_intervals


def _read(trace):
    cell = cells.load_cell(REPO, "m17_northstar4096.session_voice")
    ctx = {"run": _Run(), "trace": trace, "card": CARD, "roofline": roofline}
    return cells.metric_reader(cell, "k3_roofline")(ctx)


def test_share_of_the_front_end_kernels_time():
    ms = 1_000_000
    ops = [DeviceOp("void (anonymous namespace)::front_end_kernel<short, false>(Params)",
                    0, ms // 10),
           DeviceOp("void (anonymous namespace)::front_end_kernel<short, false>(Params)",
                    ms, ms // 10)]
    iv = merge_intervals(ops)
    tr = Trace(ops, [], 0.002, sum(b - a for a, b in iv) / 1e9, iv, 0, 2 * ms)
    least = roofline.bound_s(k3_roofline.work(64, 1920), CARD)
    assert _read(tr) == pytest.approx(100 * 2 * least / 0.0002)


def test_work_from_shapes():
    # the main path's call: [4096, 2, 24960] int16 in, [4096, 4992] f32 out
    nbytes, ops = k3_roofline.work(4096, 24960)
    assert nbytes == 4096 * (24960 * 4 + 4992 * 4 + 4 + 1 + 2 * 37)
    assert nbytes / 3.35e12 == pytest.approx(146.6e-6, rel=1e-3)
    assert ops == 20 * 4096 * 24960


def test_no_front_end_kernel_gives_nothing():
    assert _read(None) is None
    assert _read(_trace()) is None        # the eager front end: no K3 in the trace
