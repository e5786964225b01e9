"""The equalizer cell's pieces on the CPU: the two readers on synthetic
traces and counters, the ``isi`` signal, and a tiny twin of the cell run
whole, traced, through the harness."""

from __future__ import annotations

import json
import shutil
import time

import pytest
import torch

from portbench import cells, harness, roofline
from portbench.metrics import k4_roofline
from portbench.signals import isi, voice
from portbench.tests.test_portbench_metrics import CARD, _Run, _trace
from portbench.tests.tiny import REPO
from portbench.tracing import DeviceOp, Trace, merge_intervals

CELL = "m17_autoeq16384.session_isi"
SEED = 3_000_000_021


def _read(metric, trace, run=None):
    cell = cells.load_cell(REPO, CELL)
    ctx = {"run": run or _Run(), "trace": trace, "card": CARD, "roofline": roofline}
    return cells.metric_reader(cell, metric)(ctx)


def test_k4_share_of_the_equalizer_kernels_time():
    ms = 1_000_000
    name = "(anonymous namespace)::equalize_kernel((anonymous namespace)::Params)"
    ops = [DeviceOp(name, 0, ms // 10), DeviceOp(name, ms, ms // 10)]
    iv = merge_intervals(ops)
    tr = Trace(ops, [], 0.002, sum(b - a for a, b in iv) / 1e9, iv, 0, 2 * ms)
    least = roofline.bound_s(k4_roofline.work(64, 1920, roofline.frame_slots), CARD)
    assert _read("k4_roofline", tr) == pytest.approx(100 * 2 * least / 0.0002)


def test_k4_work_from_shapes():
    # the cell's call: 16384 channels of 24960 samples, 15 frame slots of 192 symbols
    assert roofline.frame_slots(24960) == 15
    nbytes, ops = k4_roofline.work(16384, 24960, roofline.frame_slots)
    slots = 16384 * 15
    assert nbytes == 2 * slots * 192 * 4 + slots + 2 * 16384 * 25
    assert nbytes / 3.35e12 == pytest.approx(113.0e-6, rel=1e-3)
    assert ops == 60 * 192 * slots


def test_no_equalizer_kernel_gives_nothing():
    assert _read("k4_roofline", None) is None
    assert _read("k4_roofline", _trace()) is None     # the eager equalizer: no K4


def test_armed_share_reads_the_programs_counters(monkeypatch):
    from m17_sdr_tpu_torch import trace

    assert _read("equalize_armed_share", None) is None
    monkeypatch.setattr(trace, "counters", lambda: {"equalize.slots": 60, "equalize.armed": 21})
    assert _read("equalize_armed_share", _trace()) == pytest.approx(0.35)
    monkeypatch.setattr(trace, "counters", lambda: {"decode.slots": 8})
    assert _read("equalize_armed_share", _trace()) is None   # a program without them


def _tiny(channels: int = 8) -> tuple[dict, dict]:
    cell = cells.load_cell(REPO, CELL)
    mix = dict(cell.traffic, sessions=4)
    return mix, dict(cell.config, channels=channels)


def test_isi_signal_same_seed_same_input_and_its_rate():
    mix, config = _tiny()
    a = isi.build(mix, config, SEED, "cpu")
    assert torch.equal(a, isi.build(mix, config, SEED, "cpu"))
    assert not torch.equal(a, isi.build(mix, config, SEED + 1, "cpu"))
    assert a.dtype == torch.int16 and a.shape == voice.build(mix, config, SEED, "cpu").shape
    with pytest.raises(ValueError, match="input_rate"):
        isi.build(mix, dict(config, input_rate=384_000), SEED, "cpu")


def test_isi_smear_leaves_the_session_clean_before_the_ramp():
    gen = torch.Generator().manual_seed(5)
    iq = voice.voice_sessions(2, 8, gen, "cpu")
    out = isi.smear(iq)
    n = iq.shape[-1]
    start = int(isi.RAMP[0] * n)
    assert (out[..., :start] - iq[..., :start]).abs().max() < 1e-5
    assert (out[..., start + n // 5:] - iq[..., start + n // 5:]).abs().max() > 0.5
    mag = out[:, 0] ** 2 + out[:, 1] ** 2
    assert (mag - 1).abs().max() < 1e-5


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout-like root with ``tiny.session_isi``: the cell at 8 channels
    and 4 sessions, a short window, the cell's own limits."""
    root = tmp_path_factory.mktemp("pbeq") / "bench"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "portbench"
    mix, config = _tiny()
    (pb / "configs" / "tiny_isi.json").write_text(json.dumps(config))
    (pb / "traffic" / "tiny_isi.json").write_text(json.dumps(
        dict(mix, warm_calls=0, trace_from=0, trace_calls=1)))
    lim = json.loads((pb / "limits" / f"{CELL}.json").read_text())
    lim.update(check_channels=4, chain_calls=1, check_calls=1, check_call_range=4)
    (pb / "limits" / "tiny.session_isi.json").write_text(json.dumps(lim))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_isi", "source": "tiny twin",
                             "file": "portbench/configs/tiny_isi.json",
                             "reduced": ["channels"], "why": "CPU test size"})
    bench["workloads"].append({"name": "tiny.session_isi", "config": "tiny_isi",
                               "traffic": "tiny_isi", "chips": 1, "why": "CPU test"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny.session_isi")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_tiny_cell_runs_correct_and_arms_the_equalizer(tiny_root):
    """One traced call: correct against the reference; no card here, so the
    device readers stay out of the line, and the program's counters give
    the equalizer's armed share."""
    from m17_sdr_tpu_torch import trace

    cell = cells.load_cell(tiny_root, "tiny.session_isi")
    trace.reset_counters()
    r = harness.execute(cell, SEED, 0.01, True, "cpu", time.perf_counter(), log=lambda m: None)
    assert r["correct"] is True and r["attempted"] == 1
    assert r["check"]["decoded_mismatches"]["value"] == 0
    assert set(r["metrics"]) == {"decode_useful_share", "equalize_armed_share"}
    assert 0.25 <= r["metrics"]["equalize_armed_share"]["value"] <= 0.75
