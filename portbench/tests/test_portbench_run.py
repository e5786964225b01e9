"""Whole runs at a tiny size on the CPU: the last line's shape, the import
check, the faults that must make ``correct`` false, and the control."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import cells, compare, harness
from portbench import run as cli
from portbench.tests.tiny import REPO, make_root

SEED = 3_000_000_019          # more than 31 bits, as the driver's seeds are
MIXES = ("stream_voice", "session_voice", "session_hunt")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("pb"))


def _run(root, mix, trace=False, control=False, seed=SEED):
    cell = cells.load_cell(root, f"tiny.{mix}")
    return harness.execute(cell, seed, 0.2, trace, "cpu", time.perf_counter(),
                           log=lambda m: None, control=control)


@pytest.mark.parametrize("mix", MIXES)
def test_last_line(root, mix):
    r = _run(root, mix)
    r.pop("_window")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    rate = "realtime_channels.stream" if mix.startswith("stream") else "realtime_channels"
    assert set(r["metrics"]) == {rate, "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["check"]["decoded_mismatches"] == {"value": 0, "limit": 0}
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.loads(json.dumps(r, allow_nan=False))


@pytest.mark.parametrize("mix", ["session_voice", "session_hunt"])
def test_same_seed_same_input(root, mix):
    cell = cells.load_cell(root, f"tiny.{mix}")
    build = cells.signal_builder(cell)
    a = build(cell.traffic, cell.config, SEED, "cpu")
    b = build(cell.traffic, cell.config, SEED, "cpu")
    c = build(cell.traffic, cell.config, SEED + 1, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c) and a.shape == c.shape
    assert a.shape[0] == cell.config["channels"] and a.dtype == torch.int16


def test_voice_refuses_a_rate_it_does_not_make(root):
    cell = cells.load_cell(root, "tiny.session_voice")
    with pytest.raises(ValueError, match="input_rate"):
        cells.signal_builder(cell)(cell.traffic, dict(cell.config, input_rate=384_000),
                                   SEED, "cpu")


def test_traced_run_reports_span_metrics(root):
    # no card here: the device readers find nothing and stay out of the line
    r = _run(root, "stream_voice", trace=True)
    assert set(r["metrics"]) == {"feed_ms_per_block", "finish_ms_per_session"}


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    rc = cli.main(["--workload", "m17_northstar4096.session_voice", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("m17_sdr_tpu_torch.fake", "jaxy", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN_MODULES for m in harness.forbidden_modules())
    assert "m17_sdr_tpu_torch.fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "m17_sdr_tpu.spec", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"m17_sdr_tpu.spec", "jaxlib"} <= set(harness.forbidden_modules())


def test_a_run_loads_neither_jax_nor_the_jax_package(root):
    code = ("import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from portbench import cells, harness\n"
            "c = cells.load_cell(%r, 'tiny.session_voice')\n"
            "harness.execute(c, 7, 0.1, False, 'cpu', time.perf_counter(), log=lambda m: None)\n"
            "print(harness.forbidden_modules())") % (str(root), str(REPO), str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ---- faults planted in the timed path must make ``correct`` false


def _state_unchanged(rx):
    real = rx.rx_block

    def fault(iq, state, **kw):
        out, _ = real(iq, state, **kw)
        return out, state
    return fault


def _half_batch(rx):
    real = rx.rx_block

    def fault(iq, state, **kw):
        out, new = real(iq, state, **kw)
        h = iq.shape[0] // 2
        # the second half of the channels gets the first half's answers
        return type(out)(*(torch.cat([x[:h], x[:iq.shape[0] - h]]) for x in out)), new
    return fault


def _answer_altered(rx):
    real = rx.rx_block

    def fault(iq, state, **kw):
        out, new = real(iq, state, **kw)
        return out._replace(stream_payload=out.stream_payload ^ 1,
                            locked=out.locked ^ True), new
    return fault


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("mix", MIXES)
def test_faults_are_caught(root, mix, fault, monkeypatch):
    from m17_sdr_tpu_torch.pipeline import rx
    monkeypatch.setattr(rx, "rx_block", fault(rx))
    r = _run(root, mix)
    assert r["correct"] is False, r["check"]


def _carry_altered_at(call):
    """One call's returned state is altered (a Golay count off by 5), and
    the program carries it on: every later call is right from its state."""
    def make(rx):
        real, n = rx.rx_block, [0]

        def fault(iq, state, **kw):
            out, new = real(iq, state, **kw)
            n[0] += 1
            if n[0] == call:
                new = new._replace(golay_errors=new.golay_errors + 5)
            return out, new
        return fault
    return make


@pytest.mark.parametrize("mix", ["session_voice", "session_hunt"])
def test_the_chain_catches_a_carry_fault_no_step_sees(root, mix, monkeypatch):
    """The reference follows the window's first calls from its own state:
    a carry altered in one of them is caught although no call is checked
    alone there (``check_calls`` 0) and every later call is right from the
    program's state."""
    from m17_sdr_tpu_torch.pipeline import rx
    cell = cells.load_cell(root, f"tiny.{mix}")
    cell.limits.update(chain_calls=2, check_calls=0)
    warm = int(cell.traffic["warm_calls"])
    monkeypatch.setattr(rx, "rx_block", _carry_altered_at(warm + 2)(rx))
    r = harness.execute(cell, SEED, 5.0, False, "cpu", time.perf_counter(),
                        log=lambda m: None)
    assert r["_window"]["attempted"] >= 2
    assert r["correct"] is False and r["check"]["decoded_mismatches"]["value"] > 0


# ---- the control: the reference in bfloat16 in the program's place


@pytest.mark.parametrize("mix", MIXES)
def test_control_fails_where_the_program_passes(root, mix):
    r = _run(root, mix, control=True)
    assert r["correct"] is True
    ctl = r["_control"]
    assert ctl["correct"] is False, ctl
    limit = cells.load_cell(root, f"tiny.{mix}").limits["limits"]["soft_rms"]
    assert ctl["numbers"]["soft_rms"] > 3 * limit > 3 * r["check"]["soft_rms"]["value"]


def test_compare_counts_what_differs():
    s, nb = 3, 2
    out = {f: torch.zeros((s, nb), dtype=torch.bool).numpy() for f in compare.EXACT}
    out.update({f: torch.zeros((s, nb, 3, 4), dtype=torch.uint8).numpy()
                for f in compare.EXACT_WHERE})
    out.update({"n_slips": torch.zeros((s, nb), dtype=torch.int32).numpy(),
                "rssi": torch.ones((s, nb)).numpy(), "dc_offset": torch.ones((s, nb)).numpy(),
                "viterbi_metric": torch.ones((s, nb, 3)).numpy(),
                "stream_quality": torch.ones((s, nb, 3)).numpy()})
    for f in ("stream_valid", "lsf_valid", "packet_valid", "bert_valid"):
        out[f] = torch.ones((s, nb, 3), dtype=torch.bool).numpy()
    state = {"receiver/flock": torch.ones(s, dtype=torch.bool).numpy(),
             "frontend/rssi": torch.ones(s).numpy()}
    prog = {k: v.copy() for k, v in out.items()}
    assert compare.compare(prog, out, state, state)["decoded_mismatches"] == 0
    prog["stream_payload"][1, 0, 2, 3] ^= 1
    prog["rssi"][2, 1] = 1.5
    r = compare.compare(prog, out, state, state)
    assert r["decoded_mismatches"] == 1 and r["soft_gap"] == pytest.approx(0.5)
    # one element of six off by 0.5 of the largest magnitude
    assert r["soft_rms"] == pytest.approx(0.5 / 6 ** 0.5) and r["rms_in"] == "rssi"
