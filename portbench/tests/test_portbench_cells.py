"""Discovery by name, and BENCHMARK.json against the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from portbench import cells
from portbench.tests.tiny import REPO, make_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_loads_by_name(w):
    cell = cells.load_cell(REPO, w["name"])
    assert cells.entry_module(cell).window
    names = {m["name"].split(".")[0] for m in cell.end_to_end()}
    assert names == {"setup_s", "realtime_channels"}
    layer = cell.per_layer()
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        assert callable(cells.metric_reader(cell, m["name"]))
    assert cell.limits["limits"]["decoded_mismatches"] == 0


def test_names_units_and_lengths():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end" and group != "per_layer":
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for m in BENCH["per_layer"]:
        assert m["moves"].startswith("realtime_channels")
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
        assert 1 <= len(m["layer"]) <= 200
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    cells_ = {w["name"] for w in BENCH["workloads"]}
    for w in cells_:     # every cell reports set-up and one more end-to-end metric
        reported = [m["name"] for m in BENCH["end_to_end"] if w in m.get("workloads", [w])]
        assert "setup_s" in reported and len(reported) >= 2
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_hold_what_they_state():
    for c in BENCH["configs"]:
        f = json.loads((REPO / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_a_cell_is_added_with_files_alone(tmp_path):
    """A new configuration, signal, mix, metric and cell: new files and new
    entries only; the harness finds them all by name and runs the cell."""
    import time

    from portbench import harness

    root = make_root(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "tiny_session_voice.json").read_text())
    (pb / "configs" / "dummy_config.json").write_text(
        json.dumps(dict(cfg, name="dummy_config", channels=6)))
    (pb / "signals" / "dummy_signal.py").write_text(
        "import torch\n\n\ndef build(mix, config, seed, device):\n"
        "    b, t = config['channels'], config['block_samples']\n"
        "    return torch.full((b, 2, 2, t), int(mix['level']), dtype=torch.int16,"
        " device=device)\n")
    mix = json.loads((pb / "traffic" / "tiny_session_voice.json").read_text())
    (pb / "traffic" / "dummy_mix.json").write_text(
        json.dumps(dict(mix, signal="dummy_signal", level=3)))
    (pb / "limits" / "dummy_config.dummy_mix.json").write_text(
        (pb / "limits" / "tiny.session_voice.json").read_text())
    (pb / "metrics" / "dummy_metric.py").write_text(
        "def read(ctx):\n    return 42.0 if ctx['trace'] is None else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_config", "source": "test",
                             "file": "portbench/configs/dummy_config.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy_config.dummy_mix", "config": "dummy_config",
                               "traffic": "dummy_mix", "chips": 1, "why": "test"})
    rate = next(m for m in bench["end_to_end"] if m["name"] == "realtime_channels")
    rate["workloads"].append("dummy_config.dummy_mix")
    bench["per_layer"].append({"name": "dummy_metric", "unit": "x", "better": "lower",
                               "source": "program_counter", "layer": "dummy",
                               "moves": "realtime_channels",
                               "workloads": ["dummy_config.dummy_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load_cell(root, "dummy_config.dummy_mix")
    assert cell.config["channels"] == 6 and cell.traffic["signal"] == "dummy_signal"
    assert [m["name"] for m in cell.per_layer()] == ["dummy_metric"]
    assert cells.entry_module(cell).__name__ == "portbench.entries.resident"
    sig = cells.signal_builder(cell)(cell.traffic, cell.config, 1, "cpu")
    assert sig.shape == (6, 2, 2, cfg["block_samples"]) and int(sig[0, 0, 0, 0]) == 3
    r = harness.execute(cell, 1, 0.1, True, "cpu", time.perf_counter(), log=lambda m: None)
    assert r["correct"] is True and r["metrics"] == {"dummy_metric": {"value": 42.0,
                                                                      "unit": "x"}}
    with pytest.raises(KeyError):
        cells.load_cell(root, "no.such_cell")
