"""The port's two-process demonstration
(m17_sdr_tpu_torch/tools/multihost_demo.py), as tests/test_multihost.py
drives the JAX tool: 32 channels, 4 frames, 4 SNR points, on the CPU.

The tool starts two worker processes that meet through the ``env://``
rendezvous on a port it finds free, shards the sweep's channels across
them and checks the gathered counters and the all_reduced totals against
one process running the same sweep: they must be equal, integer for
integer.
"""

import json
import pathlib
import subprocess
import sys

import torch

from m17_sdr_tpu_torch.tools import multihost_demo as mh

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_two_processes_match_single_process(tmp_path):
    out = tmp_path / "MULTIHOST.json"
    r = subprocess.run(
        [sys.executable, "-m", "m17_sdr_tpu_torch.tools.multihost_demo",
         "--channels", "32", "--frames", "4", "--points", "4", "--device", "cpu",
         "--out", str(out)],
        cwd=str(REPO), capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(out.read_text())
    assert json.loads(r.stdout.strip().splitlines()[-1])["ok"]
    assert doc["processes"] == 2 and doc["global_devices"] == 2
    assert (doc["backend"], doc["device"]) == ("gloo", "cpu")
    assert doc["processes_agree"]
    assert doc["distributed_equals_single_process"]
    assert doc["totals_equal_single_process"]
    assert doc["ok"]
    assert doc["totals_psum"][1] > 0           # bits were counted


def test_cuda_without_two_cards_exits_1(tmp_path, monkeypatch, capsys):
    """Without two cards and without --device cpu the tool exits 1, says
    why and writes nothing."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mh.main(["--channels", "32", "--points", "4"]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []
