"""The port's entry point: on the CPU only when asked, never as a silent
fallback from a missing card."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch

from m17_sdr_tpu_torch.entry import BATCH, entry

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)


def _run_module(*args: str) -> subprocess.CompletedProcess:
    # no card visible, whatever the machine has
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-m", "m17_sdr_tpu_torch.entry", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


def test_entry_runs_on_cpu():
    out, state = entry("cpu")
    assert out.stream_valid.shape == (BATCH, 3)
    assert out.stream_valid.device.type == "cpu"
    assert state.receiver.clk.shape == (BATCH,)


def test_module_runs_on_cpu_when_asked():
    r = _run_module("--cpu")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"entry ok on cpu: stream_valid ({BATCH}, 3)"


def test_module_without_card_fails():
    r = _run_module()
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr
    assert "entry ok" not in r.stdout
