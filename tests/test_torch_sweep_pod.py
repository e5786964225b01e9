"""The port's pod-scale sweep (m17_sdr_tpu_torch/tools/sweep_pod.py) on 2
gloo ranks on the CPU, at 32 channels x 4 points x 4 frames, against the
JAX tool (tools/sweep_pod.py) and its record (SWEEP_POD_r5.json).

The tool must write the JAX document's keys, find the sharded counters
equal to the unsharded ones and the totals equal to their sums.  The JAX
tool's steps live inside its ``main()``; its counters come from
``bert_sweep_counts``, composed here at the same size.  The two packages
draw their noise differently (``jax.random`` keys against the port's
per-channel ``torch.Generator``s), so the curves are compared only where
the noise cannot move a count: at this size (4 frames a channel) frame
recovery still depends on the draw at 20 and 24 dB (JAX's and the
port's bert_sweep_counts read 20-29 of 32 frames at 20 dB and 31-32 at 24
over seeds 0-3), and reads all 32 with no bit error at 28 dB and above.
So the sweep spans 8-38 dB, and its 28 and 38 dB rows must equal JAX's.
"""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m17_sdr_tpu.pipeline import ber_sweep as jbs
from m17_sdr_tpu_torch import _build
from m17_sdr_tpu_torch.tools import sweep_pod as sp

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "SWEEP_POD_r5.json").read_text())
ARGS = ["--channels", "32", "--points", "4", "--frames", "4", "--snr-min", "8",
        "--snr-max", "38", "--devices", "2", "--device", "cpu"]
CLEAN_DB = 28.0          # points at or above it: every frame recovered, whatever the draw


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(exit code, the document, stdout) of one CLI run."""
    out = tmp_path_factory.mktemp("sweep_pod") / "doc.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = sp.main(ARGS + ["--out", str(out)])
    return rc, json.loads(out.read_text()), buf.getvalue()


def test_document_has_the_jax_keys_and_agrees(run):
    rc, doc, _ = run
    assert rc == 0
    assert set(doc) == set(RECORD) | {"device", "kernel_launches"}
    assert set(doc["mesh"]) == set(RECORD["mesh"])
    assert (doc["mesh"]["devices"], doc["mesh"]["backend"], doc["device"]) == (2, "gloo", "cpu")
    assert (doc["channels"], doc["snr_points"], doc["channels_per_point"],
            doc["frames_per_channel"]) == (32, 4, 8, 4)
    assert doc["sharded_equals_unsharded"] is True and doc["totals_equal_sums"] is True
    assert doc["sharded_elapsed_s"] > 0 and doc["unsharded_elapsed_s"] > 0
    zero = {"m17_viterbi_decode": 0, "m17_receiver_scan": 0, "m17_front_end": 0,
            "m17_equalize": 0, "m17_compact": 0}
    assert doc["kernel_launches"] == {"sharded": zero, "unsharded": zero}


def test_curve_rows_recompute(run):
    _, doc, _ = run
    assert [set(r) for r in doc["curve"]] == [set(RECORD["curve"][0])] * 4
    assert [r["snr_db"] for r in doc["curve"]] == [8.0, 18.0, 28.0, 38.0]
    for r in doc["curve"]:
        assert r["frames_sent"] == 32
        assert r["frame_recovery"] == round(r["frames_recovered"] / 32, 4)
        assert r["ber"] == (round(r["bit_errors"] / r["bits"], 6) if r["bits"] else 1.0)
    totals = doc["totals_psum"]
    assert totals[0] == sum(r["bit_errors"] for r in doc["curve"])
    assert totals[1] == sum(r["bits"] for r in doc["curve"])
    assert totals[3] == sum(r["frames_recovered"] for r in doc["curve"])


def test_clean_points_equal_jax(run):
    """Rows at CLEAN_DB and above against JAX's ``bert_sweep_counts`` on
    the same channels (the JAX tool's per-channel keys); the noise draws
    differ, so only these rows can be held equal."""
    _, doc, _ = run
    rows = [(i, r) for i, r in enumerate(doc["curve"]) if r["snr_db"] >= CLEAN_DB]
    assert len(rows) == 2
    keys = jax.random.split(jax.random.PRNGKey(0), 32)
    snr = jnp.asarray(np.repeat(np.float32([r["snr_db"] for _, r in rows]), 8))
    sel = np.concatenate([np.arange(8 * i, 8 * i + 8) for i, _ in rows])
    err, bits, _, frames = (np.asarray(x).reshape(2, 8)
                            for x in jbs.bert_sweep_counts(keys[sel], snr, 4))
    args = SimpleNamespace(channels=16, points=2, frames=4)
    want = sp.curve(args, np.float32([r["snr_db"] for _, r in rows]),
                    {"err": err, "bits": bits, "frames": frames})
    assert [r for _, r in rows] == want
    assert all(r["frames_recovered"] == 32 and r["bit_errors"] == 0 for r in want)


def test_prints_the_jax_lines(run):
    _, doc, out = run
    lines = out.strip().splitlines()
    assert lines[:4] == [f"snr={r['snr_db']:5.2f} ber={r['ber']:.5f} "
                         f"recovery={r['frame_recovery']:.3f}" for r in doc["curve"]]
    assert lines[4].startswith("sharded==unsharded: True -> ")


def _fake_sweep(monkeypatch, unsharded_frames_delta: int, totals_delta: int):
    counts = {"err": np.zeros(32, np.int32), "bits": np.full(32, 197, np.int32),
              "uns": np.zeros(32, np.int32), "frames": np.ones(32, np.int32)}
    totals = np.array([0, 197 * 32 + totals_delta, 0, 32], np.int64)
    sharded = dict(counts, totals=totals, elapsed=np.array([1.0]),
                   launches=np.zeros(len(_build.KERNELS)))
    ref = dict(counts, frames=counts["frames"] + unsharded_frames_delta)
    monkeypatch.setattr(sp, "sharded", lambda args, snr: sharded)
    monkeypatch.setattr(sp, "unsharded", lambda args, snr: (ref, 1.0, {}))


@pytest.mark.parametrize("frames_delta, totals_delta, rc", [(0, 0, 0), (1, 0, 1), (0, 1, 1)])
def test_exit_code_follows_the_two_checks(monkeypatch, capsys, frames_delta, totals_delta, rc):
    _fake_sweep(monkeypatch, frames_delta, totals_delta)
    assert sp.main(ARGS) == rc
    io_ = capsys.readouterr()
    assert "(no --out: not written)" in io_.out
    assert ("error: sharded equals unsharded" in io_.err) == bool(rc)


def test_arguments_are_checked(monkeypatch):
    with pytest.raises(SystemExit):
        sp.main(["--channels", "30", "--points", "4", "--device", "cpu"])
    with pytest.raises(SystemExit):
        sp.main(["--channels", "32", "--points", "4", "--devices", "3", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit):          # nccl takes one card a rank
        sp.main(["--channels", "32", "--points", "4", "--devices", "2"])


def test_device_cuda_without_card_exits_1(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sp.main([]) == 1
    assert sp.main(["--devices", "1", "--out", str(tmp_path / "doc.json")]) == 1
    assert not (tmp_path / "doc.json").exists()
    assert "no CUDA device" in capsys.readouterr().err
