"""The port's IQ-domain BER-parity harness (m17_sdr_tpu_torch.pipeline.
ber_parity_iq) against the JAX package's, on the same inputs.

``make_iq_wire`` is given the noise JAX draws (jax.random.normal with
the point's key, shaped as the session's IQ), so the two wires differ
only by the TX: the port's modulator phase differs from JAX's by a few
float32 ulps, which moves a sample across an int16 rounding boundary
now and then (measured: at most 1 LSB, on about 3 % of the samples).
The payloads are equal.  The decode is held exactly on JAX's own wire:
every routed stream payload, keyed by channel and FN.  The port runs
its plain path on the CPU.
"""

from __future__ import annotations

import json
import re
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from m17_sdr_tpu.pipeline import ber_parity_iq as j_biq
from m17_sdr_tpu_torch.pipeline import ber_parity as t_bp
from m17_sdr_tpu_torch.pipeline import ber_parity_iq as t_biq

torch.set_num_threads(2)
NCH, NF, SEED = 4, 12, 5
WIRE_LSB = 1             # port wire vs JAX wire on the same noise, int16 LSB


def _jax_noise(seed: int, wire: np.ndarray) -> torch.Tensor:
    """The unit-variance noise JAX's make_iq_wire draws: [nch, 2, nsamp]."""
    nch, nsamp, _ = wire.shape
    return torch.as_tensor(np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                                      (nch, 2, nsamp))))


@pytest.mark.parametrize("offset_hz", [0.0, 300.0])
def test_make_iq_wire_near_jax(offset_hz):
    wire_j, pay_j = j_biq.make_iq_wire(NCH, NF, 15.0, seed=SEED, freq_offset_hz=offset_hz)
    wire_t, pay_t = t_biq.make_iq_wire(NCH, NF, 15.0, seed=SEED, freq_offset_hz=offset_hz,
                                       noise=_jax_noise(SEED, wire_j), device="cpu")
    np.testing.assert_array_equal(pay_t, pay_j)
    assert wire_t.shape == wire_j.shape and wire_t.dtype == wire_j.dtype == np.int16
    lsb = np.abs(wire_t.astype(np.int32) - wire_j.astype(np.int32)).max()
    assert lsb <= WIRE_LSB, lsb


def test_make_iq_wire_generator():
    """Without a noise tensor the draws come from a generator seeded with
    the seed: the same seed gives the same wire, another seed another."""
    a, _ = t_biq.make_iq_wire(2, 4, 18.0, seed=1, device="cpu")
    b, _ = t_biq.make_iq_wire(2, 4, 18.0, seed=1, device="cpu")
    c, _ = t_biq.make_iq_wire(2, 4, 18.0, seed=2, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("snr_db, offset_hz", [(15.0, 0.0), (20.0, 300.0)])
def test_iq_decodes_equal(snr_db, offset_hz):
    wire, payloads = j_biq.make_iq_wire(NCH, NF, snr_db, seed=SEED, freq_offset_hz=offset_hz)
    got = t_biq.run_chain_iq(wire, device="cpu")
    want = j_biq.run_jax_iq(wire)
    assert got == want
    assert got.stream, "no frame routed: the comparison would be vacuous"
    assert t_bp.score(got.stream, payloads, 8) == j_biq.score(want.stream, payloads, 8)


def test_config_offsets():
    assert t_biq.config_offset_hz("awgn") == 0.0
    assert t_biq.config_offset_hz("offset300Hz") == 300.0
    with pytest.raises(ValueError):
        t_biq.config_offset_hz("fading")


def test_iq_sigma_matches_record():
    rec = json.loads((Path(__file__).resolve().parents[1] / "BER_PARITY_IQ_r5.json").read_text())
    for cfg in rec["configs"].values():
        for row in cfg["points"]:
            assert round(t_biq.iq_sigma(row["snr_db"]), 6) == row["sigma"]


CANNED = [["P 0 8 " + "5a" * 16, "P 1 8 " + "00" * 16, "P 2 9", "x P 3 10 " + "11" * 16,
           "P 4 11 " + "22" * 16 + " extra"],
          ["Sync + 0", "P 5 12 " + "a5" * 16]]


def test_reference_iq_parser_equal(monkeypatch, tmp_path):
    """run_reference_iq on canned decoder output equals the JAX one: only
    four-token P lines count, the first delivery of an FN wins."""
    def run(args, **kw):
        if args[0] == "make":
            return subprocess.CompletedProcess(args, 0, "", "")
        ch = int(re.search(r"(\d+)\.bin$", args[1]).group(1))
        return subprocess.CompletedProcess(args, 0, "\n".join(CANNED[ch]), "")

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(t_bp, "reference_dir", lambda: tmp_path)
    wire = np.zeros((2, t_biq.BLOCK, 2), np.int16)
    got = t_biq.run_reference_iq(wire, str(tmp_path), jobs=2)
    want = j_biq.run_reference_iq(wire, str(tmp_path), jobs=2)
    assert got == want
    assert got.stream == {(0, 8): bytes.fromhex("5a" * 16), (1, 12): bytes.fromhex("a5" * 16)}


def test_run_reference_iq_without_sources_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(t_bp, "reference_dir", lambda: tmp_path / "absent")
    with pytest.raises(FileNotFoundError, match="absent"):
        t_biq.run_reference_iq(np.zeros((1, t_biq.BLOCK, 2), np.int16), str(tmp_path))
