"""The port's headline bench (m17_sdr_tpu_torch/bench.py) against the JAX
bench (bench.py), at B=64 on the CPU.

The JAX bench's steps are closures inside its ``main()``, so they are
composed here from the same JAX functions in the same way, on the same
numpy inputs.  Tolerances: the bench session within BENCH_LSB of JAX's
(the port's TX rounds differently in the last float32 bits,
tests/test_torch_tx.py); the Viterbi step's bits exactly, its metric to
VIT_RTOL; the headline call's integer, bool and byte fields exactly,
float fields to tests/torch_parity.py's tolerances.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_outputs_match, assert_same, assert_states_match

from m17_sdr_tpu.fec.viterbi_pallas import viterbi_decode_pallas
from m17_sdr_tpu.pipeline import benchdata as jbench
from m17_sdr_tpu.pipeline import rx as jrx
from m17_sdr_tpu_torch import bench as pb
from m17_sdr_tpu_torch.pipeline import benchdata as tbench

torch.set_num_threads(2)
B = 64
SESSION_SAMPLES = 24960
BENCH_LSB = 8            # int16 bench mix, port vs JAX (tests/test_torch_tx.py)
VIT_RTOL = 1e-5
RECORD = json.loads((Path(__file__).resolve().parents[1] / "BENCH_r05.json").read_text())["parsed"]


@pytest.fixture(scope="module")
def jax_session() -> np.ndarray:
    """JAX's bench session at B=64: its 13 blocks end to end, [64, 2, 24960] int16."""
    blocks, nblk = jbench.make_bench_blocks(B, 1920)
    assert nblk == 13
    return np.concatenate([np.asarray(b) for b in blocks], axis=-1)


@pytest.fixture(scope="module")
def small_run():
    """The whole bench at B=64 on the CPU, cut to two one-call headline
    reps, one per-block rep and two Viterbi calls a loop."""
    return pb.run(B, "cpu", reps=2, rep_s=0.0, ab_reps=1, vit_calls=2)


@jax.jit
def jax_vit_step(soft, prev_metric):
    """The JAX bench's ``vit_step``, its Pallas kernel in interpret mode."""
    s = soft + jnp.where(prev_metric[:1] > 1e30, 1.0, 0.0)
    return viterbi_decode_pallas(s, return_metric=True, interpret=True)


def test_bench_session_matches_jax(jax_session):
    blocks, nblk = tbench.make_bench_blocks(B, 1920, device="cpu")
    session = torch.cat(blocks, dim=-1)
    assert nblk == 13
    assert session.dtype == torch.int16 and session.shape == jax_session.shape == (B, 2, 24960)
    assert np.abs(session.numpy().astype(np.int32) - jax_session).max() <= BENCH_LSB


def test_viterbi_step_matches_jax():
    soft = pb.viterbi_input(B, "cpu")
    want_soft = np.random.default_rng(1).normal(size=(B, 296)).astype(np.float32)
    np.testing.assert_array_equal(soft.numpy(), want_soft)
    # viterbi_rate's last call, after its warm call and 3 chained calls
    _, bits_t, m_t = pb.viterbi_rate(soft, vit_calls=3, loops=1)
    m_j = jnp.zeros(B, jnp.float32)
    for _ in range(4):
        bits_j, m_j = jax_vit_step(jnp.asarray(want_soft), m_j)
    assert bits_t.shape == (B, 148)
    assert_same("bits", bits_t, np.asarray(bits_j))
    assert_same("metric", m_t, np.asarray(m_j), rtol=VIT_RTOL, atol=0.0)


def test_headline_call_matches_jax(jax_session):
    """The headline's call (its warm call, one whole session from a fresh
    state) on JAX's session, against JAX's ``rx_block`` on it."""
    head = pb.headline(torch.as_tensor(jax_session), reps=1, rep_s=0.0)
    out_j, st_j = jrx.rx_block(jnp.asarray(jax_session), jrx.RxSessionState.init(B))
    assert_outputs_match(head.out, out_j)
    assert_states_match(head.state, st_j)
    assert np.asarray(out_j.stream_valid).sum() > 0
    assert head.calls == [1] and len(head.rates) == len(head.seconds) == 1
    assert head.rates[0] == pytest.approx(B * SESSION_SAMPLES / head.seconds[0], rel=1e-12)


def test_document_keys_and_rates(small_run):
    doc = small_run.doc
    assert set(doc) == set(RECORD)
    assert set(RECORD["config"]) - {"rejected_attempt_rates"} <= set(doc["config"])
    cfg = doc["config"]
    assert doc["metric"] == f"rx_pipeline_channel_samples_per_s_per_chip_b{B}"
    assert (doc["unit"], doc["receiver"], doc["phase_probes"]) == ("samples/s", "plain", [])
    assert (cfg["block_samples"], cfg["hal_blocks_per_call"], cfg["sync"]) == (
        SESSION_SAMPLES, 13, "per_call")
    assert cfg["device"] == {"name": "cpu", "name_power_limit": None}
    assert cfg["kernel_launches"] == {"m17_viterbi_decode": 0, "m17_receiver_scan": 0,
                                      "m17_front_end": 0, "m17_equalize": 0,
                                      "m17_compact": 0}
    # rep_rates, calls_per_rep and rep_seconds are aligned, ascending in rate
    rates, calls, secs = cfg["rep_rates"], cfg["calls_per_rep"], cfg["rep_seconds"]
    assert len(rates) == len(calls) == len(secs) == 2 and rates == sorted(rates)
    for r, c, s in zip(rates, calls, secs):
        assert r == round(B * SESSION_SAMPLES * c / s)
    assert doc["value"] == rates[1]          # the median of two: the upper one
    assert doc["vs_baseline"] == round(small_run.headline.rates[1]
                                       / pb.REFERENCE_RX_SAMPLES_PER_S, 2)
    assert cfg["implied_input_read_gbps"] == round(small_run.headline.rates[1] * 4 / 1e9, 1)
    assert set(doc["ab_t1920"]) == {"plain"}
    assert 0 < doc["ab_t1920"]["plain"]["min"] == doc["ab_t1920"]["plain"]["med"]
    assert doc["viterbi_vs_baseline"] == round(
        doc["viterbi_frames_per_s"] / pb.REFERENCE_VITERBI_FRAMES_PER_S, 1)
    assert small_run.vit_bits.shape == (pb.VIT_BATCH, 148)


def test_roofline_guard_refuses_super_physical_rate(monkeypatch, capsys):
    roof_rate = pb.HBM_ROOF_GBPS * 1e9 / 4        # channel-samples/s at the roof
    assert pb.roof_error([roof_rate * 0.99] * 5) is None
    assert pb.roof_error([roof_rate * 0.5, roof_rate * 2, roof_rate * 2]) is not None
    # one rep over the roof is refused, even with the median under it
    assert pb.roof_error([roof_rate * 0.5, roof_rate * 0.5, roof_rate * 1.2]) is not None

    def fake_headline(session, reps=pb.REPS, rep_s=pb.REP_S):
        rates = [roof_rate * k for k in (0.9, 1.5, 1.6, 1.7, 1.8)]    # median 1.6x the roof
        return pb.Headline(rates, [1] * 5, [B * SESSION_SAMPLES / r for r in rates], rep_s,
                           None, None)

    monkeypatch.setattr(pb, "headline", fake_headline)
    monkeypatch.setattr(pb, "ab_t1920", lambda blocks, **kw: {"plain": {"min": 1, "med": 1}})
    monkeypatch.setattr(pb, "viterbi_rate",
                        lambda soft, **kw: (1.0, torch.zeros(1), torch.zeros(1)))
    assert pb.main([str(B), "--device", "cpu"]) == 1
    io = capsys.readouterr()
    assert "roofline guard" in io.err
    assert "metric" not in io.out


def test_device_cuda_without_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pb.main([str(B)]) == 1
    assert pb.main([str(B), "--device", "cuda"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
