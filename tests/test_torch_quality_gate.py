"""The port's quality-gate harness (m17_sdr_tpu_torch.tools.quality_gate)
against the JAX tool's (tools/quality_gate.py), at small sizes.

``score``, ``tally`` and ``gate_ok`` on hand-built inputs with known
answers, ``score`` and the re-anchor runs also against loop versions
written as the JAX tool's closures are; each regime builder against the
JAX tool's own lines on the same inputs at 4 channels x 4 frames: the
soft waves bit for bit (numpy in both), the IQ wires within IQ_ATOL, the
port's TX tolerance against JAX's (tests/test_torch_tx.py).  The
record-size replay of QUALITY_GATE_r5.json is in
tests/test_torch_quality_gate_record.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from m17_sdr_tpu.dsp import channel as j_ch
from m17_sdr_tpu.pipeline import ber_parity as j_bp
from m17_sdr_tpu_torch.dsp import channel as t_ch
from m17_sdr_tpu_torch.tools import quality_gate as qg
from torch_parity import jax_offset_drift_wire, jax_pluto_wire

torch.set_num_threads(2)
NCH, NF, SEED = 4, 4, 0
IQ_ATOL = 2e-4            # the port's TX against JAX's, planar IQ at unit amplitude


class Out(NamedTuple):
    """The stream fields of an RX output that ``score`` reads."""

    stream_valid: torch.Tensor
    stream_gate: torch.Tensor
    stream_fn: torch.Tensor
    stream_quality: torch.Tensor
    stream_lich_ok: torch.Tensor
    stream_fn_ok: torch.Tensor
    stream_payload: torch.Tensor


def random_out(nch: int, nblk: int, nf: int, seed: int):
    """A random RX output [nch, nblk, 3] whose valid slots decode FNs
    0..nf+1 (so some misframes) with payloads near or far from those sent,
    and the payloads sent."""
    rng = np.random.default_rng(seed)
    sent = rng.integers(0, 256, (nch, nf, 16), dtype=np.uint8)
    shape = (nch, nblk, 3)
    fn = rng.integers(0, nf + 2, shape)
    flips = np.where(rng.random(shape + (16,)) < 0.1, rng.integers(0, 256, shape + (16,)), 0)
    pl = (sent[np.arange(nch)[:, None, None], np.minimum(fn, nf - 1)] ^ flips).astype(np.uint8)
    out = Out(torch.as_tensor(rng.random(shape) < 0.6), torch.as_tensor(rng.random(shape) < 0.5),
              torch.as_tensor(fn), torch.as_tensor(rng.random(shape).astype(np.float32)),
              torch.as_tensor(rng.random(shape) < 0.8), torch.as_tensor(rng.random(shape) < 0.8),
              torch.as_tensor(pl))
    return out, sent


def score_loop(out, payloads, nf):
    """The JAX tool's ``score`` closure, row by row."""
    nch = payloads.shape[0]
    sv = out.stream_valid.reshape(nch, -1).numpy()
    gate = out.stream_gate.reshape(nch, -1).numpy()
    fn = out.stream_fn.reshape(nch, -1).numpy()
    plx = out.stream_payload.reshape(nch, -1, 16).numpy()
    q = out.stream_quality.reshape(nch, -1).numpy()
    lok = out.stream_lich_ok.reshape(nch, -1).numpy()
    fok = out.stream_fn_ok.reshape(nch, -1).numpy()
    rows = []
    for c in range(nch):
        for j in np.nonzero(sv[c])[0]:
            f = int(fn[c, j])
            e = 999 if f >= nf else int(np.unpackbits(plx[c, j] ^ payloads[c, f]).sum())
            rows.append((float(q[c, j]), bool(gate[c, j]), e, bool(lok[c, j]),
                         bool(fok[c, j]), c))
    return rows


def test_score_hand_built():
    sent = np.zeros((2, 4, 16), np.uint8)
    sent[1, 2, 0] = 0xFF
    valid = torch.zeros(2, 2, 3, dtype=torch.bool)
    fn = torch.zeros(2, 2, 3, dtype=torch.int64)
    pl = torch.zeros(2, 2, 3, 16, dtype=torch.uint8)
    q = torch.zeros(2, 2, 3)
    valid[1, 0, 2], fn[1, 0, 2], q[1, 0, 2] = True, 2, 0.5     # 0xFF sent, 0x0F got: 4 errors
    pl[1, 0, 2, 0] = 0x0F
    valid[0, 1, 0], fn[0, 1, 0], q[0, 1, 0] = True, 4, 0.75    # FN 4 >= nf: a misframe
    valid[0, 0, 1], fn[0, 0, 1], q[0, 0, 1] = True, 3, 0.25    # clean
    fn[0, 0, 0] = 9                                            # not delivered: not scored
    gate = torch.zeros_like(valid)
    gate[0, 0, 1] = True
    lok, fok = valid.clone(), torch.ones_like(valid)
    fok[0, 1, 0] = False
    rows = qg.score(Out(valid, gate, fn, q, lok, fok, pl), sent, nf=4)
    assert rows == [(0.25, True, 0, True, True, 0), (0.75, False, 999, True, False, 0),
                    (0.5, False, 4, True, True, 1)]


@pytest.mark.parametrize("seed", [1, 2])
def test_score_matches_loop(seed):
    out, sent = random_out(nch=5, nblk=4, nf=6, seed=seed)
    rows = qg.score(out, sent, nf=6)
    assert rows == score_loop(out, sent, nf=6)
    assert any(r[2] == 999 for r in rows) and any(0 < r[2] < 999 for r in rows)


def row(q=0.95, gate=True, e=0, lok=True, fok=True, c=0):
    return (q, gate, e, lok, fok, c)


def test_tally_buckets_and_empty_garbage():
    rows = [row(e=0, q=0.97), row(e=1, q=0.93), row(e=32, q=0.91, gate=False),
            row(e=0, q=0.99, c=1)]
    r = qg.tally(rows)
    assert (r["delivered"], r["clean"], r["degraded"], r["garbage"]) == (4, 2, 2, 0)
    assert r["degraded_admitted"] == 1
    assert r["garbage_quality_ceiling"] is None
    assert r["clean_quality_floor"] == 0.97
    assert r["full_gate"] == {"false_accept": 0, "false_accept_rate": None, "admitted": 3,
                              "garbage_frac_of_admitted": 0.0, "false_reject": 0,
                              "false_reject_rate": 0.0}
    assert r["reject_attribution"]["false_anchors"] == 0
    assert "reanchor_frames_lost_mean" not in r["reject_attribution"]

    r = qg.tally([row(e=33, q=0.5, gate=False), row(e=999, q=0.123456, gate=False)])
    assert (r["clean"], r["degraded"], r["garbage"]) == (0, 0, 2)
    assert r["clean_quality_floor"] is None and r["garbage_quality_ceiling"] == 0.5
    assert r["quality_threshold_only"]["false_reject_rate"] is None
    assert r["quality_threshold_only"]["garbage_frac_of_admitted"] is None

    r = qg.tally([])
    assert r["delivered"] == 0 and r["clean_quality_floor"] is None


def test_tally_false_anchor_then_two_lost_clean_frames():
    rows = [row(c=0),
            row(e=60, q=0.93, gate=False, c=0),       # false anchor: garbage above 0.9
            row(fok=False, gate=False, c=0),          # lost 1
            row(e=5, fok=False, gate=False, c=0),     # degraded: skipped
            row(fok=False, gate=False, c=0),          # lost 2
            row(c=0),                                 # the window passes again
            row(fok=False, gate=False, c=0),          # after the run: not counted
            row(e=60, q=0.85, gate=False, c=1),       # garbage below 0.9: no anchor
            row(fok=False, gate=False, c=1)]
    r = qg.tally(rows)
    a = r["reject_attribution"]
    assert (a["false_anchors"], a["reanchor_frames_lost_mean"], a["reanchor_frames_lost_max"]) \
        == (1, 2.0, 2)
    assert r["quality_threshold_only"]["false_accept"] == 1
    assert r["quality_threshold_only"]["false_accept_rate"] == 0.5
    assert r["full_gate"]["false_accept"] == 0
    assert a["fn_window_only"] == a["clean_rejected"] == 4


def test_tally_reject_attribution_sums():
    rows = [row(gate=False, lok=False, c=0),                     # LICH unknown
            row(gate=False, lok=False, q=0.5, fok=False, c=0),   # LICH unknown (only)
            row(gate=False, fok=False, c=1),                     # FN window only
            row(gate=False, q=0.85, c=1),                        # quality only
            row(gate=False, q=0.9, fok=False, c=2),              # quality and FN (0.9 fails)
            row(c=2), row(e=3, c=2)]
    a = qg.tally(rows)["reject_attribution"]
    assert {k: a[k] for k in ("clean_rejected", "lich_unknown", "fn_window_only",
                              "quality_only", "quality_and_fn")} == \
        {"clean_rejected": 5, "lich_unknown": 2, "fn_window_only": 1, "quality_only": 1,
         "quality_and_fn": 1}
    assert a["clean_rejected"] == sum(a[k] for k in ("lich_unknown", "fn_window_only",
                                                     "quality_only", "quality_and_fn"))


def reanchor_loop(rows):
    """The JAX tool's re-anchor runs, channel by channel."""
    chans = np.array([r[5] for r in rows])
    errs = np.array([r[2] for r in rows])
    clean, garbage = errs == 0, errs > 0.25 * 128
    accq = np.array([r[0] for r in rows]) > 0.9
    fok = np.array([r[4] for r in rows], bool)
    runs = []
    for c in np.unique(chans):
        m = chans == c
        cg, cc, cf = garbage[m] & accq[m], clean[m], fok[m]
        for i in np.nonzero(cg)[0]:
            run = 0
            for j in range(i + 1, len(cf)):
                if not cc[j]:
                    continue
                if cf[j]:
                    break
                run += 1
            runs.append(run)
    return runs


def test_reanchor_runs_match_loop_on_interleaved_channels():
    rng = np.random.default_rng(7)
    rows = [row(q=float(rng.uniform(0.85, 1.0)), e=int(rng.choice([0, 0, 0, 5, 40])),
                fok=bool(rng.random() < 0.6), c=int(rng.integers(0, 5))) for _ in range(300)]
    runs = reanchor_loop(rows)
    a = qg.tally(rows)["reject_attribution"]
    assert a["false_anchors"] == len(runs) > 10
    assert a["reanchor_frames_lost_mean"] == round(float(np.mean(runs)), 3)
    assert a["reanchor_frames_lost_max"] == max(runs) > 0


def regime(garbage_frac, reject_rate):
    return {"full_gate": {"garbage_frac_of_admitted": garbage_frac},
            "quality_threshold_only": {"false_reject_rate": reject_rate}}


@pytest.mark.parametrize("garbage_frac, reject_rate, ok", [
    (0.01, 0.02, True), (0.0101, 0.0, False), (0.0, 0.0201, False),
    (None, None, True), (0.0, None, True), (None, 0.02, True)])
def test_gate_ok_bounds(garbage_frac, reject_rate, ok):
    assert qg.gate_ok({"a": regime(0.0, 0.0), "b": regime(garbage_frac, reject_rate)}) is ok


@pytest.mark.parametrize("snr_db", qg.AWGN_DB)
def test_awgn_wave_bit_equal(snr_db):
    sigma = float(np.sqrt(j_bp.signal_power(2, 16) / 10 ** (snr_db / 10)))
    want, want_pl = j_bp.make_waveforms(NCH, NF, sigma, seed=SEED + 17)
    got, pl = qg.awgn_wave(NCH, NF, snr_db, SEED, "cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pl, want_pl)


def test_isi_wave_bit_equal():
    # the JAX tool's lines, its generator's first use
    rng = np.random.default_rng(SEED)
    wave, want_pl = j_bp.make_waveforms(NCH, NF, sigma=0.0, seed=SEED + 21)
    w = np.array(wave)
    t = np.arange(w.shape[1]) / w.shape[1]
    g = np.clip((t - 0.35) / 0.15, 0.0, 1.0)
    for k, a in enumerate((1.0, 0.6, 0.3)):
        if k == 0:
            continue
        w[:, k:] += (a * g[k:]) * w[:, :-k]
    w = (w + rng.normal(0, 0.02, w.shape)).astype(np.float32)
    got, pl = qg.isi_wave(NCH, NF, SEED, "cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(pl, want_pl)


def test_offset_drift_wire_noiseless():
    want, want_pl, _ = jax_offset_drift_wire(NCH, NF, SEED, noisy=False)
    got, pl = qg.offset_drift_wire(NCH, NF, SEED, "cpu", noise=torch.zeros(want.shape))
    np.testing.assert_allclose(got.numpy(), want, atol=IQ_ATOL)
    np.testing.assert_array_equal(pl, want_pl)


def test_pluto_wire_on_jax_noise():
    want, want_pl, noise = jax_pluto_wire(NCH, NF, SEED)
    got, pl = qg.pluto_wire(NCH, NF, SEED, "cpu", noise=torch.as_tensor(noise))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=IQ_ATOL)
    np.testing.assert_array_equal(pl, want_pl)


def test_wires_draw_from_a_seeded_generator():
    a, _ = qg.offset_drift_wire(2, 1, SEED, "cpu")
    b, _ = qg.offset_drift_wire(2, 1, SEED, "cpu")
    c, _ = qg.offset_drift_wire(2, 1, SEED + 1, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    p, _ = qg.pluto_wire(2, 1, SEED, "cpu")
    assert p.shape == a.shape and bool(torch.isfinite(p).all())


def test_timing_drift_long_capture():
    """At T >= 2^15 the clipped last positions round to T - 1: the port
    reads the last sample where JAX's gather fills NaN, and equals JAX
    everywhere else."""
    x = np.random.default_rng(5).normal(size=(2, 2, 40_000)).astype(np.float32)
    want = np.asarray(j_ch.timing_drift(jax.numpy.asarray(x), 120.0))
    got = t_ch.timing_drift(torch.as_tensor(x), 120.0).numpy()
    past = np.isnan(want)
    assert past.any() and not past[..., :-16].any()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[~past], want[~past], atol=1e-6)
    np.testing.assert_array_equal(got[past], np.broadcast_to(x[..., -1:], x.shape)[past])


def test_main_needs_a_card_unless_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert qg.main(["--channels", "2", "--frames", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
