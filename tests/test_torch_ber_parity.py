"""The port's soft-domain BER-parity harness (m17_sdr_tpu_torch.pipeline.
ber_parity) against the JAX package's, on the same inputs.

Held exactly: the waveforms and their truth (bit for bit: the shaping
and the noise are numpy in both, the dibits integers), the clean signal
power, the decodes of the same waveform (every routed stream payload,
packet chunk and BERT frame, keyed as the harness keys them), the scores
and their extras, the predicates' booleans on every recorded point of
BER_PARITY_r4.json, and the reference-output parser on canned lines.
The port runs its plain path on the CPU.  The 64 x 64 replay of a
recorded point is in tests/test_torch_ber_parity_record.py.
"""

from __future__ import annotations

import json
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from m17_sdr_tpu.pipeline import ber_parity as j_bp
from m17_sdr_tpu_torch.pipeline import ber_parity as t_bp

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
RECORD = ROOT / "BER_PARITY_r4.json"
NCH, NF = 6, 16
# one SNR in each kind's waterfall and one above it (BER_PARITY_r4.json)
SNR_DB = {"stream": (8.0, 14.0), "packet": (8.0, 14.0), "bert": (6.0, 12.0)}
P_SIG = j_bp.signal_power(2, 16)


@pytest.mark.parametrize("seed", [3, 1011])
@pytest.mark.parametrize("kind", ["stream", "packet", "bert"])
def test_make_waveforms_bit_equal(kind, seed):
    sigma = j_bp.signal_power(2, 4) ** 0.5 / 3.0
    wave_j, truth_j = j_bp.make_waveforms(4, 12, sigma, seed=seed, kind=kind)
    wave_t, truth_t = t_bp.make_waveforms(4, 12, sigma, seed=seed, kind=kind, device="cpu")
    assert wave_t.dtype == wave_j.dtype == np.float32
    np.testing.assert_array_equal(wave_t, wave_j)
    for a, b in zip(truth_t if kind == "packet" else (truth_t,),
                    truth_j if kind == "packet" else (truth_j,)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_signal_power_equal():
    assert t_bp.signal_power(2, 16, device="cpu") == P_SIG
    # the recorded sigmas follow from it
    rec = json.loads(RECORD.read_text())
    for row in rec["stream"]["points"]:
        assert round(t_bp.sigma_for(row["snr_db"], P_SIG), 6) == row["sigma"]


@pytest.fixture(scope="module", params=[(k, i) for k in SNR_DB for i in range(2)],
                ids=lambda p: f"{p[0]}-{SNR_DB[p[0]][p[1]]:g}dB")
def decoded(request):
    """(kind, truth, port decodes, JAX decodes) of one waveform."""
    kind, i = request.param
    sigma = t_bp.sigma_for(SNR_DB[kind][i], P_SIG)
    wave, truth = t_bp.make_waveforms(NCH, NF, sigma, seed=7 + i, kind=kind, device="cpu")
    return (kind, truth, t_bp.run_chain(wave, nf=NF, device="cpu"),
            j_bp.run_jax(wave, nf=NF))


def test_decodes_equal(decoded):
    kind, _, got, want = decoded
    assert t_bp.same_decodes(got, want)
    assert not t_bp.same_decodes(got, want._replace(stream={}, packet={}, bert={}))
    delivered = {"stream": want.stream, "packet": want.packet, "bert": want.bert}[kind]
    assert delivered, f"no {kind} frame decoded: the comparison would be vacuous"


def test_scores_equal(decoded):
    """Every score and its extras, on the decodes both chains produced,
    with and without a slip set (some channels slipped)."""
    kind, truth, got, want = decoded
    slips = {0: 2, 3: 1}
    for dec in (got, want):
        if kind == "stream":
            for min_fn in (0, 8):
                assert t_bp.score(dec.stream, truth, min_fn) == j_bp.score(dec.stream, truth,
                                                                           min_fn)
        elif kind == "packet":
            for s in (None, slips):
                assert t_bp.score_packet(dec.packet, truth[0], s) == \
                    j_bp.score_packet(dec.packet, truth[0], s)
        else:
            for s in (None, slips):
                assert t_bp.score_bert(dec.bert, NCH, NF, s) == \
                    j_bp.score_bert(dec.bert, NCH, NF, s)


def _degraded(t: tuple, extra: dict | None):
    """A chain that recovers half the frames with ten times the errors
    (and, typed, garbles three times the frames)."""
    frames, total, errs, bits = t
    t = (frames // 2, total, 10 * errs + 50, bits // 2)
    if extra is not None:
        extra = dict(extra, garbled_frames=3 * extra["garbled_frames"] + 20,
                     clean_bit_errors=10 * extra["clean_bit_errors"] + 50,
                     clean_bits=extra["clean_bits"] // 2)
    return t, extra


def _recorded_points(kind: str):
    """The record's points of one kind as (variant, port point, JAX
    point, row): as recorded, with the two chains' slots swapped, and
    with the chain under test degraded (where the predicates fail)."""
    rec = json.loads(RECORD.read_text())
    out = []
    for row in rec[kind]["points"]:
        ref, jx = t_bp._tuple(row["ref"]), t_bp._tuple(row["jax"])
        ex = row.get("extra")
        bad, bad_ex = _degraded(jx, ex and ex["jax"])
        variants = {"recorded": (ref, jx, ex),
                    "swapped": (jx, ref, ex and {"ref": ex["jax"], "jax": ex["ref"]}),
                    "degraded": (ref, bad, ex and {"ref": ex["ref"], "jax": bad_ex})}
        for name, (r, j, e) in variants.items():
            if kind == "stream":
                out.append((name, t_bp.ParityPoint(row["snr_db"], row["sigma"], r, j),
                            j_bp.ParityPoint(row["snr_db"], row["sigma"], r, j), row))
            else:
                out.append((name, t_bp.TypedParityPoint(kind, row["snr_db"], row["sigma"],
                                                        r, j, e),
                            j_bp.TypedParityPoint(kind, row["snr_db"], row["sigma"], r, j, e),
                            row))
    return out


@pytest.mark.parametrize("kind", ["stream", "packet", "bert"])
def test_predicates_on_record(kind):
    """The same booleans as the JAX predicates on every recorded point,
    swapped and degraded (where some fail), and the record's own flags
    on the points as recorded."""
    values = []
    for name, pt, pj, row in _recorded_points(kind):
        if kind == "stream":
            got = (t_bp.ber_agreement_ok(pt), t_bp.frame_agreement_ok(pt))
            want = (j_bp.ber_agreement_ok(pj), j_bp.frame_agreement_ok(pj))
            flags = (row["ber_ok"], row["frames_ok"])
        else:
            got, want = (t_bp.typed_agreement_ok(pt),), (j_bp.typed_agreement_ok(pj),)
            flags = (row["ber_ok"],)
        assert got == want, (kind, row["snr_db"], name)
        if name == "recorded":
            assert got == flags, (kind, row["snr_db"])
        values += got
    assert any(values) and not all(values)


def test_parity_to_json_keys():
    pts = [t_bp.ParityPoint(12.0, 0.1009253, (3311, 3584, 9, 423808), (3470, 3584, 6, 444160))]
    got = t_bp.parity_to_json(pts)
    want = j_bp.parity_to_json(pts)
    assert got["points"] == want["points"]
    assert got.keys() == want.keys()


# ---- the reference-output parser, fed canned lines

CANNED = [
    # channel 0: a session with two slips inside it, one outside, a
    # repeated FN (first wins), a short P line and packet chunks
    # (``K lich fn eof hex``; the eof chunk's field is its byte count)
    ["Sync + 0", "Type: LSF", "x P 0 3 " + "11" * 16, "P 0 3 " + "22" * 16,
     "Sync - 39", "P 1 4 " + "33" * 16, "P 1 5", "Sync + 0", "K 0 0 0 " + "ab" * 25,
     "K 1 1 0 " + "cd" * 25, "K 2 23 1 " + "ef" * 25, "K 3 1 0 " + "00" * 25,
     "Type: STREAM", "Sync - 39"],
    # channel 1: BERT frames (``B n hex``), a Sync line that holds a
    # marker, noise, a short K line
    ["B 0 " + "f0" * 25, "Sync P 1 2 " + "00" * 16, "Type: BERT", "B 1 " + "0f" * 25,
     "garbage line", "K 2 0 " + "ee" * 25, "Type: BERT"],
    # channel 2: nothing decoded
    ["Sync + 0", "Sync - 39"],
]


def _fake_run(outputs):
    """A subprocess.run stand-in: `make` succeeds, the decoder prints the
    canned lines of the channel its input file names."""
    def run(args, **kw):
        if args[0] == "make":
            return subprocess.CompletedProcess(args, 0, "", "")
        ch = int(re.search(r"(\d+)\.bin$", args[1]).group(1))
        return subprocess.CompletedProcess(args, 0, "\n".join(outputs[ch]) + "\n", "")
    return run


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("nf", [None, 7])
def test_reference_parser_equal(monkeypatch, tmp_path, trace, nf):
    monkeypatch.setattr(subprocess, "run", _fake_run(CANNED))
    monkeypatch.setattr(t_bp, "reference_dir", lambda: tmp_path)
    wave = np.zeros((len(CANNED), 2 * t_bp.CHUNK_2X), np.float32)
    got = t_bp.run_reference(wave, str(tmp_path), jobs=2, nf=nf, trace=trace)
    want = j_bp.run_reference(wave, str(tmp_path), jobs=2, nf=nf, trace=trace)
    assert t_bp.same_decodes(got, want)
    assert got.stream and got.packet and got.bert
    if trace:
        assert got.slips == {0: 2, 1: 0, 2: 0}
    assert not list(tmp_path.glob("*.bin")), "input files left behind"


def test_run_reference_without_sources_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(t_bp, "reference_dir", lambda: tmp_path / "absent")
    with pytest.raises(FileNotFoundError, match="absent"):
        t_bp.run_reference(np.zeros((1, t_bp.CHUNK_2X), np.float32), str(tmp_path))


def test_reference_dir_from_makefile():
    text = (t_bp.GOLDEN_DIR / "Makefile").read_text()
    assert f"REF := {t_bp.reference_dir()}" in text
