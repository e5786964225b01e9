"""Stress the stream voice gate beyond its calibration corpus.

Port of the JAX package's ``tools/quality_gate.py``.  The gate decides
which decoded voice frames are routed (``stream_gate``): an LSF known
for routing (the LICH term), the normalized Viterbi confidence above
``STREAM_QUALITY_MIN``, and the FN-continuity window; the equalizer the
soft path arms itself (``equalize="auto"``, ``EYE_ARM``) acts upstream.
Seven impairment regimes, in the record's order:

  awgn_{7,10,14}dB               soft-domain AWGN (the calibration-like
                                 regime)
  offset300Hz_drift120ppm_17dB   300 Hz carrier offset + 120 ppm clock
                                 drift + noise through the full FM chain
  pluto_384k_20dB                384 kS/s TX -> x8 decimating FIR -> chain
  isi_2ray, isi_2ray_eq          two-ray ISI growing mid-capture, under
                                 the auto-armed equalizer and forced on

Every delivered (pre-gate) stream frame is matched against the payload
sent at its FN and tallied clean (0 bit errors), garbage (more than a
quarter of its 128 bits wrong, or a misframe: a decoded FN no frame was
sent at) or degraded (in between).  Per regime: false-accept and
false-reject rates of the full gate and of the quality threshold alone,
each clean-frame reject attributed to the gate term that made it, the
re-anchor latency after a false anchor, and the quality extremes of the
clean and garbage populations.  ``ok`` holds when in every regime
garbage is at most 1 % of what the full gate admits and the threshold
alone rejects at most 2 % of clean frames.

The AWGN and ISI regimes draw their noise from numpy, as the JAX tool
does, so the port builds the same samples.  The offset+drift and Pluto
regimes draw theirs from a ``torch.Generator`` seeded as the JAX tool
seeds its ``jax.random`` keys (``seed`` and ``seed + 9``), or take it as
a given unit-variance tensor: the same statistics, other draws.

    python -m m17_sdr_tpu_torch.tools.quality_gate [--device cuda|cpu]
        [--channels 32] [--frames 24] [--seed 0] [--out PATH]

``--device`` defaults to the card and exits non-zero without one.  The
document is written to ``--out`` only where one is given, so a run never
overwrites the JAX tool's committed record.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..dsp import channel, resample
from ..pipeline import tx as txp
from ..pipeline.ber_parity import (
    CHUNK_2X, SIGNAL_POWER_SIZE, _lsf_for, make_waveforms, sigma_for, signal_power)
from ..pipeline.loopback import _blockify
from ..pipeline.rx import STREAM_QUALITY_MIN, RxSessionState, rx_stream, rx_stream_soft

AWGN_DB = (7.0, 10.0, 14.0)
OFFSET_HZ = 300.0
DRIFT_PPM = 120.0
OFFSET_SNR_DB = 17.0
PLUTO_OVERSAMPLE = 80         # samples/symbol at 384 kS/s
PLUTO_SNR_DB = 20.0
ISI_START, ISI_RAMP = 0.35, 0.15   # echoes grow from 35 % to 50 % of the capture
ISI_ECHOES = (0.6, 0.3)       # echo gains at lags 1 and 2 samples (2x/symbol)
ISI_SIGMA = 0.02
GARBAGE_BITS = 0.25 * 128     # more wrong payload bits than this: garbage
GATE_GARBAGE_MAX = 0.01       # garbage share of what the full gate admits
THRESH_REJECT_MAX = 0.02      # share of clean frames the threshold rejects

AWGN = tuple(f"awgn_{s:g}dB" for s in AWGN_DB)
OFFSET_DRIFT = "offset300Hz_drift120ppm_17dB"
PLUTO = "pluto_384k_20dB"
ISI = "isi_2ray"
ISI_EQ = "isi_2ray_eq"
REGIMES = (*AWGN, OFFSET_DRIFT, PLUTO, ISI, ISI_EQ)
IQ_REGIMES = (OFFSET_DRIFT, PLUTO)       # 48 kHz IQ through the front end
EQUALIZE = {ISI: "auto", ISI_EQ: True}   # the soft regimes' equalize; others off
# regimes that share a receiver and its settings, decoded in one call
GROUPS = (AWGN, IQ_REGIMES, (ISI,), (ISI_EQ,))


# ---------------------------------------------------------------- scoring

def score(out, payloads: np.ndarray, nf: int) -> list[tuple]:
    """Every delivered (pre-gate) stream frame of an RX pass as a row
    (quality, gate, bit errors, lich_ok, fn_ok, channel), channel-major,
    then in slot order.

    ``payloads`` [nch, nf, 16] are the payloads sent; a frame's bit errors
    count against the payload sent at its decoded FN, and a decoded FN at
    or past ``nf`` (a misframe) counts 999.  ``gate`` is the routed flag
    and ``lich_ok``/``fn_ok`` are the gate's own terms
    (``stream_lich_ok``, ``stream_fn_ok``), so rejects decompose as the
    receiver computed them.  Each output field is read to the host once.
    """
    nch = payloads.shape[0]
    sv, gate, fn, q, lok, fok = (getattr(out, f).reshape(nch, -1).cpu().numpy() for f in (
        "stream_valid", "stream_gate", "stream_fn", "stream_quality",
        "stream_lich_ok", "stream_fn_ok"))
    plx = out.stream_payload.reshape(nch, -1, 16).cpu().numpy()
    c, j = np.nonzero(sv)
    f = fn[c, j]
    misframe = f >= nf
    sent = payloads[c, np.where(misframe, 0, f)]
    errs = np.where(misframe, 999, np.unpackbits(plx[c, j] ^ sent, axis=-1).sum(-1))
    return list(zip(q[c, j].tolist(), gate[c, j].astype(bool).tolist(), errs.tolist(),
                    lok[c, j].astype(bool).tolist(), fok[c, j].astype(bool).tolist(),
                    c.tolist()))


def _rates(acc: np.ndarray, clean: np.ndarray, garbage: np.ndarray) -> dict:
    n_g, n_c = int(garbage.sum()), int(clean.sum())
    fa = int((acc & garbage).sum())
    fr = int((~acc & clean).sum())
    n_adm = int(acc.sum())
    return {"false_accept": fa,
            "false_accept_rate": round(fa / n_g, 4) if n_g else None,
            "admitted": n_adm,
            "garbage_frac_of_admitted": round(fa / n_adm, 4) if n_adm else None,
            "false_reject": fr,
            "false_reject_rate": round(fr / n_c, 4) if n_c else None}


def _reanchor_runs(chans, clean, fok, anchor) -> list[int]:
    """For each false anchor, the run of clean frames after it (in its
    channel) lost to a failed FN window before the first clean frame the
    window passes."""
    order = np.argsort(chans, kind="stable")
    ch, cl, fk = chans[order], clean[order], fok[order]
    runs = []
    for i in np.nonzero(anchor[order])[0]:
        run = 0
        for j in range(i + 1, len(ch)):
            if ch[j] != ch[i]:
                break
            if not cl[j]:
                continue
            if fk[j]:
                break
            run += 1
        runs.append(run)
    return runs


def tally(rows) -> dict:
    """Bucket ``score``'s rows and report the gate's rates.

    clean: 0 bit errors; garbage: more than GARBAGE_BITS or a misframe;
    degraded: in between (scratchy but usable voice, not false-accept
    material).  ``quality_threshold_only`` judges quality >
    STREAM_QUALITY_MIN alone, ``full_gate`` the routed flag.
    ``reject_attribution`` splits the full gate's clean-frame rejects by
    term (``fn_window_only``: a clean frame that passed the LICH term and
    the threshold and was dropped for discontinuity alone) and counts the
    false anchors (garbage above the threshold, which re-aims the FN
    window) with the clean frames each cost.  Quality extremes are rounded
    to 4 places, None for an empty population.
    """
    cols = list(zip(*rows)) if rows else [()] * 6
    qs = np.array(cols[0], np.float64)
    accg = np.array(cols[1], bool)
    errs = np.array(cols[2], np.int64)
    lok = np.array(cols[3], bool)
    fok = np.array(cols[4], bool)
    chans = np.array(cols[5], np.int64)
    clean = errs == 0
    garbage = errs > GARBAGE_BITS
    degraded = ~clean & ~garbage
    accq = qs > STREAM_QUALITY_MIN
    n_g, n_c = int(garbage.sum()), int(clean.sum())

    rej_c = clean & ~accg
    attribution = {
        "clean_rejected": int(rej_c.sum()),
        "lich_unknown": int((rej_c & ~lok).sum()),
        "fn_window_only": int((rej_c & lok & accq & ~fok).sum()),
        "quality_only": int((rej_c & lok & fok & ~accq).sum()),
        "quality_and_fn": int((rej_c & lok & ~fok & ~accq).sum()),
    }
    runs = _reanchor_runs(chans, clean, fok, garbage & accq)
    attribution["false_anchors"] = len(runs)
    if runs:
        attribution["reanchor_frames_lost_mean"] = round(float(np.mean(runs)), 3)
        attribution["reanchor_frames_lost_max"] = int(max(runs))

    return {
        "delivered": len(rows), "clean": n_c,
        "degraded": int(degraded.sum()), "garbage": n_g,
        "degraded_admitted": int((accg & degraded).sum()),
        "quality_threshold_only": _rates(accq, clean, garbage),
        "full_gate": _rates(accg, clean, garbage),
        "reject_attribution": attribution,
        "clean_quality_floor": round(float(qs[clean].min()), 4) if n_c else None,
        "garbage_quality_ceiling": round(float(qs[garbage].max()), 4) if n_g else None,
    }


def gate_ok(regimes: dict) -> bool:
    """In every regime, garbage is at most GATE_GARBAGE_MAX of what the
    full gate admits, and the threshold alone rejects at most
    THRESH_REJECT_MAX of clean frames (the full gate's rejects also hold
    frames before the LICH is known, which no threshold can route)."""
    return all(
        (r["full_gate"]["garbage_frac_of_admitted"] or 0.0) <= GATE_GARBAGE_MAX
        and (r["quality_threshold_only"]["false_reject_rate"] is None
             or r["quality_threshold_only"]["false_reject_rate"] <= THRESH_REJECT_MAX)
        for r in regimes.values())


# ---------------------------------------------------------------- regimes

def mk_session(nch: int, nf: int, seed: int, device):
    """nch voice sessions AB1CDE <- G4GUO of nf stream frames, payloads
    from ``default_rng(seed)``: (dibits [nch, N] on ``device``, payloads
    [nch, nf, 16] uint8)."""
    payloads = np.random.default_rng(seed).integers(0, 256, (nch, nf, 16), dtype=np.uint8)
    dibits = txp.build_voice_session_dibits(_lsf_for(nch, device),
                                            torch.as_tensor(payloads).to(device))
    return dibits, payloads


def _generator(noise, seed: int, device):
    return None if noise is not None else torch.Generator(device=device).manual_seed(seed)


def awgn_wave(nch: int, nf: int, snr_db: float, seed: int, device):
    """The AWGN regime at ``snr_db``: ``make_waveforms`` with seed + 17,
    sigma against the clean power of SIGNAL_POWER_SIZE.  Returns (soft
    wave [nch, T2] float32, payloads)."""
    sigma = sigma_for(snr_db, signal_power(*SIGNAL_POWER_SIZE, device=device))
    return make_waveforms(nch, nf, sigma, seed + 17, device=device)


def offset_drift_wire(nch: int, nf: int, seed: int, device, noise=None):
    """The offset+drift regime's 48 kHz wire: sessions from seed + 1,
    then ``timing_drift`` DRIFT_PPM, ``carrier_offset`` OFFSET_HZ and
    ``awgn`` OFFSET_SNR_DB.  The unit noise is ``noise`` ([nch, 2, T]) or
    is drawn from a ``torch.Generator`` on ``device`` seeded with
    ``seed``.  Returns (IQ [nch, 2, T] float32 on ``device``, payloads)."""
    dibits, payloads = mk_session(nch, nf, seed + 1, device)
    iq, _ = txp.dibits_to_iq(dibits)
    iq = channel.timing_drift(iq, DRIFT_PPM)
    iq = channel.carrier_offset(iq, OFFSET_HZ)
    iq = channel.awgn(iq, OFFSET_SNR_DB, noise=noise,
                      generator=_generator(noise, seed, iq.device))
    return iq, payloads


def pluto_wire(nch: int, nf: int, seed: int, device, noise=None):
    """The Pluto regime's wire: sessions from seed + 2 modulated at
    384 kS/s, ``awgn`` PLUTO_SNR_DB (the unit noise [nch, 2, 8 T] is
    ``noise`` or drawn from a ``torch.Generator`` seeded with seed + 9),
    then the x8 decimating FIR from a zero history.  Returns (48 kHz IQ
    [nch, 2, T] float32 on ``device``, payloads)."""
    dibits, payloads = mk_session(nch, nf, seed + 2, device)
    iq, _ = txp.dibits_to_iq(dibits, oversample=PLUTO_OVERSAMPLE)
    iq = channel.awgn(iq, PLUTO_SNR_DB, noise=noise,
                      generator=_generator(noise, seed + 9, iq.device))
    iq48, _ = resample.decimate_pluto(iq, resample.decimate_init(nch, iq.device))
    return iq48, payloads


def isi_wave(nch: int, nf: int, seed: int, device):
    """The ISI regimes' soft wave: noiseless ``make_waveforms`` with
    seed + 21, echoes ISI_ECHOES at lags 1 and 2 whose gain ramps
    linearly from 0 at ISI_START of the capture to full ISI_RAMP later
    (the receiver acquires clean; the ISI hits established sessions),
    then N(0, ISI_SIGMA) from ``default_rng(seed)``.  Returns (wave
    [nch, T2] float32, payloads)."""
    w, payloads = make_waveforms(nch, nf, sigma=0.0, seed=seed + 21, device=device)
    t = np.arange(w.shape[1]) / w.shape[1]
    g = np.clip((t - ISI_START) / ISI_RAMP, 0.0, 1.0)
    for k, a in enumerate(ISI_ECHOES, start=1):
        w[:, k:] += (a * g[k:]) * w[:, :-k]
    w = (w + np.random.default_rng(seed).normal(0, ISI_SIGMA, w.shape)).astype(np.float32)
    return w, payloads


def regime_input(name: str, nch: int, nf: int, seed: int, device):
    """(input, payloads) of one regime with the run's ``seed``: a soft wave
    [nch, T2] (numpy) for the soft-domain regimes, 48 kHz IQ [nch, 2, T]
    on ``device`` for IQ_REGIMES (noise from a ``torch.Generator``).  Both
    ISI regimes decode the same wave."""
    if name in AWGN:
        return awgn_wave(nch, nf, AWGN_DB[AWGN.index(name)], seed, device)
    if name == OFFSET_DRIFT:
        return offset_drift_wire(nch, nf, seed, device)
    if name == PLUTO:
        return pluto_wire(nch, nf, seed, device)
    if name in (ISI, ISI_EQ):
        return isi_wave(nch, nf, seed, device)
    raise ValueError(f"unknown regime {name!r}")


def decode(name: str, x, device):
    """RX of a regime's input on ``device``: ``rx_stream`` of 48 kHz IQ
    [B, 2, T] for IQ_REGIMES, else ``rx_stream_soft`` of a soft wave
    [B, T2] with the regime's ``equalize``.  Returns (out, final state)."""
    b = x.shape[0]
    state = RxSessionState.init(b, device)
    if name in IQ_REGIMES:
        return rx_stream(_blockify(x.to(device)), state)
    blocks = torch.as_tensor(x.reshape(b, -1, CHUNK_2X)).to(device)
    return rx_stream_soft(blocks, state, equalize=EQUALIZE.get(name, False))


def decode_group(group: tuple, xs, device):
    """``decode`` of the inputs ``xs`` of the regimes of one GROUPS entry,
    concatenated along channels (channels are independent)."""
    cat = torch.cat if group[0] in IQ_REGIMES else np.concatenate
    return decode(group[0], cat(list(xs)), device)


def channels(out, first: int, n: int):
    """Channels [first, first + n) of an RX output."""
    return type(out)(*(f[first:first + n] for f in out))


def regime_tally(name: str, out, st, payloads: np.ndarray, nf: int) -> dict:
    """One regime's entry of the document: ``tally`` of ``score``, and on
    ISI the channels the auto-armed equalizer armed and the median eye
    estimate, read from ``st``, the final state of the same channels."""
    r = tally(score(out, payloads, nf))
    if name == ISI:
        r["auto_eq_armed_channels"] = int(st.eq_armed.sum())
        r["eye_est_med"] = round(float(np.median(st.eye_est.cpu().numpy())), 4)
    return r


def decode_regimes(nch: int, nf: int, seed: int, device, wires: dict | None = None):
    """Every regime's input at nch channels x nf frames, and its decode.

    ``wires`` maps IQ_REGIMES names to a (48 kHz IQ [nch, 2, T], payloads)
    to decode in place of the one ``regime_input`` would build.  Each
    GROUPS entry decodes in one call: the AWGN regimes in one
    ``rx_stream_soft`` call, the IQ regimes (of one length) in one
    ``rx_stream`` call, each ISI regime in a call of its own.  Returns
    (inputs: name -> (input, payloads), decoded: group -> (out, state)).
    """
    wires = wires or {}
    made = {}
    for name in REGIMES:
        if name in wires:
            made[name] = wires[name]
        elif name == ISI_EQ:
            made[name] = made[ISI]
        else:
            made[name] = regime_input(name, nch, nf, seed, device)
    decoded = {group: decode_group(group, (made[name][0] for name in group), device)
               for group in GROUPS}
    return made, decoded


def document(made: dict, decoded: dict, nch: int, nf: int) -> dict:
    """The JAX tool's document from ``decode_regimes``' result:
    ``threshold``, ``channels``, ``frames_per_session``, ``regimes`` (and
    ``isi_2ray``'s equalizer fields) and ``ok``."""
    regimes = {}
    for group, (out, st) in decoded.items():   # ISI decodes alone: st is its channels'
        for k, name in enumerate(group):
            regimes[name] = regime_tally(name, channels(out, k * nch, nch), st,
                                         made[name][1], nf)
    regimes = {name: regimes[name] for name in REGIMES}
    return {"threshold": STREAM_QUALITY_MIN, "channels": nch, "frames_per_session": nf,
            "regimes": regimes, "ok": gate_ok(regimes)}


def run_regimes(nch: int, nf: int, seed: int, device, wires: dict | None = None) -> dict:
    """All seven regimes at nch channels x nf frames: ``document`` of
    ``decode_regimes`` (whose ``wires`` this passes on)."""
    return document(*decode_regimes(nch, nf, seed, device, wires), nch, nf)


def summary_line(name: str, r: dict) -> str:
    """One regime's counts on a line, as the JAX tool prints them."""
    return (f"{name:28s} delivered={r['delivered']:4d} "
            f"clean={r['clean']:4d} degr={r['degraded']:3d} "
            f"garbage={r['garbage']:3d} "
            f"gateFA={r['full_gate']['false_accept']} "
            f"gateFR={r['full_gate']['false_reject']} "
            f"qFA={r['quality_threshold_only']['false_accept']} "
            f"fnOnly={r['reject_attribution']['fn_window_only']} "
            f"floor={r['clean_quality_floor']} "
            f"ceil={r['garbage_quality_ceiling']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m m17_sdr_tpu_torch.tools.quality_gate",
                                 description="Stress the stream voice gate in seven "
                                             "impairment regimes.")
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the document to this JSON file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; run with --device cpu to use the CPU", file=sys.stderr)
        return 1
    doc = run_regimes(args.channels, args.frames, args.seed, torch.device(args.device))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    for name, r in doc["regimes"].items():
        print(summary_line(name, r))
    print("ok:", doc["ok"], "->", args.out or "(not written)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
