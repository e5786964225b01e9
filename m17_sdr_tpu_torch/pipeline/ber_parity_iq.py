"""IQ-domain BER parity against the reference chain.

Port of ``m17_sdr_tpu.pipeline.ber_parity_iq``.  The soft-domain harness
(``ber_parity.py``) enters both chains after the discriminator; this one
feeds both the same 48 kHz int16 interleaved IQ (the radio HAL's wire
format), so the FM front ends are compared too:

  (a) the reference's complete chain compiled in place
      (``tests/golden_gen/ber_ref_iq.cpp``: its front end, then timing
      recovery, framer and stream decode; ``run_reference_iq``), and
  (b) the port's ``rx_stream``, front end included (``run_chain_iq``),

with AWGN alone and with a carrier offset that exercises both
discriminators' DC paths.  The noise is a given unit-variance tensor or
is drawn from a ``torch.Generator`` seeded with the point's seed, so the
port's draws are not the JAX package's ``jax.random`` draws:
``replay_record_iq`` is an independent realization of a committed record
(``BER_PARITY_IQ_r5.json``), judged by the record's two-proportion
predicates against its ``ref`` tuples.
"""

from __future__ import annotations

import json
import pathlib
from typing import Sequence

import numpy as np
import torch

from ..dsp import channel
from . import tx as txp
from .ber_parity import (
    MIN_FN,
    SEED_BASE,
    SEED_STEP,
    Decodes,
    ParityPoint,
    ReplayPoint,
    _channels,
    _lsf_for,
    _tuple,
    ber_agreement_ok,
    frame_agreement_ok,
    parity_to_json,
    reference_exe,
    routed_stream,
    run_per_channel,
    score,
)
from .rx import RxSessionState, rx_stream

BLOCK = 1920                  # samples per block: 40 ms at 48 kHz
GUARD_BLOCKS = 3              # leading/trailing silence blocks
# Wire amplitude: half the level of a default capture (tx_gain 0.5 * 2.0
# = 1.0 x 0x3FFF).  The 6 dB of headroom keeps signal + noise inside
# int16 at the low-SNR points, where clipping would be a third
# impairment neither chain models.  Level cannot affect parity: both
# front ends hard-limit to unit magnitude before the discriminator.
WIRE_AMP = 0.5 * 0x3FFF


def make_iq_wire(nch: int, nf: int, snr_db: float, seed: int,
                 freq_offset_hz: float = 0.0, noise: torch.Tensor | None = None,
                 device="cuda"):
    """Build nch noisy int16-IQ voice sessions at one RF SNR on ``device``.

    Returns (wire [nch, nsamp, 2] int16 on the host, payloads [nch, nf, 16]).
    The payloads come from ``default_rng(seed)``.  SNR is against the
    unit-magnitude FM carrier (``channel.awgn``); the carrier offset is
    applied before the noise.  The unit-variance noise is ``noise``
    ([nch, 2, nsamp]) or is drawn from a ``torch.Generator`` on ``device``
    seeded with ``seed``.  Signal and noise are scaled by
    WIRE_AMP, rounded and clipped to +-32767.
    """
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (nch, nf, 16), dtype=np.uint8)
    dibits = txp.build_voice_session_dibits(
        _lsf_for(nch, device), torch.as_tensor(payloads).to(device))
    iq, _ = txp.dibits_to_iq(dibits)                 # [nch, 2, T] unit
    guard = torch.zeros((nch, 2, GUARD_BLOCKS * BLOCK), dtype=iq.dtype, device=iq.device)
    iq = torch.cat([guard, iq, guard], dim=-1)
    pad = (-iq.shape[-1]) % BLOCK
    if pad:
        iq = torch.nn.functional.pad(iq, (0, pad))
    if freq_offset_hz:
        iq = channel.carrier_offset(iq, freq_offset_hz)
    gen = None if noise is not None else torch.Generator(device=iq.device).manual_seed(seed)
    iq = channel.awgn(iq, snr_db, noise=noise, generator=gen)
    wire = torch.clamp(torch.round(iq.movedim(1, 2) * WIRE_AMP), -32767, 32767)
    return wire.to(torch.int16).cpu().numpy(), payloads


def run_reference_iq(wire: np.ndarray, workdir: str, jobs: int = 8) -> Decodes:
    """Decode the int16 IQ with the reference's complete chain, one process
    per channel.  Raises FileNotFoundError where the reference sources
    are absent."""
    exe = reference_exe("ber_ref_iq")
    dec = Decodes({}, {}, {}, {})
    for ch, out in enumerate(run_per_channel(exe, wire, "<i2", workdir, jobs)):
        parse_reference_iq_lines(dec, ch, out.splitlines())
    return dec


def parse_reference_iq_lines(dec: Decodes, ch: int, lines: Sequence[str]) -> None:
    """Add one channel's ``P lich fn hex`` stream lines to ``dec``, the
    first delivery of an FN winning."""
    for line in lines:
        toks = line.split()
        if len(toks) == 4 and toks[0] == "P":
            dec.stream.setdefault((ch, int(toks[2])), bytes.fromhex(toks[3]))


def run_chain_iq(wire: np.ndarray, device="cuda") -> Decodes:
    """Decode the int16 IQ with the port's full pipeline (mirrors the JAX
    package's ``run_jax_iq``): one ``rx_stream`` over all channels on
    ``device``, the routed stream fields read to the host once; the first
    delivery of an FN wins."""
    nch, nsamp, _ = wire.shape
    blocks = torch.as_tensor(
        np.moveaxis(wire.reshape(nch, nsamp // BLOCK, BLOCK, 2), 3, 2)).to(device)
    out, _ = rx_stream(blocks, RxSessionState.init(nch, device))
    return Decodes(routed_stream(out, nch), {}, {}, {})


def iq_sigma(snr_db: float) -> float:
    """Noise sigma per real component at ``snr_db`` against power 1."""
    return float(np.sqrt(1.0 / (2.0 * 10.0 ** (snr_db / 10.0))))


def run_parity_iq(snr_points_db, nch: int, nf: int, workdir: str,
                  seed: int = 0, min_fn: int = MIN_FN,
                  freq_offset_hz: float = 0.0,
                  jobs: int = 8, device="cuda") -> list[ParityPoint]:
    """Shared-IQ parity sweep: the same int16 IQ through both chains'
    complete RX paths.  Needs the reference's sources."""
    points = []
    for i, snr in enumerate(snr_points_db):
        wire, payloads = make_iq_wire(nch, nf, float(snr), seed=seed + SEED_STEP * i,
                                      freq_offset_hz=freq_offset_hz, device=device)
        ref = run_reference_iq(wire, workdir, jobs=jobs)
        got = run_chain_iq(wire, device=device)
        points.append(ParityPoint(
            snr_db=float(snr), sigma=iq_sigma(float(snr)),
            ref=score(ref.stream, payloads, min_fn),
            jax=score(got.stream, payloads, min_fn)))
    return points


def config_offset_hz(name: str) -> float:
    """A record config's carrier offset: "awgn" -> 0, "offset300Hz" -> 300."""
    if name == "awgn":
        return 0.0
    if name.startswith("offset") and name.endswith("Hz"):
        return float(name[len("offset"):-len("Hz")])
    raise ValueError(f"unknown IQ parity config {name!r}")


def record_point_iq(rec: dict, name: str, i: int, device="cuda"):
    """Point i of config ``name`` in an IQ-domain record
    (``BER_PARITY_IQ_r5.json``), made anew by ``make_iq_wire`` with seed
    SEED_BASE + SEED_STEP * i (payloads from numpy as recorded; the noise
    from a ``torch.Generator``, so an independent realization).  Returns
    (wire, payloads)."""
    row = rec["configs"][name]["points"][i]
    return make_iq_wire(rec["channels"], rec["frames"], row["snr_db"],
                        seed=SEED_BASE + SEED_STEP * i,
                        freq_offset_hz=config_offset_hz(name), device=device)


def replay_record_iq(path, device="cuda") -> list[ReplayPoint]:
    """Regenerate every point of an IQ-domain record
    (``BER_PARITY_IQ_r5.json``) with ``record_point_iq`` and decode all of
    them in one ``rx_stream`` call.  Each result holds the port's tuple,
    the recorded row, and ``frame_agreement_ok`` and ``ber_agreement_ok``
    on (recorded ``ref``, port)."""
    rec = json.loads(pathlib.Path(path).read_text())
    nch, min_fn = rec["channels"], rec["min_fn_scored"]
    points = [(name, i) for name, cfg in rec["configs"].items()
              for i in range(len(cfg["points"]))]
    made = [record_point_iq(rec, name, i, device) for name, i in points]
    dec = run_chain_iq(np.concatenate([w for w, _ in made]), device=device)
    results = []
    for k, ((name, i), (_, payloads)) in enumerate(zip(points, made)):
        row = rec["configs"][name]["points"][i]
        port = score(_channels(dec, k * nch, nch).stream, payloads, min_fn)
        p = ParityPoint(row["snr_db"], iq_sigma(row["snr_db"]), _tuple(row["ref"]), port)
        checks = {"frame_agreement_ok": bool(frame_agreement_ok(p)),
                  "ber_agreement_ok": bool(ber_agreement_ok(p))}
        results.append(ReplayPoint(name, row["snr_db"], p.sigma, port, {}, row, checks))
    return results


__all__ = ["make_iq_wire", "run_reference_iq", "run_chain_iq",
           "run_parity_iq", "record_point_iq", "replay_record_iq",
           "ber_agreement_ok", "frame_agreement_ok", "parity_to_json"]
