"""Measured BER parity against the reference RX chain, in the soft domain.

Port of ``m17_sdr_tpu.pipeline.ber_parity``.  One generator makes noisy
2-samples/symbol baseband waveforms (voice, packet or BERT sessions
shaped by the reference's test-mode RRC at its {+-0.3, +-1.0} symbol
map, plus AWGN), bit for bit as the JAX package makes them: the shaping
and the noise are numpy, only the dibits come from the port's TX.  The
same float32 samples are decoded by

  (a) the reference chain compiled in place from the sources that
      ``tests/golden_gen/Makefile`` names (``run_reference``), and
  (b) the chain under test, the port's ``rx_stream_soft`` (``run_chain``),

so agreement per SNR compares the implementations on the same noise.
The records keep the JAX package's layout: a point's ``ref`` slot is the
reference's tuple, its ``jax`` slot the chain under test's, and the
predicates read those two slots.

Where the reference's sources are absent, ``replay_record`` stands in
for them: it regenerates every point of a committed record
(``BER_PARITY_r4.json``) from the record's seed scheme, decodes them with
the port, and holds the port against the recorded ``ref`` and ``jax``
tuples.
"""

from __future__ import annotations

import concurrent.futures
import json
import pathlib
import re
import struct
import subprocess
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..dsp.filters import normalize_gain, rrc_filter
from ..frame import tx_frames
from ..spec import bits as bitpack
from ..spec import callsign as cs
from ..spec import crc as crcm
from ..spec import prbs
from ..spec.typefield import M17Type
from . import tx as txp
from .rx import RxSessionState, rx_stream_soft

GOLDEN_DIR = pathlib.Path(__file__).resolve().parents[2] / "tests" / "golden_gen"
CHUNK_2X = 384               # samples per block in the 2x/symbol domain
GUARD_BLOCKS = 3             # leading/trailing silence blocks per session

# the reference test-mode symbol map (m17_test.cpp:16)
_SYM_AMP = np.array([0.3, 1.0, -0.3, -1.0], dtype=np.float32)

# the record's seed scheme (tools/ber_parity.py): point i of a kind's SNR
# list uses seed SEED_BASE + SEED_STEP * i; sigma comes from the clean
# power of SIGNAL_POWER_SIZE (channels, frames); packet sessions carry at
# most PACKET_MAX_FRAMES chunks (a 5-bit frame counter)
SEED_BASE = 0
SEED_STEP = 1000
SIGNAL_POWER_SIZE = (2, 16)
PACKET_MAX_FRAMES = 32
MIN_FN = 8                   # stream frames scored from this FN on


class ParityPoint(NamedTuple):
    snr_db: float
    sigma: float
    # per chain: (frames recovered, total frames, payload bit errors,
    # payload bits among recovered frames); ``jax`` is the chain under test
    ref: tuple[int, int, int, int]
    jax: tuple[int, int, int, int]
    # reference timing bit-slip wraps counted by the trace build
    ref_slips: int = 0

    def bers(self) -> tuple[float, float]:
        return bers(self.ref, self.jax)


def bers(ref: tuple, jax: tuple) -> tuple[float, float]:
    """Each chain's bit error rate over its recovered frames' bits."""
    return (ref[2] / ref[3] if ref[3] else 0.0,
            jax[2] / jax[3] if jax[3] else 0.0)


def _test_mode_taps() -> np.ndarray:
    """The test-mode interpolation filter: 62-tap RRC at 2 samples/symbol
    normalized to unit tap sum (m17_test.cpp:57-59)."""
    return normalize_gain(rrc_filter(0.5, 62, 2), 1.0)


def _shape_wave(dibits: np.ndarray, sigma: float,
                rng: np.random.Generator) -> np.ndarray:
    """Dibits -> noisy 2x/symbol test-mode waveform with guard silence."""
    nch = dibits.shape[0]
    syms = _SYM_AMP[dibits]                              # [nch, NSYM]
    up = np.zeros((nch, syms.shape[1] * 2), np.float32)
    up[:, ::2] = syms                                    # 2 samples/symbol
    taps = _test_mode_taps()
    wave = np.stack([np.convolve(ch, taps, mode="full")[: up.shape[1]]
                     for ch in up])
    guard = np.zeros((nch, GUARD_BLOCKS * CHUNK_2X), np.float32)
    wave = np.concatenate([guard, wave, guard], axis=1)
    pad = (-wave.shape[1]) % CHUNK_2X
    if pad:
        wave = np.pad(wave, [(0, 0), (0, pad)])
    wave = wave + rng.normal(0.0, sigma, wave.shape).astype(np.float32)
    return wave.astype(np.float32)


def _lsf_for(nch: int, device) -> torch.Tensor:
    """[nch, 30] LSF AB1CDE <- G4GUO, default type, zero meta."""
    dst = bitpack.word_to_bytes(cs.encode_callsign("AB1CDE"), 6)
    src = bitpack.word_to_bytes(cs.encode_callsign("G4GUO"), 6)
    return tx_frames.build_lsf_bytes(
        torch.as_tensor(np.tile(dst, (nch, 1))).to(device),
        torch.as_tensor(np.tile(src, (nch, 1))).to(device),
        torch.full((nch,), M17Type().pack(), dtype=torch.int64, device=device),
        torch.zeros((nch, 14), dtype=torch.uint8, device=device))


def make_waveforms(nch: int, nf: int, sigma: float, seed: int,
                   kind: str = "stream", device="cuda"):
    """Build nch independent noisy session waveforms of one frame type.

    kind="stream": voice sessions; truth = payloads [nch, nf, 16].
    kind="packet": one packet superframe of nf 25-byte chunks per
      session (data length nf*25-2, CRC fills the final chunk); truth
      = (chunks [nch, nf, 25], data [nch, nf*25-2]).
    kind="bert": nf PRBS9 BERT frames per session; truth = expected
      bit frames [nf, 197] (the same for every channel: the PRBS phase
      advances 197 bits a frame from 0).

    The dibits are built on ``device``; the shaping and the noise are
    numpy, drawn from ``default_rng(seed)`` in the JAX package's order.
    Returns (wave [nch, T2] float32, truth), T2 a multiple of CHUNK_2X
    with GUARD_BLOCKS of silence on both ends.
    """
    rng = np.random.default_rng(seed)
    if kind == "stream":
        payloads = rng.integers(0, 256, (nch, nf, 16), dtype=np.uint8)
        dibits = txp.build_voice_session_dibits(
            _lsf_for(nch, device), torch.as_tensor(payloads).to(device))
        return _shape_wave(dibits.cpu().numpy(), sigma, rng), payloads
    if kind == "packet":
        if nf > PACKET_MAX_FRAMES:
            raise ValueError(f"packet sessions carry at most {PACKET_MAX_FRAMES} "
                             f"frames (5-bit counter), not {nf}")
        length = nf * 25 - 2
        data = rng.integers(0, 256, (nch, length), dtype=np.uint8)
        data_t = torch.as_tensor(data).to(device)
        dibits = txp.build_packet_session_dibits(_lsf_for(nch, device), data_t)
        chunks = crcm.crc16_append(data_t).cpu().numpy().reshape(nch, nf, 25)
        return _shape_wave(dibits.cpu().numpy(), sigma, rng), (chunks, data)
    if kind == "bert":
        dibits = txp.build_bert_session_dibits(nch, nf, device=device)
        idx = (np.arange(nf)[:, None] * prbs.BERT_FRAME_BITS
               + np.arange(prbs.BERT_FRAME_BITS)[None, :]) % prbs.PRBS9_LEN
        return _shape_wave(dibits.cpu().numpy(), sigma, rng), prbs.PRBS9_SEQUENCE[idx]
    raise ValueError(kind)


def signal_power(nch: int = 2, nf: int = 4, device="cuda") -> float:
    """Mean in-session power of the clean waveform (for SNR labels)."""
    wave, _ = make_waveforms(nch, nf, sigma=0.0, seed=0, device=device)
    live = wave[np.abs(wave) > 1e-6]
    return float(np.mean(live**2))


def sigma_for(snr_db: float, p_sig: float) -> float:
    """Noise sigma for an SNR label against the clean power ``p_sig``."""
    return float(np.sqrt(p_sig / (10.0 ** (snr_db / 10.0))))


class Decodes(NamedTuple):
    """One chain's decoded deliveries, keyed per frame type."""

    stream: dict          # {(ch, fn): 16 payload bytes}
    packet: dict          # {(ch, frame_idx): 25 chunk bytes}
    bert: dict            # {ch: [np.uint8[197] bit frames in order]}
    slips: dict           # {ch: timing bit-slip wraps} (trace runs only)


def same_decodes(a, b) -> bool:
    """Two Decodes (of either package) hold the same deliveries, BERT
    frames compared by value and dtype."""
    return (a.stream == b.stream and a.packet == b.packet and a.slips == b.slips
            and a.bert.keys() == b.bert.keys()
            and all(len(a.bert[c]) == len(b.bert[c])
                    and all(x.dtype == y.dtype and np.array_equal(x, y)
                            for x, y in zip(a.bert[c], b.bert[c]))
                    for c in a.bert))


def reference_dir() -> pathlib.Path:
    """The reference sources' directory, as ``tests/golden_gen/Makefile``
    names it (its ``REF :=`` line)."""
    text = (GOLDEN_DIR / "Makefile").read_text()
    m = re.search(r"^REF\s*:?=\s*(\S+)", text, re.MULTILINE)
    if m is None:
        raise RuntimeError(f"{GOLDEN_DIR / 'Makefile'} names no REF directory")
    return pathlib.Path(m.group(1))


def reference_exe(name: str) -> pathlib.Path:
    """The built reference decoder ``name`` (ber_ref, ber_ref_trace or
    ber_ref_iq), made with ``make`` where it is not built yet.  Raises
    FileNotFoundError where the reference sources are absent."""
    ref = reference_dir()
    if not ref.is_dir():
        raise FileNotFoundError(
            f"the reference sources are absent: {ref}, which "
            f"{GOLDEN_DIR / 'Makefile'} names, does not exist; the reference "
            "chain cannot be built (replay_record holds the port against the "
            "committed record instead)")
    exe = GOLDEN_DIR / name
    if not exe.exists():
        subprocess.run(["make", "-C", str(GOLDEN_DIR), "-s", name], check=True)
    return exe


def run_per_channel(exe: pathlib.Path, samples: np.ndarray, dtype: str,
                    workdir: str, jobs: int) -> list[str]:
    """Each channel of ``samples`` [nch, ...] through its own ``exe``
    process (the reference keeps framer lock and the LSF good-copy in file
    statics with no reset API); returns each channel's stdout."""
    def one(ch: int) -> str:
        path = pathlib.Path(workdir) / f"{exe.name}{ch}.bin"
        with open(path, "wb") as f:
            f.write(struct.pack("<ii", 1, samples.shape[1]))
            samples[ch].astype(dtype).tofile(f)
        try:
            return subprocess.run([str(exe), str(path)], check=True,
                                  capture_output=True, text=True).stdout
        finally:
            path.unlink()

    with concurrent.futures.ThreadPoolExecutor(jobs) as ex:
        return list(ex.map(one, range(samples.shape[0])))


def count_slips(lines: Sequence[str]) -> int:
    """In-session timing bit slips in a trace build's output: a polyphase
    index move that wraps (``Sync + 0`` / ``Sync - 39``) between the first
    and last frame dispatch (``Type:`` lines).  Wraps outside a session
    are the unlocked loop random-walking on guard noise and damage no
    frame."""
    tidx = [i for i, ln in enumerate(lines) if "Type:" in ln]
    if not tidx:
        return 0
    n_slip = 0
    for ln in lines[tidx[0]:tidx[-1] + 1]:
        t = ln.split()
        if len(t) >= 3 and t[0] == "Sync" and (t[1], t[2]) in (("+", "0"), ("-", "39")):
            n_slip += 1
    return n_slip


def parse_reference_lines(dec: Decodes, ch: int, lines: Sequence[str],
                          nf: int | None = None, trace: bool = False) -> None:
    """Add one channel's reference output to ``dec``: ``P fn hex`` stream
    payloads, ``K fn eof hex`` packet chunks and ``B hex`` BERT frames
    (each marker may follow other tokens), first delivery of a key
    winning.  ``nf`` maps a packet's eof chunk to index nf - 1 (its 5-bit
    field carries the byte count, not the index).  With ``trace``, also
    counts the channel's in-session slips."""
    if trace:
        dec.slips[ch] = count_slips(lines)
    for line in lines:
        toks = line.split()
        if toks and toks[0] == "Sync":
            continue
        for m, na in (("P", 3), ("K", 4), ("B", 2)):
            if m in toks:
                i = toks.index(m)
                parts = toks[i:i + 1 + na]
                break
        else:
            continue
        if len(parts) != 1 + na:
            continue
        if m == "P":
            dec.stream.setdefault((ch, int(parts[2])), bytes.fromhex(parts[3]))
        elif m == "K":
            fn, eof = int(parts[2]), int(parts[3])
            idx = (nf - 1) if (eof and nf) else fn
            dec.packet.setdefault((ch, idx), bytes.fromhex(parts[4]))
        else:
            bits = np.unpackbits(np.frombuffer(bytes.fromhex(parts[2]), np.uint8))[:197]
            dec.bert.setdefault(ch, []).append(bits)


def run_reference(wave: np.ndarray, workdir: str, jobs: int = 8,
                  nf: int | None = None, trace: bool = False) -> Decodes:
    """Decode with the reference chain, one process per channel (see
    ``run_per_channel``): channels model independent fresh receivers.
    Raises FileNotFoundError where the reference sources are absent."""
    exe = reference_exe("ber_ref_trace" if trace else "ber_ref")
    dec = Decodes({}, {}, {}, {})
    for ch, out in enumerate(run_per_channel(exe, wave, "<f4", workdir, jobs)):
        parse_reference_lines(dec, ch, out.splitlines(), nf=nf, trace=trace)
    return dec


def run_chain(wave: np.ndarray, nf: int | None = None, device="cuda",
              use_kernel: bool | None = None) -> Decodes:
    """Decode with the port's soft-domain pipeline (mirrors the JAX
    package's ``run_jax``): one ``rx_stream_soft`` over all channels on
    ``device``, each output field read to the host once.

    What is scored is what the chain routes (``stream_gate``: LSF known,
    quality gate, FN window), as the reference prints what its parse
    layer hands on.  The first delivery of a key wins: a stream FN carries
    no protection, so a later frame whose FN collides with a delivered one
    is an FN corruption, not a re-delivery.
    """
    nch, t2 = wave.shape
    blocks = torch.as_tensor(wave.reshape(nch, t2 // CHUNK_2X, CHUNK_2X)).to(device)
    out, _ = rx_stream_soft(blocks, RxSessionState.init(nch, device), use_kernel=use_kernel)
    kv = out.packet_valid.reshape(nch, -1).cpu().numpy()
    kfn = out.packet_fn.reshape(nch, -1).cpu().numpy()
    keof = out.packet_eof.reshape(nch, -1).cpu().numpy()
    kdata = out.packet_data.reshape(nch, -1, 25).cpu().numpy()
    bv = out.bert_valid.reshape(nch, -1).cpu().numpy()
    bb = out.bert_bits.reshape(nch, bv.shape[1], -1).cpu().numpy()
    dec = Decodes(routed_stream(out, nch), {}, {}, {})
    for ch in range(nch):
        for j in np.nonzero(kv[ch])[0]:
            idx = (nf - 1) if (keof[ch, j] and nf) else int(kfn[ch, j])
            dec.packet.setdefault((ch, idx), bytes(kdata[ch, j]))
        for j in np.nonzero(bv[ch])[0]:
            dec.bert.setdefault(ch, []).append(bb[ch, j].astype(np.uint8)[:197])
    return dec


def routed_stream(out, nch: int) -> dict:
    """The stream payloads an RX pass routed (``stream_gate``), read to the
    host once a field: {(ch, fn): 16 bytes}, the first delivery of an FN
    winning."""
    sv = out.stream_gate.reshape(nch, -1).cpu().numpy()
    fn = out.stream_fn.reshape(nch, -1).cpu().numpy()
    pl = out.stream_payload.reshape(nch, -1, 16).cpu().numpy()
    got = {}
    for ch in range(nch):
        for j in np.nonzero(sv[ch])[0]:
            got.setdefault((ch, int(fn[ch, j])), bytes(pl[ch, j]))
    return got


def score(got: dict, payloads: np.ndarray,
          min_fn: int = 0) -> tuple[int, int, int, int]:
    """(frames recovered, total frames, bit errors, bits recovered).

    min_fn scores steady state only: the reference routes voice solely
    through its assembled-LICH CRC gate, so its first ~6 stream frames per
    session are unroutable at any SNR.  Parity is meaningful from the
    first frame both chains can route.
    """
    nch, nf, _ = payloads.shape
    rec = errs = 0
    for ch in range(nch):
        for f in range(min_fn, nf):
            pl = got.get((ch, f))
            if pl is None:
                continue
            rec += 1
            x = np.frombuffer(pl, np.uint8) ^ payloads[ch, f]
            errs += int(np.unpackbits(x).sum())
    return rec, nch * (nf - min_fn), errs, rec * 128


# A frame with > 5% wrong bits is "slip-damaged", not channel noise: at
# any SNR where frames decode at all, post-Viterbi noise errors are a few
# bits, while a timing slip garbles everything after the slip point.
GARBLE_FRAC = 0.05


def _noslip_set(slips: dict | None, nch: int) -> set:
    """Channels where the reference's trace counted no in-session timing
    slip: the channel-matched subset."""
    if slips is None:
        return set()
    return {ch for ch in range(nch) if slips.get(ch, 0) == 0}


def score_packet(got: dict, chunks: np.ndarray, slips: dict | None = None):
    """Per-frame packet scoring + whole-superframe success counts.

    (frames, total, bit_errors, bits), extra dict.  Packet frames carry
    no per-frame CRC, so the extras split the error mass into
    ``garbled_frames`` (> GARBLE_FRAC wrong bits) and noise-floor errors
    on clean frames.  ``packets_ok`` counts superframes whose every chunk
    arrived bit-exact."""
    nch, nf, _ = chunks.shape
    noslip = _noslip_set(slips, nch)
    rec = errs = pkts_ok = garbled = clean_errs = 0
    ns_errs = ns_frames = 0
    for ch in range(nch):
        exact = 0
        for f in range(nf):
            pl = got.get((ch, f))
            if pl is None:
                continue
            rec += 1
            x = np.frombuffer(pl, np.uint8) ^ chunks[ch, f]
            e = int(np.unpackbits(x).sum())
            errs += e
            if e == 0:
                exact += 1
            if e > GARBLE_FRAC * 200:
                garbled += 1
            else:
                clean_errs += e
            if ch in noslip:
                ns_errs += e
                ns_frames += 1
        if exact == nf:
            pkts_ok += 1
    return ((rec, nch * nf, errs, rec * 200),
            {"packets_ok": pkts_ok, "packets_total": nch,
             "garbled_frames": garbled, "clean_bit_errors": clean_errs,
             "clean_bits": (rec - garbled) * 200,
             "noslip_channels": len(noslip),
             "noslip_bit_errors": ns_errs,
             "noslip_bits": ns_frames * 200})


def score_bert(got: dict, nch: int, nf: int, slips: dict | None = None):
    """BERT scoring through the PRBS9 stream checker (``spec/prbs.py``).
    (frames, total, bit_errors, bits_counted), extra.  Unsynced frames
    are booked at 50%; the extras separate them from the measured
    noise-floor errors on aligned frames."""
    noslip = _noslip_set(slips, nch)
    rec = errs = bits = garbled = clean_errs = 0
    ns_errs = ns_frames = 0
    thresh = GARBLE_FRAC * 197
    for ch in range(nch):
        frames = got.get(ch, [])
        if not frames:
            continue
        e, n, _ = prbs.check_stream(np.stack(frames))
        rec += len(frames)
        errs += e
        bits += n
        per = prbs.check_stream_frames(np.stack(frames))
        damaged = (per < 0) | (per > thresh)
        garbled += int(damaged.sum())
        clean_errs += int(per[~damaged].sum())
        if ch in noslip:
            ns_errs += e
            ns_frames += len(frames)
    return ((rec, nch * nf, errs, bits),
            {"garbled_frames": garbled,
             "clean_bit_errors": clean_errs,
             "clean_bits": (rec - garbled) * 197,
             "noslip_channels": len(noslip),
             "noslip_bit_errors": ns_errs,
             "noslip_bits": ns_frames * 197})


class TypedParityPoint(NamedTuple):
    """Parity point for the packet and BERT frame types (the same ref/jax
    tuple shape as ParityPoint, so the predicates apply unchanged)."""

    kind: str
    snr_db: float
    sigma: float
    ref: tuple[int, int, int, int]
    jax: tuple[int, int, int, int]
    extra: dict

    def bers(self) -> tuple[float, float]:
        return bers(self.ref, self.jax)


def run_parity(snr_points_db, nch: int, nf: int, workdir: str,
               seed: int = 0, min_fn: int = MIN_FN, kind: str = "stream",
               jobs: int = 8, device="cuda"):
    """Shared-waveform BER parity sweep over an SNR grid: each point's
    waveform through the reference (trace build) and through the port.

    kind="stream" returns ParityPoints scored from min_fn; kind="packet"
    or "bert" returns TypedParityPoints (min_fn is ignored: neither path
    is gated on LICH assembly), their extras split on the reference's
    slip set.  Needs the reference's sources (``run_reference``)."""
    p_sig = signal_power(min(nch, 2), min(nf, 16), device=device)
    points = []
    for i, snr in enumerate(snr_points_db):
        sigma = sigma_for(snr, p_sig)
        wave, truth = make_waveforms(nch, nf, sigma, seed=seed + SEED_STEP * i,
                                     kind=kind, device=device)
        ref = run_reference(wave, workdir, jobs=jobs, nf=nf, trace=True)
        got = run_chain(wave, nf=nf, device=device)
        ref_slips = int(sum(ref.slips.values()))
        if kind == "stream":
            points.append(ParityPoint(
                snr_db=float(snr), sigma=sigma,
                ref=score(ref.stream, truth, min_fn),
                jax=score(got.stream, truth, min_fn),
                ref_slips=ref_slips))
            continue
        if kind == "packet":
            r, rex = score_packet(ref.packet, truth[0], slips=ref.slips)
            j, jex = score_packet(got.packet, truth[0], slips=ref.slips)
        else:
            r, rex = score_bert(ref.bert, nch, nf, slips=ref.slips)
            j, jex = score_bert(got.bert, nch, nf, slips=ref.slips)
        rex["timing_slips"] = ref_slips
        points.append(TypedParityPoint(kind, float(snr), sigma, r, j,
                                       {"ref": rex, "jax": jex}))
    return points


def typed_agreement_ok(p: TypedParityPoint, z: float = 4.0,
                       abs_slack: float = 0.001) -> bool:
    """Agreement predicate for the packet and BERT frame types, which
    carry no per-frame CRC.  Requires:
      1. frame recovery at least the reference's (frame_agreement_ok);
      2. clean-frame BER equality: a two-proportion z-test over each
         chain's non-garbled frames;
      3. this chain garbles at most as many frames as the reference.
    """
    if not frame_agreement_ok(p):
        return False
    rex, jex = p.extra["ref"], p.extra["jax"]
    n1 = max(rex["clean_bits"], 1)
    n2 = max(jex["clean_bits"], 1)
    rb = rex["clean_bit_errors"] / n1
    jb = jex["clean_bit_errors"] / n2
    pooled = (rex["clean_bit_errors"] + jex["clean_bit_errors"]) / (n1 + n2)
    se = np.sqrt(max(pooled * (1 - pooled), 1e-12) * (1 / n1 + 1 / n2))
    if abs(rb - jb) > z * se + abs_slack:
        return False
    m1, m2 = max(p.ref[0], 1), max(p.jax[0], 1)
    g1 = rex["garbled_frames"] / m1
    g2 = jex["garbled_frames"] / m2
    pooled_g = (rex["garbled_frames"] + jex["garbled_frames"]) / (m1 + m2)
    g_se = np.sqrt(max(pooled_g * (1 - pooled_g), 1e-12) * (1 / m1 + 1 / m2))
    return g2 <= g1 + z * g_se + 0.02


def parity_to_json(points: list[ParityPoint]) -> dict:
    out = {"methodology": "shared-waveform: identical noisy samples "
                          "decoded by the in-place-compiled reference "
                          "chain and the chain under test", "points": []}
    for p in points:
        rb, jb = p.bers()
        out["points"].append({
            "snr_db": p.snr_db, "sigma": round(p.sigma, 6),
            "ref": {"frames": p.ref[0], "total": p.ref[1],
                    "bit_errors": p.ref[2], "bits": p.ref[3],
                    "ber": round(rb, 6)},
            "jax": {"frames": p.jax[0], "total": p.jax[1],
                    "bit_errors": p.jax[2], "bits": p.jax[3],
                    "ber": round(jb, 6)},
        })
    return out


def ber_agreement_ok(p: ParityPoint, z: float = 4.0,
                     abs_slack: float = 0.001) -> bool:
    """Two-proportion agreement within z binomial standard errors, plus a
    small absolute slack for near-zero BERs (below the 2.4e-3 effect of
    slip-garbled frames delivered without the stream quality gate)."""
    n1, n2 = max(p.ref[3], 1), max(p.jax[3], 1)
    rb, jb = p.bers()
    pooled = (p.ref[2] + p.jax[2]) / (n1 + n2)
    se = np.sqrt(max(pooled * (1 - pooled), 1e-12) * (1 / n1 + 1 / n2))
    return abs(rb - jb) <= z * se + abs_slack


def frame_agreement_ok(p: ParityPoint, z: float = 4.0,
                       abs_slack: float = 0.08) -> bool:
    """Frame recovery must be at least the reference's, within binomial
    confidence; exceeding it is a win, not a parity violation."""
    n = max(p.ref[1], 1)
    r1, r2 = p.ref[0] / n, p.jax[0] / n
    pooled = (p.ref[0] + p.jax[0]) / (2 * n)
    se = np.sqrt(max(pooled * (1 - pooled), 1e-12) * 2 / n)
    return r2 >= r1 - (z * se + abs_slack)


# ---------------------------------------------------------------- replay

# the typed extras that a replay must reproduce exactly; the noslip_*
# fields split on the reference's per-channel slip set, which the record
# does not keep
TYPED_EXACT = {"packet": ("garbled_frames", "clean_bit_errors", "clean_bits", "packets_ok"),
               "bert": ("garbled_frames", "clean_bit_errors", "clean_bits")}


def _tuple(row: dict) -> tuple[int, int, int, int]:
    return row["frames"], row["total"], row["bit_errors"], row["bits"]


class ReplayPoint(NamedTuple):
    """One recorded point, regenerated and decoded by the port."""

    kind: str                 # "stream", "packet", "bert", or an IQ config
    snr_db: float
    sigma: float
    port: tuple[int, int, int, int]
    port_extra: dict          # typed kinds: the score's extras; else {}
    recorded: dict            # the record's row ("ref", "jax", "extra", ...)
    checks: dict              # predicate name -> its value on (recorded ref, port)

    def recorded_jax(self) -> tuple[int, int, int, int]:
        return _tuple(self.recorded["jax"])

    def equals_recorded_jax(self) -> bool:
        """The port's tuple, and for typed kinds its exact extras, equal
        the recorded ``jax`` entry."""
        if self.port != self.recorded_jax():
            return False
        want = self.recorded.get("extra", {}).get("jax", {})
        return all(self.port_extra[k] == want[k] for k in TYPED_EXACT.get(self.kind, ()))

    def checks_ok(self) -> bool:
        return all(self.checks.values())


def record_point(rec: dict, kind: str, i: int, device="cuda"):
    """Point i of a kind in a soft-domain record (``BER_PARITY_r4.json``),
    made anew: ``make_waveforms`` with seed SEED_BASE + SEED_STEP * i at
    the sigma the point's SNR gives against the clean power of
    SIGNAL_POWER_SIZE, asserted to round to the recorded sigma.  Returns
    (wave, truth, sigma, frames per session)."""
    row = rec[kind]["points"][i]
    nf = min(rec["frames_per_session"], PACKET_MAX_FRAMES) if kind == "packet" \
        else rec["frames_per_session"]
    sigma = sigma_for(row["snr_db"], signal_power(*SIGNAL_POWER_SIZE, device=device))
    if round(sigma, 6) != row["sigma"]:
        raise ValueError(f"{kind} {row['snr_db']} dB: sigma {sigma:.7f} does not "
                         f"round to the recorded {row['sigma']}")
    wave, truth = make_waveforms(rec["channels"], nf, sigma, seed=SEED_BASE + SEED_STEP * i,
                                 kind=kind, device=device)
    return wave, truth, sigma, nf


def replay_record(path, kinds: Sequence[str] = ("stream", "packet", "bert"),
                  device="cuda", snr_db: Sequence[float] | None = None) -> list[ReplayPoint]:
    """Regenerate the points of a soft-domain record (``BER_PARITY_r4.json``)
    and decode them with the port.

    Each point is made by ``record_point``; all points of a kind are
    decoded in one ``rx_stream_soft`` call (channels are independent).  A
    point is scored with ``slips=None``: the record keeps the reference's
    slip count, not its slip set.  ``snr_db`` limits the replay to those
    points.  Each result holds the port's tuple and extras, the recorded
    row, and the record's predicates evaluated on (recorded ``ref``, port).
    """
    rec = json.loads(pathlib.Path(path).read_text())
    nch = rec["channels"]
    results = []
    for kind in kinds:
        idx = [i for i, row in enumerate(rec[kind]["points"])
               if snr_db is None or any(abs(row["snr_db"] - s) < 1e-9 for s in snr_db)]
        made = [record_point(rec, kind, i, device) for i in idx]
        nf = made[0][3]
        dec = run_chain(np.concatenate([m[0] for m in made]), nf=nf, device=device)
        for k, (i, (_, truth, sigma, _)) in enumerate(zip(idx, made)):
            row = rec[kind]["points"][i]
            got = _channels(dec, k * nch, nch)
            ref = _tuple(row["ref"])
            if kind == "stream":
                port, extra = score(got.stream, truth, MIN_FN), {}
                p = ParityPoint(row["snr_db"], sigma, ref, port)
                checks = {"ber_agreement_ok": bool(ber_agreement_ok(p)),
                          "frame_agreement_ok": bool(frame_agreement_ok(p))}
            else:
                if kind == "packet":
                    port, extra = score_packet(got.packet, truth[0])
                else:
                    port, extra = score_bert(got.bert, nch, nf)
                p = TypedParityPoint(kind, row["snr_db"], sigma, ref, port,
                                     {"ref": row["extra"]["ref"], "jax": extra})
                checks = {"typed_agreement_ok": bool(typed_agreement_ok(p))}
            results.append(ReplayPoint(kind, row["snr_db"], sigma, port, extra, row, checks))
    return results


def _channels(dec: Decodes, first: int, n: int) -> Decodes:
    """Channels [first, first + n) of ``dec``, renumbered from 0."""
    last = first + n
    return Decodes(
        {(ch - first, k): v for (ch, k), v in dec.stream.items() if first <= ch < last},
        {(ch - first, k): v for (ch, k), v in dec.packet.items() if first <= ch < last},
        {ch - first: v for ch, v in dec.bert.items() if first <= ch < last},
        {ch - first: v for ch, v in dec.slips.items() if first <= ch < last})
