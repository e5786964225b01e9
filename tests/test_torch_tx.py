"""The port's TX slice against the JAX package on the same seeded inputs:
spec encoders, PRBS9 and the BER checker, the frame builders, the
session builders, the modulator, the channel models, the bench mix and
the ModState conversion.

Tolerances: bits, dibits, bytes, words and counts are held exactly.
IQ is held to IQ_ATOL: the modulator's phase is an f32 cumsum that
reaches hundreds of radians over a session, and XLA and PyTorch sum it
in another order (a few f32 ulps of the phase, ~6e-5 in IQ).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m17_sdr_tpu.dsp import channel as j_ch
from m17_sdr_tpu.dsp import filters as j_filters
from m17_sdr_tpu.dsp import iq as j_iq
from m17_sdr_tpu.dsp import modulate as j_mod
from m17_sdr_tpu.fec import conv as j_conv
from m17_sdr_tpu.frame import tx_frames as j_tf
from m17_sdr_tpu.pipeline import benchdata as j_bench
from m17_sdr_tpu.pipeline import tx as j_tx
from m17_sdr_tpu.spec import bits as j_bits
from m17_sdr_tpu.spec import callsign as j_call
from m17_sdr_tpu.spec import crc as j_crc
from m17_sdr_tpu.spec import golay as j_golay
from m17_sdr_tpu.spec import prbs as j_prbs
from m17_sdr_tpu.spec import puncture as j_punc
from m17_sdr_tpu.spec import typefield as j_type
from m17_sdr_tpu.spec import whiten as j_whiten
from m17_sdr_tpu_torch import convert
from m17_sdr_tpu_torch.dsp import channel as t_ch
from m17_sdr_tpu_torch.dsp import filters as t_filters
from m17_sdr_tpu_torch.dsp import iq as t_iq
from m17_sdr_tpu_torch.dsp import modulate as t_mod
from m17_sdr_tpu_torch.fec import conv as t_conv
from m17_sdr_tpu_torch.frame import tx_frames as t_tf
from m17_sdr_tpu_torch.pipeline import benchdata as t_bench
from m17_sdr_tpu_torch.pipeline import tx as t_tx
from m17_sdr_tpu_torch.spec import bits as t_bits
from m17_sdr_tpu_torch.spec import callsign as t_call
from m17_sdr_tpu_torch.spec import crc as t_crc
from m17_sdr_tpu_torch.spec import golay as t_golay
from m17_sdr_tpu_torch.spec import prbs as t_prbs
from m17_sdr_tpu_torch.spec import puncture as t_punc
from m17_sdr_tpu_torch.spec import typefield as t_type
from m17_sdr_tpu_torch.spec import whiten as t_whiten

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
IQ_ATOL = 2e-4            # planar IQ, unit amplitude
PHASE_ATOL = 2e-4         # ModState.phase, radians in [0, 2 pi)
BENCH_LSB = 8             # int16 bench blocks (3e-5 per LSB: IQ_ATOL / 3e-5 < 7)
CALLS = ["AB1CDE", "G4GUO", "M17-M17 A", "W1AW/P", "x.y", "", "TOOLONGCALLSIGN"]


def t(x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype)


def eq(name, got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64), err_msg=name)


def _lsf_bytes(rng, b: int) -> np.ndarray:
    """b random but CRC-valid 30-byte LSFs, built by the JAX package."""
    return np.asarray(j_tf.build_lsf_bytes(
        jnp.asarray(rng.integers(0, 256, (b, 6), dtype=np.uint8)),
        jnp.asarray(rng.integers(0, 256, (b, 6), dtype=np.uint8)),
        jnp.asarray(rng.integers(0, 1 << 16, b).astype(np.uint32)),
        jnp.asarray(rng.integers(0, 256, (b, 14), dtype=np.uint8))))


def test_port_imports_neither_jax_nor_jax_package():
    """Every module of the port imports with jax, jaxlib and m17_sdr_tpu
    blocked in sys.modules."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'm17_sdr_tpu'): sys.modules[m] = None\n"
        "import m17_sdr_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(len(names))\n")
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) >= 30


def test_bit_packing_equals_jax():
    rng = np.random.default_rng(10)
    bits = rng.integers(0, 2, (3, 5, 48), dtype=np.uint8)
    dib = rng.integers(0, 4, (3, 24), dtype=np.uint8)
    by = rng.integers(0, 256, (4, 6), dtype=np.uint8)
    words = rng.integers(0, 1 << 24, (7,)).astype(np.uint32)
    eq("bits_to_dibits", t_bits.bits_to_dibits(t(bits)), j_bits.bits_to_dibits(jnp.asarray(bits)))
    eq("dibits_to_bits", t_bits.dibits_to_bits(t(dib)), j_bits.dibits_to_bits(jnp.asarray(dib)))
    eq("bytes_to_dibits", t_bits.bytes_to_dibits(t(by)), j_bits.bytes_to_dibits(jnp.asarray(by)))
    eq("word_to_bytes_device", t_bits.word_to_bytes_device(t(words.astype(np.int64)), 3),
       j_bits.word_to_bytes_device(jnp.asarray(words), 3))
    eq("bytes_to_u12x4", t_bits.bytes_to_u12x4(t(by)), j_bits.bytes_to_u12x4(jnp.asarray(by)))
    for w in (0, 1, 0xABCDEF123456, 0xFFFFFFFFFFFF):
        np.testing.assert_array_equal(t_bits.word_to_bytes(w, 6), j_bits.word_to_bytes(w, 6))


def test_callsign_and_type_field_equal_jax():
    for call in CALLS:
        word = t_call.encode_callsign(call)
        assert word == j_call.encode_callsign(call)
        assert t_call.decode_callsign(word) == j_call.decode_callsign(word)
    assert t_call.decode_callsign(0xFFFFFFFFFFFF) == "BROADCAST"
    for word in (0, 5, 0xFFFF, 0x1234):
        assert t_type.M17Type.unpack(word).pack() == j_type.M17Type.unpack(word).pack()
        assert t_type.M17Type.unpack(word).__dict__ == j_type.M17Type.unpack(word).__dict__
    assert t_type.VOICE_STREAM_TYPE.pack() == j_type.VOICE_STREAM_TYPE.pack()


@pytest.mark.parametrize("nbytes", [1, 14, 28, 52])
def test_crc16_append_equals_jax(nbytes):
    data = np.random.default_rng(nbytes).integers(0, 256, (9, nbytes), dtype=np.uint8)
    got = t_crc.crc16_append(t(data))
    eq("crc16_append", got, j_crc.crc16_append(jnp.asarray(data)))
    assert (t_crc.crc16_fixed(got) == 0).all()


def test_golay_encode_equals_jax_and_decodes():
    words = np.arange(4096, dtype=np.uint32)
    got = t_golay.golay_encode(t(words.astype(np.int64)))
    eq("golay_encode", got, j_golay.golay_encode(jnp.asarray(words)))
    data, nerr = t_golay.golay_decode(got)
    eq("golay round trip", data, words)
    assert (nerr == 0).all()


@pytest.mark.parametrize("scheme, coded_len", [("p1", 488), ("p2", 296), ("p2", 402),
                                               ("p3", 420)])
def test_puncture_equals_jax(scheme, coded_len):
    """Including the BERT frame's 402 bits, not a multiple of P2's 12."""
    x = np.random.default_rng(coded_len).integers(0, 2, (4, coded_len), dtype=np.uint8)
    got = t_punc.puncture(t(x), scheme)
    eq("puncture", got, j_punc.puncture(jnp.asarray(x), scheme))
    assert t_punc.punctured_len(scheme, coded_len) == j_punc.punctured_len(scheme, coded_len)
    assert got.shape[-1] == t_punc.punctured_len(scheme, coded_len)


def test_whiten_bits_and_conv_bytes_equal_jax():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 2, (5, 368), dtype=np.uint8)
    eq("whiten_bits", t_whiten.whiten_bits(t(x)), j_whiten.whiten_bits(jnp.asarray(x)))
    eq("whiten_bits twice", t_whiten.whiten_bits(t_whiten.whiten_bits(t(x))), x)
    by = rng.integers(0, 256, (3, 26), dtype=np.uint8)
    eq("conv_encode_bytes", t_conv.conv_encode_bytes(t(by)),
       j_conv.conv_encode_bytes(jnp.asarray(by)))


def test_prbs_tables_window_and_alignment_equal_jax():
    np.testing.assert_array_equal(t_prbs.PRBS9_SEQUENCE, j_prbs.PRBS9_SEQUENCE)
    starts = np.array([0, 1, 197, 400, 510])
    eq("tx_window tensor", t_prbs.tx_window(t(starts), 197),
       j_prbs.tx_window(jnp.asarray(starts), 197))
    eq("tx_window int", t_prbs.tx_window(300, 600, device="cpu"), j_prbs.tx_window(300, 600))
    rng = np.random.default_rng(12)
    rx = np.asarray(j_prbs.tx_window(jnp.asarray(rng.integers(0, 511, 6)), 197))
    rx = rx ^ (rng.random(rx.shape) < 0.05).astype(np.uint8)
    rx[5] = rng.integers(0, 2, 197)                            # junk
    e_t, s_t = t_prbs.align_and_count_errors(t(rx))
    e_j, s_j = j_prbs.align_and_count_errors(jnp.asarray(rx))
    eq("align errors", e_t, e_j)
    eq("align shift", s_t, s_j)


def _frames(nf: int, start: int = 0) -> np.ndarray:
    idx = (start + np.arange(nf)[:, None] * 197 + np.arange(197)[None, :]) % 511
    return j_prbs.PRBS9_SEQUENCE[idx].astype(np.uint8)


def _checker_cases():
    """(bv [6, 10], bb [6, 10, 197]): the cases of the JAX package's own
    device-checker test: clean, burst, destroyed, dead link and gaps."""
    rng = np.random.default_rng(3)
    nch, s, n = 6, 10, 197
    bv = np.zeros((nch, s), bool)
    bb = np.zeros((nch, s, n), np.uint8)
    for ch in range(nch):
        nf = int(rng.integers(0, s + 1))
        frames = _frames(nf) if nf else np.zeros((0, n), np.uint8)
        if ch == 1 and nf > 2:
            frames[1, 40:90] ^= 1
        if ch == 2 and nf > 3:
            frames[2, 5:190] ^= 1
        if ch == 3:
            frames = rng.integers(0, 2, (nf, n), np.uint8)
        slots = np.sort(rng.choice(s, nf, replace=False))
        for f, sl in enumerate(slots):
            bv[ch, sl] = True
            bb[ch, sl] = frames[f]
    return bv, bb


def test_check_stream_host_walk_equals_jax():
    bv, bb = _checker_cases()
    for ch in range(bv.shape[0]):
        frames = bb[ch][bv[ch]]
        if len(frames):
            assert t_prbs.check_stream(frames) == j_prbs.check_stream(frames), ch
            np.testing.assert_array_equal(t_prbs.check_stream_frames(frames),
                                          j_prbs.check_stream_frames(frames))
    dropped = np.delete(_frames(8), 3, axis=0)
    assert t_prbs.check_stream(dropped) == j_prbs.check_stream(dropped) == (0, 7 * 197, 0)


def test_check_stream_device_equals_host_walk():
    bv, bb = _checker_cases()
    de, dn, du = t_prbs.check_stream_device(t(bv), t(bb))
    for ch in range(bv.shape[0]):
        frames = bb[ch][bv[ch]]
        want = t_prbs.check_stream(frames) if len(frames) else (0, 0, 0)
        assert (int(de[ch]), int(dn[ch]), int(du[ch])) == want, ch
    je, jn, ju = j_prbs.check_stream_device(jnp.asarray(bv), jnp.asarray(bb))
    for name, got, want in (("errors", de, je), ("bits", dn, jn), ("unsynced", du, ju)):
        eq(name, got, want)


def test_filters_and_iq_helpers_equal_jax():
    for os_ in (10, 40):
        np.testing.assert_array_equal(t_filters.tx_rrc_polyphase(os_),
                                      j_filters.tx_rrc_polyphase(os_))
    h = np.random.default_rng(13).normal(size=31).astype(np.float32)
    np.testing.assert_array_equal(t_filters.normalize_gain(h, 10.0),
                                  j_filters.normalize_gain(h, 10.0))
    z = np.exp(1j * np.linspace(0, 7, 50)).astype(np.complex64)[None]
    p = t_iq.from_complex(z, "cpu")
    np.testing.assert_array_equal(p.numpy(), np.asarray(j_iq.from_complex(z)))
    np.testing.assert_array_equal(t_iq.to_complex(p), j_iq.to_complex(np.asarray(p)))
    ph = np.linspace(-500, 500, 777).astype(np.float32)[None]
    np.testing.assert_allclose(t_iq.from_phase(t(ph)).numpy(),
                               np.asarray(j_iq.from_phase(jnp.asarray(ph))), atol=1e-6)


def test_frame_builders_equal_jax():
    rng = np.random.default_rng(14)
    b = 12
    lsf = _lsf_bytes(rng, b)
    dst, src = (rng.integers(0, 256, (b, 6), dtype=np.uint8) for _ in range(2))
    tw = rng.integers(0, 1 << 16, b)
    meta = rng.integers(0, 256, (b, 14), dtype=np.uint8)
    eq("build_lsf_bytes", t_tf.build_lsf_bytes(t(dst), t(src), t(tw), t(meta)),
       j_tf.build_lsf_bytes(jnp.asarray(dst), jnp.asarray(src),
                            jnp.asarray(tw.astype(np.uint32)), jnp.asarray(meta)))
    eq("build_link_setup_frame", t_tf.build_link_setup_frame(t(lsf)),
       j_tf.build_link_setup_frame(jnp.asarray(lsf)))

    count = rng.integers(0, 12, b)
    fn = rng.integers(0, 1 << 16, b)
    pay = rng.integers(0, 256, (b, 16), dtype=np.uint8)
    eq("build_stream_frame", t_tf.build_stream_frame(t(lsf), t(count), t(fn), t(pay)),
       j_tf.build_stream_frame(jnp.asarray(lsf), jnp.asarray(count.astype(np.int32)),
                               jnp.asarray(fn.astype(np.uint32)), jnp.asarray(pay)))

    pay25 = rng.integers(0, 256, (b, 25), dtype=np.uint8)
    eof = rng.random(b) < 0.5
    nf = rng.integers(0, 32, b)
    eq("build_packet_frame", t_tf.build_packet_frame(t(pay25), t(eof), t(nf)),
       j_tf.build_packet_frame(jnp.asarray(pay25), jnp.asarray(eof),
                               jnp.asarray(nf.astype(np.int32))))

    starts = rng.integers(0, 511, b)
    eq("build_bert_frame", t_tf.build_bert_frame(t(starts)),
       j_tf.build_bert_frame(jnp.asarray(starts.astype(np.int32))))
    eq("preamble_frame", t_tf.preamble_frame(3, "cpu"), j_tf.preamble_frame(3))
    eq("eot_frame", t_tf.eot_frame(3, "cpu"), j_tf.eot_frame(3))


def test_voice_session_dibits_equal_jax_across_fn_wrap():
    """fn0 near 0x7FFF (and one above it, and a large uint32) wraps the
    15-bit FN inside the session."""
    rng = np.random.default_rng(15)
    b, nf = 4, 6
    lsf = _lsf_bytes(rng, b)
    pay = rng.integers(0, 256, (b, nf, 16), dtype=np.uint8)
    fn0 = np.array([0x7FFC, 0x7FFF, 0x8003, 0xFFFFFFFE], dtype=np.uint32)
    got = t_tx.build_voice_session_dibits(t(lsf), t(pay), fn0=t(fn0.astype(np.int64)))
    eq("voice session", got, j_tx.build_voice_session_dibits(
        jnp.asarray(lsf), jnp.asarray(pay), fn0=jnp.asarray(fn0)))
    eq("voice session fn0=0", t_tx.build_voice_session_dibits(t(lsf), t(pay), n_preambles=1),
       j_tx.build_voice_session_dibits(jnp.asarray(lsf), jnp.asarray(pay), n_preambles=1))


@pytest.mark.parametrize("length", [23, 48, 60])
def test_packet_session_dibits_equal_jax(length):
    """23 and 48 bytes with their CRC fill 1 and 2 frames exactly; 60
    leave a short last chunk of 12 bytes."""
    rng = np.random.default_rng(length)
    lsf = _lsf_bytes(rng, 3)
    data = rng.integers(0, 256, (3, length), dtype=np.uint8)
    eq("packet session", t_tx.build_packet_session_dibits(t(lsf), t(data)),
       j_tx.build_packet_session_dibits(jnp.asarray(lsf), jnp.asarray(data)))


def test_bert_session_dibits_equal_jax():
    eq("bert session", t_tx.build_bert_session_dibits(3, 5, device="cpu"),
       j_tx.build_bert_session_dibits(3, 5))


def _jax_modulate(dibits, st=None):
    st = j_mod.ModState.init(dibits.shape[0]) if st is None else st
    iq, st = j_mod.modulate_dibits(jnp.asarray(dibits), st)
    return np.asarray(iq), st


def test_modulate_dibits_matches_jax_and_streams():
    rng = np.random.default_rng(16)
    dibits = rng.integers(0, 4, (3, 960), dtype=np.uint8)     # 5 frames
    iq_j, st_j = _jax_modulate(dibits)
    iq_t, st_t = t_mod.modulate_dibits(t(dibits), t_mod.ModState.init(3, "cpu"))
    np.testing.assert_allclose(iq_t.numpy(), iq_j, atol=IQ_ATOL)
    np.testing.assert_array_equal(st_t.filter_tail.numpy(), np.asarray(st_j.filter_tail))
    np.testing.assert_allclose(st_t.phase.numpy(), np.asarray(st_j.phase), atol=PHASE_ATOL)

    # 32-symbol chunks with the carry equal one shot
    st = t_mod.ModState.init(3, "cpu")
    parts = []
    for i in range(0, 960, 32):
        part, st = t_mod.modulate_dibits(t(dibits[:, i:i + 32]), st)
        parts.append(part)
    np.testing.assert_allclose(torch.cat(parts, dim=-1).numpy(), iq_t.numpy(), atol=IQ_ATOL)

    # other oversampling, and the carrier through the same chain
    iq_j, st_j = j_mod.modulate_dibits(jnp.asarray(dibits[:, :64]), j_mod.ModState.init(3),
                                       oversample=40)
    iq_t, st_t = t_mod.modulate_dibits(t(dibits[:, :64]), t_mod.ModState.init(3, "cpu"),
                                       oversample=40)
    np.testing.assert_allclose(iq_t.numpy(), np.asarray(iq_j), atol=IQ_ATOL)
    car_j, _ = j_mod.modulate_carrier(3, 48, st_j)
    car_t, _ = t_mod.modulate_carrier(3, 48, st_t)
    np.testing.assert_allclose(car_t.numpy(), np.asarray(car_j), atol=IQ_ATOL)


def test_iq_to_int16_equals_jax():
    z = np.random.default_rng(17).normal(size=(2, 2, 500)).astype(np.float32)
    z /= np.abs(z).max()
    eq("iq_to_int16", t_mod.iq_to_int16(t(z)), j_mod.iq_to_int16(jnp.asarray(z)))


def test_channel_models_match_jax():
    rng = np.random.default_rng(18)
    dibits = rng.integers(0, 4, (3, 192), dtype=np.uint8)
    iq, _ = _jax_modulate(dibits)
    x, jx = t(iq), jnp.asarray(iq)
    freq = np.array([100.0, -350.0, 1200.0])
    np.testing.assert_allclose(t_ch.carrier_offset(x, freq, phase0=0.3).numpy(),
                               np.asarray(j_ch.carrier_offset(jx, freq, phase0=0.3)),
                               atol=1e-5)
    np.testing.assert_allclose(t_ch.carrier_ramp(x, [50.0, -80.0, 20.0], start_hz=100.0)
                               .numpy(),
                               np.asarray(j_ch.carrier_ramp(jx, np.array([50.0, -80.0, 20.0]),
                                                            start_hz=100.0)), atol=1e-5)
    for ppm, off in ((130.0, 0.0), (np.array([-200.0, 50.0, 0.0]), 0.37)):
        np.testing.assert_allclose(t_ch.timing_drift(x, ppm, off).numpy(),
                                   np.asarray(j_ch.timing_drift(jx, ppm, off)), atol=1e-6)
    key = jax.random.PRNGKey(4)
    snr = np.array([10.0, 20.0, 30.0], dtype=np.float32)
    noise = np.asarray(jax.random.normal(key, iq.shape))
    np.testing.assert_allclose(t_ch.awgn(x, t(snr), noise=t(noise)).numpy(),
                               np.asarray(j_ch.awgn(key, jx, snr)), atol=1e-6)
    soft = rng.normal(size=(3, 100)).astype(np.float32)
    noise = np.asarray(jax.random.normal(key, soft.shape))
    np.testing.assert_allclose(
        t_ch.symbol_rate_awgn(t(soft), t(snr), noise=t(noise)).numpy(),
        np.asarray(j_ch.symbol_rate_awgn(key, jnp.asarray(soft), snr)), atol=1e-6)
    g = torch.Generator().manual_seed(0)
    assert t_ch.awgn(x, 20.0, generator=g).shape == x.shape
    with pytest.raises(ValueError):
        t_ch.awgn(x, 20.0)


def test_make_bench_blocks_matches_jax():
    blocks_t, nblk_t = t_bench.make_bench_blocks(128, device="cpu")
    blocks_j, nblk_j = j_bench.make_bench_blocks(128)
    assert nblk_t == nblk_j == len(blocks_t) == 13
    got = torch.stack(blocks_t, dim=1).numpy().astype(np.int32)
    want = np.stack([np.asarray(b) for b in blocks_j], axis=1).astype(np.int32)
    assert got.shape == want.shape == (128, 13, 2, 1920)
    assert blocks_t[0].dtype == torch.int16
    assert np.abs(got - want).max() <= BENCH_LSB


def test_mod_state_round_trip_continues_a_jax_stream():
    """A TX stream started in the JAX package goes on in the port."""
    rng = np.random.default_rng(19)
    dibits = rng.integers(0, 4, (2, 384), dtype=np.uint8)
    _, st_j = _jax_modulate(dibits[:, :192])
    flat = {f: np.asarray(getattr(st_j, f)) for f in st_j._fields}
    st_t = convert.mod_state_from_numpy(flat, "cpu")
    back = convert.mod_state_to_numpy(st_t)
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype and back[k].shape == flat[k].shape
        np.testing.assert_array_equal(back[k], flat[k])
    iq_j, _ = _jax_modulate(dibits[:, 192:], st_j)
    iq_t, _ = t_mod.modulate_dibits(t(dibits[:, 192:]), st_t)
    np.testing.assert_allclose(iq_t.numpy(), iq_j, atol=IQ_ATOL)
    with pytest.raises(ValueError):
        convert.mod_state_from_numpy({"phase": flat["phase"]}, "cpu")
