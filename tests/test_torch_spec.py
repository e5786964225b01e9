"""The port's protocol tables and bit transforms against the JAX package
(exact, on seeded random inputs) and against the golden vectors of the
C++ reference (tests/goldens/goldens.txt)."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m17_sdr_tpu.dsp.filters as j_filters
import m17_sdr_tpu.fec.conv as j_conv
import m17_sdr_tpu.spec.constants as j_const
from m17_sdr_tpu.spec import bits as j_bits
from m17_sdr_tpu.spec import crc as j_crc
from m17_sdr_tpu.spec import golay as j_golay
from m17_sdr_tpu.spec import interleave as j_il
from m17_sdr_tpu.spec import puncture as j_punc
from m17_sdr_tpu.spec import whiten as j_whiten
from m17_sdr_tpu_torch.dsp import filters as t_filters
from m17_sdr_tpu_torch.fec import conv as t_conv
from m17_sdr_tpu_torch.spec import bits as t_bits
from m17_sdr_tpu_torch.spec import constants as t_const
from m17_sdr_tpu_torch.spec import crc as t_crc
from m17_sdr_tpu_torch.spec import golay as t_golay
from m17_sdr_tpu_torch.spec import interleave as t_il
from m17_sdr_tpu_torch.spec import puncture as t_punc
from m17_sdr_tpu_torch.spec import whiten as t_whiten

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "tests" / "goldens" / "goldens.txt"


def _goldens() -> dict[str, np.ndarray]:
    out = {}
    for line in GOLDENS.read_text().splitlines():
        name, n, *vals = line.split()
        is_float = any("." in v or "e" in v for v in vals)
        out[name] = np.array([float(v) for v in vals]) if is_float else \
            np.array([int(v) for v in vals], dtype=np.int64)
        assert len(out[name]) == int(n)
    return out


G = _goldens()


def t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("name, port, ref", [
    ("SYNC_PATTERNS", t_const.SYNC_PATTERNS, j_const.SYNC_PATTERNS),
    ("DIBIT_TO_SYMBOL", t_const.DIBIT_TO_SYMBOL, j_const.DIBIT_TO_SYMBOL),
    ("CLUT", t_conv.CLUT, j_conv.CLUT),
    ("PREV0", t_conv.PREV0, j_conv.PREV0),
    ("PREV1", t_conv.PREV1, j_conv.PREV1),
    ("DIBIT0", t_conv.DIBIT0, j_conv.DIBIT0),
    ("DIBIT1", t_conv.DIBIT1, j_conv.DIBIT1),
    ("INTERLEAVE_PERM", t_il.INTERLEAVE_PERM, j_il.INTERLEAVE_PERM),
    ("SYNDROME_TABLE", t_golay.SYNDROME_TABLE, j_golay.SYNDROME_TABLE),
    ("GOLAY_P", t_golay._P, j_golay._P),
    ("WHITEN_SIGNS", t_whiten.WHITEN_SIGNS, j_whiten.WHITEN_SIGNS),
    ("CRC_AFFINE_30", t_crc._affine(30)[0], j_crc._affine(30)[0]),
    ("CRC_CONST_30", t_crc._affine(30)[1], j_crc._affine(30)[1]),
    ("P1_INDICES", t_punc._indices("p1", 488), j_punc._indices("p1", 488)),
    ("P2_INDICES", t_punc._indices("p2", 296), j_punc._indices("p2", 296)),
    ("P3_INDICES", t_punc._indices("p3", 420), j_punc._indices("p3", 420)),
    ("MF_BANK", t_filters.polyphase_rrc_bank(40, 31)[0], j_filters.polyphase_rrc_bank(40, 31)[0]),
    ("DMF_BANK", t_filters.polyphase_rrc_bank(40, 31)[1], j_filters.polyphase_rrc_bank(40, 31)[1]),
])
def test_tables_equal_jax(name, port, ref):
    np.testing.assert_array_equal(np.asarray(port).astype(np.float64),
                                  np.asarray(ref).astype(np.float64), err_msg=name)


def test_scalar_constants_equal_jax():
    names = [n for n in dir(t_const) if n.isupper() and not n.startswith("_")]
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(t_const, n)),
                                      np.asarray(getattr(j_const, n)), err_msg=n)


def test_bit_packing_equals_jax():
    rng = np.random.default_rng(1)
    by = rng.integers(0, 256, (5, 7, 30), dtype=np.uint8)
    bits = rng.integers(0, 2, (5, 7, 48), dtype=np.uint8)
    u12 = rng.integers(0, 4096, (9, 4), dtype=np.int32)
    soft = rng.normal(size=(9, 4, 24)).astype(np.float32)
    soft[0, 0, :5] = 0.0
    np.testing.assert_array_equal(t_bits.bytes_to_bits(t(by)).numpy(),
                                  np.asarray(j_bits.bytes_to_bits(jnp.asarray(by))))
    np.testing.assert_array_equal(t_bits.bits_to_bytes(t(bits)).numpy(),
                                  np.asarray(j_bits.bits_to_bytes(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        t_bits.bytes_to_word(t(by[..., :2])).numpy(),
        np.asarray(j_bits.bytes_to_word_device(jnp.asarray(by[..., :2]))).astype(np.int64))
    np.testing.assert_array_equal(t_bits.u12x4_to_bytes(t(u12)).numpy(),
                                  np.asarray(j_bits.u12x4_to_bytes(jnp.asarray(u12))))
    np.testing.assert_array_equal(
        t_bits.hard_decision_word(t(soft)).numpy(),
        np.asarray(j_bits.hard_decision_word(jnp.asarray(soft))).astype(np.int64))


@pytest.mark.parametrize("nbytes", [30, 52])
def test_crc_equals_jax(nbytes):
    rng = np.random.default_rng(nbytes)
    msg = rng.integers(0, 256, (64, nbytes), dtype=np.uint8)
    with_crc = np.asarray(j_crc.crc16_append(jnp.asarray(msg[:, :-2])))
    msg[:8] = with_crc[:8]           # some valid messages: CRC 0
    got = t_crc.crc16_fixed(t(msg)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_crc.crc16_fixed(jnp.asarray(msg))))
    assert (got[:8] == 0).all()


def test_golay_decode_equals_jax():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 4096, 300)
    words = np.asarray(j_golay.golay_encode(jnp.asarray(data, jnp.uint32))).astype(np.int64)
    # 0 to 5 bit errors in each word
    for i, w in enumerate(words):
        for pos in rng.choice(24, size=i % 6, replace=False):
            words[i] ^= 1 << int(pos)
    d_t, e_t = t_golay.golay_decode(t(words))
    d_j, e_j = j_golay.golay_decode(jnp.asarray(words, jnp.uint32))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j).astype(np.int64))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    assert (e_t.numpy()[np.arange(300) % 6 <= 3] <= 3).all()


def test_soft_unwrap_and_depuncture_equal_jax():
    rng = np.random.default_rng(3)
    soft = rng.normal(size=(6, 368)).astype(np.float32)
    np.testing.assert_array_equal(t_whiten.whiten_soft(t(soft)).numpy(),
                                  np.asarray(j_whiten.whiten_soft(jnp.asarray(soft))))
    np.testing.assert_array_equal(t_il.deinterleave(t(soft)).numpy(),
                                  np.asarray(j_il.deinterleave(jnp.asarray(soft))))
    for scheme, n in (("p1", 488), ("p2", 296), ("p2", 402), ("p3", 420)):
        kept = len(j_punc._indices(scheme, n))
        x = rng.normal(size=(6, kept)).astype(np.float32)
        np.testing.assert_array_equal(
            t_punc.depuncture(t(x), scheme, n).numpy(),
            np.asarray(j_punc.depuncture(jnp.asarray(x), scheme, n)), err_msg=scheme)


def test_conv_encode_equals_jax():
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (7, 144), dtype=np.uint8)
    np.testing.assert_array_equal(t_conv.conv_encode_bits(t(bits)).numpy(),
                                  np.asarray(j_conv.conv_encode_bits(jnp.asarray(bits))))


def test_goldens():
    """The port against the C++ reference's golden vectors."""
    coded = t_conv.conv_encode_bits(t(G["conv1_in_bits"], torch.uint8))
    np.testing.assert_array_equal(coded.numpy(), G["conv1_out_bits"])
    coded = t_conv.conv_encode_bits(t_bits.bytes_to_bits(t(G["conv_in_bytes"], torch.uint8)))
    np.testing.assert_array_equal(coded.numpy(), G["conv_out_bits"])

    np.testing.assert_array_equal(
        t_il.interleave(t(G["p1_punc_bits"], torch.uint8)).numpy(), G["interleaved_bits"])
    soft = t(G["whitened_bits"], torch.float32) * 2 - 1
    de = t_il.deinterleave(t_whiten.whiten_soft(soft))
    np.testing.assert_array_equal((de > 0).numpy().astype(np.int64), G["soft_deint_sign"])

    assert int(t_crc.crc16_fixed(t(G["crc_msg"], torch.uint8))) == int(G["crc_val"][0])

    ref = G["golay_words"].reshape(8, 3)
    words = (ref[:, 0] << 16) | (ref[:, 1] << 8) | ref[:, 2]
    data, nerr = t_golay.golay_decode(t(words))
    np.testing.assert_array_equal(data.numpy(), G["golay_data"])
    assert (nerr.numpy() == 0).all()

    # P2 depuncture of the reference's punctured stream restores the code
    kept = t(G["stream_punc_bits"], torch.float32) * 1.8 - 0.9
    full = t_punc.depuncture(kept, "p2", 296)
    stream_coded = t_conv.conv_encode_bits(
        t_bits.bytes_to_bits(t(G["stream_in_bytes"], torch.uint8)))
    nz = full != 0
    np.testing.assert_array_equal((full[nz] > 0).numpy(), stream_coded[nz].numpy() == 1)


def test_port_imports_no_jax():
    """Importing the port and running its entry point on the CPU loads
    neither JAX nor the JAX package."""
    code = ("import sys; import m17_sdr_tpu_torch; "
            "from m17_sdr_tpu_torch.entry import entry; "
            "out, st = entry('cpu'); "
            "assert out.stream_valid.shape == (64, 3); "
            "bad = [m for m in sys.modules "
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'm17_sdr_tpu')]; "
            "assert not bad, bad; print('clean')")
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"
