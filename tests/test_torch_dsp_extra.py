"""The port's dormant DSP and the helpers only tests reach, against the JAX
package on the same inputs: the PLL discriminator and the half-band
filter, the Kalman training equalizer, ``crc16_scan`` and
``parse_lsf_fields``.  Each mirrors a JAX test (tests/test_pll_halfband.py,
tests/test_equalize_gps_ptt.py, tests/test_spec.py, tests/test_frame.py)
and also runs the JAX function on the same input."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_equalize_gps_ptt import ScalarEq, _symbols
from torch_parity import FLOAT_ATOL, FLOAT_RTOL, assert_same

from m17_sdr_tpu.dsp import equalize as j_eq
from m17_sdr_tpu.dsp import pll as j_pll
from m17_sdr_tpu.frame import rx_frames as j_rxf
from m17_sdr_tpu.frame import tx_frames as j_txf
from m17_sdr_tpu.spec import crc as j_crc
from m17_sdr_tpu_torch import convert
from m17_sdr_tpu_torch.dsp import equalize as t_eq
from m17_sdr_tpu_torch.dsp import pll as t_pll
from m17_sdr_tpu_torch.frame import rx_frames as t_rxf
from m17_sdr_tpu_torch.spec import callsign as t_call
from m17_sdr_tpu_torch.spec import crc as t_crc
from m17_sdr_tpu_torch.spec.bits import bytes_to_word_host
from m17_sdr_tpu_torch.spec.constants import DIBIT_TO_SYMBOL

torch.set_num_threads(2)

SRATE = 48000.0
# The PLL's detector output is up to A*sqrt(2) = 2.8e4 at int16 scale, and
# cos/sin and the rotation's sums round unlike XLA's in the last ulp
# (2e-3 at that scale).  Measured over 15360 samples: outputs within
# 8.8e-3 (2.8e-7 of full scale), the DC within 9.8e-4, z equal.  Floats
# are held to FLOAT_RTOL and an absolute 1e-6 of full scale.
PLL_ATOL = 0.03
# equalize_train: XLA's CPU backend contracts the recursion's multiply-adds
# into fused multiply-adds (one rounding where torch rounds twice; its
# compiled fusions show it).  Evaluated op by op (jax.disable_jit) the JAX
# function equals the port bit for bit (test below).  Jitted, the two stay
# within 1.2e-6 while the recursion is well conditioned (measured: the
# scalar-model inputs, and the first 250 symbols of the noiseless ISI run).
EQ_ATOL = 1e-4
# After ~250 symbols of noiseless ISI training the UD factors grow ill
# conditioned (d up to 1e12, taps up to 1.6e5 by symbol 392), and the FMA
# roundings grow to 4.6e-5 by symbol 300 and 2.3e-2 by 400 (measured): the
# jitted JAX run is held symbol by symbol over the first ISI_HELD symbols.
ISI_HELD = 250


def _tone(freq_hz, amp, n, batch=2):
    t = np.arange(n) / SRATE
    ph = 2 * np.pi * freq_hz * t
    x = np.stack([amp * np.cos(ph), amp * np.sin(ph)])
    return np.tile(x[None], (batch, 1, 1)).astype(np.float32)


def _raw_vals(out, dc):
    """pll_disc returns vals - dc; the raw detector output."""
    return np.asarray(out) + np.asarray(dc)[:, None]


def _pll_both(x, z0=None):
    b = x.shape[0]
    st_t = t_pll.PllState.init(b, "cpu")
    st_j = j_pll.PllState.init(b)
    if z0 is not None:
        st_j = j_pll.PllState(z=jnp.asarray(z0))
        st_t = convert.fields_from_numpy(t_pll.PllState, {"z": z0}, "cpu")
    got = t_pll.pll_disc(torch.as_tensor(x), st_t)
    want = j_pll.pll_disc(jnp.asarray(x), st_j)
    for name, a, w in (("disc", got[0], want[0]), ("dc", got[1], want[1]),
                       ("z", got[2].z, want[2].z)):
        assert_same(name, a, w, FLOAT_RTOL, PLL_ATOL)
    return got


# ---------------------------------------------------------------- PLL


def test_pll_locks_to_carrier_offset():
    """Type-I loop: settled detector output val = -omega / k (within the
    ~10 Hz lock range of K = 3e-8 at int16 scale)."""
    amp, freq, n = 20000.0, 5.0, 8 * 1920
    out, dc, _ = _pll_both(_tone(freq, amp, n))
    assert out.shape == (2, n // 5)
    vals = _raw_vals(out, dc)
    tail = float(vals[0, -vals.shape[1] // 4:].mean())
    np.testing.assert_allclose(tail * t_pll.PLL_LOOP_GAIN, -2 * np.pi * freq / SRATE, rtol=0.1)


def test_pll_zero_offset_settles_to_zero():
    out, dc, _ = _pll_both(_tone(0.0, 20000.0, 8 * 1920))
    vals = _raw_vals(out, dc)
    assert float(np.abs(vals[0, -vals.shape[1] // 4:]).mean()) < 20000.0 * 0.02


def test_pll_block_split_matches_one_shot():
    """The carry: two chained blocks give the one double block's outputs
    (tolerance of the JAX test), and the second block from a JAX state
    matches JAX."""
    amp, freq, n = 20000.0, 5.0, 2 * 1920
    x = _tone(freq, amp, n)
    full, dcf, _ = _pll_both(x)
    o1, dc1, st = _pll_both(x[:, :, : n // 2])
    o2, dc2, _ = _pll_both(x[:, :, n // 2:], z0=convert.fields_to_numpy(st)["z"])
    np.testing.assert_allclose(_raw_vals(full, dcf),
                               np.concatenate([_raw_vals(o1, dc1), _raw_vals(o2, dc2)], -1),
                               rtol=1e-4, atol=2.0)


def test_pll_rejects_block_not_multiple_of_decimation():
    with pytest.raises(AssertionError):
        t_pll.pll_disc(torch.zeros(1, 2, 1921), t_pll.PllState.init(1, "cpu"))


def test_halfband_matches_reference_loop_and_jax():
    """Against a transcription of m17_halfband_filter's index walk (1 LSB,
    the float32 accumulation) and the JAX function."""
    flen = 63
    compact = t_pll.design_halfband(flen)
    np.testing.assert_array_equal(compact, j_pll.design_halfband(flen))
    rng = np.random.default_rng(0)
    n = 400
    x = rng.integers(-32768, 32767, (2, 2, n)).astype(np.float32)
    h = t_pll.expand_halfband(compact.astype(np.float32), flen)
    np.testing.assert_array_equal(h, j_pll.expand_halfband(compact.astype(np.float32), flen))
    want = np.zeros((2, 2, n - flen + 1), np.float32)
    for i in range(n - flen + 1):
        want[:, :, i] = np.floor(np.einsum("bct,t->bc", x[:, :, i:i + flen], h) / 32768.0)
    got = t_pll.halfband_filter(torch.as_tensor(x), compact, flen).numpy()
    np.testing.assert_allclose(got, want, atol=1.0)
    # integer-valued outputs: the port and JAX differ at most where the
    # float32 sums round across an integer, by 1 LSB
    np.testing.assert_allclose(got, np.asarray(j_pll.halfband_filter(jnp.asarray(x), compact,
                                                                     flen)), atol=1.0)


def test_halfband_zero_taps_and_bands():
    h = t_pll.expand_halfband(t_pll.design_halfband(63).astype(np.float32), 63)
    for off in range(2, 31, 2):
        assert h[31 + off] == 0.0 and h[31 - off] == 0.0
    compact = t_pll.design_halfband(63)
    amp = []
    for f in (1000.0, 23000.0):
        y = t_pll.halfband_filter(torch.as_tensor(_tone(f, 10000.0, 2000, batch=1)),
                                  compact).numpy()
        amp.append(np.abs(y[0, 0] + 1j * y[0, 1]).mean())
    assert amp[0] > 9000.0 and amp[1] < 500.0


# ---------------------------------------------------------- equalizer


def _train_both(rx, state_b, train=None, mask=None, held=None):
    """equalize_train in both packages from the same initial state; the
    symbols are compared over the first ``held`` (all by default) and the
    final states where all are."""
    flat = convert.fields_to_numpy(state_b)
    st_j = j_eq.EqState(**{k: jnp.asarray(v) for k, v in flat.items()})
    got, st_t = t_eq.equalize_train(
        torch.as_tensor(rx), state_b,
        None if train is None else torch.as_tensor(train),
        None if mask is None else torch.as_tensor(mask))
    want, st_jn = j_eq.equalize_train(
        jnp.asarray(rx), st_j, None if train is None else jnp.asarray(train),
        None if mask is None else jnp.asarray(mask))
    assert_same("symbols", got[:, :held], np.asarray(want)[:, :held], FLOAT_RTOL, EQ_ATOL)
    if held is None:
        for f in t_eq.EqState._fields:
            assert_same(f, getattr(st_t, f), getattr(st_jn, f), FLOAT_RTOL, EQ_ATOL)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("trained", [True, False])
def test_equalize_train_matches_scalar_model_and_jax(trained):
    """Known-symbol training and decision-directed operation against the
    independent scalar model of m17_equalize.cpp (the JAX test's 2e-3)."""
    rng = np.random.default_rng(3 if trained else 4)
    n = 120 if trained else 100
    syms = _symbols(rng, n)
    rx = np.repeat(syms, 2) + (0.05 if trained else 0.03) * rng.normal(size=2 * n)
    ref = ScalarEq()
    want = [ref.train(rx[2 * i: 2 * i + 2], syms[i] if trained else None) for i in range(n)]
    got, _ = _train_both(rx[None, :].astype(np.float32), t_eq.EqState.init(1, "cpu"),
                         train=syms[None, :].astype(np.float32) if trained else None)
    np.testing.assert_allclose(got[0], want, atol=2e-3)


def test_equalize_train_mask_mixes_known_and_decisions():
    rng = np.random.default_rng(7)
    b, n = 3, 80
    syms = _symbols(rng, b * n).reshape(b, n).astype(np.float32)
    rx = (np.repeat(syms, 2, axis=-1) + 0.05 * rng.normal(size=(b, 2 * n))).astype(np.float32)
    mask = (np.arange(n)[None, :] % 8 < 3) & (np.arange(b)[:, None] != 1)
    _train_both(rx, t_eq.EqState.init(b, "cpu"), train=syms, mask=mask)


def test_equalize_train_converges_on_isi_channel():
    rng = np.random.default_rng(5)
    b, n = 8, 400
    syms = _symbols(rng, b * n).reshape(b, n)
    clean = np.repeat(syms, 2, axis=-1).astype(np.float32)
    rx_t = t_eq.isi_channel(torch.as_tensor(clean), (1.0, 0.0, 0.35))
    rx_j = j_eq.isi_channel(jnp.asarray(clean), (1.0, 0.0, 0.35))
    assert_same("isi_channel", rx_t, rx_j)
    outs = _train_both(rx_t.numpy(), t_eq.EqState.init(b, "cpu"),
                       train=syms.astype(np.float32), held=ISI_HELD)
    for out in outs:                    # the port's, then JAX's
        err = out - syms
        head, tail = np.mean(err[:, :50] ** 2), np.mean(err[:, -100:] ** 2)
        assert tail < head / 4 and tail < 0.01


def test_equalize_train_equals_jax_op_by_op():
    """Without XLA's fusion (so without its FMA contraction) the JAX
    function gives the port's symbols and state bit for bit, here on the
    start of the ISI run (op by op JAX takes ~0.17 s a symbol)."""
    import jax

    rng = np.random.default_rng(5)
    b, n = 4, 24
    syms = _symbols(rng, b * n).reshape(b, n).astype(np.float32)
    rx = t_eq.isi_channel(torch.as_tensor(np.repeat(syms, 2, axis=-1)), (1.0, 0.0, 0.35))
    got, st_t = t_eq.equalize_train(rx, t_eq.EqState.init(b, "cpu"), torch.as_tensor(syms))
    with jax.disable_jit():
        want, st_j = j_eq.equalize_train(jnp.asarray(rx.numpy()), j_eq.EqState.init(b),
                                         jnp.asarray(syms))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for f in t_eq.EqState._fields:
        np.testing.assert_array_equal(getattr(st_t, f).numpy(), np.asarray(getattr(st_j, f)))


def test_equalize_train_batch_equals_loop():
    rng = np.random.default_rng(6)
    b, n = 4, 60
    rx = rng.normal(size=(b, 2 * n)).astype(np.float32) * 0.5
    batch_out, _ = _train_both(rx, t_eq.EqState.init(b, "cpu"))
    for ch in range(b):
        single, _ = t_eq.equalize_train(torch.as_tensor(rx[ch: ch + 1]),
                                        t_eq.EqState.init(1, "cpu"))
        np.testing.assert_allclose(batch_out[ch], single.numpy()[0], atol=1e-5)


def test_equalize_restart_keeps_taps_and_state_round_trips():
    st = t_eq.EqState.init(2, "cpu")
    st = st._replace(c=st.c + 0.5, d=st.d * 3)
    st2 = st.restart()
    np.testing.assert_array_equal(st2.c.numpy(), st.c.numpy())
    np.testing.assert_allclose(st2.d.numpy(), 0.1)
    np.testing.assert_array_equal(st2.u.numpy(), 0.0)
    st_j = j_eq.EqState(**{k: jnp.asarray(v) for k, v in convert.fields_to_numpy(st).items()})
    for f in t_eq.EqState._fields:
        assert_same(f, getattr(st2, f), getattr(st_j.restart(), f))
    for f in t_eq.EqState._fields:
        assert_same(f, getattr(t_eq.EqState.init(3, "cpu"), f), getattr(j_eq.EqState.init(3), f))
    with pytest.raises(ValueError):
        convert.fields_from_numpy(t_eq.EqState, {"c": np.zeros((1, 5), np.float32)}, "cpu")


def test_slicer_and_kalman_gain_match_jax():
    rng = np.random.default_rng(8)
    sym = (rng.normal(size=64) * 0.8).astype(np.float32)
    np.testing.assert_array_equal(t_eq.slicer(torch.as_tensor(sym)).numpy(),
                                  np.asarray(j_eq.slicer(jnp.asarray(sym))))
    x = rng.normal(size=(6, 5)).astype(np.float32)
    u = np.triu(rng.normal(size=(6, 5, 5)) * 0.1, 1).astype(np.float32)
    d = rng.uniform(0.05, 0.2, (6, 5)).astype(np.float32)
    got = t_eq._kalman_gain(torch.as_tensor(x), torch.as_tensor(u), torch.as_tensor(d))
    want = j_eq._kalman_gain(jnp.asarray(x), jnp.asarray(u), jnp.asarray(d))
    for name, a, w in zip(("g", "y", "u", "d"), got, want):
        assert_same(name, a, w)


# ------------------------------------------------------- CRC and LSF


def test_crc16_scan_reference_self_test_and_fixed():
    """The reference's 0..255 self-test message (m17_crc.cpp:40-49), and
    the scan equal to the affine form and to JAX on random messages."""
    msg = np.arange(256, dtype=np.uint8)
    assert int(t_crc.crc16_scan(torch.as_tensor(msg))) == t_crc._crc_numpy(msg)
    np.testing.assert_array_equal(t_crc.CRC_TABLE, j_crc.CRC_TABLE.astype(np.int64))
    rng = np.random.default_rng(2)
    for n in (30, 7, 1):
        msgs = rng.integers(0, 256, size=(16, n), dtype=np.uint8)
        got = t_crc.crc16_scan(torch.as_tensor(msgs))
        assert torch.equal(got, t_crc.crc16_fixed(torch.as_tensor(msgs)))
        assert_same(f"crc16_scan n={n}", got, j_crc.crc16_scan(jnp.asarray(msgs)))


def test_parse_lsf_fields_reads_g4guo():
    """An LSF frame decoded by the port splits into the fields JAX reads."""
    from test_frame import _mk_lsf

    lsf = np.asarray(_mk_lsf(4))
    frame = np.asarray(j_txf.build_link_setup_frame(jnp.asarray(lsf)))
    syms = torch.as_tensor(DIBIT_TO_SYMBOL[frame] * 0.31)
    dec = t_rxf.decode_lsf(t_rxf.demap_frame(syms))
    assert bool(dec.crc_ok.all())
    np.testing.assert_array_equal(dec.lsf_bytes.numpy(), lsf)
    got = t_rxf.parse_lsf_fields(dec.lsf_bytes)
    want = j_rxf.parse_lsf_fields(jnp.asarray(lsf))
    for name, a, w in zip(("dst", "src", "type", "meta"), got, want):
        assert_same(name, a, w)
    assert t_call.decode_callsign(int(bytes_to_word_host(got[1][0].numpy()))).strip() == "G4GUO"
