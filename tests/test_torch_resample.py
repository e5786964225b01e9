"""The port's Pluto-rate x8 decimator (m17_sdr_tpu_torch.dsp.resample) and
the 384 kHz receive path through it, against the JAX package.

Taps and filter designs must be exactly equal.  ``fir_decimate`` agrees
with the JAX function to rtol 1e-5, atol 1e-6 (float32 sums of 31 terms
in another order) and keeps the same tail exactly; split into blocks it
equals itself unsplit exactly (the same products summed in the same
order).  The 384 kHz ``StreamingRx`` and ``Session.rx_file`` are held as
in tests/test_torch_app.py: integer, bool and byte fields exact, floats
to 1e-3 relative, stats equal with rssi to its rounding.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_parity import FLOAT_RTOL, assert_outputs_match, assert_same

from m17_sdr_tpu.app import session as j_session
from m17_sdr_tpu.app import streaming as j_st
from m17_sdr_tpu.dsp import filters as j_filters
from m17_sdr_tpu.dsp import resample as j_resample
from m17_sdr_tpu_torch.app import session as t_session
from m17_sdr_tpu_torch.app import streaming as t_st
from m17_sdr_tpu_torch.dsp import filters as t_filters
from m17_sdr_tpu_torch.dsp import resample as t_resample

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6
CHUNK = 4
RATE = 384_000
TX_LSB = 8            # port TX vs JAX TX, int16 LSB (tests/test_torch_app.py)


def test_taps_and_filter_designs_equal_jax():
    np.testing.assert_array_equal(t_resample.pluto_dec_taps(), j_resample.pluto_dec_taps())
    assert t_resample.pluto_dec_taps().dtype == np.float32
    for bw, n in ((1 / 8, 31), (0.25, 15), (0.05, 64)):
        np.testing.assert_array_equal(t_filters.lpf_filter(bw, n), j_filters.lpf_filter(bw, n))
    for n in (8, 31, 64):
        np.testing.assert_array_equal(t_filters.raised_cosine_window(n),
                                      j_filters.raised_cosine_window(n))


@pytest.mark.parametrize("t", [8, 1920, 15360])
def test_fir_decimate_matches_jax(t):
    rng = np.random.default_rng(t)
    x = rng.normal(size=(3, 2, t)).astype(np.float32)
    tail = rng.normal(size=(3, 2, 30)).astype(np.float32)
    taps = j_resample.pluto_dec_taps()
    y_j, tail_j = j_resample.fir_decimate(x, taps, tail)
    y_t, tail_t = t_resample.fir_decimate(torch.as_tensor(x), taps, torch.as_tensor(tail))
    assert y_t.shape == (3, 2, t // 8) and y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_j))


def test_fir_decimate_matches_float64():
    """Against the FIR in float64, within 1e-5 of the output's peak (31
    float32 products summed), as chip_smoke.py holds it on the card."""
    rng = np.random.default_rng(3)
    x = (0.5 * rng.normal(size=(4, 2, 15360))).astype(np.float32)
    tail = (0.5 * rng.normal(size=(4, 2, 30))).astype(np.float32)
    taps = t_resample.pluto_dec_taps()
    y, _ = t_resample.fir_decimate(torch.as_tensor(x), taps, torch.as_tensor(tail))
    xx = np.concatenate([tail, x], axis=-1).astype(np.float64)
    ref = sum(float(taps[30 - j]) * xx[..., j: j + 8 * 1919 + 1: 8] for j in range(31))
    assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_fir_decimate_blockwise_equals_unsplit():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(2, 2, 1920)).astype(np.float32))
    y_full, _ = t_resample.decimate_pluto(x, t_resample.decimate_init(2, "cpu"))
    tail = t_resample.decimate_init(2, "cpu")
    outs = []
    for i in range(4):
        y, tail = t_resample.decimate_pluto(x[..., i * 480:(i + 1) * 480], tail)
        outs.append(y)
    assert torch.equal(torch.cat(outs, dim=-1), y_full)


def test_fir_decimate_dc_gain_shape_and_ragged_block():
    x = torch.ones((1, 2, 640))
    y, tail = t_resample.decimate_pluto(x, t_resample.decimate_init(1, "cpu"))
    assert y.shape == (1, 2, 80) and tail.shape == (1, 2, 30)
    # after the filter delay, DC passes at unit gain
    np.testing.assert_allclose(y[0, 0, 10:].numpy(), 1.0, atol=1e-5)
    with pytest.raises(ValueError):
        t_resample.decimate_pluto(torch.ones((1, 2, 644)), tail)


@pytest.fixture(scope="module")
def pluto(tmp_path_factory):
    """A 4-frame voice session transmitted at 384 kHz by the JAX package
    (9 blocks), and the JAX StreamingRx decode of it in chunks of 4."""
    td = tmp_path_factory.mktemp("pluto")
    js = j_session.Session()
    js.db.tx_src_call, js.db.tx_dest_call = "G4GUO", "AB1CDE"
    path = str(td / "hi.iq")
    tx_stats = js.tx_file(path, n_frames=4, output_rate=RATE)
    srx = j_st.StreamingRx(batch=1, input_rate=RATE, chunk_blocks=CHUNK, equalize="auto")
    srx.run(j_st.wire_block_iter(path, srx.block_in))
    dec_tail = np.asarray(srx._state.dec_tail)
    return dict(td=td, path=path, tx_stats=tx_stats, jax=srx.finish(), dec_tail=dec_tail)


@pytest.mark.parametrize("use_ring", [True, False])
def test_streaming_rx_384k_matches_jax(pluto, use_ring):
    srx = t_st.StreamingRx(batch=1, input_rate=RATE, chunk_blocks=CHUNK, equalize="auto",
                           device="cpu")
    srx.run(t_st.wire_block_iter(pluto["path"], srx.block_in), use_ring=use_ring)
    assert_same("dec_tail", srx._state.dec_tail, pluto["dec_tail"])
    out_t, st_t, n_t = srx.finish()
    out_j, st_j, n_j = pluto["jax"]
    assert n_t == n_j == 9
    assert_outputs_match(out_t, out_j)
    assert int(out_t.stream_gate.sum()) == 4
    for name in ("lich_good", "lich_good_valid", "golay_errors", "n_frames", "last_fn"):
        assert_same(name, getattr(st_t, name), getattr(st_j, name))


def test_session_rx_file_384k_matches_jax(pluto, tmp_path):
    stats = {}
    for name, sess in (("jax", j_session.Session()),
                       ("port", t_session.Session(device="cpu"))):
        stats[name] = sess.rx_file(pluto["path"], input_rate=RATE, chunk_blocks=CHUNK,
                                   payload_out=str(tmp_path / f"{name}.bin"))
    got, want = stats["port"], stats["jax"]
    np.testing.assert_allclose(got.pop("rssi"), want.pop("rssi"), rtol=FLOAT_RTOL, atol=1e-4)
    assert got == want
    assert got["payload_frames"] == 4 and got["lsf"] == {"dst": "AB1CDE", "src": "G4GUO"}
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


def test_session_tx_file_384k_matches_jax(pluto, tmp_path):
    ts = t_session.Session(device="cpu")
    ts.db.tx_src_call, ts.db.tx_dest_call = "G4GUO", "AB1CDE"
    path = tmp_path / "hi.iq"
    assert ts.tx_file(str(path), n_frames=4, output_rate=RATE) == pluto["tx_stats"]
    got = np.fromfile(path, dtype="<i2").astype(np.int32)
    want = np.fromfile(pluto["path"], dtype="<i2").astype(np.int32)
    assert got.shape == want.shape and np.abs(got - want).max() <= TX_LSB
    with pytest.raises(ValueError):
        ts.tx_file(str(path), output_rate=96_000)
