"""The port's receive path against the JAX package on two session-level
paths: the auto equalizer arming on an ISI channel (soft-sample entry),
and a session resumed in the port from a JAX checkpoint."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_outputs_match, assert_states_match, two_sessions

from m17_sdr_tpu.pipeline import rx as jrx
from m17_sdr_tpu_torch.convert import state_from_numpy, state_to_numpy
from m17_sdr_tpu_torch.pipeline import rx as trx

torch.set_num_threads(2)


def test_rx_stream_soft_auto_arms_on_isi():
    """A two-ray ISI channel (dsp/equalize.py isi_channel) that sets in
    after acquisition closes the eye: the auto equalizer arms on every
    channel, and the port follows JAX field for field."""
    from m17_sdr_tpu.dsp.equalize import isi_channel
    from m17_sdr_tpu.pipeline import ber_parity as bp

    nch = 3
    wave, _ = bp.make_waveforms(nch, 3, sigma=0.0, seed=21)
    wave = np.asarray(wave)
    isi = np.asarray(isi_channel(jnp.asarray(wave), (1.0, 0.45, 0.2)))
    onset = wave.shape[1] * 2 // 5
    wave = np.concatenate([wave[:, :onset], isi[:, onset:]], axis=1)
    wave = (wave + np.random.default_rng(0).normal(0, 0.02, wave.shape)).astype(np.float32)
    blocks = wave.reshape(nch, -1, bp.CHUNK_2X)
    out_t, st_t = trx.rx_stream_soft(torch.as_tensor(blocks),
                                     trx.RxSessionState.init(nch, "cpu"), equalize="auto")
    out_j, st_j = jrx.rx_stream_soft(jnp.asarray(blocks), jrx.RxSessionState.init(nch),
                                     equalize="auto")
    assert int(np.asarray(st_j.eq_armed).sum()) == nch
    assert_outputs_match(out_t, out_j)
    assert_states_match(st_t, st_j)


def test_resume_from_jax_checkpoint(tmp_path):
    """Part of a run in JAX, saved with app/checkpoint.save_state while
    locked, resumed in the port: the rest matches JAX's own continuation."""
    from m17_sdr_tpu.app.checkpoint import save_state

    split = 4
    x = two_sessions()
    b = x.shape[0]
    _, st_j = jrx.rx_stream(jnp.asarray(x[:, :split]), jrx.RxSessionState.init(b),
                            afc_enabled=True)
    path = tmp_path / "rx.npz"
    save_state(str(path), st_j)
    with np.load(path) as z:
        st_t = state_from_numpy({k: z[k] for k in z.files}, "cpu")
    assert st_t.last_fn.dtype == torch.int64
    assert bool(st_t.receiver.flock.all())                  # resumed mid-session
    rest = x[:, split:]
    out_t, st_t = trx.rx_stream(torch.as_tensor(rest), st_t, afc_enabled=True)
    out_j, st_j = jrx.rx_stream(jnp.asarray(rest), st_j, afc_enabled=True)
    assert_outputs_match(out_t, out_j)
    assert_states_match(st_t, st_j)
    assert np.asarray(out_j.stream_gate).sum() > 0


def test_state_round_trip():
    st = trx.RxSessionState.init(2, "cpu")
    flat = state_to_numpy(st)
    assert flat["last_fn"].dtype == np.uint32
    back = state_to_numpy(state_from_numpy(flat, "cpu"))
    assert list(back) == list(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
        assert back[k].dtype == flat[k].dtype, k
    with pytest.raises(ValueError):
        state_from_numpy({k: v for k, v in flat.items() if k != "eye_est"}, "cpu")
