"""The port's timing+framer scan against the JAX package.

The scan step is held exactly to the JAX ``_scan_step`` fed the same
matched-filter values, on the hard waveform of
tests/test_receiver_pallas.py (130 ppm drift with in-lock bit slips,
EOT loss of lock, error-budget loss of lock, re-acquisition), and
``receive_block`` to the JAX ``receive_block`` at frame level.  The
kernel is tested on the card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

from m17_sdr_tpu.frame import receiver as jr
from m17_sdr_tpu.frame import sync as j_sync
from m17_sdr_tpu.pipeline import ber_parity as bp
from m17_sdr_tpu_torch.frame import receiver as tr
from m17_sdr_tpu_torch.frame import sync as t_sync

torch.set_num_threads(2)
S2 = 384


@pytest.fixture(scope="module")
def hard_wave() -> np.ndarray:
    """16 channels: session A ends with an EOT, session B is cut
    mid-stream and followed by silence, all resampled at +130 ppm."""
    nuniq = 16
    wave_a, _ = bp.make_waveforms(nuniq, 6, sigma=0.05, seed=5)
    wave_b, _ = bp.make_waveforms(nuniq, 3, sigma=0.05, seed=6)
    cut = wave_b.shape[1] // 2
    wave = np.concatenate(
        [wave_a, wave_b[:, :cut], np.zeros((nuniq, 6 * S2), np.float32)], axis=1)
    r = 1 + 130e-6
    n = wave.shape[1]
    tgrid = np.arange(int((n - 2) / r)) * r + 0.75
    wave = np.stack([np.interp(tgrid, np.arange(n), w) for w in wave]).astype(np.float32)
    return wave[:, : (wave.shape[1] // S2) * S2]


def test_mf_bank_equals_jax_conv():
    """The plain tap-ordered filter bank gives the JAX bf16 convolution's
    values exactly."""
    rng = np.random.default_rng(0)
    ext = rng.normal(size=(4, S2 + 30)).astype(np.float32)
    kern = jnp.asarray(np.concatenate([jr._MF_BANK, jr._DMF_BANK], axis=0))
    want = jax.lax.conv_general_dilated(
        jnp.asarray(ext)[:, None, :].astype(jnp.bfloat16),
        kern[:, None, :].astype(jnp.bfloat16), window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"), preferred_element_type=jnp.bfloat16)
    got = tr.mf_bank(torch.as_tensor(ext))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.astype(jnp.float32)))


def test_sync_check_equals_jax():
    rng = np.random.default_rng(1)
    win = rng.normal(size=(300, 8)).astype(np.float32)
    win[:100] = np.asarray(j_sync.SYNC_PATTERNS)[rng.integers(0, 6, 100)] * \
        rng.uniform(0.5, 3, (100, 1)) + rng.normal(0, 0.3, (100, 8))
    win[100:110] = 0.0
    win = win.astype(np.float32)
    sc_t = t_sync.sync_check(torch.as_tensor(win))
    sc_j = j_sync.sync_check(jnp.asarray(win))
    np.testing.assert_array_equal(sc_t.ftype.numpy(), np.asarray(sc_j.ftype))
    np.testing.assert_array_equal(sc_t.votes.numpy(), np.asarray(sc_j.votes))
    np.testing.assert_allclose(sc_t.variance.numpy(), np.asarray(sc_j.variance), rtol=1e-6)
    for gate in ("unlocked_pass", "locked_pass"):
        np.testing.assert_array_equal(getattr(t_sync, gate)(sc_t).numpy(),
                                      np.asarray(getattr(j_sync, gate)(sc_j)), err_msg=gate)


def test_scan_step_exact_on_hard_waveform(hard_wave):
    b = hard_wave.shape[0]
    st_t = tr.ReceiverState.init(b, "cpu")
    st_j = jr.ReceiverState.init(b)
    scan_j = jax.jit(lambda st, mf: jax.lax.scan(jr._scan_step, st, mf))
    window = np.zeros((b, 31), np.float32)
    n_slip_locked = frames_after_slip = los_total = aos_total = frames = 0
    for blk in range(hard_wave.shape[1] // S2):
        ext = np.concatenate([window[:, 1:], hard_wave[:, blk * S2:(blk + 1) * S2]], axis=1)
        window = ext[:, -31:]
        # both sides take the same f32 filter values: the port's bf16 bank
        mf = tr.mf_bank(torch.as_tensor(ext))                    # [B, 80, S2]
        st_j, ys_j = scan_j(st_j, jnp.asarray(mf.permute(2, 0, 1).numpy()))
        ys_t = []
        for t in range(S2):
            st_t, y = tr._scan_step(st_t, mf[:, :, t])
            ys_t.append(y)
        names = ("slot_val", "slot_valid", "frame_done", "sync_type", "parse", "aos",
                 "los", "slip", "slipped")
        for name, col_t, col_j in zip(names, zip(*ys_t), ys_j):
            got = torch.stack(col_t, dim=1).numpy()
            want = np.asarray(col_j).T
            if name == "slot_val":
                np.testing.assert_array_equal(got, want, err_msg=f"block {blk}")
            else:
                np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64),
                                              err_msg=f"{name} block {blk}")
        slipped = np.asarray(ys_j[8]).T
        done = np.asarray(ys_j[2]).T
        n_slip_locked += int(slipped.sum())
        frames_after_slip += int(sum(np.asarray(ys_j[7]).T[c].any() and done[c].any()
                                     and not np.asarray(ys_j[6]).T[c].any()
                                     for c in range(b)))
        los_total += int(np.asarray(ys_j[6]).sum())
        aos_total += int(np.asarray(ys_j[5]).sum())
        frames += int(done.sum())
    for f in jr.ReceiverState._fields:
        if f not in ("window", "sym_hist"):     # receive_block keeps those
            assert_same(f, getattr(st_t, f), getattr(st_j, f), 0.0, 0.0)
    # the waveform reached the hard paths
    assert n_slip_locked > 0 and frames_after_slip > 0
    assert aos_total >= 2 and los_total >= 2
    assert frames > 0


def test_receive_block_matches_jax(hard_wave):
    """receive_block, plain version, against the JAX XLA receive_block."""
    wave = hard_wave[:6, : 20 * S2]
    b = wave.shape[0]
    st_t = tr.ReceiverState.init(b, "cpu")
    st_j = jr.ReceiverState.init(b)
    n_frames = 0
    for blk in range(wave.shape[1] // S2):
        x = wave[:, blk * S2:(blk + 1) * S2]
        ev_t, st_t = tr.receive_block(torch.as_tensor(x), st_t)
        ev_j, st_j = jr.receive_block(jnp.asarray(x), st_j)
        for f in jr.BlockEvents._fields:
            assert_same(f"{f} block {blk}", getattr(ev_t, f), getattr(ev_j, f), 0.0, 0.0)
        n_frames += int(np.asarray(ev_j.frame_valid).sum())
    for f in jr.ReceiverState._fields:
        assert_same(f, getattr(st_t, f), getattr(st_j, f), 0.0, 0.0)
    assert n_frames > 0


def test_kernel_wrapper_rejects_cpu_tensors():
    st = tr.ReceiverState.init(2, "cpu")
    with pytest.raises(ValueError):
        tr.receiver_scan_cuda(torch.zeros(2, S2), st)
    with pytest.raises(ValueError):
        tr.receive_block(torch.zeros(2, S2), st, use_kernel=True)
